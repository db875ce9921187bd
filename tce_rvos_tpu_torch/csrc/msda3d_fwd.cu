// Temporal multi-scale deformable attention (3D MSDA, ``--msda_3d``)
// forward, hand-written for Hopper (sm_90a), with a plain C interface loaded
// from Python through ctypes (tce_rvos_tpu_torch/ops/msda_cuda.py).
//
// Replaces the two TPU kernels of the JAX package's 3D forward:
//   * tce_rvos_tpu/ops/pallas_msda_3d.py::_sep_kernel_3d  (one level above
//     1024 pixels, the whole frame axis of the value in VMEM per grid cell);
//   * tce_rvos_tpu/ops/pallas_msda_3d.py::_flat_kernel_3d (the small levels
//     in one call).
// The TPU kernels build each frame's bilinear taps as dense interpolation
// matmuls (per-frame x-contractions) because the TPU has no gather. Hopper
// has one, so this is a single gather kernel over all levels in the form of
// msda_fwd.cu; none of the TPU tiling carries over.
//
// What it computes (tce_rvos_tpu/ops/msda.py::ms_deform_attn_3d, and
// ops/msda.py::ms_deform_attn_3d_plain in the port):
//   f_im = f * N - 0.5, f0 = floor(f_im), df = f_im - f0
//   out[n, q, m*D + d] = sum_l sum_p attn[n,q,m,l,p] * (
//       (1 - df) * bilinear_zero_pad(value_l[f0,     :, m, d], (x, y))
//     +      df  * bilinear_zero_pad(value_l[f0 + 1, :, m, d], (x, y)))
// with (x, y) = loc * (W_l, H_l) - 0.5 and frames outside [0, N - 1]
// contributing nothing. Time is the call's whole batch axis (N frames), as
// in the JAX package. value [N, S, M, D] f32 or bf16, loc
// [N, Q, M, L, P, 3] f32 (x, y, f), attn [N, Q, M, L, P] f32, out
// [N, Q, M*D] in the value's dtype. D = 32. Sums are taken in f32. The
// coordinates are rounded as the plain version rounds them (__fmul_rn,
// __fsub_rn: no FMA contraction), so both floor to the same pixel and frame:
// at zero temporal offset f_im is an exact integer, the query's own frame.
//
// What bounds it: memory, as for the 2D forward. Each output row (n, q, m)
// reads L*P*3 location floats and L*P weights once and writes D outputs;
// each tap gathers up to 2 frames x 4 corners of 64-byte (bf16) value rows,
// re-read by many queries through the 50 MB L2. The design follows
// msda_fwd.cu: one warp per output row, lane = channel d, the level shapes as
// kernel arguments, no shared memory and no atomics. A frame whose lerp
// weight is 0 (an exact-integer f_im: every tap at zero temporal offset) is
// not read.
// Not done yet (later work, measured first): caching a query's value window
// in shared memory, wider vector loads, fusing the softmax of the weights.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kChannels = 32;  // D: one lane per channel
constexpr int kThreads = 256;  // 8 output rows per block

struct Levels {
  int h[kMaxLevels];
  int w[kMaxLevels];
  long long start[kMaxLevels];
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
msda3d_fwd_kernel(const T* __restrict__ value, const Levels lv, const int n_levels,
                  const float* __restrict__ loc, const float* __restrict__ attn,
                  T* __restrict__ out, const long long n_rows, const int N, const int S,
                  const int M, const int P) {
  const long long row = (long long)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (row >= n_rows) return;
  const int lane = threadIdx.x & 31;
  const int m = (int)(row % M);
  const int taps = n_levels * P;
  const float* loc_r = loc + row * taps * 3;
  const float* attn_r = attn + row * taps;
  const long long pix = (long long)M * kChannels;    // stride of one pixel
  const long long frame = (long long)S * pix;        // stride of one frame
  const T* v_m = value + (long long)m * kChannels + lane;
  const float fN = (float)N;

  float acc = 0.f;
  // unrolled so that lv.* is indexed statically: a dynamic index into a
  // kernel argument would copy the struct to local memory
#pragma unroll
  for (int l = 0; l < kMaxLevels; ++l) {
    if (l >= n_levels) break;
    const int h = lv.h[l];
    const int w = lv.w[l];
    const T* v_l = v_m + lv.start[l] * pix;
    for (int p = 0; p < P; ++p) {
      const int t = l * P + p;
      const float* c = loc_r + 3 * t;
      const float x = __fsub_rn(__fmul_rn(__ldg(c), (float)w), 0.5f);
      const float y = __fsub_rn(__fmul_rn(__ldg(c + 1), (float)h), 0.5f);
      const float f = __fsub_rn(__fmul_rn(__ldg(c + 2), fN), 0.5f);
      // some corner inside and some frame inside; also false for NaN
      if (!(x > -1.f && x < (float)w && y > -1.f && y < (float)h && f > -1.f && f < fN))
        continue;
      const float a = __ldg(attn_r + t);
      const float x0f = floorf(x);
      const float y0f = floorf(y);
      const float f0f = floorf(f);
      const int x0 = (int)x0f;  // in [-1, w - 1]
      const int y0 = (int)y0f;  // in [-1, h - 1]
      const int f0 = (int)f0f;  // in [-1, N - 1]
      const float dx = x - x0f;
      const float dy = y - y0f;
      const float df = f - f0f;
      float s = 0.f;
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int fr = f0 + k;
        const float wf = k ? df : 1.f - df;
        if (fr < 0 || fr >= N || wf == 0.f) continue;
        const T* v_f = v_l + fr * frame;
        float sf = 0.f;
        if (y0 >= 0) {
          const T* r = v_f + (long long)y0 * w * pix;
          if (x0 >= 0) sf += (1.f - dy) * (1.f - dx) * to_float(r[x0 * pix]);
          if (x0 + 1 < w) sf += (1.f - dy) * dx * to_float(r[(x0 + 1) * pix]);
        }
        if (y0 + 1 < h) {
          const T* r = v_f + (long long)(y0 + 1) * w * pix;
          if (x0 >= 0) sf += dy * (1.f - dx) * to_float(r[x0 * pix]);
          if (x0 + 1 < w) sf += dy * dx * to_float(r[(x0 + 1) * pix]);
        }
        s += wf * sf;
      }
      acc += a * s;
    }
  }
  store(out + row * kChannels + lane, acc);
}

}  // namespace

// value_dtype: 0 = float32, 1 = bfloat16. level_hw: host array of
// n_levels (H, W) pairs. Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for arguments the kernel does not take).
extern "C" int tce_msda3d_fwd(const void* value, int value_dtype, const int* level_hw,
                              int n_levels, const void* loc, const void* attn, void* out,
                              int N, int S, int Q, int M, int D, int P, void* stream) {
  if (D != kChannels || n_levels < 1 || n_levels > kMaxLevels || P < 1 ||
      (value_dtype != 0 && value_dtype != 1))
    return (int)cudaErrorInvalidValue;
  Levels lv;
  long long start = 0;
  for (int l = 0; l < n_levels; ++l) {
    lv.h[l] = level_hw[2 * l];
    lv.w[l] = level_hw[2 * l + 1];
    lv.start[l] = start;
    start += (long long)lv.h[l] * lv.w[l];
  }
  if (start != S) return (int)cudaErrorInvalidValue;
  const long long n_rows = (long long)N * Q * M;
  if (n_rows == 0) return (int)cudaSuccess;
  const long long rows_per_block = kThreads / 32;
  const dim3 grid((unsigned)((n_rows + rows_per_block - 1) / rows_per_block));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* loc_f = static_cast<const float*>(loc);
  const float* attn_f = static_cast<const float*>(attn);
  if (value_dtype == 0) {
    msda3d_fwd_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(value), lv, n_levels, loc_f, attn_f,
        static_cast<float*>(out), n_rows, N, S, M, P);
  } else {
    msda3d_fwd_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(value), lv, n_levels, loc_f, attn_f,
        static_cast<__nv_bfloat16*>(out), n_rows, N, S, M, P);
  }
  return (int)cudaGetLastError();
}
