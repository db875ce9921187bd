// Multi-scale deformable attention (MSDA) forward, hand-written for Hopper
// (sm_90a), with a plain C interface loaded from Python through ctypes
// (tce_rvos_tpu_torch/ops/msda_cuda.py).
//
// Replaces the two TPU kernels of the JAX package's forward:
//   * tce_rvos_tpu/ops/pallas_msda.py::_sep_kernel_ah  (one level above
//     1024 pixels, e.g. 48x80 at the flagship clip size);
//   * tce_rvos_tpu/ops/pallas_msda.py::_flat_kernel_ah (all small levels in
//     one call).
// The TPU kernels build the bilinear taps as dense interpolation matmuls
// over banded value windows because the TPU has no gather. Hopper has one,
// so this is a single gather kernel over all levels, in the form of the
// original ms_deformable_im2col CUDA kernel.
//
// What it computes (the semantics of tce_rvos_tpu/ops/msda.py and of
// ops/msda.py::ms_deform_attn_plain in the port):
//   out[n, q, m*D + d] = sum_l sum_p attn[n,q,m,l,p] *
//       bilinear_zero_pad(value_l[n, :, m, d], loc[n,q,m,l,p] * (W_l, H_l) - 0.5)
// value [N, S, M, D] f32 or bf16, loc [N, Q, M, L, P, 2] f32,
// attn [N, Q, M, L, P] f32, out [N, Q, M*D] in the value's dtype. D = 32.
// Sums are taken in f32. A tap whose four corners all lie outside its level
// (or whose location is not finite) contributes nothing.
//
// What bounds it: memory. Each output row (n, q, m) reads L*P*2 location
// floats and L*P weights once and writes D outputs; the value rows it
// gathers are re-read by many queries. At the flagship encoder call
// (N = 5 frames, Q = S = 5100, bf16 value) the compulsory traffic is
// 13 MB of value, 26 MB of locations, 13 MB of weights and 13 MB of output,
// some 65 MB, or about 20 us at 3.35 TB/s; the gathered corner reads come to
// about 0.8 GB but mostly hit the 50 MB L2, which holds the whole value.
// The design follows from that:
//   * one warp per output row (n, q, m), lane = channel d: each corner read
//     is one coalesced 64-byte (bf16) or 128-byte (f32) row segment;
//   * the location and weight of a tap are read once per warp (a broadcast
//     load) and kept in registers; no shared memory, no atomics, no
//     cross-block reduction, since every output row is owned by one warp;
//   * the level shapes travel as kernel arguments, so no device array of
//     shapes is read.
// Not done yet (later work, measured first): caching a query's value window
// in shared memory, wider vector loads, and fusing the softmax of the
// attention weights and the output projection.

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
msda_fwd_kernel(const T* __restrict__ value, const Levels lv, const int n_levels,
                const float* __restrict__ loc, const float* __restrict__ attn,
                T* __restrict__ out, const long long n_rows, const int S,
                const int Q, const int M, const int P) {
  const long long row = (long long)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (row >= n_rows) return;
  const int lane = threadIdx.x & 31;
  const int m = (int)(row % M);
  const long long n = row / ((long long)M * Q);
  const int taps = n_levels * P;
  const float* loc_r = loc + row * taps * 2;
  const float* attn_r = attn + row * taps;
  const long long pix = (long long)M * kChannels;  // stride of one pixel
  const T* v_nm = value + (n * S * M + m) * kChannels + lane;

  float acc = 0.f;
  // unrolled so that lv.* is indexed statically: a dynamic index into a
  // kernel argument would copy the struct to local memory
#pragma unroll
  for (int l = 0; l < kMaxLevels; ++l) {
    if (l >= n_levels) break;
    const int h = lv.h[l];
    const int w = lv.w[l];
    const T* v_l = v_nm + lv.start[l] * pix;
    for (int p = 0; p < P; ++p) {
      const int t = l * P + p;
      const float2 xy = __ldg(reinterpret_cast<const float2*>(loc_r) + t);
      const float x = xy.x * (float)w - 0.5f;
      const float y = xy.y * (float)h - 0.5f;
      // at least one corner inside; also false for NaN
      if (!(x > -1.f && x < (float)w && y > -1.f && y < (float)h)) continue;
      const float a = __ldg(attn_r + t);
      const float x0f = floorf(x);
      const float y0f = floorf(y);
      const int x0 = (int)x0f;  // in [-1, w - 1]
      const int y0 = (int)y0f;  // in [-1, h - 1]
      const float dx = x - x0f;
      const float dy = y - y0f;
      float s = 0.f;
      if (y0 >= 0) {
        const T* r = v_l + (long long)y0 * w * pix;
        if (x0 >= 0) s += (1.f - dy) * (1.f - dx) * to_float(r[x0 * pix]);
        if (x0 + 1 < w) s += (1.f - dy) * dx * to_float(r[(x0 + 1) * pix]);
      }
      if (y0 + 1 < h) {
        const T* r = v_l + (long long)(y0 + 1) * w * pix;
        if (x0 >= 0) s += dy * (1.f - dx) * to_float(r[x0 * pix]);
        if (x0 + 1 < w) s += dy * dx * to_float(r[(x0 + 1) * pix]);
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
extern "C" int tce_msda_fwd(const void* value, int value_dtype, const int* level_hw,
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
    msda_fwd_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(value), lv, n_levels, loc_f, attn_f,
        static_cast<float*>(out), n_rows, S, Q, M, P);
  } else {
    msda_fwd_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(value), lv, n_levels, loc_f, attn_f,
        static_cast<__nv_bfloat16*>(out), n_rows, S, Q, M, P);
  }
  return (int)cudaGetLastError();
}
