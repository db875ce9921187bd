// Temporal multi-scale deformable attention (3D MSDA, ``--msda_3d``)
// backward, hand-written for Hopper (sm_90a), with a plain C interface loaded
// from Python through ctypes (tce_rvos_tpu_torch/ops/msda_cuda.py,
// MSDeformAttn3DFunction.backward).
//
// Replaces the four TPU kernels of the JAX package's 3D backward
// (tce_rvos_tpu/ops/pallas_msda_3d_bwd.py, reached through msda_backward_3d):
//   * _bwd3d_q_sep  (d_loc (x, y, f) and d_attn, one level above 1024 px);
//   * _bwd3d_v_sep  (d_value for that level, grid over frame, n, query block);
//   * _bwd3d_q_flat (d_loc, d_attn for the small levels, merged);
//   * _bwd3d_v_flat (d_value for the small levels).
// The TPU kernels split query-side and value-side gradients and build each
// frame's bilinear weights as dense interpolation matmuls because Mosaic has
// no gather and no scatter. Hopper has both, so this is ONE fused
// gather/scatter kernel over all levels, in the form of msda_bwd.cu: each
// value row is read once per tap for all four gradients.
//
// What it computes, for the forward of msda3d_fwd.cu
//   out[n, q, m*D + d] = sum_l sum_p attn * sum_k w_k * tap_k[d],
//   tap_k = bilinear_zero_pad(value_l[f0 + k, :, m, d], (x, y)),
//   w_0 = 1 - df, w_1 = df (0 for a frame outside [0, N - 1]),
// and the upstream gradient g[n, q, m*D + d]:
//   d_attn = sum_k w_k <g, tap_k>
//   d_loc_x = attn * W * sum_k w_k <g, d tap_k / dx>   (as in 2D, per frame)
//   d_loc_y = attn * H * sum_k w_k <g, d tap_k / dy>
//   d_loc_f = attn * N * (<g, tap_1> [f0 + 1 in range] - <g, tap_0> [f0 in range])
//   d_value[f0 + k, corner] += attn * w_k * w_corner * g
// with (x0, y0, f0) the floors of the pixel and frame coordinates and
// (dx, dy, df) their fractions. At an integer coordinate the floor makes
// this the RIGHT derivative, as the JAX package's autodiff of the XLA op and
// autograd through the plain version (ops/msda.py) give it. So at an
// exact-integer f_im (every tap at zero temporal offset), where df = 0, the
// tap of frame f0 + 1 still enters d_loc_f: its frame is read although its
// weight is 0, and the frame test admits f0 = -1 (frame 0 is then tap_1).
// The coordinates are rounded as the plain version rounds them
// (__fmul_rn / __fsub_rn, no FMA contraction), so both floor alike.
// Queries of one clip read, and scatter into, the frames of the clip beside
// it when clips are stacked on the batch axis: time is the call's whole
// batch axis, as in the JAX package.
// value [N, S, M, D] f32 or bf16 and g [N, Q, M*D] in the value's dtype; loc
// [N, Q, M, L, P, 3] f32, attn [N, Q, M, L, P] f32; outputs d_value
// [N, S, M, D] f32 (accumulated with atomics into a buffer the caller has
// zeroed), d_loc [N, Q, M, L, P, 3] f32 and d_attn [N, Q, M, L, P] f32
// (every element written). D = 32.
//
// What bounds it: the d_value scatter and the gathers, as in 2D, with up to
// twice the corner reads (two frames per tap). The design follows
// msda_bwd.cu: one warp per row (n, q, m), lane = channel d; each corner read
// and each corner's atomic reduction is one coalesced 64/128-byte row; the
// four per-tap sums share one butterfly of warp shuffles and lane 0 writes
// d_loc and d_attn; the atomics are the cross-query reduction, so d_value is
// not bitwise reproducible from run to run.
// Not done yet (later work, measured first): accumulating hot value rows of
// neighbouring pixel queries in shared memory before one atomic flush.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kChannels = 32;  // D: one lane per channel
constexpr int kThreads = 256;  // 8 rows per block

struct Levels {
  int h[kMaxLevels];
  int w[kMaxLevels];
  long long start[kMaxLevels];
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
msda3d_bwd_kernel(const T* __restrict__ value, const Levels lv, const int n_levels,
                  const float* __restrict__ loc, const float* __restrict__ attn,
                  const T* __restrict__ grad_out, float* __restrict__ grad_value,
                  float* __restrict__ grad_loc, float* __restrict__ grad_attn,
                  const long long n_rows, const int N, const int S, const int M,
                  const int P) {
  const long long row = (long long)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (row >= n_rows) return;  // warp-uniform: the shuffles below see full warps
  const int lane = threadIdx.x & 31;
  const int m = (int)(row % M);
  const int taps = n_levels * P;
  const float* loc_r = loc + row * taps * 3;
  const float* attn_r = attn + row * taps;
  float* dloc_r = grad_loc + row * taps * 3;
  float* dattn_r = grad_attn + row * taps;
  const long long pix = (long long)M * kChannels;  // stride of one pixel
  const long long frame = (long long)S * pix;      // stride of one frame
  const long long base = (long long)m * kChannels + lane;
  const T* v_m = value + base;
  float* dv_m = grad_value + base;
  const float g = to_float(grad_out[row * kChannels + lane]);
  const float fN = (float)N;

  // unrolled so that lv.* is indexed statically: a dynamic index into a
  // kernel argument would copy the struct to local memory
#pragma unroll
  for (int l = 0; l < kMaxLevels; ++l) {
    if (l >= n_levels) break;
    const int h = lv.h[l];
    const int w = lv.w[l];
    const T* v_l = v_m + lv.start[l] * pix;
    float* dv_l = dv_m + lv.start[l] * pix;
    for (int p = 0; p < P; ++p) {
      const int t = l * P + p;
      const float* c = loc_r + 3 * t;
      const float x = __fsub_rn(__fmul_rn(__ldg(c), (float)w), 0.5f);
      const float y = __fsub_rn(__fmul_rn(__ldg(c + 1), (float)h), 0.5f);
      const float f = __fsub_rn(__fmul_rn(__ldg(c + 2), fN), 0.5f);
      // some corner and some frame inside, or on the edge where the right
      // derivative still sees one (x == -1 reads corner 0 with weight 0,
      // f == -1 reads frame 0 with weight 0); false for NaN
      if (!(x >= -1.f && x < (float)w && y >= -1.f && y < (float)h && f >= -1.f &&
            f < fN)) {
        if (lane == 0) {
          dloc_r[3 * t] = 0.f;
          dloc_r[3 * t + 1] = 0.f;
          dloc_r[3 * t + 2] = 0.f;
          dattn_r[t] = 0.f;
        }
        continue;
      }
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
      const bool in_x0 = x0 >= 0, in_x1 = x0 + 1 < w;
      const bool in_y0 = y0 >= 0, in_y1 = y0 + 1 < h;
      const long long r0 = (long long)y0 * w, r1 = (long long)(y0 + 1) * w;
      const float w00 = (1.f - dy) * (1.f - dx), w01 = (1.f - dy) * dx;
      const float w10 = dy * (1.f - dx), w11 = dy * dx;
      const float ag = a * g;
      float tap = 0.f, gx = 0.f, gy = 0.f, gf = 0.f;  // per lane, before the g product
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int fr = f0 + k;
        if (fr < 0 || fr >= N) continue;
        const float wf = k ? df : 1.f - df;
        const T* v_f = v_l + fr * frame;
        const float v00 = (in_y0 && in_x0) ? to_float(v_f[(r0 + x0) * pix]) : 0.f;
        const float v01 = (in_y0 && in_x1) ? to_float(v_f[(r0 + x0 + 1) * pix]) : 0.f;
        const float v10 = (in_y1 && in_x0) ? to_float(v_f[(r1 + x0) * pix]) : 0.f;
        const float v11 = (in_y1 && in_x1) ? to_float(v_f[(r1 + x0 + 1) * pix]) : 0.f;
        const float tap_k = w00 * v00 + w01 * v01 + w10 * v10 + w11 * v11;
        tap += wf * tap_k;
        gx += wf * ((1.f - dy) * (v01 - v00) + dy * (v11 - v10));
        gy += wf * ((1.f - dx) * (v10 - v00) + dx * (v11 - v01));
        gf += k ? tap_k : -tap_k;
        // scatter attn * w_k * w_corner * g into the live corners of this
        // frame; a zero frame or corner weight adds nothing
        if (wf != 0.f) {
          const float agf = ag * wf;
          float* dv_f = dv_l + fr * frame;
          if (in_y0 && in_x0 && w00 != 0.f) atomicAdd(dv_f + (r0 + x0) * pix, agf * w00);
          if (in_y0 && in_x1 && w01 != 0.f) atomicAdd(dv_f + (r0 + x0 + 1) * pix, agf * w01);
          if (in_y1 && in_x0 && w10 != 0.f) atomicAdd(dv_f + (r1 + x0) * pix, agf * w10);
          if (in_y1 && in_x1 && w11 != 0.f) atomicAdd(dv_f + (r1 + x0 + 1) * pix, agf * w11);
        }
      }
      const float s_attn = warp_sum(g * tap);
      const float s_x = warp_sum(g * gx);
      const float s_y = warp_sum(g * gy);
      const float s_f = warp_sum(g * gf);
      if (lane == 0) {
        dloc_r[3 * t] = a * (float)w * s_x;
        dloc_r[3 * t + 1] = a * (float)h * s_y;
        dloc_r[3 * t + 2] = a * fN * s_f;
        dattn_r[t] = s_attn;
      }
    }
  }
}

}  // namespace

// value_dtype: 0 = float32, 1 = bfloat16 (grad_out has the value's dtype).
// level_hw: host array of n_levels (H, W) pairs. grad_value must be zeroed
// by the caller. Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for arguments the kernel does not take).
extern "C" int tce_msda3d_bwd(const void* value, int value_dtype, const int* level_hw,
                              int n_levels, const void* loc, const void* attn,
                              const void* grad_out, void* grad_value, void* grad_loc,
                              void* grad_attn, int N, int S, int Q, int M, int D, int P,
                              void* stream) {
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
  float* dv = static_cast<float*>(grad_value);
  float* dl = static_cast<float*>(grad_loc);
  float* da = static_cast<float*>(grad_attn);
  if (value_dtype == 0) {
    msda3d_bwd_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(value), lv, n_levels, loc_f, attn_f,
        static_cast<const float*>(grad_out), dv, dl, da, n_rows, N, S, M, P);
  } else {
    msda3d_bwd_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(value), lv, n_levels, loc_f, attn_f,
        static_cast<const __nv_bfloat16*>(grad_out), dv, dl, da, n_rows, N, S, M, P);
  }
  return (int)cudaGetLastError();
}
