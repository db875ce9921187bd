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
// gather/scatter kernel over all levels: each value row is read once per
// tap and frame for all four gradients.
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
// weight is 0, and the frame test admits f0 = -1 (frame 0 is then tap_1);
// x = -1 or y = -1 likewise keeps a tap alive. A frame or corner of zero
// weight scatters nothing. The coordinates are rounded as the plain version
// rounds them (__fmul_rn / __fsub_rn, no FMA contraction), so both floor
// alike. Queries of one clip read, and scatter into, the frames of the clip
// beside it when clips are stacked on the batch axis: time is the call's
// whole batch axis, as in the JAX package.
// value [N, S, M, D] f32 or bf16 and g [N, Q, M*D] in the value's dtype; loc
// [N, Q, M, L, P, 3] f32, attn [N, Q, M, L, P] f32; outputs d_value
// [N, S, M, D] f32 (accumulated with atomics into a buffer the caller has
// zeroed), d_loc [N, Q, M, L, P, 3] f32 and d_attn [N, Q, M, L, P] f32
// (every element written). D = 32.
//
// What bounds it: the d_value scatter, then the gathers and per-tap sums,
// as in 2D, with up to two frames a tap. The first design of this kernel
// (one warp per row, lane = channel, one 2-byte load and one scalar f32
// atomicAdd a lane per corner and frame, 4 x 5 shuffles a tap) ran at 7.2%
// of its bound (PERF.md). This design is the 2D backward's mapping
// (msda_bwd.cu, msda2d_common.cuh, msda3d_common.cuh):
//   * 16 lanes a row, 4 channel groups x 4 tap groups: a lane takes 4 taps
//     and 8 channels, and a tap's two frames one after the other (so that
//     only one frame's corners are held at a time); each frame's three sums
//     are 8 in-lane FMAs, and the tap's four sums meet in 2 shuffle steps
//     across its 4 channel groups. Channel group cg holds channels
//     4cg..4cg+3 and 16+4cg..16+4cg+3 (Row8<T, true>), so that each float4
//     atomic instruction of a row's four groups fills two whole 32-byte
//     sectors of its d_value row;
//   * every call takes one path: rows in (n, q, m) order, 16 to a block of
//     256 threads, every tap from device memory. Reading frame n's small
//     levels from shared memory, as the 2D backward does, was measured
//     10-23% slower here, and 2-3% faster only with every tap on its own
//     frame and pixel (PERF.md);
//   * every corner of a frame of non-zero weight goes to device memory as
//     two float4 atomicAdds (sm_90), resolved in L2. f32 atomicAdd on
//     shared memory is a compare-and-swap loop on sm_90 and lost in 2D
//     (PERF.md), so d_value is not summed in shared memory first.
// d_value is not bitwise reproducible from run to run (f32 atomics sum in
// another order).

#include "msda3d_common.cuh"

#include <cmath>
#include <type_traits>

namespace {

using namespace msda3d;

__device__ __forceinline__ float quad_sum(float v, unsigned mask) {
  v += __shfl_xor_sync(mask, v, 1);
  v += __shfl_xor_sync(mask, v, 2);
  return v;
}

// One tap of a row: d_loc (x, y, f) and d_attn of the tap (written by
// channel group 0), and this lane's 8 channels of d_value at the live
// corners of its frames. v_l, dv_l: the level's value and d_value rows of
// frame 0 for this head and channel group.
template <typename T>
__device__ __forceinline__ void tap_backward(int h, int w, const T* __restrict__ v_l,
                                             float* __restrict__ dv_l, long long pix,
                                             long long frame, int N, float3 xyf, float a_t,
                                             const float g[8], float* __restrict__ dloc_t,
                                             float* __restrict__ dattn_t, const Lane& ln) {
  const float x = pixel_coord(xyf.x, w);
  const float y = pixel_coord(xyf.y, h);
  const float f = pixel_coord(xyf.z, N);
  // some corner and some frame inside, or on the edge where the right
  // derivative still sees one (x == -1 reads corner 0 with weight 0, f == -1
  // reads frame 0 with weight 0); false for NaN
  const bool live = x >= -1.f && x < (float)w && y >= -1.f && y < (float)h && f >= -1.f &&
                    f < (float)N;
  const float a = live ? a_t : 0.f;
  const Corners c = corners(x, y, h, w, live);
  const TapFrames tf = tap_frames(f, live);
  const float dx = c.dx, dy = c.dy;
  const float wc[4] = {(1.f - dy) * (1.f - dx), (1.f - dy) * dx, dy * (1.f - dx), dy * dx};
  float s_attn = 0.f, s_x = 0.f, s_y = 0.f, s_f = 0.f;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int fr = tf.f0 + k;
    // a frame of zero weight is still read: d_loc_f takes it
    if (!live || fr < 0 || fr >= N) continue;
    const float wf = k ? tf.df : 1.f - tf.df;
    float t_k = 0.f, x_k = 0.f, y_k = 0.f;
    {
      Row8<T, true> v[4];
      load_corners(at_frame(h, w, v_l, fr, frame), pix, c, v);
      float fv[4][8];
#pragma unroll
      for (int i = 0; i < 4; ++i) v[i].to_float(fv[i]);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float tap = wc[0] * fv[0][j] + wc[1] * fv[1][j] + wc[2] * fv[2][j] + wc[3] * fv[3][j];
        const float gx = (1.f - dy) * (fv[1][j] - fv[0][j]) + dy * (fv[3][j] - fv[2][j]);
        const float gy = (1.f - dx) * (fv[2][j] - fv[0][j]) + dx * (fv[3][j] - fv[1][j]);
        t_k += g[j] * tap;
        x_k += g[j] * gx;
        y_k += g[j] * gy;
      }
    }
    s_attn += wf * t_k;
    s_x += wf * x_k;
    s_y += wf * y_k;
    s_f += k ? t_k : -t_k;
    // scatter attn * w_k * w_corner * g into the live corners of this
    // frame; a zero frame or corner weight adds nothing
    float* dv_f = dv_l + fr * frame;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float wk = a * wf * wc[i];
      if (!c.in[i] || wk == 0.f) continue;
      float* d = dv_f + c.idx[i] * pix;  // channels 4cg.. and 16 + 4cg.. (Row8<T, true>)
      atomicAdd(reinterpret_cast<float4*>(d),
                make_float4(wk * g[0], wk * g[1], wk * g[2], wk * g[3]));
      atomicAdd(reinterpret_cast<float4*>(d + kChannels / 2),
                make_float4(wk * g[4], wk * g[5], wk * g[6], wk * g[7]));
    }
  }
  s_attn = quad_sum(s_attn, ln.quad_mask);
  s_x = quad_sum(s_x, ln.quad_mask);
  s_y = quad_sum(s_y, ln.quad_mask);
  s_f = quad_sum(s_f, ln.quad_mask);
  if (ln.cg == 0) {
    dloc_t[0] = live ? a * (float)w * s_x : 0.f;
    dloc_t[1] = live ? a * (float)h * s_y : 0.f;
    dloc_t[2] = live ? a * (float)N * s_f : 0.f;
    *dattn_t = live ? s_attn : 0.f;
  }
}

// One row (n, q, m): this lane's taps. v_m, dv_m: the value and d_value of
// this head and channel group at frame 0, pixel 0.
template <typename T, int kL, int kP>
__device__ __forceinline__ void row_backward(
    const T* __restrict__ v_m, float* __restrict__ dv_m, const Levels& lv, int n_levels, int P,
    long long pix, long long frame, int N, const float* __restrict__ loc_r,
    const float* __restrict__ attn_r, const T* __restrict__ g_r, float* __restrict__ dloc_r,
    float* __restrict__ dattn_r, const Lane& ln) {
  float g[8];
  Row8<T, true> gr;
  gr.load_global(g_r);
  gr.to_float(g);
  const auto tap = [&](int l, int t, float3 xyf, float a) {
    tap_backward(lv.h[l], lv.w[l], v_m + lv.start[l] * pix, dv_m + lv.start[l] * pix, pix,
                 frame, N, xyf, a, g, dloc_r + 3 * t, dattn_r + t, ln);
  };
  if (kL) {  // point tg of every level; locations and weights ahead
    constexpr int kN = kL > 0 ? kL : 1;  // no zero-sized arrays in device code
    float3 xyf[kN];
    float a[kN];
#pragma unroll
    for (int l = 0; l < kL; ++l) {
      xyf[l] = load_xyf(loc_r + 3 * (l * kP + ln.tg));
      a[l] = __ldg(attn_r + l * kP + ln.tg);
    }
#pragma unroll
    for (int l = 0; l < kL; ++l) tap(l, l * kP + ln.tg, xyf[l], a[l]);
  } else {
    for (int t = ln.tg; t < n_levels * P; t += kTapGroups)
      tap(t / P, t, load_xyf(loc_r + 3 * t), __ldg(attn_r + t));
  }
}

template <typename T, int kL, int kP>
__global__ void __launch_bounds__(kThreads, 2)
msda3d_bwd_kernel(const T* __restrict__ value, const __grid_constant__ Levels lv,
                  const int n_levels, const float* __restrict__ loc,
                  const float* __restrict__ attn, const T* __restrict__ grad_out,
                  float* __restrict__ grad_value, float* __restrict__ grad_loc,
                  float* __restrict__ grad_attn, const int N, const int S, const int Q,
                  const int M, const int P) {
  const Lane ln = lane_of_row();
  const long long row = (long long)blockIdx.x * kRowsPerBlock + threadIdx.x / kLanesPerRow;
  if (row >= (long long)N * Q * M) return;  // whole rows: the quads stay together
  const int m = (int)(row % M);
  const int taps = n_levels * P;
  const long long pix = (long long)M * kChannels;  // stride of one pixel
  const long long base = m * kChannels + ln.cg * 4;
  row_backward<T, kL, kP>(value + base, grad_value + base, lv, n_levels, P, pix, S * pix, N,
                          loc + row * taps * 3, attn + row * taps,
                          grad_out + row * kChannels + ln.cg * 4, grad_loc + row * taps * 3,
                          grad_attn + row * taps, ln);
}

// L = P = 4 (the flagship's) unrolled; other L and P take the runtime loops.
template <typename T>
int launch(const T* value, const Levels& lv, int n_levels, const float* loc, const float* attn,
           const T* grad_out, float* grad_value, float* grad_loc, float* grad_attn, int N, int S,
           int Q, int M, int P, cudaStream_t stream) {
  auto* kernel = n_levels == 4 && P == 4 ? msda3d_bwd_kernel<T, 4, 4> : msda3d_bwd_kernel<T, 0, 0>;
  kernel<<<blocks_for(N, Q, M), kThreads, 0, stream>>>(value, lv, n_levels, loc, attn, grad_out,
                                                        grad_value, grad_loc, grad_attn, N, S, Q,
                                                        M, P);
  return (int)cudaGetLastError();
}

}  // namespace

// value_dtype: 0 = float32, 1 = bfloat16 (grad_out has the value's dtype).
// level_hw: host array of n_levels (H, W) pairs. grad_value must be zeroed
// by the caller. value, grad_out and grad_value must start on a 16-byte
// boundary. Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for arguments the kernel does not take).
extern "C" int tce_msda3d_bwd(const void* value, int value_dtype, const int* level_hw,
                              int n_levels, const void* loc, const void* attn,
                              const void* grad_out, void* grad_value, void* grad_loc,
                              void* grad_attn, int N, int S, int Q, int M, int D, int P,
                              void* stream) {
  const auto off = [](const void* p, unsigned a) { return reinterpret_cast<uintptr_t>(p) % a; };
  if (D != kChannels || n_levels < 1 || n_levels > kMaxLevels || P < 1 ||
      (value_dtype != 0 && value_dtype != 1) || off(value, 16) || off(grad_out, 16) ||
      off(grad_value, 16))
    return (int)cudaErrorInvalidValue;
  Levels lv;
  if (!make_levels(level_hw, n_levels, S, &lv)) return (int)cudaErrorInvalidValue;
  if ((long long)N * Q * M == 0) return (int)cudaSuccess;
  const auto call = [&](auto* typed_value) {
    using T = std::remove_const_t<std::remove_pointer_t<decltype(typed_value)>>;
    return launch(typed_value, lv, n_levels, static_cast<const float*>(loc),
                  static_cast<const float*>(attn), static_cast<const T*>(grad_out),
                  static_cast<float*>(grad_value), static_cast<float*>(grad_loc),
                  static_cast<float*>(grad_attn), N, S, Q, M, P,
                  static_cast<cudaStream_t>(stream));
  };
  return value_dtype == 0 ? call(static_cast<const float*>(value))
                          : call(static_cast<const __nv_bfloat16*>(value));
}
