// Multi-scale deformable attention (MSDA) backward, hand-written for Hopper
// (sm_90a), with a plain C interface loaded from Python through ctypes
// (tce_rvos_tpu_torch/ops/msda_cuda.py, MSDeformAttnFunction.backward).
//
// Replaces the four TPU kernels of the JAX package's backward
// (tce_rvos_tpu/ops/pallas_msda_bwd.py, reached through msda_backward_nmq):
//   * _bwd_q_kernel_sep  (d_loc, d_attn for one level above 1024 pixels);
//   * _bwd_v_kernel_sep  (d_value for that level, summed over queries);
//   * _bwd_q_kernel_flat (d_loc, d_attn for the small levels, merged);
//   * _bwd_v_kernel_flat (d_value for the small levels).
// The TPU kernels split query-side and value-side gradients and build the
// bilinear weights as dense interpolation matmuls over banded value windows
// because Mosaic has no gather and no scatter. Hopper has both, so this is
// ONE fused gather/scatter kernel over all levels: each value row is read
// once per tap for all three gradients.
//
// What it computes, for the forward
//   out[n, q, m*D + d] = sum_l sum_p attn[n,q,m,l,p] *
//       bilinear_zero_pad(value_l[n, :, m, d], loc[n,q,m,l,p] * (W_l, H_l) - 0.5)
// and the upstream gradient g[n, q, m*D + d]:
//   d_attn[n,q,m,l,p] = sum_d g[d] * tap[d]
//   d_loc_x           = attn * W * sum_d g[d] * ((1-dy)(V01-V00) + dy(V11-V10))[d]
//   d_loc_y           = attn * H * sum_d g[d] * ((1-dx)(V10-V00) + dx(V11-V01))[d]
//   d_value[corner]  += attn * w_corner * g[d]
// with (x0, y0) = floor of the pixel coordinate and (dx, dy) its fraction.
// A corner outside its level counts as zero. At an integer coordinate the
// floor makes this the RIGHT derivative (-V[x] + V[x+1]), as in the JAX
// package's _lin_weight and in autograd through the plain version
// (ops/msda.py). The pixel coordinate is computed as loc * W, rounded,
// then - 0.5, rounded (__fmul_rn / __fsub_rn: no FMA contraction), the f32
// order of the plain version, so both floor to the same integer; x = -1
// keeps a tap alive (it reads corner 0 with weight 0 for the derivative).
// value [N, S, M, D] f32 or bf16 and g [N, Q, M*D] in the value's dtype;
// loc [N, Q, M, L, P, 2] f32, attn [N, Q, M, L, P] f32; outputs d_value
// [N, S, M, D] f32 (accumulated with atomics into a buffer the caller has
// zeroed), d_loc [N, Q, M, L, P, 2] f32 and d_attn [N, Q, M, L, P] f32
// (every element written). D = 32.
//
// What bounds it: the d_value scatter, then the gathers and per-tap sums.
// At the training encoder call (N = 5 frames, Q = S = 5100, M = 8,
// L = P = 4) every live corner adds attn * w * g into 32 channels of
// d_value; the small levels' rows are hot (per (frame, head) each row of
// level 3, 6x10, takes about 1,360 adds). The first design of this kernel
// (one warp per row, lane = channel, 3 x 5 shuffles and a warp-wide f32
// atomicAdd per corner) ran at under 5% of its bound (PERF.md). This
// design, with the forward's mapping and plan (msda2d_common.cuh):
//   * 16 lanes a row, 4 channel groups x 4 tap groups: a lane takes 4 taps
//     and 8 channels; each tap's three sums are 8 in-lane FMAs and 2
//     shuffle steps across its 4 channel groups. Channel group cg holds
//     channels 4cg..4cg+3 and 16+4cg..16+4cg+3 (Row8<T, true>), so that each
//     float4 atomic instruction of a row's four groups fills two whole
//     32-byte sectors of its d_value row: L2 resolves atomics a sector at a
//     time, and 8 contiguous channels a lane took twice as many;
//   * staged path (Q >= 512): the value rows of the trailing levels that
//     fit are read from shared memory, as in the forward;
//   * every corner goes to device memory as two float4 atomicAdds (sm_90),
//     resolved in L2. Summing the hot levels' d_value in shared memory
//     first was measured slower: f32 atomicAdd on shared memory is a
//     compare-and-swap loop (ATOMS.CAST.SPIN) on sm_90 (PERF.md).
// d_value is not bitwise reproducible from run to run (f32 atomics sum in
// another order).

#include "msda2d_common.cuh"

#include <cmath>
#include <type_traits>

namespace {

using namespace msda2d;

__device__ __forceinline__ float quad_sum(float v, unsigned mask) {
  v += __shfl_xor_sync(mask, v, 1);
  v += __shfl_xor_sync(mask, v, 2);
  return v;
}

// One tap of a row: d_loc and d_attn of the tap (written by channel group
// 0), and this lane's 8 channels of d_value at its live corners. dv_l: the
// level's d_value rows of this (n, m) and channel group (pixel stride pix).
template <typename T>
__device__ __forceinline__ void tap_backward(const LevelRef<T>& lr, float* __restrict__ dv_l,
                                             long long pix, float2 xy, float a_t,
                                             const float g[8], float2* __restrict__ dloc_t,
                                             float* __restrict__ dattn_t, const Lane& ln) {
  const float x = pixel_coord(xy.x, lr.w);
  const float y = pixel_coord(xy.y, lr.h);
  // some corner inside, or on the edge where the right derivative still
  // sees one (x == -1 reads corner 0 with weight 0); false for NaN
  const bool live = x >= -1.f && x < (float)lr.w && y >= -1.f && y < (float)lr.h;
  const float a = live ? a_t : 0.f;
  const Corners c = corners(x, y, lr.h, lr.w, live);
  Row8<T, true> v[4];
  load_corners(lr, pix, c, v);
  const float dx = c.dx, dy = c.dy;
  const float wc[4] = {(1.f - dy) * (1.f - dx), (1.f - dy) * dx, dy * (1.f - dx), dy * dx};
  float s_attn = 0.f, s_x = 0.f, s_y = 0.f;
  {
    float f[4][8];
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k].to_float(f[k]);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float tap = wc[0] * f[0][j] + wc[1] * f[1][j] + wc[2] * f[2][j] + wc[3] * f[3][j];
      const float gx = (1.f - dy) * (f[1][j] - f[0][j]) + dy * (f[3][j] - f[2][j]);
      const float gy = (1.f - dx) * (f[2][j] - f[0][j]) + dx * (f[3][j] - f[1][j]);
      s_attn += g[j] * tap;
      s_x += g[j] * gx;
      s_y += g[j] * gy;
    }
  }
  s_attn = quad_sum(s_attn, ln.quad_mask);
  s_x = quad_sum(s_x, ln.quad_mask);
  s_y = quad_sum(s_y, ln.quad_mask);
  if (ln.cg == 0) {
    *dloc_t = live ? make_float2(a * (float)lr.w * s_x, a * (float)lr.h * s_y)
                   : make_float2(0.f, 0.f);
    *dattn_t = live ? s_attn : 0.f;
  }
  // scatter attn * w_corner * g into the live corners; a corner whose
  // bilinear weight is 0 (a tap on a pixel centre) adds nothing
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float wk = a * wc[k];
    if (!c.in[k] || wk == 0.f) continue;
    float* d = dv_l + c.idx[k] * pix;  // channels 4cg.. and 16 + 4cg.. (Row8<T, true>)
    atomicAdd(reinterpret_cast<float4*>(d),
              make_float4(wk * g[0], wk * g[1], wk * g[2], wk * g[3]));
    atomicAdd(reinterpret_cast<float4*>(d + kChannels / 2),
              make_float4(wk * g[4], wk * g[5], wk * g[6], wk * g[7]));
  }
}

// One row (n, q, m): this lane's taps. v_nm, dv_nm: the row's (n, m) value
// and d_value rows for this lane's channel group (pixel stride `pix`);
// s_val: the staged levels (pixels from value_start), for levels from
// value_from on.
template <typename T, int kL, int kP>
__device__ __forceinline__ void row_backward(
    const T* __restrict__ v_nm, const T* s_val, int value_from, int value_start,
    float* __restrict__ dv_nm, const Levels& lv, int n_levels, int P, long long pix,
    const float* __restrict__ loc_r, const float* __restrict__ attn_r,
    const T* __restrict__ g_r, float* __restrict__ dloc_r, float* __restrict__ dattn_r,
    const Lane& ln) {
  float g[8];
  Row8<T, true> gr;
  gr.load_global(g_r);
  gr.to_float(g);
  const auto tap = [&](int l, int t, float2 xy, float a) {
    const LevelRef<T> lr{lv.h[l], lv.w[l], v_nm + lv.start[l] * pix,
                         l >= value_from ? s_val + (lv.start[l] - value_start) * kChannels
                                         : nullptr};
    tap_backward(lr, dv_nm + lv.start[l] * pix, pix, xy, a, g,
                 reinterpret_cast<float2*>(dloc_r) + t, dattn_r + t, ln);
  };
  if (kL) {  // point tg of every level; locations and weights ahead
    constexpr int kN = kL > 0 ? kL : 1;  // no zero-sized arrays in device code
    float2 xy[kN];
    float a[kN];
#pragma unroll
    for (int l = 0; l < kL; ++l) {
      xy[l] = __ldg(reinterpret_cast<const float2*>(loc_r) + l * kP + ln.tg);
      a[l] = __ldg(attn_r + l * kP + ln.tg);
    }
#pragma unroll
    for (int l = 0; l < kL; ++l) tap(l, l * kP + ln.tg, xy[l], a[l]);
  } else {
    for (int t = ln.tg; t < n_levels * P; t += kTapGroups)
      tap(t / P, t, __ldg(reinterpret_cast<const float2*>(loc_r) + t), __ldg(attn_r + t));
  }
}

template <typename T, int kL, int kP, bool kStaged, int kThreads>
__global__ void __launch_bounds__(kThreads, 2)
msda_bwd_kernel(const T* __restrict__ value, const __grid_constant__ Levels lv,
                const int n_levels, const float* __restrict__ loc,
                const float* __restrict__ attn, const T* __restrict__ grad_out,
                float* __restrict__ grad_value, float* __restrict__ grad_loc,
                float* __restrict__ grad_attn, const __grid_constant__ Plan plan, const int N,
                const int S, const int Q, const int M, const int P) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* s_val = reinterpret_cast<T*>(smem);
  const Lane ln = lane_of_row();
  const int taps = n_levels * P;
  const long long pix = (long long)M * kChannels;  // stride of one pixel
  constexpr int kRowsPerPass = kThreads / kLanesPerRow;
  const int row_in_pass = threadIdx.x / kLanesPerRow;
  if (kStaged) {
    const BlockRun b = block_run(plan.run, Q, M);
    stage_pixels<kThreads>(s_val, value, b.n, S, M, b.m, plan.value_start, S);
    const long long base = (b.n * S * M + b.m) * kChannels + ln.cg * 4;
    for (int q = b.q0 + row_in_pass; q < b.q1; q += kRowsPerPass) {
      const long long row = (b.n * Q + q) * M + b.m;
      row_backward<T, kL, kP>(value + base, s_val + ln.cg * 4, plan.value_from,
                              plan.value_start, grad_value + base, lv, n_levels, P, pix,
                              loc + row * taps * 2, attn + row * taps,
                              grad_out + row * kChannels + ln.cg * 4, grad_loc + row * taps * 2,
                              grad_attn + row * taps, ln);
    }
  } else {
    const long long row = (long long)blockIdx.x * kRowsPerPass + row_in_pass;
    if (row >= (long long)N * Q * M) return;  // whole rows: the quads stay together
    const int m = (int)(row % M);
    const long long n = row / ((long long)M * Q);
    const long long base = (n * S * M + m) * kChannels + ln.cg * 4;
    row_backward<T, kL, kP>(value + base, s_val, n_levels, S, grad_value + base, lv, n_levels,
                            P, pix, loc + row * taps * 2, attn + row * taps,
                            grad_out + row * kChannels + ln.cg * 4, grad_loc + row * taps * 2,
                            grad_attn + row * taps, ln);
  }
}

// One call's arguments, as the host passes them to an instantiation.
template <typename T>
struct Call {
  const T* value;
  Levels lv;
  int n_levels;
  const float *loc, *attn;
  const T* grad_out;
  float *grad_value, *grad_loc, *grad_attn;
  Plan plan;
  int N, S, Q, M, P;
  cudaStream_t stream;
};

template <typename T, int kL, int kP, bool kStaged, int kThreads>
int launch(const Call<T>& c) {
  auto* kernel = msda_bwd_kernel<T, kL, kP, kStaged, kThreads>;
  if (c.plan.smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, c.plan.smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<c.plan.blocks, kThreads, c.plan.smem, c.stream>>>(
      c.value, c.lv, c.n_levels, c.loc, c.attn, c.grad_out, c.grad_value, c.grad_loc,
      c.grad_attn, c.plan, c.N, c.S, c.Q, c.M, c.P);
  return (int)cudaGetLastError();
}

// L = P = 4 (the flagship's) unrolled; other L and P take the runtime loops.
template <typename T>
int dispatch(const Call<T>& c) {
  const bool flagship = c.n_levels == 4 && c.P == 4;
  if (c.plan.staged)
    return flagship ? launch<T, 4, 4, true, kThreadsStagedBackward>(c)
                    : launch<T, 0, 0, true, kThreadsStagedBackward>(c);
  return flagship ? launch<T, 4, 4, false, kThreadsFlat>(c)
                  : launch<T, 0, 0, false, kThreadsFlat>(c);
}

}  // namespace

// value_dtype: 0 = float32, 1 = bfloat16 (grad_out has the value's dtype).
// level_hw: host array of n_levels (H, W) pairs. grad_value must be zeroed
// by the caller. value, grad_out and grad_value must start on a 16-byte
// boundary, loc and grad_loc on an 8-byte one. Returns cudaGetLastError()
// after the launch (cudaErrorInvalidValue for arguments the kernel does
// not take).
extern "C" int tce_msda_bwd(const void* value, int value_dtype, const int* level_hw,
                            int n_levels, const void* loc, const void* attn,
                            const void* grad_out, void* grad_value, void* grad_loc,
                            void* grad_attn, int N, int S, int Q, int M, int D, int P,
                            void* stream) {
  const auto off = [](const void* p, unsigned a) { return reinterpret_cast<uintptr_t>(p) % a; };
  if (D != kChannels || n_levels < 1 || n_levels > kMaxLevels || P < 1 ||
      (value_dtype != 0 && value_dtype != 1) || off(value, 16) || off(grad_out, 16) ||
      off(grad_value, 16) || off(loc, 8) || off(grad_loc, 8))
    return (int)cudaErrorInvalidValue;
  Levels lv;
  if (!make_levels(level_hw, n_levels, S, &lv)) return (int)cudaErrorInvalidValue;
  if ((long long)N * Q * M == 0) return (int)cudaSuccess;
  const Plan plan = make_plan(true, value_dtype == 0 ? 4 : 2, lv, n_levels, N, Q, M);
  const auto call = [&](auto* typed_value) {
    using T = std::remove_const_t<std::remove_pointer_t<decltype(typed_value)>>;
    return dispatch(Call<T>{typed_value, lv, n_levels, static_cast<const float*>(loc),
                            static_cast<const float*>(attn), static_cast<const T*>(grad_out),
                            static_cast<float*>(grad_value), static_cast<float*>(grad_loc),
                            static_cast<float*>(grad_attn), plan, N, S, Q, M, P,
                            static_cast<cudaStream_t>(stream)});
  };
  return value_dtype == 0 ? call(static_cast<const float*>(value))
                          : call(static_cast<const __nv_bfloat16*>(value));
}
