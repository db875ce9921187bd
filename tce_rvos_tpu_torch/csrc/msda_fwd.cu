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
// so this is a gather kernel over all levels.
//
// What it computes (the semantics of tce_rvos_tpu/ops/msda.py and of
// ops/msda.py::ms_deform_attn_plain in the port):
//   out[n, q, m*D + d] = sum_l sum_p attn[n,q,m,l,p] *
//       bilinear_zero_pad(value_l[n, :, m, d], loc[n,q,m,l,p] * (W_l, H_l) - 0.5)
// value [N, S, M, D] f32 or bf16, loc [N, Q, M, L, P, 2] f32,
// attn [N, Q, M, L, P] f32, out [N, Q, M*D] in the value's dtype. D = 32.
// Sums are taken in f32 and written once in the value's dtype. A tap whose
// four corners all lie outside its level (or whose location is not finite)
// contributes nothing.
//
// What bounds it. The compulsory traffic of the serving encoder call
// (N = 20 frames, Q = S = 5100, M = 8, L = P = 4, bf16) is about 261 MB
// (locations 104 MB, weights 52 MB, value and output 52 MB each), some
// 78 us at 3.35 TB/s. The gathers are another matter: 16 taps x 4 corners
// x 64 bytes for each of the 816,000 rows, 3.3 GB, re-reading value rows
// that many queries share. The first design of this kernel (one warp per
// row, lane = channel, one tap at a time) ran at under 5% of the bound
// (PERF.md). This design (msda2d_common.cuh):
//   * 16 lanes a row: 4 channel groups of 8 channels (one 16-byte load a
//     corner in bf16) x 4 tap groups of 4 taps; the tap groups' sums meet
//     through 2 shuffle steps. With L = P = 4 (the flagship's) at compile
//     time a lane's 4 locations and weights are loaded ahead of the
//     gathers; other L (1..8) and P take the runtime-loop instantiation;
//   * staged path (Q >= 512): a block takes one (frame, head) and a run of
//     consecutive queries, and stages the trailing levels of that
//     (frame, head) that fit (levels 1-3 of the flagship in bf16: 1,260
//     pixels, 80,640 bytes) in shared memory with cp.async; level 0 reads
//     device memory through L1, which the run's neighbouring queries share.
//     512 threads a block, so 64 registers a thread and 32 warps an SM;
//   * flat path for the small calls (FTF Q = 8, decoder Q = 5): the same
//     row code with every tap from device memory.
// Correctness never depends on locality: a staged level is staged whole,
// and every other tap reads device memory.

#include "msda2d_common.cuh"

#include <cmath>
#include <type_traits>

namespace {

using namespace msda2d;

// One tap, added into this lane's 8 channels.
template <typename T>
__device__ __forceinline__ void tap_forward(const LevelRef<T>& lr, long long pix, float2 xy,
                                            float a_t, float acc[8]) {
  const float x = pixel_coord(xy.x, lr.w);
  const float y = pixel_coord(xy.y, lr.h);
  // at least one corner inside; also false for NaN
  const bool live = x > -1.f && x < (float)lr.w && y > -1.f && y < (float)lr.h;
  const float a = live ? a_t : 0.f;  // a dead tap adds nothing
  const Corners c = corners(x, y, lr.h, lr.w, live);
  Row8<T> v[4];
  load_corners(lr, pix, c, v);
  const float wgt[4] = {a * (1.f - c.dy) * (1.f - c.dx), a * (1.f - c.dy) * c.dx,
                        a * c.dy * (1.f - c.dx), a * c.dy * c.dx};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    float f[8];
    v[k].to_float(f);
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j] += wgt[k] * f[j];
  }
}

// One row (n, q, m): this lane's taps, summed over the row's tap groups
// and written by tap group 0. v_nm: the row's (n, m) value rows for this
// lane's channel group (pixel stride `pix`); s_val: the staged levels
// (pixels from value_start), for levels from value_from on.
template <typename T, int kL, int kP>
__device__ __forceinline__ void row_forward(const T* __restrict__ v_nm, const T* s_val,
                                            int value_from, int value_start, const Levels& lv,
                                            int n_levels, int P, long long pix,
                                            const float* __restrict__ loc_r,
                                            const float* __restrict__ attn_r,
                                            T* __restrict__ out_r, const Lane& ln) {
  const auto level = [&](int l) {
    return LevelRef<T>{lv.h[l], lv.w[l], v_nm + lv.start[l] * pix,
                       l >= value_from ? s_val + (lv.start[l] - value_start) * kChannels
                                       : nullptr};
  };
  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
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
    for (int l = 0; l < kL; ++l) tap_forward(level(l), pix, xy[l], a[l], acc);
  } else {
    for (int t = ln.tg; t < n_levels * P; t += kTapGroups)
      tap_forward(level(t / P), pix, __ldg(reinterpret_cast<const float2*>(loc_r) + t),
                  __ldg(attn_r + t), acc);
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {  // sum over the 4 tap groups (lane bits 2-3)
    acc[j] += __shfl_xor_sync(ln.row_mask, acc[j], kChannelGroups);
    acc[j] += __shfl_xor_sync(ln.row_mask, acc[j], 2 * kChannelGroups);
  }
  if (ln.tg == 0) store8(out_r, acc);
}

template <typename T, int kL, int kP, bool kStaged, int kThreads>
__global__ void __launch_bounds__(kThreads, 2)
msda_fwd_kernel(const T* __restrict__ value, const __grid_constant__ Levels lv, const int n_levels,
                const float* __restrict__ loc, const float* __restrict__ attn,
                T* __restrict__ out, const __grid_constant__ Plan plan, const int N, const int S,
                const int Q, const int M, const int P) {
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
    const T* v_nm = value + (b.n * S * M + b.m) * kChannels + ln.cg * 8;
    for (int q = b.q0 + row_in_pass; q < b.q1; q += kRowsPerPass) {
      const long long row = (b.n * Q + q) * M + b.m;
      row_forward<T, kL, kP>(v_nm, s_val + ln.cg * 8, plan.value_from, plan.value_start, lv,
                             n_levels, P, pix, loc + row * taps * 2, attn + row * taps,
                             out + row * kChannels + ln.cg * 8, ln);
    }
  } else {
    const long long row = (long long)blockIdx.x * kRowsPerPass + row_in_pass;
    if (row >= (long long)N * Q * M) return;  // whole rows: the 16 lanes stay together
    const int m = (int)(row % M);
    const long long n = row / ((long long)M * Q);
    row_forward<T, kL, kP>(value + (n * S * M + m) * kChannels + ln.cg * 8, s_val, n_levels, S,
                           lv, n_levels, P, pix, loc + row * taps * 2, attn + row * taps,
                           out + row * kChannels + ln.cg * 8, ln);
  }
}

// One call's arguments, as the host passes them to an instantiation.
template <typename T>
struct Call {
  const T* value;
  Levels lv;
  int n_levels;
  const float *loc, *attn;
  T* out;
  Plan plan;
  int N, S, Q, M, P;
  cudaStream_t stream;
};

template <typename T, int kL, int kP, bool kStaged, int kThreads>
int launch(const Call<T>& c) {
  auto* kernel = msda_fwd_kernel<T, kL, kP, kStaged, kThreads>;
  if (c.plan.smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, c.plan.smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<c.plan.blocks, kThreads, c.plan.smem, c.stream>>>(
      c.value, c.lv, c.n_levels, c.loc, c.attn, c.out, c.plan, c.N, c.S, c.Q, c.M, c.P);
  return (int)cudaGetLastError();
}

// L = P = 4 (the flagship's) unrolled; other L and P take the runtime loops.
template <typename T>
int dispatch(const Call<T>& c) {
  const bool flagship = c.n_levels == 4 && c.P == 4;
  if (c.plan.staged)
    return flagship ? launch<T, 4, 4, true, kThreadsStagedForward>(c)
                    : launch<T, 0, 0, true, kThreadsStagedForward>(c);
  return flagship ? launch<T, 4, 4, false, kThreadsFlat>(c)
                  : launch<T, 0, 0, false, kThreadsFlat>(c);
}

}  // namespace

// value_dtype: 0 = float32, 1 = bfloat16. level_hw: host array of
// n_levels (H, W) pairs. value and out must start on a 16-byte boundary,
// loc on an 8-byte one. Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for arguments the kernel does not take).
extern "C" int tce_msda_fwd(const void* value, int value_dtype, const int* level_hw,
                            int n_levels, const void* loc, const void* attn, void* out,
                            int N, int S, int Q, int M, int D, int P, void* stream) {
  if (D != kChannels || n_levels < 1 || n_levels > kMaxLevels || P < 1 ||
      (value_dtype != 0 && value_dtype != 1) ||
      reinterpret_cast<uintptr_t>(value) % 16 || reinterpret_cast<uintptr_t>(out) % 16 ||
      reinterpret_cast<uintptr_t>(loc) % 8)
    return (int)cudaErrorInvalidValue;
  Levels lv;
  if (!make_levels(level_hw, n_levels, S, &lv)) return (int)cudaErrorInvalidValue;
  if ((long long)N * Q * M == 0) return (int)cudaSuccess;
  const Plan plan = make_plan(false, value_dtype == 0 ? 4 : 2, lv, n_levels, N, Q, M);
  const auto call = [&](auto* typed_out) {
    using T = std::remove_pointer_t<decltype(typed_out)>;
    return dispatch(Call<T>{static_cast<const T*>(value), lv, n_levels,
                            static_cast<const float*>(loc), static_cast<const float*>(attn),
                            typed_out, plan, N, S, Q, M, P, static_cast<cudaStream_t>(stream)});
  };
  return value_dtype == 0 ? call(static_cast<float*>(out))
                          : call(static_cast<__nv_bfloat16*>(out));
}

// The launch plan tce_msda_fwd (backward = 0) or tce_msda_bwd (1) takes
// for these shapes, into out[6]: staged, threads, run, blocks, value_from,
// smem (msda2d_common.cuh; mirrored by ops/msda_cuda.py::launch_plan).
extern "C" int tce_msda_plan(int backward, int value_dtype, const int* level_hw, int n_levels,
                             int N, int S, int Q, int M, int* out) {
  Levels lv;
  if (n_levels < 1 || n_levels > kMaxLevels || !make_levels(level_hw, n_levels, S, &lv))
    return (int)cudaErrorInvalidValue;
  const Plan p = make_plan(backward != 0, value_dtype == 0 ? 4 : 2, lv, n_levels, N, Q, M);
  const int v[6] = {p.staged, p.threads, p.run, p.blocks, p.value_from, p.smem};
  for (int i = 0; i < 6; ++i) out[i] = v[i];
  return 0;
}
