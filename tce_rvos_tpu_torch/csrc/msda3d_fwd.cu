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
// has one, so this is a gather kernel over all levels; none of the TPU
// tiling carries over.
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
// [Nq, Q, M, L, P, 3] f32 (x, y, f), attn [Nq, Q, M, L, P] f32, out
// [Nq, Q, M*D] in the value's dtype. D = 32. The rows are the Nq query
// frames; N, the value's frames, sets f_im and the frame bounds. A row's
// own frame is read only through its f coordinate, so Nq < N is the
// frame-sharded forward's call: a rank's queries over the whole clip's
// gathered value (parallel/mesh.py::shard_time_axis). The model's other
// calls have Nq = N. Sums are taken in f32 and
// written once in the value's dtype. The coordinates are rounded as the
// plain version rounds them (__fmul_rn, __fsub_rn: no FMA contraction), so
// both floor to the same pixel and frame: at zero temporal offset f_im is
// an exact integer, the query's own frame. A frame whose lerp weight is 0
// (an exact-integer f_im) is not read.
//
// What bounds it: at the serving encoder call (N = 20, Q = S = 5100,
// M = 8, L = P = 4, bf16) the compulsory traffic is about 313 MB (locations
// 157 MB, weights 52 MB, value and output 52 MB each), some 94 us at
// 3.35 TB/s; the gathers read up to 2 frames x 4 corners x 64 bytes a tap,
// 5-6 GB in all, re-reading rows that many queries share through L1 and
// L2. The first design of this kernel (one warp per row, lane = channel,
// one 2-byte load a lane per corner) ran at 2.4% of the bound (PERF.md).
// This design is the 2D forward's mapping (msda_fwd.cu, msda2d_common.cuh,
// msda3d_common.cuh): 16 lanes a row, 4 channel groups of 8 channels (one
// 16-byte load a corner and frame in bf16) x 4 tap groups of 4 taps; a
// tap's two frames are read one after the other; the tap groups' sums meet
// through 2 shuffle steps. With L = P = 4 at compile time a lane's 4
// locations and weights are loaded ahead of the gathers; other L (1..8) and
// P take the runtime-loop instantiation. Every call, from the decoder's
// Q = 5 to the encoder's Q = 5100, takes one path: rows in (n, q, m)
// order, 16 to a block of 256 threads, every tap from device memory.
// Staging a block's small levels in shared memory, as the 2D forward does,
// was measured 1-21% slower here (frame n's levels 1-3, or levels 2-3 of
// frames n-1..n+1 or n-2..n+2, on four tap distributions; PERF.md).

#include "msda3d_common.cuh"

#include <cmath>
#include <type_traits>

namespace {

using namespace msda3d;

// One tap, added into this lane's 8 channels: the bilinear taps of its two
// frames, each with its lerp weight. v_l: the level's value rows of frame 0
// for this head and channel group.
template <typename T>
__device__ __forceinline__ void tap_forward(int h, int w, const T* __restrict__ v_l,
                                            long long pix, long long frame, int N, float3 xyf,
                                            float a_t, float acc[8]) {
  const float x = pixel_coord(xyf.x, w);
  const float y = pixel_coord(xyf.y, h);
  const float f = pixel_coord(xyf.z, N);
  // some corner inside and some frame inside; also false for NaN
  const bool live = x > -1.f && x < (float)w && y > -1.f && y < (float)h && f > -1.f &&
                    f < (float)N;
  const Corners c = corners(x, y, h, w, live);
  const TapFrames tf = tap_frames(f, live);
  const float wc[4] = {(1.f - c.dy) * (1.f - c.dx), (1.f - c.dy) * c.dx, c.dy * (1.f - c.dx),
                       c.dy * c.dx};
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int fr = tf.f0 + k;
    const float wf = k ? tf.df : 1.f - tf.df;
    if (!live || fr < 0 || fr >= N || wf == 0.f) continue;  // a zero-weight frame is not read
    Row8<T> v[4];
    load_corners(at_frame(h, w, v_l, fr, frame), pix, c, v);
    const float af = a_t * wf;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float fv[8];
      v[i].to_float(fv);
      const float wgt = af * wc[i];
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[j] += wgt * fv[j];
    }
  }
}

// One row (n, q, m): this lane's taps, summed over the row's tap groups
// and written by tap group 0. v_m: the value of this head and channel
// group at frame 0, pixel 0.
template <typename T, int kL, int kP>
__device__ __forceinline__ void row_forward(const T* __restrict__ v_m, const Levels& lv,
                                            int n_levels, int P, long long pix, long long frame,
                                            int N, const float* __restrict__ loc_r,
                                            const float* __restrict__ attn_r,
                                            T* __restrict__ out_r, const Lane& ln) {
  const auto tap = [&](int l, float3 xyf, float a, float acc[8]) {
    tap_forward(lv.h[l], lv.w[l], v_m + lv.start[l] * pix, pix, frame, N, xyf, a, acc);
  };
  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
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
    for (int l = 0; l < kL; ++l) tap(l, xyf[l], a[l], acc);
  } else {
    for (int t = ln.tg; t < n_levels * P; t += kTapGroups)
      tap(t / P, load_xyf(loc_r + 3 * t), __ldg(attn_r + t), acc);
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {  // sum over the 4 tap groups (lane bits 2-3)
    acc[j] += __shfl_xor_sync(ln.row_mask, acc[j], kChannelGroups);
    acc[j] += __shfl_xor_sync(ln.row_mask, acc[j], 2 * kChannelGroups);
  }
  if (ln.tg == 0) store8(out_r, acc);
}

template <typename T, int kL, int kP>
__global__ void __launch_bounds__(kThreads, 2)
msda3d_fwd_kernel(const T* __restrict__ value, const __grid_constant__ Levels lv,
                  const int n_levels, const float* __restrict__ loc,
                  const float* __restrict__ attn, T* __restrict__ out, const int Nq,
                  const int N, const int S, const int Q, const int M, const int P) {
  const Lane ln = lane_of_row();
  const long long row = (long long)blockIdx.x * kRowsPerBlock + threadIdx.x / kLanesPerRow;
  if (row >= (long long)Nq * Q * M) return;  // whole rows: the 16 lanes stay together
  const int m = (int)(row % M);
  const int taps = n_levels * P;
  const long long pix = (long long)M * kChannels;  // stride of one pixel
  row_forward<T, kL, kP>(value + m * kChannels + ln.cg * 8, lv, n_levels, P, pix, S * pix, N,
                         loc + row * taps * 3, attn + row * taps,
                         out + row * kChannels + ln.cg * 8, ln);
}

// L = P = 4 (the flagship's) unrolled; other L and P take the runtime loops.
template <typename T>
int launch(const T* value, const Levels& lv, int n_levels, const float* loc, const float* attn,
           T* out, int Nq, int N, int S, int Q, int M, int P, cudaStream_t stream) {
  auto* kernel = n_levels == 4 && P == 4 ? msda3d_fwd_kernel<T, 4, 4> : msda3d_fwd_kernel<T, 0, 0>;
  kernel<<<blocks_for(Nq, Q, M), kThreads, 0, stream>>>(value, lv, n_levels, loc, attn, out, Nq,
                                                         N, S, Q, M, P);
  return (int)cudaGetLastError();
}

}  // namespace

// value_dtype: 0 = float32, 1 = bfloat16. level_hw: host array of
// n_levels (H, W) pairs. value and out must start on a 16-byte boundary.
// Nq: the query frames (rows of loc, attn and out); N: the value's frames.
// The name's _nq marks this argument, which the entry point's earlier
// tce_msda3d_fwd (one N for both) lacked. Returns cudaGetLastError() after
// the launch (cudaErrorInvalidValue for arguments the kernel does not take).
extern "C" int tce_msda3d_fwd_nq(const void* value, int value_dtype, const int* level_hw,
                                 int n_levels, const void* loc, const void* attn, void* out,
                                 int Nq, int N, int S, int Q, int M, int D, int P,
                                 void* stream) {
  if (D != kChannels || n_levels < 1 || n_levels > kMaxLevels || P < 1 || Nq < 0 || N < 0 ||
      (value_dtype != 0 && value_dtype != 1) ||
      reinterpret_cast<uintptr_t>(value) % 16 || reinterpret_cast<uintptr_t>(out) % 16)
    return (int)cudaErrorInvalidValue;
  Levels lv;
  if (!make_levels(level_hw, n_levels, S, &lv)) return (int)cudaErrorInvalidValue;
  if ((long long)Nq * Q * M == 0) return (int)cudaSuccess;
  const auto call = [&](auto* typed_out) {
    using T = std::remove_pointer_t<decltype(typed_out)>;
    return launch(static_cast<const T*>(value), lv, n_levels, static_cast<const float*>(loc),
                  static_cast<const float*>(attn), typed_out, Nq, N, S, Q, M, P,
                  static_cast<cudaStream_t>(stream));
  };
  return value_dtype == 0 ? call(static_cast<float*>(out))
                          : call(static_cast<__nv_bfloat16*>(out));
}
