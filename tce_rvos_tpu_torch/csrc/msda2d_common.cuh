// Shared by the 2D MSDA forward (msda_fwd.cu) and backward (msda_bwd.cu):
// the level shapes, the launch plan, the thread mapping, the 8-channel row
// loads, one tap's corners and the staging of a (frame, head)'s small
// levels in shared memory.
//
// Thread mapping: 16 lanes serve one row (n, q, head): lane = (tap group
// tg, channel group cg), 4 x 4. Channel group cg owns 8 channels (the
// forward's 8cg..8cg+7, one 16-byte load a corner in bf16; the backward's
// are split in two halves, Row8<T, true>). Tap
// group tg takes taps tg, tg + 4, ... of the row (with L = P = 4: point tg
// of every level), so a lane carries 4 taps and few registers. A block of
// `threads` threads (the plan's) serves threads / 16 rows at a time.
//
// The launch plan (mirrored by ops/msda_cuda.py::launch_plan and exported
// by tce_msda_plan, so that the two can be compared on the card):
//   * staged path, for calls with at least kStageMinQueries queries (the
//     encoder's pixel queries): a block takes one (frame n, head m) and a
//     run of consecutive queries, and first copies the trailing levels of
//     that (n, m) that fit in kSmemBudget into shared memory with
//     cp.async. Every tap of a staged level is then a shared-memory read,
//     wherever it lands; taps of the other levels read device memory
//     (through L1, which the run's neighbouring queries share). The
//     forward takes 512 threads a block here (64 registers, 32 warps on an
//     SM), the backward 256 (it needs more registers);
//   * flat path, for small calls (FTF Q = 8, decoder Q = 5): rows in
//     (n, q, m) order, 16 to a block of 256 threads, every tap from device
//     memory.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace msda2d {

constexpr int kMaxLevels = 8;
constexpr int kChannels = 32;            // D
constexpr int kChannelGroups = 4;        // 8 channels a lane
constexpr int kTapGroups = 4;
constexpr int kLanesPerRow = kChannelGroups * kTapGroups;  // 16
constexpr int kThreadsFlat = 256;
constexpr int kThreadsStagedForward = 512;
constexpr int kThreadsStagedBackward = 256;
constexpr int kStageMinQueries = 512;
constexpr int kSmemBudget = 115712;      // bytes a block: two blocks on an SM
constexpr int kTargetBlocks = 4 * 132;   // two waves of two blocks on 132 SMs

struct Levels {
  int h[kMaxLevels];
  int w[kMaxLevels];
  int start[kMaxLevels + 1];  // start[n_levels] = S
};

struct Plan {
  int staged;       // 1: staged path, 0: flat path
  int threads;      // a block's
  int run;          // queries a block takes (staged path)
  int blocks;       // grid size
  int value_from;   // first staged level (n_levels: none)
  int smem;         // dynamic shared-memory bytes
  int value_start;  // lv.start[value_from]
};

// Levels from host (H, W) pairs; false if they do not cover S.
inline bool make_levels(const int* level_hw, int n_levels, int S, Levels* lv) {
  long long start = 0;
  for (int l = 0; l < n_levels; ++l) {
    lv->h[l] = level_hw[2 * l];
    lv->w[l] = level_hw[2 * l + 1];
    lv->start[l] = (int)start;
    start += (long long)lv->h[l] * lv->w[l];
  }
  lv->start[n_levels] = (int)start;
  return start == S;
}

// elt: bytes of one value element (4 for f32, 2 for bf16).
inline Plan make_plan(bool backward, int elt, const Levels& lv, int n_levels, int N, int Q,
                      int M) {
  Plan p{};
  const long long nm = (long long)N * M;
  const long long pix_bytes = (long long)elt * kChannels;
  // the trailing levels that fit in the budget
  int from = n_levels;
  while (from > 0 && (lv.start[n_levels] - lv.start[from - 1]) * pix_bytes <= kSmemBudget)
    --from;
  p.staged = Q >= kStageMinQueries && from < n_levels && nm > 0;
  if (!p.staged) {
    p.threads = kThreadsFlat;
    const int rows_per_block = p.threads / kLanesPerRow;
    p.blocks = (int)((nm * Q + rows_per_block - 1) / rows_per_block);
    p.value_from = n_levels;
    p.value_start = lv.start[n_levels];
    return p;
  }
  p.threads = backward ? kThreadsStagedBackward : kThreadsStagedForward;
  const int rows_per_pass = p.threads / kLanesPerRow;
  long long per_nm = (kTargetBlocks + nm - 1) / nm;
  long long run = (Q + per_nm - 1) / per_nm;
  run = (run + rows_per_pass - 1) / rows_per_pass * rows_per_pass;
  p.run = (int)run;
  p.blocks = (int)(nm * ((Q + run - 1) / run));
  p.value_from = from;
  p.value_start = lv.start[from];
  p.smem = (int)((lv.start[n_levels] - lv.start[from]) * pix_bytes);
  return p;
}

// ---- this lane's place in its row -------------------------------------

struct Lane {
  int cg, tg;            // channel group, tap group
  unsigned row_mask;     // the row's 16 lanes
  unsigned quad_mask;    // the 4 lanes of this tap group
};

__device__ __forceinline__ Lane lane_of_row() {
  const int lane = threadIdx.x & 31;
  Lane r;
  r.cg = lane % kChannelGroups;
  r.tg = (lane / kChannelGroups) % kTapGroups;
  r.row_mask = 0xffffu << (lane & 16);
  r.quad_mask = 0xfu << (lane & ~(kChannelGroups - 1));
  return r;
}

// ---- 8 channels of one value row, as one lane holds them --------------

// A plain load from shared or device memory.
template <typename V>
__device__ __forceinline__ V load_any(const void* p) {
  return *reinterpret_cast<const V*>(p);
}

// Row8<T>: channels p[0..7], one 16-byte load in bf16. Row8<T, true>:
// channels p[0..3] and p[16..19]; four lanes at p = row + 0, 4, 8, 12 then
// hold channels 0-15 in their first halves and 16-31 in their second, so
// that each half, as f32, fills whole 32-byte sectors (the backward's
// d_value atomics: one L2 operation a sector, not two).
template <typename T, bool kSplit = false>
struct Row8;

template <bool kSplit>
struct Row8<__nv_bfloat16, kSplit> {
  uint32_t w[4];  // 4 x bf16x2
  __device__ __forceinline__ void zero() { w[0] = w[1] = w[2] = w[3] = 0u; }
  template <bool kReadOnly>
  __device__ __forceinline__ void load_from(const __nv_bfloat16* p) {
    if (kSplit) {
      const uint2 lo = kReadOnly ? __ldg(reinterpret_cast<const uint2*>(p)) : load_any<uint2>(p);
      const uint2 hi = kReadOnly ? __ldg(reinterpret_cast<const uint2*>(p + 16))
                                 : load_any<uint2>(p + 16);
      w[0] = lo.x; w[1] = lo.y; w[2] = hi.x; w[3] = hi.y;
    } else {
      const uint4 u = kReadOnly ? __ldg(reinterpret_cast<const uint4*>(p)) : load_any<uint4>(p);
      w[0] = u.x; w[1] = u.y; w[2] = u.z; w[3] = u.w;
    }
  }
  __device__ __forceinline__ void load_global(const __nv_bfloat16* p) { load_from<true>(p); }
  __device__ __forceinline__ void load(const __nv_bfloat16* p) { load_from<false>(p); }
  __device__ __forceinline__ void to_float(float f[8]) const {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      __nv_bfloat162 h;
      *reinterpret_cast<uint32_t*>(&h) = w[k];
      const float2 v = __bfloat1622float2(h);
      f[2 * k] = v.x;
      f[2 * k + 1] = v.y;
    }
  }
};

template <bool kSplit>
struct Row8<float, kSplit> {
  static constexpr int kSecond = kSplit ? 16 : 4;  // first channel of the second half
  float4 a, b;
  __device__ __forceinline__ void zero() { a = b = make_float4(0.f, 0.f, 0.f, 0.f); }
  __device__ __forceinline__ void load_global(const float* p) {
    a = __ldg(reinterpret_cast<const float4*>(p));
    b = __ldg(reinterpret_cast<const float4*>(p + kSecond));
  }
  __device__ __forceinline__ void load(const float* p) {
    a = load_any<float4>(p);
    b = load_any<float4>(p + kSecond);
  }
  __device__ __forceinline__ void to_float(float f[8]) const {
    f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
    f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
  }
};

__device__ __forceinline__ void store8(float* p, const float f[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(f[0], f[1], f[2], f[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(f[4], f[5], f[6], f[7]);
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float f[8]) {
  uint4 u;
  uint32_t* w = reinterpret_cast<uint32_t*>(&u);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * k], f[2 * k + 1]);
    w[k] = *reinterpret_cast<const uint32_t*>(&h);
  }
  *reinterpret_cast<uint4*>(p) = u;
}

// ---- one tap's bilinear corners ---------------------------------------

// The pixel coordinate loc * size - 0.5, rounded after the product and
// after the difference (no FMA contraction): the f32 order of the plain
// version, so that both floor to the same integer.
__device__ __forceinline__ float pixel_coord(float loc, int size) {
  return __fsub_rn(__fmul_rn(loc, (float)size), 0.5f);
}

struct Corners {
  int idx[4];     // pixel index inside the level of corners 00, 01, 10, 11
  bool in[4];     // inside the level
  float dx, dy;   // fraction of the coordinate
};

// Corners of the tap at pixel coordinates (x, y) on an (h, w) level; none
// is inside unless the tap is live, which puts x0 and y0 in [-1, w - 1] /
// [-1, h - 1] (and keeps NaN out of the integer conversion).
__device__ __forceinline__ Corners corners(float x, float y, int h, int w, bool live) {
  Corners c;
  const float xs = live ? x : 0.f, ys = live ? y : 0.f;
  const float x0f = floorf(xs), y0f = floorf(ys);
  const int x0 = (int)x0f, y0 = (int)y0f;
  c.dx = xs - x0f;
  c.dy = ys - y0f;
  const bool ix0 = x0 >= 0, ix1 = x0 + 1 < w, iy0 = y0 >= 0, iy1 = y0 + 1 < h;
  c.in[0] = live && iy0 && ix0;
  c.in[1] = live && iy0 && ix1;
  c.in[2] = live && iy1 && ix0;
  c.in[3] = live && iy1 && ix1;
  c.idx[0] = y0 * w + x0;
  c.idx[1] = c.idx[0] + 1;
  c.idx[2] = c.idx[0] + w;
  c.idx[3] = c.idx[2] + 1;
  return c;
}

// One level as a lane reads it: its shape, its value rows in device memory
// (this (n, m) and channel group; pixel stride `pix`) and, if staged, in
// shared memory (pixel stride 32).
template <typename T>
struct LevelRef {
  int h, w;
  const T* global;
  const T* shared;  // null: not staged
};

// The four corner rows of a tap: zero where a corner lies outside.
template <typename T, bool kSplit>
__device__ __forceinline__ void load_corners(const LevelRef<T>& lr, long long pix,
                                             const Corners& c, Row8<T, kSplit> v[4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (!c.in[k]) v[k].zero();
    else if (lr.shared) v[k].load(lr.shared + c.idx[k] * kChannels);
    else v[k].load_global(lr.global + c.idx[k] * pix);
  }
}

// ---- staging ------------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* smem_dst, const void* gmem_src) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem_src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_all;\n" ::: "memory");
}

// Copy pixels [p0, p1) of (frame n, head m) of a [N, S, M, 32] value into
// shared memory, 32 channels a pixel, contiguous, and wait for them. Called
// by the whole block.
template <int kThreads, typename T>
__device__ __forceinline__ void stage_pixels(T* s_val, const T* __restrict__ value, long long n,
                                             int S, int M, int m, int p0, int p1) {
  constexpr int kChunk = 16 / sizeof(T);          // elements of a 16-byte chunk
  constexpr int kChunks = kChannels / kChunk;     // chunks a pixel
  const int total = (p1 - p0) * kChunks;
  for (int i = threadIdx.x; i < total; i += kThreads) {
    const int px = i / kChunks, c = i % kChunks;
    const T* src = value + ((n * S + p0 + px) * (long long)M + m) * kChannels + c * kChunk;
    cp_async16(s_val + px * kChannels + c * kChunk, src);
  }
  cp_async_wait_all();
  __syncthreads();
}

// Block -> (n, m, first query, end query) on the staged path.
struct BlockRun {
  long long n;
  int m, q0, q1;
};

__device__ __forceinline__ BlockRun block_run(int run, int Q, int M) {
  const int per_nm = (Q + run - 1) / run;
  const long long nm = blockIdx.x / per_nm;
  const int split = (int)(blockIdx.x - nm * per_nm);
  BlockRun b;
  b.n = nm / M;
  b.m = (int)(nm % M);
  b.q0 = split * run;
  b.q1 = min(Q, b.q0 + run);
  return b;
}

}  // namespace msda2d
