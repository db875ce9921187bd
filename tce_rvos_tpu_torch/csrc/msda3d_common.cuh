// Shared by the 3D MSDA forward (msda3d_fwd.cu) and backward
// (msda3d_bwd.cu): the 2D kernels' thread mapping, row loads and corners
// (msda2d_common.cuh), plus what time adds: a tap's (x, y, f) location, its
// frames, and a level as one frame of it reads.
//
// A 3D tap at (x, y, f) reads the bilinear corners of frames floor(f_im)
// and floor(f_im) + 1, f_im = f * N - 0.5, which may lie anywhere on the
// call's N frames. The kernels take every call on one path: rows in
// (n, q, m) order, 16 to a block of 256 threads, every tap from device
// memory through L1 and L2. Staging a block's small levels in shared
// memory, as the 2D kernels do from 512 queries on, was measured slower
// here, for frame n's levels and for windows of frames around it (PERF.md).

#pragma once

#include "msda2d_common.cuh"

namespace msda3d {

using namespace msda2d;

constexpr int kThreads = kThreadsFlat;                  // 256
constexpr int kRowsPerBlock = kThreads / kLanesPerRow;  // 16

// One tap's frames: f0 = floor(f_im) and its fraction df. f_im is f * N -
// 0.5 rounded after the product and after the difference (pixel_coord), so
// that at zero temporal offset it is an exact integer, as in the plain
// version; a tap that is not live reads as frame 0.
struct TapFrames {
  int f0;
  float df;
};

__device__ __forceinline__ TapFrames tap_frames(float f_im, bool live) {
  const float fs = live ? f_im : 0.f;
  const float f0f = floorf(fs);
  return TapFrames{(int)f0f, fs - f0f};
}

// Frame fr of a level as load_corners reads it: v_l is the level's value
// rows of frame 0 (this head and channel group; frame stride `frame`).
template <typename T>
__device__ __forceinline__ LevelRef<T> at_frame(int h, int w, const T* v_l, int fr,
                                                long long frame) {
  return LevelRef<T>{h, w, v_l + fr * frame, nullptr};
}

// A tap's (x, y, f) location: three floats, 12 bytes (no vector load).
__device__ __forceinline__ float3 load_xyf(const float* __restrict__ p) {
  return make_float3(__ldg(p), __ldg(p + 1), __ldg(p + 2));
}

inline int blocks_for(int N, int Q, int M) {
  return (int)(((long long)N * Q * M + kRowsPerBlock - 1) / kRowsPerBlock);
}

}  // namespace msda3d
