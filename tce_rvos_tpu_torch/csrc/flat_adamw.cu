// The fused flat AdamW update on the card (parallel/flat_adamw.py).
//
// Replaces the update that XLA fuses for the JAX package's fused flat AdamW
// (tce_rvos_tpu/parallel/flat_adamw.py, `_moments` and `apply_params` of
// `make_flat_adamw_fused`, :180-200 and :238-270). The JAX package wrote no
// Pallas kernel for it: it is a handful of full-width elementwise passes
// that XLA fuses. Here it is one pass over the live range of the flat
// f32 buffers:
//
//   scale = gnorm < clip ? 1 : clip / gnorm        (gnorm read on the device)
//   g  = g * scale
//   mu = b1 * mu + (1 - b1) * g
//   nu = b2 * nu + (1 - b2) * (g * g)
//   p  = p * decay_t - lr_t * ((mu / bc1) / (sqrt(nu / bc2) + eps))
//
// where lr_t = lr * rel and decay_t = 1 - lr_t * wd are the scalars of the
// element's tier (the live tiers are contiguous, sorted, at most four) and
// bc1, bc2 the bias corrections 1 - b^count, all taken in f32 on the host
// as the JAX package takes them. Every operation is rounded on its own
// (__f*_rn: no contraction into FMAs), so the result is that of the plain
// torch version op by op.
//
// What bounds it: bytes. Each element reads g, p, mu and nu and writes p,
// mu and nu (28 B) for about 20 flops, far below the card's 295 flop/B
// balance point. The design is a plain streaming pass: float4 loads and
// stores (16 B a thread, neighbouring threads on neighbouring addresses),
// a grid-stride loop over 64-bit indices with a few blocks an SM, the
// tier's scalars picked by comparisons against the kernel's by-value
// argument (no table in memory), and gnorm read once a thread from device
// memory, so that the step needs no host sync. Where the live range does
// not start on a 16-byte boundary of all four buffers (a frozen prefix
// whose length is not a multiple of 4), the same pass runs a float at a
// time.

#include <cuda_runtime.h>

#define MAX_TIERS 4

struct TierTable {
  long long hi[MAX_TIERS];  // exclusive ends in live coordinates, ascending
  float lr[MAX_TIERS];      // lr_t * rel
  float decay[MAX_TIERS];   // 1 - lr_t * rel * wd
  int n;
};

struct Consts {
  float clip, b1, omb1, b2, omb2, bc1, bc2, eps;
};

__device__ __forceinline__ void adamw_element(float& p, float g, float& m, float& v,
                                              long long e, float scale,
                                              const TierTable& t, const Consts& c) {
  float lr = t.lr[0], decay = t.decay[0];
#pragma unroll
  for (int j = 1; j < MAX_TIERS; ++j) {
    if (j < t.n && e >= t.hi[j - 1]) {
      lr = t.lr[j];
      decay = t.decay[j];
    }
  }
  const float gs = __fmul_rn(g, scale);
  m = __fadd_rn(__fmul_rn(m, c.b1), __fmul_rn(gs, c.omb1));
  v = __fadd_rn(__fmul_rn(v, c.b2), __fmul_rn(__fmul_rn(gs, gs), c.omb2));
  const float mhat = __fdiv_rn(m, c.bc1);
  const float vhat = __fdiv_rn(v, c.bc2);
  const float adam = __fdiv_rn(mhat, __fadd_rn(__fsqrt_rn(vhat), c.eps));
  p = __fsub_rn(__fmul_rn(p, decay), __fmul_rn(adam, lr));
}

template <bool VEC>
__global__ void __launch_bounds__(256)
flat_adamw_kernel(float* __restrict__ p, const float* __restrict__ g, float* __restrict__ mu,
                  float* __restrict__ nu, const float* __restrict__ gnorm, long long n,
                  TierTable tiers, Consts c) {
  const float gn = __ldg(gnorm);
  const float scale = gn < c.clip ? 1.0f : __fdiv_rn(c.clip, gn);
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long start = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long scalar_from = 0;
  if (VEC) {
    const long long n4 = n >> 2;
    float4* p4 = reinterpret_cast<float4*>(p);
    const float4* g4 = reinterpret_cast<const float4*>(g);
    float4* m4 = reinterpret_cast<float4*>(mu);
    float4* v4 = reinterpret_cast<float4*>(nu);
    for (long long i = start; i < n4; i += stride) {
      float4 pv = p4[i], mv = m4[i], vv = v4[i];
      const float4 gv = __ldg(g4 + i);
      const long long e = i << 2;
      adamw_element(pv.x, gv.x, mv.x, vv.x, e, scale, tiers, c);
      adamw_element(pv.y, gv.y, mv.y, vv.y, e + 1, scale, tiers, c);
      adamw_element(pv.z, gv.z, mv.z, vv.z, e + 2, scale, tiers, c);
      adamw_element(pv.w, gv.w, mv.w, vv.w, e + 3, scale, tiers, c);
      p4[i] = pv;
      m4[i] = mv;
      v4[i] = vv;
    }
    scalar_from = n4 << 2;  // the last n % 4 elements
  }
  for (long long e = scalar_from + start; e < n; e += stride) {
    float pe = p[e], me = mu[e], ve = nu[e];
    adamw_element(pe, __ldg(g + e), me, ve, e, scale, tiers, c);
    p[e] = pe;
    mu[e] = me;
    nu[e] = ve;
  }
}

// One update of the n live elements. p and g point at the live range of
// the flat parameter and gradient buffers, mu and nu at the moments (n
// each), gnorm at the f32 global norm of the whole gradient buffer. The
// tiers' ends, LRs and decays are host arrays of n_tiers (1 to 4) entries.
// Returns the launch's CUDA error code (0 when it was accepted).
extern "C" int flat_adamw_update(float* p, const float* g, float* mu, float* nu,
                                 const float* gnorm, long long n, int n_tiers,
                                 const long long* tier_hi, const float* tier_lr,
                                 const float* tier_decay, float clip, float b1, float omb1,
                                 float b2, float omb2, float bc1, float bc2, float eps,
                                 void* stream) {
  if (n_tiers < 1 || n_tiers > MAX_TIERS) return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  TierTable t;
  for (int j = 0; j < MAX_TIERS; ++j) {
    const int k = j < n_tiers ? j : n_tiers - 1;
    t.hi[j] = tier_hi[k];
    t.lr[j] = tier_lr[k];
    t.decay[j] = tier_decay[k];
  }
  t.n = n_tiers;
  const Consts c{clip, b1, omb1, b2, omb2, bc1, bc2, eps};

  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 132;
  }
  const bool vec = ((reinterpret_cast<unsigned long long>(p) |
                     reinterpret_cast<unsigned long long>(g) |
                     reinterpret_cast<unsigned long long>(mu) |
                     reinterpret_cast<unsigned long long>(nu)) & 15ULL) == 0;
  const int threads = 256;
  const long long items = vec ? (n >> 2) + (n & 3) : n;
  const long long want = (items + threads - 1) / threads;
  const long long cap = 8LL * sms;  // eight blocks of 256 threads an SM
  const int blocks = (int)(want < cap ? want : cap);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (vec) {
    flat_adamw_kernel<true><<<blocks, threads, 0, s>>>(p, g, mu, nu, gnorm, n, t, c);
  } else {
    flat_adamw_kernel<false><<<blocks, threads, 0, s>>>(p, g, mu, nu, gnorm, n, t, c);
  }
  return (int)cudaGetLastError();
}
