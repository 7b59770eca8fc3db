// The Viterbi sampler: stochastic backtraces through the sweep's forward
// probabilities (kernel 5 of the port).
//
// Replaces poreseq_tpu/engine/tpu/viterbi.py:_backtrace_one (XLA, a lax.scan
// over rows, vmapped over candidates and regions in :_bt_multi_fn;
// reference Viterbi.cpp:403-423); the plain PyTorch twin is
// engine/viterbi.py:sample_paths_reference, a Python loop of about 12 torch
// ops per row.  One chain per (region b, candidate k): path[R-1] =
// startst[b], and walking down the rows, at each real row i > 0
//   probs = T[cur] * fwds[b, i]^atten[k],  probs /= total(probs),
//   cur = argmax(log(probs + eps) + gumbel(u[k, i])),  first index on ties,
// with gumbel = -log(-log(u)) and eps = 1e-300 (0 in float, as torch casts
// the twin's constant).  The uniforms u[k, i, s] are the twin's
// counter_uniforms, computed here from the same 32-bit counter hash
// (lowbias32, four rounds) in uint32 arithmetic: f32 takes the hash's top
// 23 bits, f64 52 bits of two hashes (lane 1 at w = s + 1024 gives the low
// word), plus 0.5, times 2^-23 / 2^-52, so they equal the twin's bit for
// bit.
//
// What bounds it on this card: each row's state depends on the previous
// row's argmax, so a chain is a sequence of block-wide reductions: latency,
// not bytes (T's 1024-wide row and one fwds row a step, from L2) or
// operations (a pow, two logs, a hash and a divide per state).  The design
// gives each chain its own block (8 regions x 16 candidates = 128 blocks on
// 132 SMs), 256 threads of 4 states each (thread t holds t + 256q), the
// total on the twin's halving tree (levels 1-2 in-thread, 3-5 by one warp
// from shared memory, 6-10 its shuffles) and a shuffle argmax.  Four block
// barriers a row.
#include "common.cuh"

using namespace psq;

namespace {

constexpr int NT = 256;

__device__ __forceinline__ float lg(float x) { return logf(x); }
__device__ __forceinline__ double lg(double x) { return log(x); }
__device__ __forceinline__ float pw(float x, float y) { return powf(x, y); }
__device__ __forceinline__ double pw(double x, double y) { return pow(x, y); }

// engine/viterbi.py:_mix32 (lowbias32)
__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  return x ^ (x >> 16);
}

// counter_uniforms: u in (0, 1) from h = mix(hki ^ w), hki the hash of
// (seed, k, i) so far
template <typename T> __device__ __forceinline__ T uniform(uint32_t hki, int s);
template <> __device__ __forceinline__ float uniform<float>(uint32_t hki,
                                                            int s) {
  const uint32_t x = mix32(hki ^ (uint32_t)s);
  return ((float)(x >> 9) + 0.5f) * 1.1920928955078125e-07f;   // 2^-23
}
template <> __device__ __forceinline__ double uniform<double>(uint32_t hki,
                                                              int s) {
  const uint64_t hi = mix32(hki ^ (uint32_t)s);
  const uint64_t lo = mix32(hki ^ (uint32_t)(s + 1024));
  const uint64_t x = ((hi >> 12) << 32) | lo;
  return ((double)x + 0.5) * 2.220446049250313e-16;              // 2^-52
}

template <typename T>
__global__ void __launch_bounds__(NT)
sample_kernel(const T* __restrict__ Tm, const T* __restrict__ fwds,
              const bool* __restrict__ valid,
              const int64_t* __restrict__ startst,
              const T* __restrict__ attens, int64_t* __restrict__ paths,
              int nk, int R, uint32_t seed) {
  const int b = blockIdx.x / nk, k = blockIdx.x % nk;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  __shared__ T red[256];
  __shared__ T total;
  __shared__ T wv[NT / 32];
  __shared__ int ws[NT / 32];
  __shared__ int next;

  const T at = attens[k];
  const T eps = T(1e-300);
  const uint32_t hk = mix32(mix32(seed ^ 0x9E3779B9u) ^ (uint32_t)k);
  const bool* valid_b = valid + (size_t)b * R;
  int64_t* path = paths + ((size_t)b * nk + k) * R;
  int cur = (int)startst[b];
  for (int i = R - 1; i >= 0; --i) {
    if (t == 0) path[i] = cur;
    if (i == 0 || !valid_b[i]) continue;        // block-uniform
    const T* fr = fwds + ((size_t)b * R + i) * 1024;
    const T* tr = Tm + (size_t)cur * 1024;
    T p[4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      p[q] = tr[t + 256 * q] * pw(fr[t + 256 * q], at);
    red[t] = (p[0] + p[2]) + (p[1] + p[3]);
    __syncthreads();
    if (warp == 0) {
      const T x = tree_total(red);
      if (lane == 0) total = x;
    }
    __syncthreads();
    const T tot = total;
    const uint32_t hki = mix32(hk ^ (uint32_t)i);
    T v = T(0);
    int s = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int st = t + 256 * q;
      const T g = -lg(-lg(uniform<T>(hki, st)));
      const T x = lg(p[q] / tot + eps) + g;
      if (q == 0) { v = x; s = st; }
      else first_max(v, s, x, st);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      first_max(v, s, __shfl_xor_sync(FULL, v, off),
                __shfl_xor_sync(FULL, s, off));
    if (lane == 0) { wv[warp] = v; ws[warp] = s; }
    __syncthreads();
    if (warp == 0) {
      v = wv[lane & (NT / 32 - 1)];
      s = ws[lane & (NT / 32 - 1)];
#pragma unroll
      for (int off = NT / 64; off > 0; off >>= 1)
        first_max(v, s, __shfl_xor_sync(FULL, v, off),
                  __shfl_xor_sync(FULL, s, off));
      if (lane == 0) next = s;
    }
    __syncthreads();
    cur = next;
  }
}

template <typename T>
int launch(const void* Tm, const void* fwds, const void* valid,
           const void* startst, const void* attens, void* paths, int B,
           int nk, int R, unsigned seed, void* stream) {
  if (B == 0 || nk == 0) return 0;
  sample_kernel<T><<<B * nk, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(Tm), static_cast<const T*>(fwds),
      static_cast<const bool*>(valid), static_cast<const int64_t*>(startst),
      static_cast<const T*>(attens), static_cast<int64_t*>(paths), nk, R,
      seed);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int psq_viterbi_sample_f32(const void* Tm, const void* fwds,
                                      const void* valid, const void* startst,
                                      const void* attens, void* paths, int B,
                                      int nk, int R, unsigned seed,
                                      void* stream) {
  return launch<float>(Tm, fwds, valid, startst, attens, paths, B, nk, R,
                       seed, stream);
}

extern "C" int psq_viterbi_sample_f64(const void* Tm, const void* fwds,
                                      const void* valid, const void* startst,
                                      const void* attens, void* paths, int B,
                                      int nk, int R, unsigned seed,
                                      void* stream) {
  return launch<double>(Tm, fwds, valid, startst, attens, paths, B, nk, R,
                        seed, stream);
}
