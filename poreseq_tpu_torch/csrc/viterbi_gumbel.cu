// The Viterbi sampler's Gumbel noise (kernel 6 of the port).
//
// Replaces the noise that jax.random.categorical draws inside
// poreseq_tpu/engine/tpu/viterbi.py:_backtrace_one; the plain PyTorch twin
// is engine/viterbi.py:gumbel_reference.  g[k, i, s] = -log(-log(u[k, i,
// s])) for candidate k < nk, row i < R and state s < 1024, where u is the
// twin's counter_uniforms, computed here from the same 32-bit counter hash
// (lowbias32, four rounds) in uint32 arithmetic: f32 takes the hash's top
// 23 bits, f64 52 bits of two hashes (lane 1 at w = s + 1024 gives the low
// word), plus 0.5, times 2^-23 / 2^-52, so they equal the twin's bit for
// bit.  The noise depends on (k, i, s) only, so one launch serves every
// region of a sampler call (csrc/viterbi_sample.cu reads it).
//
// What bounds it on this card: the bytes it writes (nk x R x 4 KB in f32);
// an elementwise grid-stride loop, 256 threads a block, at most 16 blocks
// per SM.
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int NT = 256;

__device__ __forceinline__ float lg(float x) { return logf(x); }
__device__ __forceinline__ double lg(double x) { return log(x); }

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

// element e = (k R + i) 1024 + s
template <typename T>
__global__ void __launch_bounds__(NT)
gumbel_kernel(T* __restrict__ g, int nk, int R, uint32_t seed) {
  const size_t n = (size_t)nk * R * 1024;
  const uint32_t h0 = mix32(seed ^ 0x9E3779B9u);
  for (size_t e = (size_t)blockIdx.x * NT + threadIdx.x; e < n;
       e += (size_t)gridDim.x * NT) {
    const size_t ki = e >> 10;
    const uint32_t k = (uint32_t)(ki / R), i = (uint32_t)(ki % R);
    const uint32_t hki = mix32(mix32(h0 ^ k) ^ i);
    g[e] = -lg(-lg(uniform<T>(hki, (int)(e & 1023))));
  }
}

template <typename T>
int launch(void* g, int nk, int R, unsigned seed, void* stream) {
  const size_t n = (size_t)nk * R * 1024;
  if (n == 0) return 0;
  const int blocks = (int)std::min<size_t>((n + NT - 1) / NT, 132 * 16);
  const auto st = static_cast<cudaStream_t>(stream);
  gumbel_kernel<T><<<blocks, NT, 0, st>>>(static_cast<T*>(g), nk, R, seed);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int psq_viterbi_gumbel_f32(void* g, int nk, int R, unsigned seed,
                                      void* stream) {
  return launch<float>(g, nk, R, seed, stream);
}

extern "C" int psq_viterbi_gumbel_f64(void* g, int nk, int R, unsigned seed,
                                      void* stream) {
  return launch<double>(g, nk, R, seed, stream);
}
