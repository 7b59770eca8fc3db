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
// What bounds it on this card: the instruction slots of its arithmetic.
// The f32 kernel is about 315 SASS instructions, nearly all of them a
// thread's 4 states of a row, so under 80 a state (the hash, the uniform
// and two accurate logs, whose polynomials use fused multiply-adds of
// their own; tools/sweep_constants.py counts them, PERF.md §6): they take
// about twice as long as writing the state's 4 bytes.  The design keeps
// every instruction that is not the state's own out of the inner work: a
// row r = k R + i of 1024 states is taken by 256 threads (NT / 256 rows a
// block at once, a grid-stride loop over rows), which derive k and i with
// one 32-bit divide and the row's hash hki = mix(mix(h0 ^ k) ^ i) once per
// row; each thread makes 4 consecutive states with 32-bit indexes and
// stores them as one float4 (f32) or two double2 (f64).  The grid is
// SM_BLOCKS blocks for each of the card's 132 SMs at most
// (tools/sweep_constants.py timed NT 256-1024 and SM_BLOCKS 2-32 within
// 1.2 % of one another at 256 threads, PERF.md §6).
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int NT = 256;          // threads a block
constexpr int SM_BLOCKS = 16;    // blocks an SM, at most
constexpr int RB = NT / 256;     // rows a block takes at once
static_assert(NT % 256 == 0, "a row is 256 threads of 4 states");

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

template <typename T>
__device__ __forceinline__ T gumbel(uint32_t hki, int s) {
  return -lg(-lg(uniform<T>(hki, s)));
}

// states s .. s + 3 of a row, one 16-byte store (f32) or two (f64)
__device__ __forceinline__ void store4(float* g, uint32_t hki, int s) {
  *reinterpret_cast<float4*>(g + s) = make_float4(
      gumbel<float>(hki, s), gumbel<float>(hki, s + 1),
      gumbel<float>(hki, s + 2), gumbel<float>(hki, s + 3));
}
__device__ __forceinline__ void store4(double* g, uint32_t hki, int s) {
  *reinterpret_cast<double2*>(g + s) = make_double2(
      gumbel<double>(hki, s), gumbel<double>(hki, s + 1));
  *reinterpret_cast<double2*>(g + s + 2) = make_double2(
      gumbel<double>(hki, s + 2), gumbel<double>(hki, s + 3));
}

// g [nk R, 1024]: row r = k R + i
template <typename T>
__global__ void __launch_bounds__(NT)
gumbel_kernel(T* __restrict__ g, int rows, int R, uint32_t seed) {
  const uint32_t h0 = mix32(seed ^ 0x9E3779B9u);
  const int s = (threadIdx.x & 255) * 4;
  for (int r = blockIdx.x * RB + (threadIdx.x >> 8); r < rows;
       r += gridDim.x * RB) {
    const uint32_t k = (uint32_t)r / (uint32_t)R;
    const uint32_t i = (uint32_t)r - k * (uint32_t)R;
    store4(g + (size_t)r * 1024, mix32(mix32(h0 ^ k) ^ i), s);
  }
}

template <typename T>
int launch(void* g, int nk, int R, unsigned seed, void* stream) {
  const long long rows = (long long)nk * R;
  if (rows == 0) return 0;
  if (nk < 0 || R < 0 || rows > INT_MAX) return (int)cudaErrorInvalidValue;
  const int blocks = (int)std::min<long long>((rows + RB - 1) / RB,
                                              132 * SM_BLOCKS);
  const auto st = static_cast<cudaStream_t>(stream);
  gumbel_kernel<T><<<blocks, NT, 0, st>>>(static_cast<T*>(g), (int)rows, R,
                                          seed);
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
