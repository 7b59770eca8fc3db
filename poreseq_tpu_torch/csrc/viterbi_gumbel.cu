// The Viterbi sampler's Gumbel noise (kernel 6 of the port).
//
// Replaces the noise that jax.random.categorical draws inside
// poreseq_tpu/engine/tpu/viterbi.py:_backtrace_one (:330-333); the plain
// PyTorch twin is engine/viterbi.py:gumbel_reference.  g[k, i, s] =
// -log(-log(u)) for candidate k < nk, row i < R and state s < 1024, where u
// is state s of jax.random.uniform(key_ki, (1024,), minval=tiny, maxval=1)
// under the row key key_ki = fold_in(split(PRNGKey(seed), nk)[k], i): JAX's
// threefry2x32 (engine/prng.py) in uint32 arithmetic.  A state's two words
// (y0, y1) = threefry2x32(key_ki, (0, s)) give the fraction bits, y0 ^ y1
// >> 9 (f32) or y0 << 20 | y1 >> 12 (f64), set into 1.m and less 1 (exact),
// then u = m * (1 - tiny) + tiny, at least tiny, as JAX's _uniform takes it
// (built with --fmad=false: the multiply and the add stay two roundings),
// so the noise equals the twin's bit for bit.  It depends on (k, i, s)
// only, so one launch serves every region of a sampler call
// (csrc/viterbi_sample.cu reads it).
//
// What bounds it on this card: the instruction slots of its arithmetic.  A
// state costs one threefry2x32, 20 rounds of an add, a rotate (one funnel
// shift) and an xor and 5 key injections, about 70 integer instructions,
// beside the uniform and two accurate logs, whose polynomials use fused
// multiply-adds of their own (tools/sweep_constants.py counts the SASS,
// PERF.md §6).  The design keeps every instruction that is not the state's
// own out of the inner work: a row r = k R + i of 1024 states is taken by
// 256 threads (NT / 256 rows a block at once, a grid-stride loop over
// rows), each making 4 consecutive states with 32-bit indexes, stored as
// one float4 (f32) or two double2 (f64).  A row key costs two threefry2x32
// calls, as much as two of a thread's states, so a warp derives the keys
// of its next 32 rows at once, lane j the key of its j-th row (k and i by
// one 32-bit divide), and hands row j's key to every lane by two shuffles.
// The grid is SM_BLOCKS blocks for each of the card's 132 SMs at most
// (tools/sweep_constants.py timed NT 256-1024 and SM_BLOCKS 2-32 within
// 1.2 % of one another at 256 threads for the kernel before threefry,
// PERF.md §6).
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int NT = 256;          // threads a block
constexpr int SM_BLOCKS = 16;    // blocks an SM, at most
constexpr int RB = NT / 256;     // rows a block takes at once
static_assert(NT % 256 == 0, "a row is 256 threads of 4 states");

__device__ __forceinline__ float lg(float x) { return logf(x); }
__device__ __forceinline__ double lg(double x) { return log(x); }

// one threefry round: x0 += x1, x1 = rotl(x1, r) ^ x0
__device__ __forceinline__ void mix(uint32_t& x0, uint32_t& x1, int r) {
  x0 += x1;
  x1 = __funnelshift_l(x1, x1, r) ^ x0;
}

__device__ __forceinline__ void four(uint32_t& x0, uint32_t& x1, int a,
                                     int b, int c, int d) {
  mix(x0, x1, a);
  mix(x0, x1, b);
  mix(x0, x1, c);
  mix(x0, x1, d);
}

// engine/prng.py:threefry2x32, the counter (x0, x1) under (k0, k1)
__device__ __forceinline__ void threefry(uint32_t k0, uint32_t k1,
                                         uint32_t& x0, uint32_t& x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  x0 += k0;
  x1 += k1;
  four(x0, x1, 13, 15, 26, 6);
  x0 += k1;
  x1 += k2 + 1u;
  four(x0, x1, 17, 29, 16, 24);
  x0 += k2;
  x1 += k0 + 2u;
  four(x0, x1, 13, 15, 26, 6);
  x0 += k0;
  x1 += k1 + 3u;
  four(x0, x1, 17, 29, 16, 24);
  x0 += k1;
  x1 += k2 + 4u;
  four(x0, x1, 13, 15, 26, 6);
  x0 += k2;
  x1 += k0 + 5u;
}

// prng.uniform: state s's uniform under the row key (a, b)
template <typename T>
__device__ __forceinline__ T uniform(uint32_t a, uint32_t b, uint32_t s);
template <> __device__ __forceinline__ float uniform<float>(uint32_t a,
                                                            uint32_t b,
                                                            uint32_t s) {
  uint32_t y0 = 0, y1 = s;
  threefry(a, b, y0, y1);
  const float tiny = 1.17549435082228751e-38f;
  const float f = __uint_as_float(0x3f800000u | ((y0 ^ y1) >> 9)) - 1.0f;
  return fmaxf(f * (1.0f - tiny) + tiny, tiny);
}
template <> __device__ __forceinline__ double uniform<double>(uint32_t a,
                                                              uint32_t b,
                                                              uint32_t s) {
  uint32_t y0 = 0, y1 = s;
  threefry(a, b, y0, y1);
  const double tiny = 2.2250738585072014e-308;
  const uint64_t m = ((uint64_t)y0 << 20) | (y1 >> 12);
  const double f = __longlong_as_double(
      (long long)(0x3ff0000000000000ull | m)) - 1.0;
  return fmax(f * (1.0 - tiny) + tiny, tiny);
}

template <typename T>
__device__ __forceinline__ T gumbel(uint32_t a, uint32_t b, int s) {
  return -lg(-lg(uniform<T>(a, b, (uint32_t)s)));
}

// states s .. s + 3 of a row, one 16-byte store (f32) or two (f64)
__device__ __forceinline__ void store4(float* g, uint32_t a, uint32_t b,
                                       int s) {
  *reinterpret_cast<float4*>(g + s) = make_float4(
      gumbel<float>(a, b, s), gumbel<float>(a, b, s + 1),
      gumbel<float>(a, b, s + 2), gumbel<float>(a, b, s + 3));
}
__device__ __forceinline__ void store4(double* g, uint32_t a, uint32_t b,
                                       int s) {
  *reinterpret_cast<double2*>(g + s) = make_double2(
      gumbel<double>(a, b, s), gumbel<double>(a, b, s + 1));
  *reinterpret_cast<double2*>(g + s + 2) = make_double2(
      gumbel<double>(a, b, s + 2), gumbel<double>(a, b, s + 3));
}

// g [nk R, 1024]: row r = k R + i under fold_in(split(key, nk)[k], i),
// key = (key0, key1)
template <typename T>
__global__ void __launch_bounds__(NT)
gumbel_kernel(T* __restrict__ g, int rows, int R, uint32_t key0,
              uint32_t key1) {
  const int s = (threadIdx.x & 255) * 4;
  const int lane = threadIdx.x & 31;
  const long long stride = (long long)gridDim.x * RB;
  // a warp's rows are base, base + stride, ...: 32 of them a pass
  for (long long base = blockIdx.x * RB + (threadIdx.x >> 8); base < rows;
       base += 32 * stride) {
    uint32_t a = 0, b = 0;
    const long long rj = base + lane * stride;
    if (rj < rows) {
      const uint32_t k = (uint32_t)rj / (uint32_t)R;
      const uint32_t i = (uint32_t)rj - k * (uint32_t)R;
      b = k;
      threefry(key0, key1, a, b);               // split(key, nk)[k]
      uint32_t c = 0, d = i;
      threefry(a, b, c, d);                     // fold_in(., i)
      a = c;
      b = d;
    }
    const long long left = (rows - 1 - base) / stride + 1;
    const int n = left < 32 ? (int)left : 32;
    for (int j = 0; j < n; ++j) {
      const uint32_t ka = __shfl_sync(psq::FULL, a, j);
      const uint32_t kb = __shfl_sync(psq::FULL, b, j);
      store4(g + (base + j * stride) * 1024, ka, kb, s);
    }
  }
}

template <typename T>
int launch(void* g, int nk, int R, unsigned long long seed, void* stream) {
  const long long rows = (long long)nk * R;
  if (rows == 0) return 0;
  if (nk < 0 || R < 0 || rows > INT_MAX) return (int)cudaErrorInvalidValue;
  const int blocks = (int)std::min<long long>((rows + RB - 1) / RB,
                                              132 * SM_BLOCKS);
  const auto st = static_cast<cudaStream_t>(stream);
  // prng.prng_key: the seed's high and low words
  gumbel_kernel<T><<<blocks, NT, 0, st>>>(static_cast<T*>(g), (int)rows, R,
                                          (uint32_t)(seed >> 32),
                                          (uint32_t)seed);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int psq_viterbi_gumbel_f32(void* g, int nk, int R,
                                      unsigned long long seed,
                                      void* stream) {
  return launch<float>(g, nk, R, seed, stream);
}

extern "C" int psq_viterbi_gumbel_f64(void* g, int nk, int R,
                                      unsigned long long seed,
                                      void* stream) {
  return launch<double>(g, nk, R, seed, stream);
}
