// The Viterbi observations: per-state trimmed-mean emission log-likelihoods
// (kernel 7 of the port).
//
// Replaces poreseq_tpu/engine/tpu/viterbi.py:_obs_device (batched in
// :_obs_multi_fn), an XLA program that builds [B, R, E, 1024] emissions and
// sorts them over events; the plain PyTorch twin is
// engine/viterbi.py:obs_multi_reference.  For region b, row r and state s:
// the emission of every valid event e (dp.emission with the stdv clamped to
// 1e-30, no offset), the nskip = floor(nlik / 4) smallest (value, event
// index) pairs dropped (none when that leaves fewer than 2 or nlik <= 1; of
// equal values the lower index goes first), the rest summed in event index
// order and divided by max(nlik - nskip, 1).  Built with --fmad=false, the
// emission is the twin's expression tree and the sum its order, so the
// result equals the twin's bit for bit.
//
// What bounds it on this card: the operations, about 20 an emission over
// B x R x E x 1024 (e.g. 8 x 1088 x 16 x 1024: 2.9 GFLOP, 0.04 ms at the f32
// peak) against about 40 MB of bytes: the twin's sort moved its [B, R, E,
// 1024] values and int64 indexes through device memory several times.  The
// design never writes an emission: a block holds one row's 256 states (one
// a thread), the row's level data (mean, clamped stdv, its log, the valid
// flag) in shared memory, and reads the model tables coalesced along the
// states.  A row without a trim sums in one pass.  A row with one finds the
// drop threshold first, the nskip-th smallest (value, index), in a sorted
// list of KBUF registers (nskip <= KBUF: up to 35 events) or, above that,
// by nskip selection passes; a second pass recomputes each emission and
// sums those after the threshold.  Every branch on the trim is uniform over
// the block (one row).  Shared memory: E (3 sizeof(T) + 1) bytes, so a row
// takes up to 8192 events (engine/viterbi.py:OBS_MAX_EVENTS).
#include "common.cuh"

namespace {

using namespace psq;

constexpr int NT = 256;     // states per block
constexpr int KBUF = 8;     // the register drop list's length

__device__ __forceinline__ float lg(float x) { return logf(x); }
__device__ __forceinline__ double lg(double x) { return log(x); }

// (a, ia) comes before (b, ib): by value, then by event index
template <typename T>
__device__ __forceinline__ bool before(T a, int ia, T b, int ib) {
  return a < b || (a == b && ia < ib);
}

// lvl, sd, valid [B, R, E]; tabs [B, 6, E, 1024]; obs [B, R, 1024]
template <typename T>
__global__ void __launch_bounds__(NT)
obs_kernel(const T* __restrict__ lvl, const T* __restrict__ sd,
           const uint8_t* __restrict__ valid, const T* __restrict__ tabs,
           T* __restrict__ obs, int R, int E) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s_lvl = reinterpret_cast<T*>(smem_raw);
  T* s_sdc = s_lvl + E;
  T* s_lsd = s_sdc + E;
  uint8_t* s_ok = reinterpret_cast<uint8_t*>(s_lsd + E);

  const int s = blockIdx.x * NT + threadIdx.x;
  const size_t row = (size_t)blockIdx.z * R + blockIdx.y;
  for (int e = threadIdx.x; e < E; e += NT) {
    const T sdc = mx(sd[row * E + e], T(1e-30));
    s_lvl[e] = lvl[row * E + e];
    s_sdc[e] = sdc;
    s_lsd[e] = lg(sdc);
    s_ok[e] = valid[row * E + e];
  }
  __syncthreads();

  int nlik = 0;
  for (int e = 0; e < E; ++e) nlik += s_ok[e];
  int nskip = nlik / 4;
  if (nskip > nlik - 2 || nlik <= 1) nskip = 0;

  // tabs[b, k, e, s] = tb[(k E + e) 1024]
  const T* tb = tabs + (size_t)blockIdx.z * 6 * E * 1024 + s;
  const size_t kst = (size_t)E * 1024;
  auto em = [&](int e) {
    const T* t = tb + (size_t)e * 1024;
    return emission<T>(s_lvl[e], s_sdc[e], s_lsd[e], t[0], t[kst],
                       t[2 * kst], t[3 * kst], t[4 * kst], t[5 * kst], T(0));
  };

  // the threshold: (tv, ti) the last dropped pair, every pair after it kept
  T tv = -pos_inf<T>();
  int ti = -1;
  if (nskip > 0 && nskip <= KBUF) {
    T bv[KBUF];
    int bi[KBUF];
#pragma unroll
    for (int j = 0; j < KBUF; ++j) { bv[j] = pos_inf<T>(); bi[j] = INT_MAX; }
    for (int e = 0; e < E; ++e) {
      if (!s_ok[e]) continue;
      T v = em(e);
      int ie = e;
#pragma unroll
      for (int j = 0; j < KBUF; ++j) {         // insert, the list sorted
        if (before(v, ie, bv[j], bi[j])) {
          const T x = bv[j]; bv[j] = v; v = x;
          const int k = bi[j]; bi[j] = ie; ie = k;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < KBUF; ++j) {
      if (j == nskip - 1) { tv = bv[j]; ti = bi[j]; }
    }
  } else if (nskip > 0) {
    for (int k = 0; k < nskip; ++k) {          // the next pair after (tv, ti)
      T mv = pos_inf<T>();
      int mi = INT_MAX;
      for (int e = 0; e < E; ++e) {
        if (!s_ok[e]) continue;
        const T v = em(e);
        if (before(tv, ti, v, e) && before(v, e, mv, mi)) { mv = v; mi = e; }
      }
      tv = mv;
      ti = mi;
    }
  }

  T acc = T(0);
  for (int e = 0; e < E; ++e) {
    if (!s_ok[e]) continue;
    const T v = em(e);
    if (before(tv, ti, v, e)) acc = acc + v;
  }
  obs[row * 1024 + s] = acc / T(max(nlik - nskip, 1));
}

template <typename T>
int launch(const void* lvl, const void* sd, const void* valid,
           const void* tabs, void* obs, int B, int R, int E, void* stream) {
  if (B == 0 || R == 0) return 0;
  if (E < 0 || R > 65535 || B > 65535) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)E * (3 * sizeof(T) + 1);
  cudaError_t err = cudaFuncSetAttribute(
      obs_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const auto st = static_cast<cudaStream_t>(stream);
  obs_kernel<T><<<dim3(1024 / NT, R, B), NT, smem, st>>>(
      static_cast<const T*>(lvl), static_cast<const T*>(sd),
      static_cast<const uint8_t*>(valid), static_cast<const T*>(tabs),
      static_cast<T*>(obs), R, E);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int psq_viterbi_obs_f32(const void* lvl, const void* sd,
                                   const void* valid, const void* tabs,
                                   void* obs, int B, int R, int E,
                                   void* stream) {
  return launch<float>(lvl, sd, valid, tabs, obs, B, R, E, stream);
}

extern "C" int psq_viterbi_obs_f64(const void* lvl, const void* sd,
                                   const void* valid, const void* tabs,
                                   void* obs, int B, int R, int E,
                                   void* stream) {
  return launch<double>(lvl, sd, valid, tabs, obs, B, R, E, stream);
}
