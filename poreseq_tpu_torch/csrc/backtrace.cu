// Best-path backtrace over the forward fill (kernel 3 of the port).
//
// Replaces poreseq_tpu/engine/tpu/align.py:backtrace_core (XLA, a vmapped
// lax.scan of C + 2T + 8 steps per event; reference Alignment.cpp:516-624);
// the plain PyTorch twin is engine/align.py:backtrace_reference.  From each
// event's best cell it walks the M / S lattices and their backpointer bytes
// back to the start, writing ref_align (the 1-based reference index, or -1
// for an inserted level) and ref_like (the lattice score) at every emitted
// level, 0 elsewhere.
//
// What bounds it on this card: the walk is a chain of dependent loads
// (each step's cell depends on the previous step's move), so it is bound by
// memory latency, one event per thread; there is no arithmetic to speak of.
// The design gives each event its own block: the block's threads first zero
// the event's output rows with coalesced stores, then one thread walks.  The
// walk stops as soon as the event's path ends (the scan version keeps
// stepping to max_steps with no effect), so an event costs its path length.
#include "common.cuh"

using namespace psq;

template <typename T>
__global__ void backtrace_kernel(const T* __restrict__ M,
                                 const T* __restrict__ S,
                                 const uint8_t* __restrict__ steps_m,
                                 const uint8_t* __restrict__ steps_s,
                                 const int* __restrict__ i0,
                                 const int* __restrict__ i1,
                                 const int* __restrict__ best_i,
                                 const int* __restrict__ best_j,
                                 T* ral, T* rlk, int C, int E, int W, int Tpad,
                                 int max_steps) {
  const int e = blockIdx.x;
  T* ral_e = ral + (size_t)e * Tpad;
  T* rlk_e = rlk + (size_t)e * Tpad;
  for (int t = threadIdx.x; t < Tpad; t += blockDim.x) {
    ral_e[t] = T(0);
    rlk_e[t] = T(0);
  }
  __syncthreads();
  if (threadIdx.x != 0) return;

  const int* i0_e = i0 + (size_t)e * (C + 1);
  const int* i1_e = i1 + (size_t)e * (C + 1);
  int i = best_i[e], j = best_j[e], arr = 0;
  bool act = i > 0;
  for (int step = 0; step < max_steps && act; ++step) {
    const bool jok = j >= 1 && j <= C;
    const int jc = min(max(j, 1), C);
    const int lo = i0_e[jc], hi = i1_e[jc];
    const int rw = i - lo;
    const bool inb = rw >= 0 && rw < W && i <= hi && i >= lo;
    const int rowc = min(max(rw, 0), W - 1);
    const size_t cell = ((size_t)(jc - 1) * E + e) * W + rowc;
    const T sc = arr == 0 ? M[cell] : S[cell];
    const uint8_t stp = arr == 0 ? steps_m[cell] : steps_s[cell];
    const bool ok = i > 0 && jok && inb && sc > T(0);
    if (!ok) break;
    const bool is_match = stp == MATCH, is_ignore = stp == IGNORE;
    const bool is_insert = stp == INSERT, is_stay = stp == STAY;
    const bool is_extend = stp == EXTEND, is_skip = stp == SKIP;
    const bool emit_ref = is_match || is_extend || (is_stay && arr == 1);
    if (emit_ref || is_ignore || is_insert) {
      ral_e[i - 1] = emit_ref ? T(j) : T(-1);
      rlk_e[i - 1] = sc;
      i -= 1;
    }
    if (is_skip || is_match || is_ignore) j -= 1;
    if (is_stay) arr = 1 - arr;
    act = (is_match || is_ignore || is_insert || is_stay || is_extend ||
           is_skip) && i > 0;
  }
}

template <typename T>
static int launch(const void* M, const void* S, const void* sm,
                  const void* ss, const void* i0, const void* i1,
                  const void* bi, const void* bj, void* ral, void* rlk, int C,
                  int E, int W, int Tpad, int max_steps, void* stream) {
  backtrace_kernel<T><<<E, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(M), static_cast<const T*>(S),
      static_cast<const uint8_t*>(sm), static_cast<const uint8_t*>(ss),
      static_cast<const int*>(i0), static_cast<const int*>(i1),
      static_cast<const int*>(bi), static_cast<const int*>(bj),
      static_cast<T*>(ral), static_cast<T*>(rlk), C, E, W, Tpad, max_steps);
  return (int)cudaGetLastError();
}

extern "C" int psq_backtrace_f32(const void* M, const void* S, const void* sm,
                                 const void* ss, const void* i0,
                                 const void* i1, const void* bi,
                                 const void* bj, void* ral, void* rlk, int C,
                                 int E, int W, int Tpad, int max_steps,
                                 void* stream) {
  return launch<float>(M, S, sm, ss, i0, i1, bi, bj, ral, rlk, C, E, W, Tpad,
                       max_steps, stream);
}

extern "C" int psq_backtrace_f64(const void* M, const void* S, const void* sm,
                                 const void* ss, const void* i0,
                                 const void* i1, const void* bi,
                                 const void* bj, void* ral, void* rlk, int C,
                                 int E, int W, int Tpad, int max_steps,
                                 void* stream) {
  return launch<double>(M, S, sm, ss, i0, i1, bi, bj, ral, rlk, C, E, W, Tpad,
                        max_steps, stream);
}
