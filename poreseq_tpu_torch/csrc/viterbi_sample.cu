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
//   cur = argmax(log(probs + eps) + g[k, i]),  first index on ties,
// with eps = 1e-300 (0 in float, as torch casts the twin's constant) and g
// the Gumbel noise that csrc/viterbi_gumbel.cu wrote for the call (it
// depends on (k, i, s) only, so every region shares it).
//
// What bounds it on this card: each row's state depends on the previous
// row's argmax, so a chain is a sequence of dependent reductions: latency
// and issue slots, not bytes or operations.  The design keeps on the chain
// only what depends on cur:
// - T's row comes from the state bits, not from memory: T[cur, p] is one of
//   16 sums of the j-step weights, picked by the 4-bit mask of the steps j
//   whose predecessor set of cur holds p ((p & (4^(5-j) - 1)) == cur >> 2j),
//   or stay_prob on the diagonal; the wrapper passes those 17 values
//   (engine/viterbi.py:transition_table) and the block keeps them in shared
//   memory;
// - fwds[b, i]^atten[k] and row i's noise are made by 4 producer warps,
//   which load them and run the pows up to NS rows ahead of the chain into
//   a shared-memory ring; their issue slots fill the chain's stalls.
// The chain runs on a team of 4 warps (common.cuh: lane l of warp w holds
// the states l + 32m, m = w + 4q): the total on the twin's halving tree
// (levels 1-3 in-thread, one exchange, 4-5 in every warp, 6-10 xor
// shuffles) and the first argmax as an integer key (torch.argmax's order)
// by the warp's integer max and min reductions, then across the warps.
// Named barriers only, no __syncthreads on the chain: two team barriers a
// row (bar.sync 1, 128, the chain's warps): A before the total's exchange,
// because the total sums every warp's states, and B before the warps'
// argmaxes are combined; and per ring slot a full barrier (the producers
// arrive, the chain waits) and a free one (the chain arrives, the
// producers wait).  The team and producer counts are the ones measured
// fastest on the H100 (PERF.md §6: chains of 2, 4 and 8 warps, with 4 or 8
// producers, were tried).
#include "common.cuh"

using namespace psq;

namespace {

constexpr int TEAM = 4;                 // warps on the chain
constexpr int PROD = 4;                 // warps that fill the ring
constexpr int NTHR = (TEAM + PROD) * 32;

__device__ __forceinline__ float lg(float x) { return logf(x); }
__device__ __forceinline__ double lg(double x) { return log(x); }
__device__ __forceinline__ float pw(float x, float y) { return powf(x, y); }
__device__ __forceinline__ double pw(double x, double y) { return pow(x, y); }

// T's 17 values in the working type, a kernel parameter
template <typename T>
struct Table {
  T v[17];
};

// index of T[cur, s] in the 17-value table: the diagonal, else the mask of
// the steps j = 1..4 whose predecessor set of cur holds s
__device__ __forceinline__ int t_index(int cur, int s) {
  if (s == cur) return 16;
  int m = 0;
#pragma unroll
  for (int j = 1; j <= 4; ++j)
    m |= ((s & ((1 << (10 - 2 * j)) - 1)) == (cur >> (2 * j))) << (j - 1);
  return m;
}

// named barriers 2 + slot (the slot is full) and 2 + NS + slot (it is
// free again), over the whole block
__device__ __forceinline__ int full_bar(int slot) { return 2 + slot; }
template <int NS>
__device__ __forceinline__ int free_bar(int slot) { return 2 + NS + slot; }

template <typename T>
__global__ void __launch_bounds__(NTHR)
sample_kernel(Table<T> tab, const T* __restrict__ fwds,
              const T* __restrict__ gum, const bool* __restrict__ valid,
              const int64_t* __restrict__ startst,
              const T* __restrict__ attens, int64_t* __restrict__ paths,
              int nk, int R) {
  using Key = decltype(order_key(T(0)));
  constexpr int Q = 32 / TEAM;
  constexpr int NS = sizeof(T) == 4 ? 4 : 2;     // ring slots (rows ahead)
  const int b = blockIdx.x / nk, k = blockIdx.x % nk;
  const int l = threadIdx.x & 31, w = threadIdx.x >> 5;
  __shared__ T tb[17];
  __shared__ T red[32 * TEAM];
  __shared__ ValIdx<Key> best[TEAM];
  __shared__ T ring_pw[NS][1024], ring_g[NS][1024];
#pragma unroll
  for (int j = 0; j < 17; ++j)
    if (threadIdx.x == j) tb[j] = tab.v[j];

  const bool* valid_b = valid + (size_t)b * R;
  // rows top..1 pass through the ring, row i in slot (top - i) % NS; rows
  // past the region's end keep the start state
  int top = R - 1;
  while (top > 0 && !valid_b[top]) --top;
  __syncthreads();                              // tb is written
  if (w >= TEAM) {
    // producer: row i's powers fwds[b, i]^atten[k] and Gumbel noise; row
    // i - 1's loads are issued before row i's pows, so their latency
    // overlaps the pows
    const T at = attens[k];
    const T* f_b = fwds + (size_t)b * R * 1024;
    const T* g_k = gum + (size_t)k * R * 1024;
    const int t = threadIdx.x - TEAM * 32;
    constexpr int J = 1024 / (PROD * 32);
    T pv[J], gv[J], pn[J], gn[J];
    const auto load = [&](int i, T* p, T* g) {
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const size_t e = (size_t)i * 1024 + t + PROD * 32 * j;
        p[j] = f_b[e];
        g[j] = g_k[e];
      }
    };
    if (top >= 1) load(top, pv, gv);
    for (int i = top, n = 0; i >= 1; --i, ++n) {
      const int slot = n % NS;
      if (i > 1) load(i - 1, pn, gn);
#pragma unroll
      for (int j = 0; j < J; ++j) pv[j] = pw(pv[j], at);
      if (n >= NS) named_sync(free_bar<NS>(slot), NTHR);
#pragma unroll
      for (int j = 0; j < J; ++j) {
        ring_pw[slot][t + PROD * 32 * j] = pv[j];
        ring_g[slot][t + PROD * 32 * j] = gv[j];
        pv[j] = pn[j];
        gv[j] = gn[j];
      }
      named_arrive(full_bar(slot), NTHR);
    }
    return;
  }
  // the chain
  const T eps = T(1e-300);
  int64_t* path = paths + ((size_t)b * nk + k) * R;
  int cur = (int)startst[b];
  if (threadIdx.x == 0)
    for (int i = R - 1; i > top; --i) path[i] = cur;
  const auto add = [](T a, T c) { return a + c; };
  for (int i = top, n = 0; i >= 1; --i, ++n) {
    if (threadIdx.x == 0) path[i] = cur;
    const int slot = n % NS;
    named_sync(full_bar(slot), NTHR);
    if (valid_b[i]) {                           // team-uniform
      T p[Q], g[Q], x[Q];
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const int s = team_state<TEAM>(l, w, q);
        p[q] = tb[t_index(cur, s)] * ring_pw[slot][s];
        g[q] = ring_g[slot][s];
        x[q] = p[q];
      }
      red[l + 32 * w] = thread_levels<TEAM>(x, add, (T*)nullptr, l, w);
      team_sync<TEAM>();                                   // barrier A
      const T tot = shuffle_total(
          exchange_levels<TEAM>(red, add, (T*)nullptr, l));
      const bool tot_ok = tot > T(0) && tot < T(INFINITY);
      // the first argmax of the scores: this lane's states come in
      // increasing order, so a later one wins only with a larger key
      Key kb = 0;
      int sb = 0;
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const Key key =
            order_key(lg(div_total(p[q], tot, tot_ok) + eps) + g[q]);
        if (q == 0 || key > kb) {
          kb = key;
          sb = team_state<TEAM>(l, w, q);
        }
      }
      warp_first_max(kb, sb);
      if (l == 0) best[w] = {kb, sb};
      team_sync<TEAM>();                                   // barrier B
      kb = best[0].v;
      sb = best[0].s;
#pragma unroll
      for (int m = 1; m < TEAM; ++m)
        if (best[m].v > kb || (best[m].v == kb && best[m].s < sb)) {
          kb = best[m].v;
          sb = best[m].s;
        }
      cur = sb;
    }
    // the slot is read: free it if the producer fills it again
    if (n + NS < top) named_arrive(free_bar<NS>(slot), NTHR);
  }
  if (threadIdx.x == 0) path[0] = cur;
}

template <typename T>
int launch(const double* tab, const void* fwds, const void* gum,
           const void* valid, const void* startst, const void* attens,
           void* paths, int B, int nk, int R, void* stream) {
  if (B == 0 || nk == 0 || R == 0) return 0;
  Table<T> t;
  for (int j = 0; j < 17; ++j) t.v[j] = (T)tab[j];
  const auto st = static_cast<cudaStream_t>(stream);
  sample_kernel<T><<<B * nk, NTHR, 0, st>>>(
      t, static_cast<const T*>(fwds), static_cast<const T*>(gum),
      static_cast<const bool*>(valid), static_cast<const int64_t*>(startst),
      static_cast<const T*>(attens), static_cast<int64_t*>(paths), nk, R);
  return (int)cudaGetLastError();
}

}  // namespace

// tab: T's 17 values in f64 on the host (transition_table), cast here
extern "C" int psq_viterbi_sample_f32(const double* tab, const void* fwds,
                                      const void* gum, const void* valid,
                                      const void* startst, const void* attens,
                                      void* paths, int B, int nk, int R,
                                      void* stream) {
  return launch<float>(tab, fwds, gum, valid, startst, attens, paths, B, nk,
                       R, stream);
}

extern "C" int psq_viterbi_sample_f64(const double* tab, const void* fwds,
                                      const void* gum, const void* valid,
                                      const void* startst, const void* attens,
                                      void* paths, int B, int nk, int R,
                                      void* stream) {
  return launch<double>(tab, fwds, gum, valid, startst, attens, paths, B, nk,
                        R, stream);
}
