// The 1024-state Viterbi sweep over a region's positions (kernel 4 of the
// port).
//
// Replaces poreseq_tpu/engine/tpu/viterbi.py:_viterbi_sweep_multi (XLA, a
// vmapped lax.scan over positions; with backpointers, :_viterbi_sweep;
// reference Viterbi.cpp:239-426); the plain PyTorch twin is
// engine/viterbi.py:viterbi_sweep_reference, a Python loop of about 34 torch
// ops per position.  Per row: the 1/2/3-step predecessor group maxima of
// liks (and, with backpointers, their first argmax states), the stay move,
// newlik = ob + best, and the forward probabilities f = ((sp1 g1 + sp2 g2) +
// sp3 g3) + stay fwd, f *= exp(ob), f /= total(f).  Rows past a region's
// end pass the carry (their backpointers are still computed, from it).
//
// What bounds it on this card: a chain of dependent rows, each a handful of
// 1024-wide reductions, so latency and issue slots, not bytes or
// operations: a region reads 4 KB of obs and writes 4 KB of fwds a row.
// The design keeps a region's liks and fwd in registers across the whole
// sweep and loops over the rows inside the kernel, one team of 8 warps per
// region, the whole block (common.cuh: lane l of warp w holds the states
// l + 32m, m = w + 8q).  Every reduction is the twin's halving tree: levels
// 1-2 in-thread, one shared-memory exchange, levels 3-5 in every warp,
// levels 6-10 as shuffles; levels 2, 4 and 6 are the group reductions for
// j = 1, 2, 3 and level 10 the total, so sums equal the twin's bit for bit
// (--fmad=false keeps every product and sum its own rounding).  A row has
// two team barriers (bar.sync 1, 256): A after the group trees' in-thread
// levels, because a state's group values come from other warps' states,
// and B before the total's exchange, because the total sums every warp's
// states.  The next row of obs is loaded while the current one is reduced.
// The team size is the one measured fastest on the H100 (PERF.md §6: 1, 2,
// 4 and 8 warps were tried).
#include "common.cuh"

using namespace psq;

namespace {

__device__ __forceinline__ float ex(float x) { return expf(x); }
__device__ __forceinline__ double ex(double x) { return exp(x); }

constexpr int TEAM = 8;        // warps per region

template <typename T, bool BP>
__global__ void __launch_bounds__(TEAM * 32)
sweep_kernel(const T* __restrict__ obs, const int64_t* __restrict__ n_real,
             T* __restrict__ liks_out, T* __restrict__ fwds,
             int64_t* __restrict__ bps, int R, T lsp1, T lsp2, T lsp3,
             T stay_lik, T sp1, T sp2, T sp3, T stay_p) {
  using VS = ValIdx<T>;
  constexpr int Q = 32 / TEAM;
  const int b = blockIdx.x, l = threadIdx.x & 31, w = threadIdx.x >> 5;
  // level 2 in one shared copy (in-thread, written before barrier A);
  // levels 4 and 6 in a copy per warp (each warp computes them after the
  // exchange)
  __shared__ T gs1[256], gm1[256], gs2[TEAM][64], gm2[TEAM][64];
  __shared__ T gs3[TEAM][16], gm3[TEAM][16];
  __shared__ VS ga1[BP ? 256 : 1], ga2[BP ? TEAM : 1][64];
  __shared__ VS ga3[BP ? TEAM : 1][16];
  __shared__ T xs[32 * TEAM], xm[32 * TEAM], xf[32 * TEAM];   // exchanges
  __shared__ VS xa[BP ? 32 * TEAM : 1];

  const int n = (int)n_real[b];
  const T* ob_b = obs + (size_t)b * R * 1024;
  T* fw_b = fwds + (size_t)b * R * 1024;
  T lk[Q], fw[Q], ob[Q], nx[Q];
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    lk[q] = T(0);
    fw[q] = T(1.0 / 1024.0);
    nx[q] = R > 0 ? ob_b[team_state<TEAM>(l, w, q)] : T(0);
  }
  const auto add = [](T a, T c) { return a + c; };
  const auto mxo = [](T a, T c) { return mx(a, c); };
  const auto fmo = [](VS a, VS c) { return first_of(a, c); };

  for (int row = 0; row < R; ++row) {
    T* out = fw_b + (size_t)row * 1024;
    const bool real = row < n;
    if (!BP && !real) {             // team-uniform: pass the carry
#pragma unroll
      for (int q = 0; q < Q; ++q) out[team_state<TEAM>(l, w, q)] = fw[q];
      continue;
    }
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      ob[q] = nx[q];
      if (row + 1 < R)
        nx[q] = ob_b[(size_t)(row + 1) * 1024 + team_state<TEAM>(l, w, q)];
    }
    // the group sums of fw and maxima (first argmaxima) of lk: levels 2, 4
    // and 6 of their trees
    {
      T a[Q], c[Q];
      VS e[Q];
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        a[q] = fw[q];
        c[q] = lk[q];
        if constexpr (BP) e[q] = VS{lk[q], team_state<TEAM>(l, w, q)};
      }
      xs[l + 32 * w] = thread_levels<TEAM>(a, add, gs1, l, w);
      xm[l + 32 * w] = thread_levels<TEAM>(c, mxo, gm1, l, w);
      if constexpr (BP)
        xa[l + 32 * w] = thread_levels<TEAM>(e, fmo, ga1, l, w);
      team_sync<TEAM>();                                   // barrier A
      const T s5 = exchange_levels<TEAM>(xs, add, gs2[w], l);
      const T m5 = exchange_levels<TEAM>(xm, mxo, gm2[w], l);
      VS a5{};
      if constexpr (BP) a5 = exchange_levels<TEAM>(xa, fmo, ga2[w], l);
      const T s6 = s5 + shfl_down(s5, 16);
      const T m6 = mx(m5, shfl_down(m5, 16));
      VS a6{};
      if constexpr (BP) a6 = first_of(a5, shfl_down(a5, 16));
      if (l < 16) {
        gs3[w][l] = s6;
        gm3[w][l] = m6;
        if constexpr (BP) ga3[w][l] = a6;
      }
      __syncwarp();
    }
    // newlik and f in place (lk, fw): a state reads only its own lk and fw,
    // the rest from the group values
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int s = team_state<TEAM>(l, w, q);
      const T m1 = gm1[s >> 2] + lsp1, m2 = gm2[w][s >> 4] + lsp2;
      const T m3 = gm3[w][s >> 6] + lsp3, mstay = lk[q] + stay_lik;
      const T nl = ob[q] + mx(mx(m1, m2), mx(m3, mstay));
      if constexpr (BP) {
        int bp = ga1[s >> 2].s;
        T cur = m1;
        if (m2 > cur) { bp = ga2[w][s >> 4].s; cur = m2; }
        if (m3 > cur) { bp = ga3[w][s >> 6].s; cur = m3; }
        if (mstay > cur) bp = s;
        bps[((size_t)b * R + row) * 1024 + s] = bp;
      }
      if (real) {
        const T f = ((sp1 * gs1[s >> 2] + sp2 * gs2[w][s >> 4]) +
                     sp3 * gs3[w][s >> 6]) + stay_p * fw[q];
        fw[q] = f * ex(ob[q]);
        lk[q] = nl;
      }
    }
    if (!real) {            // team-uniform (backpointers only): the carry
      team_sync<TEAM>();    // barrier B: the group values were read
#pragma unroll
      for (int q = 0; q < Q; ++q) out[team_state<TEAM>(l, w, q)] = fw[q];
      continue;
    }
    // the total of f
    T x[Q];
#pragma unroll
    for (int q = 0; q < Q; ++q) x[q] = fw[q];
    xf[l + 32 * w] = thread_levels<TEAM>(x, add, (T*)nullptr, l, w);
    team_sync<TEAM>();                                     // barrier B
    const T tot =
        shuffle_total(exchange_levels<TEAM>(xf, add, (T*)nullptr, l));
    const bool tot_ok = tot > T(0) && tot < T(INFINITY);
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      fw[q] = div_total(fw[q], tot, tot_ok);
      out[team_state<TEAM>(l, w, q)] = fw[q];
    }
  }
#pragma unroll
  for (int q = 0; q < Q; ++q)
    liks_out[(size_t)b * 1024 + team_state<TEAM>(l, w, q)] = lk[q];
}

template <typename T>
int launch(const void* obs, const void* n_real, void* liks, void* fwds,
           void* bps, int B, int R, double lsp1, double lsp2, double lsp3,
           double stay_lik, double sp1, double sp2, double sp3,
           double stay_p, void* stream) {
  if (B == 0) return 0;
  const auto st = static_cast<cudaStream_t>(stream);
  const T* o = static_cast<const T*>(obs);
  const int64_t* n = static_cast<const int64_t*>(n_real);
  if (bps)
    sweep_kernel<T, true><<<B, TEAM * 32, 0, st>>>(
        o, n, static_cast<T*>(liks), static_cast<T*>(fwds),
        static_cast<int64_t*>(bps), R, T(lsp1), T(lsp2), T(lsp3),
        T(stay_lik), T(sp1), T(sp2), T(sp3), T(stay_p));
  else
    sweep_kernel<T, false><<<B, TEAM * 32, 0, st>>>(
        o, n, static_cast<T*>(liks), static_cast<T*>(fwds), nullptr, R,
        T(lsp1), T(lsp2), T(lsp3), T(stay_lik), T(sp1), T(sp2), T(sp3),
        T(stay_p));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int psq_viterbi_sweep_f32(const void* obs, const void* n_real,
                                     void* liks, void* fwds, void* bps,
                                     int B, int R, double lsp1, double lsp2,
                                     double lsp3, double stay_lik, double sp1,
                                     double sp2, double sp3, double stay_p,
                                     void* stream) {
  return launch<float>(obs, n_real, liks, fwds, bps, B, R, lsp1, lsp2, lsp3,
                       stay_lik, sp1, sp2, sp3, stay_p, stream);
}

extern "C" int psq_viterbi_sweep_f64(const void* obs, const void* n_real,
                                     void* liks, void* fwds, void* bps,
                                     int B, int R, double lsp1, double lsp2,
                                     double lsp3, double stay_lik, double sp1,
                                     double sp2, double sp3, double stay_p,
                                     void* stream) {
  return launch<double>(obs, n_real, liks, fwds, bps, B, R, lsp1, lsp2, lsp3,
                        stay_lik, sp1, sp2, sp3, stay_p, stream);
}
