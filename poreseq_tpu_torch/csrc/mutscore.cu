// Mutation group scorer (kernel 2 of the port).
//
// Replaces poreseq_tpu/engine/tpu/pallas_mutscore.py:_kernel
// (score_groups_pallas) with the semantics of the default XLA scorer
// poreseq_tpu/engine/tpu/mutscore.py:_group_kernel_body, which it
// reproduces step for step for every (K, D) class, including slots whose
// chosen column is the copied one (k_star < 0).  The plain PyTorch twin is
// engine/mutscore.py:group_deltas_reference (+ sum_rows_reference).
//
// Per (start group g, event row e of the group's region slice) and per slot
// p (one mutation; up to P=9 share a start): restart the forward DP from
// the column before the mutation against the mutated states, for up to K
// columns at scoring width Ws — the first step copies the realign-width
// forward column through the seam offset, later steps carry the previous
// refill column — keep the column at k_star, join it with the backward
// lattice at q_b (columnMax over the realign width W) and subtract the
// lag-0 join of the unmutated lattices at max(start-3, 1).  The deltas go
// to a [G, P, E_g] buffer; a second kernel sums each (g, p) row over e in
// order 0..E_g-1.  No float atomics: acceptance depends on the sign of
// these totals, and the fixed order makes them reproducible.
//
// What bounds it on this card: each refill step is one max-plus scan over
// Ws rows and the K steps of a slot are sequential, so the latency of a
// step bounds a block; the joins stream 4 lattice columns of W values from
// L2/DRAM per slot.  The design gives every (group, event row) its own block
// of ceil32(Ws) threads (tens of thousands of blocks fill the card; past
// 1024 window rows a thread holds RPT = 2 or 4 adjacent rows, so
// ceil32(Ws / RPT) threads; past 4095 rows the cluster instance, next, or
// group_wide_kernel, below, which keeps the step's column in memory), keeps
// the carried column and the selected column in shared memory, precomputes
// the band anchor each step shifts from, and lets a slot stop at its last
// active step.  A step runs the warp-shuffle scan of common.cuh:mp_scan
// (the fill's: two block barriers, one when Ws < 64) and one more barrier
// after the carried column is written; its column max is reduced in each
// warp and finished by warp 0 after that barrier.  The next step's state,
// band, model values and data window are loaded while a step is solved
// (the state one step earlier still), and its emissions are computed while
// warp 0 scans the tails.  Rows of other regions and invalid slots exit at
// once.  Shared memory per block: (3Ws + 6*32 + 64) T + K int; registers
// (nvcc -Xptxas -v, sm_90a, held to 64 by the 1024-thread launch bound):
// f32 spills 28 and 36 bytes at one and two rows a thread and 164 at
// four, f64 184, 312 and 1,216.
//
// The cluster instance (CL, windows past RPT_ROWS rows up to GCL_MAX CTAs;
// engine/mutscore.py group_instance): past 4095 rows one block no longer
// holds the window in registers, so a (group, event row) pair takes a
// thread-block cluster of ceil((Ws - 1) / SPAN) CTAs, CTA k holding window
// rows [k SPAN, (k + 1) SPAN) at GCL_RPT rows a thread of GCL_THREADS
// (SPAN = GCL_THREADS GCL_RPT, chosen by tools/sweep_constants.py
// mutscore).  Ws = 2 width + 1 is odd, so at a power-of-two width the
// window is n SPAN + 1 rows: its last row is a destination of one level-0
// down-sweep combine only, from the row below, and the last CTA's last
// thread takes it as an extra row (the cluster scans n SPAN rows and that
// thread combines the last after), rather than a CTA for one row.  Each
// cell is computed by the same code as above; what crosses CTAs goes
// through distributed shared memory:
//  - the scan (common.cuh:mp_scan_cluster, the fill's): each CTA's levels
//    below SPAN, its total to the higher ranks, one cluster barrier, the
//    levels above in every CTA's warp 0: the tree's combines, bit-equal;
//  - the seams: a step reads the carried column at rows w + d and w + d -
//    1 (d in [0, DMAX]), so each CTA keeps its rows of it with a halo of
//    the row below and the DMAX rows above, which the neighbours write
//    into it when they write their own rows (after the scan's cluster
//    barrier, which every read of the step before has passed); a second
//    cluster barrier a step, split (arrived at once the rows are sent,
//    waited on before the next step reads them), makes them visible;
//  - the column maxima: max is exact in any order, so each thread keeps
//    the running max of its rows' column maxima over the steps and its
//    value at k_star; the CTA's max of those is its part of sbest;
//  - the joins: each CTA takes the old and new scores' maxima over its
//    rows (the last CTA also the realign rows past the window) and sends
//    them to rank 0, which takes the maxima and writes the deltas after
//    the pair's last cluster barrier.
// A step costs two block and two cluster barriers where the wide instance
// has 2 log2 Ws + 2 block barriers.  The anchors are computed by every CTA
// (the same values).  Shared memory per CTA: (3 SPAN + 2 + DMAX + 1 + 6*32
// + 64 + 6*32 + 2 + (1 + P) GCL_MAX) T + K int, 27,088 bytes in f32 at
// SPAN 2048, P = 9, K = 7; registers (sm_90a, GCL_THREADS 512, GCL_RPT 4)
// 128 in f32, no spill, and 128 in f64, 288 bytes spilled.
//
// Built with --fmad=false so the kernel evaluates the twin's expression
// tree without fused multiply-adds.
#include "common.cuh"

using namespace psq;

struct MutArgs {
  const void *Mf, *Sf, *Mb, *Sb;        // [C1, E, W] blank-extended lattices
  const int *i0f, *i1f;                 // [E, C1] realign band geometry
  const int *i0r, *i1r;                 // [E, C1] scoring band geometry
  const void* win[3];                   // [Q1, E, Ws] mean, stdv, lsr
  const void *bpf, *bpb;                // [C1, E] best prefix / suffix
  const int* ev_region;                 // [E]
  const int* n0;                        // [E]
  const uint8_t* active;                // [E]
  const void* lik[4];                   // [E] skip stay extend insert
  const void* model[6];                 // [E, 1024]
  const int *g_start, *g_startind, *g_S, *g_region, *g_evoff;   // [G]
  const int *s_mlen, *s_nst;            // [G, P]
  const int* s_win;                     // [G, P, K]
  const uint8_t* s_valid;               // [G, P]
  void* deltas;                         // [G, P, E_g]
  void* totals;                         // [G, P]
  int C1, E, W, Ws, Q1, RS, K, P, DM, E_g, G;
  double lik_offset;
  int rpt;                              // window rows a thread: 1, 2 or 4;
                                        // 0: group_wide_kernel;
                                        // RPT_CLUSTER: the cluster instance
  void* scratch;                        // [blocks, WIDE_ARRAYS, Ws] the wide
                                        // instance's arrays, or null: in
  int scratch_blocks;                   // shared memory (blocks a grid)
};

// the register-held scan's widest window: scoring width 2047 (engine/fill.py
// rows_per_thread); wider windows run group_wide_kernel
constexpr int RPT_ROWS = 4095;
// the wide instance's arrays of Ws values: the carried and the selected
// columns (M, S) and the six scan rows
constexpr int WIDE_ARRAYS = 9;
// the cluster instance (MutArgs.rpt RPT_CLUSTER; engine/mutscore.py
// group_instance): GCL_THREADS threads of GCL_RPT window rows a CTA, so a
// CTA spans GCL_THREADS * GCL_RPT rows (a power of two), and at most
// GCL_MAX CTAs a cluster (past 8 the card's non-portable sizes)
// (tools/sweep_constants.py, PERF.md §6)
constexpr int RPT_CLUSTER = -1;
constexpr int GCL_THREADS = 512;
constexpr int GCL_RPT = 4;
constexpr int GCL_MAX = 16;

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return min(max(x, lo), hi);
}

// the cluster instance's CTAs at window width Ws, SPAN rows a CTA:
// ceil((Ws - 1) / SPAN), where Ws = n SPAN + 1 leaves its last row to the
// last CTA's last thread
__host__ __device__ constexpr unsigned group_ctas(int Ws, int span) {
  return Ws < 2 ? 1u : (unsigned)((Ws - 2 + span) / span);
}

// a refill step's band and mutated state
struct Step {
  int i0, i1, st;
};

// a step's loaded emission operands: model values at its state and the
// data window at each of the thread's rows
template <typename T, int RPT>
struct StepData {
  T m[6];
  T w[RPT][3];
  T x[3];       // the cluster instance's extra row (its thread only)
};

// The parts of a (group, event row) pair's score that both instances of
// the group kernel share.  Every thread of the block calls old_score and
// new_score (block_max); their results are valid in warp 0.

// the band anchor step k shifts from: it advances whenever ANY slot of the
// group (valid or not) is still refilling at step k; one thread writes
// cik[k < K]
__device__ __forceinline__ void group_anchors(const MutArgs& a, int g,
                                              int startind, int st0, int wi0,
                                              const int* i0r_e, int* cik) {
  const int K = a.K, P = a.P;
  int ci0 = wi0 + a.RS;
  for (int k = 0; k < K; ++k) {
    cik[k] = ci0;
    bool any = false;
    for (int p = 0; p < P; ++p) {
      const int gp = g * P + p, mlen = a.s_mlen[gp], nst = a.s_nst[gp];
      const int nfill = clampi(min(startind + mlen + 6, nst) - startind, 0,
                               K);
      any |= k < mlen + 6 && startind + 1 + k <= nst && k < nfill;
    }
    if (any) ci0 = i0r_e[clampi(st0 + 1 + k, 0, a.C1 - 1)];
  }
}

// old score: lag-0 join of the unmutated lattices at max(start-3, 1)
// (rows rr0 <= rr < rr1 of the column only, where given: the cluster
// instance's CTAs each take a part and reduce the maxima over the cluster,
// max(max(max(m, 0), x), y) being a max of all its terms)
template <typename T>
__device__ __forceinline__ T old_score(const MutArgs& a, int e, int start,
                                       int sS, int n0e, const int* i0f_e,
                                       T* red, int rr0 = 0,
                                       int rr1 = INT_MAX) {
  const int E = a.E, W = a.W, C1 = a.C1;
  const T* Mf = static_cast<const T*>(a.Mf);
  const T* Sf = static_cast<const T*>(a.Sf);
  const T* Mb = static_cast<const T*>(a.Mb);
  const T* Sb = static_cast<const T*>(a.Sb);
  const int q_old = clampi(max(start - 3, 1), 0, sS);
  const size_t base = ((size_t)clampi(q_old, 0, C1 - 1) * E + e) * W;
  const int fao = i0f_e[clampi(q_old, 0, C1 - 1)];
  T m = T(0);
  for (int rr = rr0 + threadIdx.x; rr < min(W, rr1); rr += blockDim.x) {
    const int ii = fao + rr;
    if (ii >= 1 && ii <= n0e)
      m = mx(m, mx(Mf[base + rr] + Mb[base + rr],
                   Sf[base + rr] + Sb[base + rr]));
  }
  m = block_max(m, red);
  const size_t qe = (size_t)clampi(q_old, 0, C1 - 1) * E + e;
  return mx(mx(mx(m, T(0)), static_cast<const T*>(a.bpf)[qe]),
            static_cast<const T*>(a.bpb)[qe]);
}

// new score of a slot: the selected refill column (selM, selS [Ws], anchor
// sa, best sbest) or, for a copied column (use_sel false), the forward
// column at the start (Mw, Sw [W], anchor wi0, best wbest) against the back
// column at rab = nst - refind_used + 1
template <typename T>
__device__ __forceinline__ T new_score(const MutArgs& a, int e, int sS,
                                       int n0e, const int* i0f_e, int nst,
                                       int refind_used, bool use_sel, int sa,
                                       T sbest, const T* selM, const T* selS,
                                       int wi0, T wbest, const T* Mw,
                                       const T* Sw, T* red, int rr0 = 0,
                                       int rr1 = INT_MAX) {
  const int E = a.E, W = a.W, Ws = a.Ws, C1 = a.C1;
  const T* Mb = static_cast<const T*>(a.Mb);
  const T* Sb = static_cast<const T*>(a.Sb);
  const int span = DMAX * a.DM + 64;
  const int JMIN = -span, JMAX = a.RS + span, CMIN = -span, CMAX = span;
  const int rab_new = clampi(nst - refind_used + 1, 0, sS);
  const int q_b = clampi(sS - rab_new + 1, 0, C1 - 1);
  const size_t bb = ((size_t)q_b * E + e) * W;
  const int ba = i0f_e[q_b];
  const T bbest = static_cast<const T*>(a.bpb)[(size_t)q_b * E + e];
  const int fa = use_sel ? sa : wi0;
  const T fbest = use_sel ? sbest : wbest;
  const int s = fa - ba;
  const bool inr = use_sel ? (s >= JMIN && s <= JMAX)
                           : (s >= CMIN && s <= CMAX);
  T m = T(0);
  for (int rr = rr0 + threadIdx.x; rr < min(W, rr1); rr += blockDim.x) {
    const T FM = use_sel ? (rr < Ws ? selM[rr] : T(0)) : Mw[rr];
    const T FS = use_sel ? (rr < Ws ? selS[rr] : T(0)) : Sw[rr];
    if (fa + rr >= 1 && fa + rr <= n0e) {
      const T BMs = inr ? at_or_zero(Mb + bb, rr + s, W) : T(0);
      const T BSs = inr ? at_or_zero(Sb + bb, rr + s, W) : T(0);
      m = mx(m, mx(mx(FM + BMs, FS + BSs), mx(FM, FS)));
    }
    if (ba + rr >= 1 && ba + rr <= n0e)
      m = mx(m, mx(Mb[bb + rr], Sb[bb + rr]));
  }
  m = block_max(m, red);
  return mx(mx(mx(m, T(0)), fbest), bbest);
}

// RPT: window rows a thread (1 for Ws <= 1024, 2 up to 2048, 4 up to
// 4095), adjacent scan positions (common.cuh:mp_scan).  CL: the cluster
// instance, GCL_THREADS threads of RPT = GCL_RPT rows a CTA.
template <typename T, int RPT, bool CL = false>
__global__ void __launch_bounds__(CL ? GCL_THREADS : 1024)
    group_kernel(MutArgs a) {
  constexpr int SPAN = GCL_THREADS * RPT;      // CL: window rows a CTA
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int Ws = a.Ws, W = a.W, P = a.P, K = a.K, E = a.E, C1 = a.C1;
  // CL: CTA `rank` of `ncta` holds window rows [base, base + SPAN) and keeps
  // the carried column's rows base - 1 .. base + SPAN + DMAX - 1 (the row
  // below and the DMAX rows above are its neighbours', which they send),
  // row w at Mc[w + ro]; its selected column's row w at selM[w - base].
  // Where Ws = ncta SPAN + 1 the last row is the extra row of the last
  // CTA's last thread (xrow): a destination of one level-0 down-sweep
  // combine only, from the row below, so the cluster scans ncta SPAN rows
  // and that thread combines it after (no CTA for one row)
  const unsigned ncta = CL ? group_ctas(Ws, SPAN) : 1;
  const unsigned rank = CL ? cluster_rank() : 0;
  const int base = CL ? rank * SPAN : 0, ro = CL ? 1 - base : 0;
  const int nscan = CL ? min(Ws, (int)ncta * SPAN) : Ws;
  const bool xrow = CL && nscan < Ws && rank + 1 == ncta &&
                    (int)threadIdx.x + 1 == (int)blockDim.x;
  const int xw = Ws - 1;                      // xrow: its window row
  const int mcn = CL ? SPAN + DMAX + 1 : Ws, sn = CL ? SPAN + 1 : Ws;
  T* Mc = reinterpret_cast<T*>(smem_raw);     // carried refill column
  T* selM = Mc + mcn;                         // selected column (k_star)
  T* selS = selM + sn;
  T* tails = selS + sn;                       // [6][32] mp_scan's
  T* red_s = tails + 6 * 32;                  // [32] step column max
  T* red_j = red_s + 32;                      // [32] joins
  T* tops = red_j + 32;     // CL: [6][32] lower ranks' totals
  T* pref = tops + 6 * 32;  // CL: [2] the previous CTA's last final u
  T* cl_j = pref + 2;       // CL, rank 0: [(1 + P) GCL_MAX] the CTAs' joins
  int* cik = reinterpret_cast<int*>(CL ? cl_j + (1 + P) * GCL_MAX
                                       : red_j + 32);   // [K] anchor per step

  const int pair = CL ? blockIdx.x / ncta : blockIdx.x;
  const int g = pair / a.E_g, el = pair % a.E_g;
  const int r = threadIdx.x, nt = blockDim.x;
  const int lane = r & 31, warp = r >> 5, nw = nt >> 5;
  // the thread's window rows base + r RPT + j
  int wr[RPT];
#pragma unroll
  for (int j = 0; j < RPT; ++j) wr[j] = base + r * RPT + j;
  T* out = static_cast<T*>(a.deltas) + (size_t)g * P * a.E_g + el;
  const int greg = a.g_region[g];
  const int e = clampi(a.g_evoff[g], 0, E - a.E_g) + el;
  if (!(a.active[e] && a.ev_region[e] == greg)) {
    if (r < P && rank == 0) out[(size_t)r * a.E_g] = T(0);
    return;                     // CL: every CTA of the cluster
  }

  const T NB = neg_big<T>();
  const T* Mf = static_cast<const T*>(a.Mf);
  const T* Sf = static_cast<const T*>(a.Sf);
  const T* bpf = static_cast<const T*>(a.bpf);
  const int* i0f_e = a.i0f + (size_t)e * C1;
  const int* i0r_e = a.i0r + (size_t)e * C1;
  const int* i1r_e = a.i1r + (size_t)e * C1;
  const int start = a.g_start[g], startind = a.g_startind[g];
  const int sS = a.g_S[g];
  const int n0e = a.n0[e];
  const int st0 = clampi(startind, 0, C1 - 1);
  const T* Mw = Mf + ((size_t)st0 * E + e) * W;
  const T* Sw = Sf + ((size_t)st0 * E + e) * W;
  const int wi0 = i0f_e[st0], wi1 = a.i1f[(size_t)e * C1 + st0];
  const T wbest = bpf[(size_t)st0 * E + e];
  const T lsk = static_cast<const T*>(a.lik[0])[e];
  const T lst = static_cast<const T*>(a.lik[1])[e];
  const T lex = static_cast<const T*>(a.lik[2])[e];
  const T lin = static_cast<const T*>(a.lik[3])[e];
  const T off = T(a.lik_offset);
  const T* mdl[6];
#pragma unroll
  for (int k = 0; k < 6; ++k)
    mdl[k] = static_cast<const T*>(a.model[k]) + (size_t)e * 1024;
  const T* wm = static_cast<const T*>(a.win[0]);
  const T* wsd = static_cast<const T*>(a.win[1]);
  const T* wl = static_cast<const T*>(a.win[2]);
  const int FSMIN = -64, FSMAX = a.RS + 64 + DMAX;
  // CL: the joins' rows of this CTA: its window rows, and the last CTA the
  // realign rows past them
  const int rr0 = CL ? base : 0;
  const int rr1 = CL && rank + 1 < ncta ? base + SPAN : INT_MAX;
  // the carried column at window row w (0 outside [0, Ws))
  auto mc_at = [&](int w) {
    return w >= 0 && w < Ws ? Mc[w + ro] : T(0);
  };

  // CL: each CTA its own anchors (the same values)
  if (r == 0) group_anchors(a, g, startind, st0, wi0, i0r_e, cik);
  const T old = old_score(a, e, start, sS, n0e, i0f_e, red_j, rr0, rr1);
  if constexpr (CL) {           // every CTA of the cluster running before
    cluster_arrive();           // any sends
    cluster_wait();
    if (r == 0) cluster_map(cl_j, 0)[rank] = old;
  }
  __syncthreads();              // cik visible

  for (int p = 0; p < P; ++p) {
    const int gp = g * P + p;
    if (!a.s_valid[gp]) {       // delta masked to 0
      if (r == 0 && rank == 0) out[(size_t)p * a.E_g] = T(0);
      continue;
    }
    const int mlen = a.s_mlen[gp], nst = a.s_nst[gp];
    const int nfill = clampi(min(startind + mlen + 6, nst) - startind, 0, K);
    const int Lf = startind + nfill;
    const int refind_used = min(start + mlen + 1, max(Lf, startind));
    const int k_star = refind_used - startind - 1;   // -1: copied column
#pragma unroll
    for (int j = 0; j < RPT; ++j)
      if (wr[j] < Ws) {
        Mc[wr[j] + ro] = T(0);
        selM[wr[j] - rr0] = T(0);
        selS[wr[j] - rr0] = T(0);
      }
    if (xrow) {
      Mc[xw + ro] = T(0);
      selM[xw - rr0] = T(0);
      selS[xw - rr0] = T(0);
    }
    int sa = wi0 + a.RS;
    T sbest = wbest, cbest = wbest;   // meaningful in warp 0
    // CL: the thread's running max of its rows' live M over the steps, and
    // its value at k_star (the CTA's maxima then the cluster's give sbest:
    // a max in any order)
    T tbest = wbest, tsb = wbest;
    bool pending = false;       // CL: a cluster barrier arrived at

    // step k's band and state, and its emission operands (indices past
    // the last step are clamped; their values are never used)
    auto step = [&](int k) {
      const int q = clampi(st0 + 1 + k, 0, C1 - 1);
      return Step{i0r_e[q], i1r_e[q],
                  K > 0 ? a.s_win[(size_t)gp * K + clampi(k, 0, K - 1)]
                        : -1};
    };
    auto load = [&](int k, const Step& s) {
      StepData<T, RPT> d;
      const int stc = clampi(s.st, 0, 1023);
#pragma unroll
      for (int j = 0; j < 6; ++j) d.m[j] = mdl[j][stc];
      const int qw = clampi(st0 + 1 + k, 0, a.Q1 - 1);
#pragma unroll
      for (int j = 0; j < RPT; ++j) {
        const size_t wi = ((size_t)qw * E + e) * Ws + wr[j];
        d.w[j][0] = wr[j] < Ws ? wm[wi] : T(0);
        d.w[j][1] = wr[j] < Ws ? wsd[wi] : T(1);
        d.w[j][2] = wr[j] < Ws ? wl[wi] : T(0);
      }
      if (xrow) {
        const size_t wi = ((size_t)qw * E + e) * Ws + xw;
        d.x[0] = wm[wi];
        d.x[1] = wsd[wi];
        d.x[2] = wl[wi];
      }
      return d;
    };
    auto emit = [&](const StepData<T, RPT>& d, const Step& s,
                    T (&eo)[RPT]) {
#pragma unroll
      for (int j = 0; j < RPT; ++j) {
        const T em = emission<T>(d.w[j][0], d.w[j][1], d.w[j][2], d.m[0],
                                 d.m[1], d.m[2], d.m[3], d.m[4], d.m[5],
                                 off);
        eo[j] = wr[j] < Ws && s.i0 + wr[j] <= s.i1 && s.st >= 0 ? em : T(0);
      }
    };
    // xrow: the extra row's emission
    auto emit_x = [&](const StepData<T, RPT>& d, const Step& s) {
      const T em = emission<T>(d.x[0], d.x[1], d.x[2], d.m[0], d.m[1],
                               d.m[2], d.m[3], d.m[4], d.m[5], off);
      return s.i0 + xw <= s.i1 && s.st >= 0 ? em : T(0);
    };
    Step cur = step(0), nxt = step(1);
    T eo[RPT], xeo = T(0);
    {
      const StepData<T, RPT> d0 = load(0, cur);
      emit(d0, cur, eo);
      if (xrow) xeo = emit_x(d0, cur);
    }
    __syncthreads();

    for (int k = 0; k < K; ++k) {
      // a slot stays active for a prefix of the steps
      if (!(k < mlen + 6 && startind + 1 + k <= nst && k < nfill)) break;
      // loads for the next two steps, in flight while this one is solved
      const Step after = step(k + 2);
      const StepData<T, RPT> dn = load(k + 1, nxt);
      T eo_n[RPT], xeo_n = T(0);
      auto next_emission = [&]() {
        emit(dn, nxt, eo_n);
        if (xrow) xeo_n = emit_x(dn, nxt);
      };
      if (CL && pending) {      // the neighbours' rows of Mc arrived
        cluster_wait();
        pending = false;
      }

      const int i0c = cur.i0, i1c = cur.i1;
      // the previous column at window rows w and w - 1 (pm_i, pm_im1):
      // the forward column through the seam offset (k = 0, a wide copy)
      // or the carried column shifted by d in [0, DMAX], else zeros
      const int s0 = i0c - wi0 - 1;
      const bool inr = s0 >= FSMIN - 1 && s0 <= FSMAX;
      const int ci0 = k == 0 ? 0 : cik[k];
      const int d = i0c - ci0;
      const bool okd = d >= 0 && d <= DMAX;
      auto prev = [&](int w, T& pi, T& pim1) {
        if (k == 0) {
          pim1 = inr ? at_or_zero(Mw, w + s0, W) : T(0);
          pi = inr ? at_or_zero(Mw, w + s0 + 1, W) : T(0);
        } else {
          pi = okd ? mc_at(w + d) : T(0);
          pim1 = okd ? mc_at(w + d - 1) : T(0);
        }
      };
      const int p0 = k == 0 ? wi0 : ci0;
      const int p1 = k == 0 ? wi1 : ci0 + Ws - 1;
      // a row's scan element from its previous-column values and emission
      auto element = [&](int w, T pi, T pim1, T e_, T (&x)[6]) {
        const int i = i0c + w;
        const bool valid_i = i >= p0 && i <= p1;
        const bool valid_ul = i > p0 && i <= p1;
        const T skip_c = (valid_i ? pi : T(0)) + lsk;
        const T match_c = (valid_ul ? pim1 : T(0)) + e_;
        const T ignore_c = valid_ul ? pim1 + lin : T(0);
        const T D = mx(mx(T(0), skip_c), mx(match_c, ignore_c));
        const T a_stay = e_ + lst, a_ext = e_ + lex;
        const bool cut = w == 0;
        x[0] = cut ? NB : mx(lin, a_stay);
        x[1] = cut ? NB : a_ext;
        x[2] = cut ? NB : a_stay;
        x[3] = cut ? NB : a_ext;
        x[4] = D;
        x[5] = cut ? NB : T(0);
      };
      T v[RPT][6];
      bool live[RPT];
#pragma unroll
      for (int j = 0; j < RPT; ++j) {
        T pi, pim1;
        prev(wr[j], pi, pim1);
        live[j] = wr[j] < Ws && i0c + wr[j] <= i1c && cur.st >= 0;
        element(wr[j], pi, pim1, eo[j], v[j]);
      }
      T vx[6];
      bool live_x = false;
      if (xrow) {
        T pi, pim1;
        prev(xw, pi, pim1);
        live_x = i0c + xw <= i1c && cur.st >= 0;
        element(xw, pi, pim1, xeo, vx);
      }
      if constexpr (CL)
        mp_scan_cluster<T, RPT>(v, tails, tops, pref, nscan, base, rank,
                                ncta, next_emission);
      else
        mp_scan<T, RPT>(v, tails, Ws, next_emission);
      T lmax = live[0] ? v[0][4] : NB;   // the thread's column max
#pragma unroll
      for (int j = 0; j < RPT; ++j) {
        const T Mn = live[j] ? v[j][4] : T(0);
        const T Sn = live[j] ? v[j][5] : T(0);
        if (j > 0) lmax = mx(lmax, live[j] ? Mn : NB);
        if (wr[j] < Ws) {
          Mc[wr[j] + ro] = Mn;  // its readers passed barrier A
          if (k == k_star) {
            selM[wr[j] - rr0] = Mn;
            selS[wr[j] - rr0] = Sn;
          }
          if constexpr (CL) {
            // the row into the halo of the CTA below (its top DMAX rows'
            // reads) or above (its first row's d - 1), whose readers
            // passed the scan's cluster barrier
            if (rank > 0 && wr[j] - base < DMAX)
              cluster_map(Mc, rank - 1)[wr[j] - base + SPAN + 1] = Mn;
            if (rank + 1 < ncta && wr[j] == base + SPAN - 1)
              cluster_map(Mc, rank + 1)[0] = Mn;
          }
        }
      }
      if (xrow) {
        // the extra row: the tree's level-0 down-sweep combine from the
        // row below, the thread's last position, final now
        mp_combine_u(v[RPT - 1][4], v[RPT - 1][5], vx);
        const T Mn = live_x ? vx[4] : T(0);
        lmax = mx(lmax, live_x ? Mn : NB);
        Mc[xw + ro] = Mn;
        if (k == k_star) {
          selM[xw - rr0] = Mn;
          selS[xw - rr0] = live_x ? vx[5] : T(0);
        }
      }
      if (k == k_star) sa = i0c;
      if constexpr (CL) {
        tbest = mx(tbest, lmax);
        if (k == k_star) tsb = tbest;
        cluster_arrive();       // Mc and the halos; waited before the
        pending = true;         // next step reads them
      } else {
        const T wmax = warp_max(lmax);
        if (lane == 0) red_s[warp] = wmax;
        __syncthreads();        // Mc and the partial maxima visible
        if (warp == 0) {
          const T cmax = warp_max(lane < nw ? red_s[lane] : NB);
          const T bestn = mx(cmax, cbest);
          cbest = bestn;
          if (k == k_star) sbest = bestn;
        }
      }
      cur = nxt;
      nxt = after;
#pragma unroll
      for (int j = 0; j < RPT; ++j) eo[j] = eo_n[j];
      xeo = xeo_n;
    }

    if constexpr (CL) {
      if (pending) cluster_wait();
      sbest = block_max(tsb, red_s);   // the CTA's part, in warp 0
    }
    const T newv = new_score(a, e, sS, n0e, i0f_e, nst, refind_used,
                             k_star >= 0, sa, sbest, selM - rr0,
                             selS - rr0, wi0, wbest, Mw, Sw, red_j, rr0,
                             rr1);
    if constexpr (CL) {
      if (r == 0) cluster_map(cl_j, 0)[(1 + p) * GCL_MAX + rank] = newv;
    } else {
      if (r == 0) out[(size_t)p * a.E_g] = newv - old;
    }
  }
  if constexpr (CL) {
    // rank 0 takes the maxima of the CTAs' joins: every partial sent
    cluster_arrive();
    cluster_wait();
    if (rank == 0 && r < P && a.s_valid[g * P + r]) {
      T o = cl_j[0], nv = cl_j[(1 + r) * GCL_MAX];
      for (unsigned c = 1; c < ncta; ++c) {
        o = mx(o, cl_j[c]);
        nv = mx(nv, cl_j[(1 + r) * GCL_MAX + c]);
      }
      out[(size_t)r * a.E_g] = nv - o;
    }
  }
}

// The wide instance: windows past RPT_ROWS rows (scoring width 2048 and
// up), whose six scan values a row outrun the registers.  A step's column
// lives in memory with the carried and selected columns, WIDE_ARRAYS Ws
// values: in dynamic shared memory where they fit (Ws <= 6,449 in f32 and
// 3,221 in f64 at K = 0), else in a device scratch of
// scratch_blocks slices, one for each block of a grid of that many blocks
// that strides over the (group, event row) pairs.  1024 threads a block;
// every phase of a step strides over the window rows (thread r takes rows
// r, r + 1024, ...): the emissions and the scan elements, the scan level by
// level (common.cuh:mp_scan_mem, the twin's tree), then the carried and
// selected columns and the column max; the anchors, the joins and the
// deltas are group_kernel's.  Each value is computed as there, so the
// deltas are the same bit for bit.
template <typename T>
__global__ void __launch_bounds__(1024) group_wide_kernel(MutArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int Ws = a.Ws, W = a.W, P = a.P, K = a.K, E = a.E, C1 = a.C1;
  const size_t sws = (size_t)Ws;
  T* red_s = reinterpret_cast<T*>(smem_raw);        // [32] step column max
  T* red_j = red_s + 32;                            // [32] joins
  T* Mc = a.scratch                                 // carried column
      ? static_cast<T*>(a.scratch) + (size_t)blockIdx.x * WIDE_ARRAYS * sws
      : red_j + 32;
  T* selM = Mc + sws;                               // selected column
  T* selS = selM + sws;
  T* sc = selS + sws;                               // [6][Ws] scan elements
  int* cik = reinterpret_cast<int*>(a.scratch ? red_j + 32 : sc + 6 * sws);

  const int r = threadIdx.x, nt = blockDim.x;
  const int lane = r & 31, warp = r >> 5, nw = nt >> 5;
  const T NB = neg_big<T>();
  const T* Mf = static_cast<const T*>(a.Mf);
  const T* Sf = static_cast<const T*>(a.Sf);
  const T* bpf = static_cast<const T*>(a.bpf);
  const T* wm = static_cast<const T*>(a.win[0]);
  const T* wsd = static_cast<const T*>(a.win[1]);
  const T* wl = static_cast<const T*>(a.win[2]);
  const T off = T(a.lik_offset);
  const int FSMIN = -64, FSMAX = a.RS + 64 + DMAX;
  const long long items = (long long)a.G * a.E_g;

  for (long long item = blockIdx.x; item < items; item += gridDim.x) {
    __syncthreads();            // the previous pair's shared reads done
    const int g = (int)(item / a.E_g), el = (int)(item % a.E_g);
    T* out = static_cast<T*>(a.deltas) + (size_t)g * P * a.E_g + el;
    const int greg = a.g_region[g];
    const int e = clampi(a.g_evoff[g], 0, E - a.E_g) + el;
    if (!(a.active[e] && a.ev_region[e] == greg)) {
      if (r < P) out[(size_t)r * a.E_g] = T(0);
      continue;
    }
    const int* i0f_e = a.i0f + (size_t)e * C1;
    const int* i0r_e = a.i0r + (size_t)e * C1;
    const int* i1r_e = a.i1r + (size_t)e * C1;
    const int start = a.g_start[g], startind = a.g_startind[g];
    const int sS = a.g_S[g];
    const int n0e = a.n0[e];
    const int st0 = clampi(startind, 0, C1 - 1);
    const T* Mw = Mf + ((size_t)st0 * E + e) * W;
    const T* Sw = Sf + ((size_t)st0 * E + e) * W;
    const int wi0 = i0f_e[st0], wi1 = a.i1f[(size_t)e * C1 + st0];
    const T wbest = bpf[(size_t)st0 * E + e];
    const T lsk = static_cast<const T*>(a.lik[0])[e];
    const T lst = static_cast<const T*>(a.lik[1])[e];
    const T lex = static_cast<const T*>(a.lik[2])[e];
    const T lin = static_cast<const T*>(a.lik[3])[e];

    if (r == 0) group_anchors(a, g, startind, st0, wi0, i0r_e, cik);
    const T old = old_score(a, e, start, sS, n0e, i0f_e, red_j);

    for (int p = 0; p < P; ++p) {
      const int gp = g * P + p;
      if (!a.s_valid[gp]) {     // delta masked to 0
        if (r == 0) out[(size_t)p * a.E_g] = T(0);
        continue;
      }
      const int mlen = a.s_mlen[gp], nst = a.s_nst[gp];
      const int nfill = clampi(min(startind + mlen + 6, nst) - startind, 0,
                               K);
      const int Lf = startind + nfill;
      const int refind_used = min(start + mlen + 1, max(Lf, startind));
      const int k_star = refind_used - startind - 1;   // -1: copied column
      __syncthreads();          // cik; the previous slot's join read selM
      for (int w = r; w < Ws; w += nt) {
        Mc[w] = T(0);
        selM[w] = T(0);
        selS[w] = T(0);
      }
      int sa = wi0 + a.RS;
      T sbest = wbest, cbest = wbest;   // meaningful in warp 0
      __syncthreads();

      for (int k = 0; k < K; ++k) {
        if (!(k < mlen + 6 && startind + 1 + k <= nst && k < nfill)) break;
        const int q = clampi(st0 + 1 + k, 0, C1 - 1);
        const int i0c = i0r_e[q], i1c = i1r_e[q];
        const int st = a.s_win[(size_t)gp * K + k];
        const int stc = clampi(st, 0, 1023);
        T m6[6];
#pragma unroll
        for (int j = 0; j < 6; ++j)
          m6[j] = static_cast<const T*>(a.model[j])[(size_t)e * 1024 + stc];
        const int qw = clampi(st0 + 1 + k, 0, a.Q1 - 1);
        const size_t wrow = ((size_t)qw * E + e) * sws;
        // the previous column: the forward column through the seam offset
        // (k = 0) or the carried refill column shifted by d
        const int s0 = i0c - wi0 - 1;
        const bool inr = s0 >= FSMIN - 1 && s0 <= FSMAX;
        const int ci0 = k == 0 ? 0 : cik[k];
        const int d = i0c - ci0;
        const bool okd = d >= 0 && d <= DMAX;
        const int p0 = k == 0 ? wi0 : ci0;
        const int p1 = k == 0 ? wi1 : ci0 + Ws - 1;

        for (int w = r; w < Ws; w += nt) {
          const T em = emission<T>(wm[wrow + w], wsd[wrow + w], wl[wrow + w],
                                   m6[0], m6[1], m6[2], m6[3], m6[4], m6[5],
                                   off);
          const T eo = i0c + w <= i1c && st >= 0 ? em : T(0);
          T pm_i, pm_im1;
          if (k == 0) {
            pm_im1 = inr ? at_or_zero(Mw, w + s0, W) : T(0);
            pm_i = inr ? at_or_zero(Mw, w + s0 + 1, W) : T(0);
          } else {
            pm_i = okd ? at_or_zero(Mc, w + d, Ws) : T(0);
            pm_im1 = okd ? at_or_zero(Mc, w + d - 1, Ws) : T(0);
          }
          const int i = i0c + w;
          const bool valid_i = i >= p0 && i <= p1;
          const bool valid_ul = i > p0 && i <= p1;
          const T skip_c = (valid_i ? pm_i : T(0)) + lsk;
          const T match_c = (valid_ul ? pm_im1 : T(0)) + eo;
          const T ignore_c = valid_ul ? pm_im1 + lin : T(0);
          const T D = mx(mx(T(0), skip_c), mx(match_c, ignore_c));
          const T a_stay = eo + lst, a_ext = eo + lex;
          const bool cut = w == 0;
          sc[w] = cut ? NB : mx(lin, a_stay);
          sc[sws + w] = cut ? NB : a_ext;
          sc[2 * sws + w] = cut ? NB : a_stay;
          sc[3 * sws + w] = cut ? NB : a_ext;
          sc[4 * sws + w] = D;
          sc[5 * sws + w] = cut ? NB : T(0);
        }
        __syncthreads();        // the elements, and every read of Mc done
        mp_scan_mem(sc, Ws);
        T lmax = NB;            // the thread's column max
        for (int w = r; w < Ws; w += nt) {
          const bool live = i0c + w <= i1c && st >= 0;
          const T Mn = live ? sc[4 * sws + w] : T(0);
          const T Sn = live ? sc[5 * sws + w] : T(0);
          lmax = mx(lmax, live ? Mn : NB);
          Mc[w] = Mn;
          if (k == k_star) { selM[w] = Mn; selS[w] = Sn; }
        }
        const T wmax = warp_max(lmax);
        if (lane == 0) red_s[warp] = wmax;
        if (k == k_star) sa = i0c;
        __syncthreads();        // Mc and the partial maxima visible
        if (warp == 0) {
          const T cmax = warp_max(lane < nw ? red_s[lane] : NB);
          const T bestn = mx(cmax, cbest);
          cbest = bestn;
          if (k == k_star) sbest = bestn;
        }
      }

      const T newv = new_score(a, e, sS, n0e, i0f_e, nst, refind_used,
                               k_star >= 0, sa, sbest, selM, selS, wi0, wbest,
                               Mw, Sw, red_j);
      if (r == 0) out[(size_t)p * a.E_g] = newv - old;
    }
  }
}

// totals[g, p] = sum over e of deltas[g, p, e], in order e = 0..E_g-1
template <typename T>
__global__ void sum_rows_kernel(const T* deltas, T* totals, int GP, int E_g) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= GP) return;
  T acc = T(0);
  for (int el = 0; el < E_g; ++el) acc = acc + deltas[(size_t)idx * E_g + el];
  totals[idx] = acc;
}

template <typename T, int RPT>
static int launch_groups(const MutArgs* a, cudaStream_t st) {
  const int threads = ((a->Ws + RPT - 1) / RPT + 31) / 32 * 32;
  const size_t smem = (size_t)(3 * a->Ws + 6 * 32 + 64) * sizeof(T) +
                      (size_t)a->K * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      group_kernel<T, RPT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)a->G * a->E_g;
  if (blocks > 0)
    group_kernel<T, RPT><<<(unsigned)blocks, threads, smem, st>>>(*a);
  return (int)cudaGetLastError();
}

// the wide instance: a block of 1024 threads for every (group, event row)
// pair, its arrays in dynamic shared memory; or, with a scratch, a grid of
// scratch_blocks blocks striding over the pairs, its arrays there
template <typename T>
static int launch_wide(const MutArgs* a, cudaStream_t st) {
  const size_t smem =
      64 * sizeof(T) + (size_t)a->K * sizeof(int) +
      (a->scratch ? 0 : (size_t)WIDE_ARRAYS * a->Ws * sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(
      group_wide_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  long long blocks = (long long)a->G * a->E_g;
  if (a->scratch) {
    if (a->scratch_blocks < 1) return (int)cudaErrorInvalidValue;
    blocks = blocks < a->scratch_blocks ? blocks : a->scratch_blocks;
  }
  if (blocks > 0)
    group_wide_kernel<T><<<(unsigned)blocks, 1024, smem, st>>>(*a);
  return (int)cudaGetLastError();
}

// the cluster instance: a cluster of group_ctas(Ws, GCL_THREADS GCL_RPT)
// CTAs a (group, event row) pair (cudaLaunchKernelEx with a cluster dimension;
// past 8 CTAs the card's non-portable sizes), refused
// (cudaErrorLaunchOutOfResources) where the card cannot place one such
// cluster; never another instance instead
template <typename T>
static int launch_cluster(const MutArgs* a, cudaStream_t st) {
  constexpr int SPAN = GCL_THREADS * GCL_RPT;
  const int n = (int)group_ctas(a->Ws, SPAN);
  const size_t smem = (size_t)(3 * SPAN + 2 + DMAX + 1 + 6 * 32 + 64 +
                               6 * 32 + 2 + (1 + a->P) * GCL_MAX) *
                          sizeof(T) +
                      (size_t)a->K * sizeof(int);
  auto kern = group_kernel<T, GCL_RPT, true>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess && n > 8)
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return (int)err;
  const long long pairs = (long long)a->G * a->E_g;
  if (pairs == 0) return 0;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(pairs * n));
  cfg.blockDim = dim3(GCL_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int placed = 0;
  err = cudaOccupancyMaxActiveClusters(&placed, (void*)kern, &cfg);
  if (err != cudaSuccess) return (int)err;
  if (placed < 1) return (int)cudaErrorLaunchOutOfResources;
  err = cudaLaunchKernelEx(&cfg, kern, *a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// the group kernel's instance a->rpt names (engine/mutscore.py
// group_instance): window rows a thread 1, 2 or 4 (Ws <= 1024 rpt <=
// RPT_ROWS); 0, the wide instance (Ws > RPT_ROWS); RPT_CLUSTER, the cluster
// instance (RPT_ROWS < Ws <= GCL_MAX CTAs of GCL_THREADS GCL_RPT rows)
template <typename T>
static int launch(const MutArgs* a, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a->Ws < 1 ||
      !(a->rpt == RPT_CLUSTER || a->rpt == 0 || a->rpt == 1 ||
        a->rpt == 2 || a->rpt == 4) ||
      (a->rpt > 0 && a->Ws > 1024 * a->rpt) ||
      (a->rpt <= 0 && a->Ws <= RPT_ROWS) ||
      (a->rpt == RPT_CLUSTER &&
       (group_ctas(a->Ws, GCL_THREADS * GCL_RPT) > (unsigned)GCL_MAX ||
        a->P > 32)))
    return (int)cudaErrorInvalidValue;
  const int err = a->rpt == RPT_CLUSTER ? launch_cluster<T>(a, st)
                  : a->rpt == 0   ? launch_wide<T>(a, st)
                  : a->rpt == 1 ? launch_groups<T, 1>(a, st)
                  : a->rpt == 2 ? launch_groups<T, 2>(a, st)
                                : launch_groups<T, 4>(a, st);
  if (err != cudaSuccess) return err;
  const int GP = a->G * a->P;
  if (GP > 0 && a->totals)       // no totals: the deltas are summed later
    sum_rows_kernel<T><<<(GP + 255) / 256, 256, 0, st>>>(
        static_cast<const T*>(a->deltas), static_cast<T*>(a->totals), GP,
        a->E_g);
  return (int)cudaGetLastError();
}

// totals [GP] from deltas [GP, E_g] alone: the reduction over a mesh's
// gathered per-shard deltas, in the same row order as in launch()
template <typename T>
static int sum_rows(const void* deltas, void* totals, int GP, int E_g,
                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (GP > 0)
    sum_rows_kernel<T><<<(GP + 255) / 256, 256, 0, st>>>(
        static_cast<const T*>(deltas), static_cast<T*>(totals), GP, E_g);
  return (int)cudaGetLastError();
}

extern "C" int psq_mutscore_f32(const MutArgs* a, void* stream) {
  return launch<float>(a, stream);
}

extern "C" int psq_mutscore_f64(const MutArgs* a, void* stream) {
  return launch<double>(a, stream);
}

extern "C" int psq_sum_rows_f32(const void* deltas, void* totals, int GP,
                                int E_g, void* stream) {
  return sum_rows<float>(deltas, totals, GP, E_g, stream);
}

extern "C" int psq_sum_rows_f64(const void* deltas, void* totals, int GP,
                                int E_g, void* stream) {
  return sum_rows<double>(deltas, totals, GP, E_g, stream);
}
