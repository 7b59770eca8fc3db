// Banded pair-HMM fill, forward and backward (kernel 1 of the port).
//
// Replaces poreseq_tpu/engine/tpu/pallas_fill.py:_kernel (make_pallas_fill),
// with the semantics of its f64 twin dp.make_fill; the plain PyTorch twin is
// engine/dp.py:fill_reference.  Per band column it computes the emission from
// the column state's model values, the skip / match / ignore candidates with
// implicit local restarts from the previous column (band shifts of at most
// DMAX rows), the in-column (M, S) chain as a max-plus scan (reversed for the
// backward fill, which runs in forward coordinates), uint8 backpointers
// (forward), the column's max and first argmax, and the running best of
// make_pallas_fill's epilogue (pallas_fill.py:494-511; the twin is
// engine/dp.py:finish_fill): the thread that finishes each column's argmax
// carries the running max of the column maxima in processing order, writes
// best_pfx = max(running, 0) for the column and keeps the column of the
// last strict raise with its argmax; at the end it writes best = max(final,
// 0), best_i = i0 + argmax and best_j = column + 1 of that raise (0, 0 when
// the best is not above 0).  The first column in processing order whose max
// reaches the final best is that raise, so this is finish_fill's answer,
// by max and compare only (bit-equal in f32 and f64), with no block
// barrier and one store a column.
//
// What bounds it on this card: the bytes it must move (M and S, 8 or 16
// bytes a cell, and the step bytes) set a bound of about 0.02 ms for the
// 10 events of a 1 kb region at 10X (a launch padded to E=64, C=1024,
// W=601, f32; engine/roofline.py), but columns are sequential per
// event and the in-column chain is sequential per column, so the latency
// of one column bounds it: one event is one thread block that walks its C
// columns.  The design keeps that latency short:
//  - thread t holds logical position t of the scan: row t forward, row
//    W-1-t backward (`row` below is the physical band row, used for every
//    band test and every address); past 1024 rows a thread holds RPT = 2
//    (W <= 2048) or 4 (W <= 4095) adjacent positions t RPT + j, whose
//    lowest scan levels run in its registers (common.cuh:mp_scan), so one
//    block of at most 1024 threads still holds an event's band (wider
//    bands: the cluster instance, next, or fill_wide_kernel, below);
//  - the scan (common.cuh) runs the combine tree of
//    jax.lax.associative_scan, the twin's, levels 0-4 in registers by warp
//    shuffles, the chunk tails' levels in one warp, the down-sweep on the u
//    part (M, S) only: two block barriers, where a shared-memory scan needs
//    two per level;
//  - for W <= 608 the block has one warp more than its rows need (XW):
//    it scans the tails while the row warps compute the next column's
//    emissions, and finishes the column argmax (each row warp reduces its
//    own first, same first-index tie rule), so no row warp waits on
//    either; for wider bands warp 0 does both;
//  - the forward step pass takes row r-1 from the lane below (lane 0 from
//    the tails the scan leaves); the backward source emission of row r+1
//    is computed by the thread itself;
//  - no global load on the column chain: the next column's band, state,
//    model values and level data are loaded while this column is solved
//    (the column after next's band and state one step earlier still);
//  - so a column has three block barriers: A after the up-sweep, B after
//    the tails' scan (none when W < 64: one tail, final already) and C
//    after the previous-column buffers are written; the backward fill
//    with steps has one more (each warp's first M, S for the warp below).
// The cluster instance (CL, bands past RPT_ROWS rows up to CL_MAX CTAs;
// engine/fill.py fill_instance): past 4095 rows one block no longer holds
// the band in registers, and one block an event leaves most SMs idle, so
// an event takes a thread-block cluster of ceil(W / 1024) CTAs (up to 16,
// the card's non-portable size), CTA k holding positions [1024 k, 1024 (k
// + 1)) at 2 rows a thread of 512 (the 512-thread launch bound leaves 128
// registers: no spill in f32).  Each cell is computed by the same code as
// above; what crosses CTAs goes through distributed shared memory:
//  - the scan (common.cuh:mp_scan_cluster): each CTA's levels below 1024
//    as mp_scan's, its total to the higher ranks, one cluster barrier,
//    then every CTA's warp 0 runs the levels above over the lower ranks'
//    totals and its own, which gives its last position's final value and
//    the previous CTA's, its down-sweep's outside source: the tree's
//    combines, bit-equal;
//  - the seams: a row reads the previous column's M and emission DMAX rows
//    either side, so each CTA keeps its rows' prevM / prevO with a halo of
//    DMAX rows a side, which its neighbours write when they write theirs;
//    the forward step of a CTA's first row reads the previous CTA's last
//    final (M, S), the scan's outside source; the backward step of its
//    last row reads the next CTA's first, one level-0 combine of its own
//    last final value and that CTA's first element, sent before the scan;
//  - the column's max and first argmax: each CTA reduces its rows, rank 0
//    reduces the CTAs' partials (ties to the smaller row, as in one
//    block) and carries the running best;
//  - a second cluster barrier a column, split: each CTA arrives once its
//    halo and partial are sent and waits before the next live column reads
//    them (rank 0 then finishes the column before), so a column costs two
//    cluster barriers beside the three block barriers; dead columns cost
//    none (a pending column is finished at the first after it).
// Shared memory per block: (2W + 6*32 + 32 + 64) T + 32 int, i.e. 6,088
// bytes in f32 and 12,048 in f64 at W = 601 (66,040 in f64 at W = 4095).
// The cluster instance's CTA: (2 (1024 + 2 DMAX) + 520) T + 64 int, 10,656
// bytes in f32, 21,056 in f64.
// Registers (nvcc -Xptxas -v, sm_90a; chip_smoke.py prints them):
// the W <= 608 instances 71-81 in f32 and 96 in f64, no spills but 16
// and 108 bytes in the f64 backward fills; the wider instances are held
// to 64 by their 1024-thread launch bound and spill up to 24 bytes in f32
// and 500 in f64 at one row a thread, 128 and 1,228 at two, 440 and 2,032
// at four; the cluster instance 100-112 in f32, no spill, and 128 in f64,
// spilling 72-184 bytes.
//
// Built with --fmad=false so the kernel evaluates the twin's expression
// tree without fused multiply-adds.
#include "common.cuh"

using namespace psq;

struct FillArgs {
  const void* mean;        // [E, T]
  const void* stdv;        // [E, T]
  const void* lsx;         // [E, T] lsr (forward) or lsd (backward)
  const void* model[6];    // [E, 1024] lev_mean lev_stdv log_lev sd_mean
                           //           sd_lambda log_lambda
  const void* lik[4];      // [E] skip stay extend insert
  const int* n0;           // [E]
  const uint8_t* active;   // [E]
  const int* states;       // [C, E]
  const uint8_t* is_pad;   // [C, E]
  const int* i0;           // [E, C+1]
  const int* i1;           // [E, C+1]
  void* M;                 // [C, E, W]
  void* S;                 // [C, E, W]
  uint8_t* steps_m;        // [C, E, W] (need_steps)
  uint8_t* steps_s;        // [C, E, W] (need_steps)
  void* cmax;              // [C, E]
  int* carg;               // [C, E]
  void* best_pfx;          // [C, E] the running best, clamped at 0
  void* best;              // [E]
  int* best_i;             // [E]
  int* best_j;             // [E]
  int C, E, W, Tlen, backward, need_steps;
  double lik_offset;
  int rpt;                 // band rows a thread: 1, 2 or 4; 0: the wide
                           // instance (fill_wide_kernel); RPT_CLUSTER: the
                           // cluster instance
  void* scratch;           // [E, WIDE_ARRAYS, W] the wide instance's column
                           // arrays in device memory, or null: in shared
};

// the register-held scan's widest band (1024 threads of 4 rows; realign
// width 2047); wider bands run fill_wide_kernel (engine/fill.py
// rows_per_thread)
constexpr int RPT_ROWS = 4095;
// the wide instance's column arrays of W values: prevM, prevO, the column's
// emissions and its six scan rows
constexpr int WIDE_ARRAYS = 9;
// the cluster instance (FillArgs.rpt RPT_CLUSTER; engine/fill.py
// fill_instance): CL_THREADS threads of CL_RPT rows a CTA, so a CTA spans
// CL_THREADS * CL_RPT band positions (a power of two), and at most CL_MAX
// CTAs a cluster (past 8 the card's non-portable cluster sizes)
constexpr int RPT_CLUSTER = -1;
constexpr int CL_THREADS = 512;
constexpr int CL_RPT = 2;
constexpr int CL_MAX = 16;

// a column's band and state
struct Col {
  int pad, i0, i1, st;
};

// the running best of make_pallas_fill's epilogue, carried by one thread
template <typename T>
struct Running {
  T run = T(0);
  int c_star = 0, a_star = 0;
  // column c, processing step tt, with max cv at its first argmax ci
  __device__ __forceinline__ void column(const FillArgs& a, int e, int tt,
                                         int c, T cv, int ci) {
    if (tt == 0 || cv > run) { run = cv; c_star = c; a_star = ci; }
    static_cast<T*>(a.best_pfx)[(size_t)c * a.E + e] = mx(run, T(0));
  }
  // the event's best, max(run, 0), and its coordinates when above 0
  __device__ __forceinline__ void finish(const FillArgs& a, int e) const {
    const bool hit = run > T(0);
    static_cast<T*>(a.best)[e] = mx(run, T(0));
    a.best_i[e] = hit ? a.i0[(size_t)e * (a.C + 1) + c_star + 1] + a_star : 0;
    a.best_j[e] = hit ? c_star + 1 : 0;
  }
};

// a cell's backpointers (steps_m, steps_s): the candidate walk in order
// 0..3 with strict >, then the stay override; Mm1, Sm1 are row r-1's M and
// S (0 when not live), esrc the cell's within-column source emission
template <typename T>
__device__ __forceinline__ void step_codes(
    T skip_c, T match_c, T ignore_c, bool valid_i, bool valid_ul, T Sv,
    T Mm1, T Sm1, T esrc, bool nfirst, T lin, T lst, T lex, uint8_t& stp,
    uint8_t& sstp) {
  const T NB = neg_big<T>();
  const T ins_c = nfirst ? Mm1 + lin : T(0);
  const T s4 = nfirst ? Mm1 + esrc + lst : NB;
  const T s5 = nfirst ? Sm1 + esrc + lex : NB;
  T val = T(0);
  stp = 0;
  if (skip_c > val) {
    val = skip_c;
    stp = valid_i ? SKIP : IMPLICIT;
  }
  if (match_c > val) {
    val = match_c;
    stp = valid_ul ? MATCH : IMPLICIT;
  }
  if (ins_c > val) { val = ins_c; stp = INSERT; }
  if (ignore_c > val) { val = ignore_c; stp = IGNORE; }
  if (Sv > val) stp = STAY;
  T sval = nfirst ? T(0) : NB;
  sstp = 0;
  if (s4 > sval) { sval = s4; sstp = STAY; }
  if (s5 > sval) sstp = EXTEND;
}

// a column's loaded emission operands: model values at its state and the
// level data at row-1 of each of the thread's rows (and, backward, at row
// of its first row: the source row r+1's; a later row's source is the
// thread's row before it, whose emission it already has)
template <typename T, bool BWD, int RPT>
struct ColData {
  T m[6];
  T lv[RPT][3];
  T lv1[BWD ? 3 : 1];
};

// XW: the block has one warp more than its band rows need, which scans the
// chunk tails and finishes the column argmax, so that no warp holding rows
// does either (for W <= 608; the 640-thread launch bound leaves 96
// registers a thread); without it warp 0 does both (W up to 1024 at RPT =
// 1, 64 registers).  RPT: band rows a thread (1 for W <= 1024, 2 up to
// 2048, 4 up to 4095), adjacent scan positions (common.cuh:mp_scan).  CL:
// the cluster instance, CL_THREADS threads of RPT = CL_RPT rows a CTA.
template <typename T, bool BWD, bool STEPS, bool XW, int RPT, bool CL = false>
__global__ void __launch_bounds__(XW ? 640 : CL ? CL_THREADS : 1024)
    fill_kernel(FillArgs a) {
  static_assert(!XW || RPT == 1, "the spare warp is for one row a thread");
  static_assert(!CL || !XW, "a cluster's CTAs have no spare warp");
  constexpr int LR = log2_rpt<RPT>();
  constexpr int SPAN = CL_THREADS * RPT;       // CL: positions a CTA
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int W = a.W, C = a.C, E = a.E, Tlen = a.Tlen;
  // CL: CTA `rank` of `ncta` holds positions [pos0, pos0 + nloc), rows
  // [lo, lo + nloc), and keeps prevM / prevO of those rows and DMAX more on
  // each side (the halo its neighbours send), row r at index r + ro
  const unsigned ncta = CL ? (W + SPAN - 1) / SPAN : 1;
  const unsigned rank = CL ? cluster_rank() : 0;
  const int pos0 = rank * SPAN;
  const int nloc = CL ? min(SPAN, W - pos0) : W;
  const int lo = CL ? (BWD ? W - pos0 - nloc : pos0) : 0;
  const int pw = CL ? SPAN + 2 * DMAX : W, ro = CL ? DMAX - lo : 0;
  T* prevM = reinterpret_cast<T*>(smem_raw);   // previous column, by row
  T* prevO = prevM + pw;
  T* tails = prevO + pw;                       // [6][32] mp_scan's
  T* red_v = tails + 6 * 32;                   // [32] argmax partials
  T* head = red_v + 32;                        // [2][32] warps' first M, S
  T* tops = head + 64;      // CL: [6][32] lower ranks' totals
  T* pref = tops + 6 * 32;  // CL: [2] the previous CTA's last final u
  T* first = pref + 2;      // CL: [6] the next CTA's first scan element
  T* cl_v = first + 6;      // CL, rank 0: [32] the CTAs' column maxima
  int* red_i = reinterpret_cast<int*>(CL ? cl_v + 32 : head + 64);
  int* cl_i = red_i + 32;   // CL, rank 0: [32] their first argmaxes

  const int e = CL ? blockIdx.x / ncta : blockIdx.x, t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  // warps holding band rows
  const int nwr = (nloc + (32 << LR) - 1) >> (5 + LR);
  const bool tail_warp = XW && warp == nwr;
  // the thread's scan positions pos0 + t RPT + j: row pos0 + t RPT + j
  // forward, row W-1-(pos0 + t RPT + j) backward (`row` is the physical
  // band row, used for every band test and every address)
  bool has[RPT];
  int row[RPT];
#pragma unroll
  for (int j = 0; j < RPT; ++j) {
    const int p = pos0 + t * RPT + j;
    has[j] = p < W;
    row[j] = BWD ? W - 1 - p : p;
  }
  const T NB = neg_big<T>();
  const T* mean = static_cast<const T*>(a.mean) + (size_t)e * Tlen;
  const T* stdv = static_cast<const T*>(a.stdv) + (size_t)e * Tlen;
  const T* lsx = static_cast<const T*>(a.lsx) + (size_t)e * Tlen;
  const T* mdl[6];
#pragma unroll
  for (int k = 0; k < 6; ++k)
    mdl[k] = static_cast<const T*>(a.model[k]) + (size_t)e * 1024;
  const T lsk = static_cast<const T*>(a.lik[0])[e];
  const T lst = static_cast<const T*>(a.lik[1])[e];
  const T lex = static_cast<const T*>(a.lik[2])[e];
  const T lin = static_cast<const T*>(a.lik[3])[e];
  const T off = T(a.lik_offset);
  const bool act_e = a.active[e] != 0;
  T* Mo = static_cast<T*>(a.M);
  T* So = static_cast<T*>(a.S);
  T* cmax = static_cast<T*>(a.cmax);

  // processing step tt -> its column's band and state (pad past the end)
  auto col = [&](int tt) {
    Col k{1, 0, 0, -1};
    if (tt < C) {
      const int c = BWD ? C - 1 - tt : tt;
      const size_t ce = (size_t)c * E + e;
      k.pad = a.is_pad[ce];
      k.i0 = a.i0[(size_t)e * (C + 1) + c + 1];
      k.i1 = a.i1[(size_t)e * (C + 1) + c + 1];
      k.st = a.states[ce];
    }
    return k;
  };
  auto level = [&](T* lv, int idx, bool in) {
    const bool ok = in && idx >= 0 && idx < Tlen;
    lv[0] = ok ? mean[idx] : T(0);
    lv[1] = ok ? stdv[idx] : T(1);
    lv[2] = ok ? lsx[idx] : T(0);
  };
  auto load = [&](const Col& k) {
    ColData<T, BWD, RPT> d;
    const int stc = min(max(k.st, 0), 1023);
#pragma unroll
    for (int j = 0; j < 6; ++j) d.m[j] = mdl[j][stc];
#pragma unroll
    for (int j = 0; j < RPT; ++j) level(d.lv[j], k.i0 + row[j] - 1, has[j]);
    if constexpr (BWD) level(d.lv1, k.i0 + row[0], has[0]);
    return d;
  };
  // each row's emission (0 out of band) and, backward, row r+1's (the
  // within-column source emission; 0 past the band or the last row): the
  // first row's computed, a later row's the emission of the thread's row
  // before it (row + 1), the same value
  auto emit = [&](const ColData<T, BWD, RPT>& d, const Col& k, T (&ev)[RPT],
                  T (&esrc)[RPT]) {
#pragma unroll
    for (int j = 0; j < RPT; ++j) {
      const T em = emission<T>(d.lv[j][0], d.lv[j][1], d.lv[j][2], d.m[0],
                               d.m[1], d.m[2], d.m[3], d.m[4], d.m[5], off);
      ev[j] = has[j] && k.i0 + row[j] <= k.i1 ? em : T(0);
    }
    if constexpr (BWD) {
      const T e1 = emission<T>(d.lv1[0], d.lv1[1], d.lv1[2], d.m[0], d.m[1],
                               d.m[2], d.m[3], d.m[4], d.m[5], off);
      esrc[0] = has[0] && row[0] + 1 < W && k.i0 + row[0] + 1 <= k.i1 ? e1
                                                                     : T(0);
#pragma unroll
      for (int j = 1; j < RPT; ++j) esrc[j] = has[j] ? ev[j - 1] : T(0);
    } else {
#pragma unroll
      for (int j = 0; j < RPT; ++j) esrc[j] = ev[j];
    }
  };

  // the running best, carried by the finisher: lane 0 of the warp that
  // finishes the column argmax (the spare warp, else warp 0; CL: rank 0's)
  Running<T> best;
  // CL: rank 0's warp 0 finishes a column's max and first argmax from the
  // CTAs' partials (cl_v, cl_i) after the cluster barrier that follows it
  // (pending: the last live column's, not yet finished)
  bool pending = false;
  int pend_tt = 0, pend_c = 0;
  auto finish_pending = [&]() {
    cluster_wait();
    pending = false;
    if (rank != 0 || warp != 0) return;
    T cv = lane < (int)ncta ? cl_v[lane] : NB;
    int ci = lane < (int)ncta ? cl_i[lane] : INT_MAX;
    warp_argmax(cv, ci);
    if (lane == 0) {
      const size_t pe = (size_t)pend_c * E + e;
      cmax[pe] = cv;
      a.carg[pe] = ci;
      best.column(a, e, pend_tt, pend_c, cv, ci);
    }
  };
  // CL: row r's new prevM / prevO also into the halo of the CTA holding
  // row r - DMAX .. r + DMAX, where that is another
  auto send_halo = [&](int r, T m, T o) {
    auto to = [&](unsigned k) {
      const int b = k * SPAN, nl = min(SPAN, W - b);
      const int i = r - (BWD ? W - b - nl : b) + DMAX;
      cluster_map(prevM, k)[i] = m;
      cluster_map(prevO, k)[i] = o;
    };
    if (r - lo < DMAX && lo > 0) to(BWD ? rank + 1 : rank - 1);
    if (lo + nloc - 1 - r < DMAX && lo + nloc < W)
      to(BWD ? rank - 1 : rank + 1);
  };
  // the column's max and first argmax from the row warps' partials
  auto finish_argmax = [&](int tt, int c) {
    T cv = lane < nwr ? red_v[lane] : NB;
    int ci = lane < nwr ? red_i[lane] : INT_MAX;
    warp_argmax(cv, ci);
    if (lane == 0) {
      const size_t ce = (size_t)c * E + e;
      cmax[ce] = cv;
      a.carg[ce] = ci;
      best.column(a, e, tt, c, cv, ci);
    }
  };

  if constexpr (CL) {
    for (int i = t; i < pw; i += blockDim.x) {
      prevM[i] = T(0);
      prevO[i] = T(0);
    }
  } else {
#pragma unroll
    for (int j = 0; j < RPT; ++j)
      if (has[j]) { prevM[row[j]] = T(0); prevO[row[j]] = T(0); }
  }
  int p0 = 0, p1 = a.n0[e];     // the blank column [0, n0]
  Col cur = col(0), nxt = col(1);
  T ev[RPT], esrc[RPT];
  emit(load(cur), cur, ev, esrc);
  __syncthreads();
  if constexpr (CL) {           // every CTA of the cluster running, its
    cluster_arrive();           // halo zeroed, before any sends
    cluster_wait();
  }

  for (int tt = 0; tt < C; ++tt) {
    const int c = BWD ? C - 1 - tt : tt;
    const size_t ce = (size_t)c * E + e;
    // loads for the next two steps, in flight while this column is solved
    const Col after = col(tt + 2);
    if (tail_warp) {            // the barriers of a live column, and its
      if (!cur.pad) {           // tails and argmax
        __syncthreads();        // A
        if (W >= 64) {
          scan_tails(tails, W);
          __syncthreads();      // B
        }
        if (BWD && STEPS) __syncthreads();
        __syncthreads();        // C
        finish_argmax(tt, c);
      } else if (lane == 0) {
        best.column(a, e, tt, c, NB, 0);
      }
      cur = nxt;
      nxt = after;
      continue;
    }
    const ColData<T, BWD, RPT> dn = load(nxt);
    T ev_n[RPT], esrc_n[RPT];
    auto next_emission = [&]() { emit(dn, nxt, ev_n, esrc_n); };

    if (cur.pad) {              // dead column: zeros out, carry unchanged
#pragma unroll
      for (int j = 0; j < RPT; ++j) {
        if (!has[j]) continue;
        const size_t base = ce * W + row[j];
        Mo[base] = T(0);
        So[base] = T(0);
        if (STEPS) { a.steps_m[base] = 0; a.steps_s[base] = 0; }
      }
      if (CL && pending) finish_pending();
      if (t == 0 && rank == 0) {
        cmax[ce] = NB;
        a.carg[ce] = 0;
        if (!XW) best.column(a, e, tt, c, NB, 0);
      }
      next_emission();
    } else {
      // CL: the previous column's halo and partials arrived
      if (CL && pending) finish_pending();
      const int i0c = cur.i0, i1c = cur.i1, st = cur.st;
      const int dv = i0c - p0;
      T v[RPT][6];
      bool live[RPT], valid_i[RPT], valid_ul[RPT];
      T skip_c[RPT], match_c[RPT], ignore_c[RPT];
#pragma unroll
      for (int j = 0; j < RPT; ++j) {
        const int r = row[j], i = i0c + r;
        live[j] = has[j] && i <= i1c && st >= 0 && act_e;

        // previous-column candidates (implicit-zero local restarts)
        valid_i[j] = i >= p0 && i <= p1;
        T pm_i, pm_d;
        const T* pM = prevM + ro;
        if (BWD) {
          pm_i = at_or_zero(pM, r + min(max(dv, -DMAX), 0), W);
          const int sd = min(max(dv + 1, -DMAX + 1), 1);
          pm_d = at_or_zero(pM, r + sd, W);
          const T pobs_d = at_or_zero(prevO + ro, r + sd, W);
          valid_ul[j] = i >= p0 && i < p1;
          match_c[j] = valid_ul[j] ? pm_d + pobs_d : T(0);
        } else {
          pm_i = at_or_zero(pM, r + min(max(dv, 0), DMAX), W);
          pm_d = at_or_zero(pM, r + min(max(dv - 1, -1), DMAX - 1), W);
          valid_ul[j] = i > p0 && i <= p1;
          match_c[j] = (valid_ul[j] ? pm_d : T(0)) + ev[j];
        }
        skip_c[j] = (valid_i[j] ? pm_i : T(0)) + lsk;
        ignore_c[j] = valid_ul[j] ? pm_d + lin : T(0);
        const T D = mx(mx(T(0), skip_c[j]), mx(match_c[j], ignore_c[j]));

        // within-column chain: the source emission is the cell's own
        // (forward) or the source i+1 cell's (backward)
        const bool cut = BWD ? (i >= i1c) : (r == 0);
        const T floor0 = (BWD ? (i == i1c) : cut) ? NB : T(0);
        const T a_stay = esrc[j] + lst, a_ext = esrc[j] + lex;
        v[j][0] = cut ? NB : mx(lin, a_stay);
        v[j][1] = cut ? NB : a_ext;
        v[j][2] = cut ? NB : a_stay;
        v[j][3] = cut ? NB : a_ext;
        v[j][4] = D;
        v[j][5] = floor0;
      }
      if constexpr (XW) {
        scan_up<T, 1>(v, tails, W);
        __syncthreads();        // A: the chunk tails written
        next_emission();        // while the tail warp scans them
        if (W >= 64) __syncthreads();     // B: the tails final
        scan_down<T, 1>(v, tails, W);
      } else if constexpr (CL) {
        // backward with steps: the CTA's first element (position pos0,
        // never an up-sweep destination) to the previous CTA, whose last
        // row's step reads this row's final M, S
        if (BWD && STEPS && rank > 0 && t == 0) {
          T* dst = cluster_map(first, rank - 1);
#pragma unroll
          for (int k = 0; k < 6; ++k) dst[k] = v[0][k];
        }
        mp_scan_cluster<T, RPT>(v, tails, tops, pref, W, pos0, rank, ncta,
                                next_emission);
      } else {
        mp_scan<T, RPT>(v, tails, W, next_emission);
      }
      T Mv[RPT], Sv[RPT];
#pragma unroll
      for (int j = 0; j < RPT; ++j) {
        Mv[j] = live[j] ? v[j][4] : T(0);
        Sv[j] = live[j] ? v[j][5] : T(0);
      }

      if (STEPS) {
        // M, S of physical row r-1: the thread's own next position
        // (backward) or previous one (forward), else the lane above
        // (backward) or below (forward); across a warp boundary, the next
        // warp's first lane (backward) or the previous chunk's tail from
        // mp_scan (forward)
        T Mx, Sx;
        if (BWD) {
          Mx = __shfl_down_sync(FULL, Mv[0], 1);
          Sx = __shfl_down_sync(FULL, Sv[0], 1);
          if (lane == 0) { head[warp] = Mv[0]; head[32 + warp] = Sv[0]; }
          __syncthreads();
          if (lane == 31 && warp + 1 < nwr) {
            Mx = head[warp + 1];
            Sx = head[32 + warp + 1];
          } else if (CL && lane == 31 && warp + 1 == nwr &&
                     rank + 1 < ncta) {
            // the next CTA's first position: its final u is the tree's
            // level-0 down-sweep combine of this CTA's last position's
            T f[6];
#pragma unroll
            for (int k = 0; k < 6; ++k) f[k] = first[k];
            mp_combine_u(v[RPT - 1][4], v[RPT - 1][5], f);
            const bool lm1 =
                i0c + row[RPT - 1] - 1 <= i1c && st >= 0 && act_e;
            Mx = lm1 ? f[4] : T(0);
            Sx = lm1 ? f[5] : T(0);
          }
        } else {
          Mx = __shfl_up_sync(FULL, Mv[RPT - 1], 1);
          Sx = __shfl_up_sync(FULL, Sv[RPT - 1], 1);
          if (lane == 0 && (warp > 0 || (CL && rank > 0))) {
            const bool lm1 = i0c + row[0] - 1 <= i1c && st >= 0 && act_e;
            Mx = lm1 ? (warp > 0 ? tails[4 * 32 + warp - 1] : pref[0]) : T(0);
            Sx = lm1 ? (warp > 0 ? tails[5 * 32 + warp - 1] : pref[1]) : T(0);
          }
        }
#pragma unroll
        for (int j = 0; j < RPT; ++j) {
          if (!has[j]) continue;
          const T Mm1 = BWD ? (j == RPT - 1 ? Mx : Mv[j + 1])
                            : (j == 0 ? Mx : Mv[j - 1]);
          const T Sm1 = BWD ? (j == RPT - 1 ? Sx : Sv[j + 1])
                            : (j == 0 ? Sx : Sv[j - 1]);
          uint8_t stp, sstp;
          step_codes(skip_c[j], match_c[j], ignore_c[j], valid_i[j],
                     valid_ul[j], Sv[j], Mm1, Sm1, esrc[j], row[j] > 0, lin,
                     lst, lex, stp, sstp);
          const size_t base = ce * W + row[j];
          a.steps_m[base] = live[j] ? stp : 0;
          a.steps_s[base] = live[j] ? sstp : 0;
        }
      }
      // the thread's first maximum (smallest row among equals), then the
      // warp's
      T cv = NB;
      int ci = INT_MAX;
#pragma unroll
      for (int j = 0; j < RPT; ++j) {
        if (!has[j]) continue;
        const size_t base = ce * W + row[j];
        Mo[base] = Mv[j];
        So[base] = Sv[j];
        const T po = live[j] ? ev[j] : T(0);
        prevM[row[j] + ro] = Mv[j];  // its readers passed barrier A
        prevO[row[j] + ro] = po;
        if (CL) send_halo(row[j], Mv[j], po);
        const T ov = live[j] ? Mv[j] : NB;
        if (j == 0 || ov > cv || (ov == cv && row[j] < ci)) {
          cv = ov;
          ci = row[j];
        }
      }
      warp_argmax(cv, ci);
      if (lane == 0) { red_v[warp] = cv; red_i[warp] = ci; }
      p0 = i0c;
      p1 = i1c;
      __syncthreads();          // C: prevM/prevO and the partials
      if constexpr (CL) {
        // the CTA's max and first argmax to rank 0; the halo and the
        // partials are read after the cluster barrier this arrives at
        if (warp == 0) {
          T bv = lane < nwr ? red_v[lane] : NB;
          int bi = lane < nwr ? red_i[lane] : INT_MAX;
          warp_argmax(bv, bi);
          if (lane == 0) {
            cluster_map(cl_v, 0)[rank] = bv;
            cluster_map(cl_i, 0)[rank] = bi;
          }
        }
        cluster_arrive();
        pending = true;
        pend_tt = tt;
        pend_c = c;
      } else if (!XW && warp == 0) {
        finish_argmax(tt, c);
      }
    }
    cur = nxt;
    nxt = after;
#pragma unroll
    for (int j = 0; j < RPT; ++j) {
      ev[j] = ev_n[j];
      esrc[j] = esrc_n[j];
    }
  }
  if (CL && pending) finish_pending();
  if (t == (XW ? 32 * nwr : 0) && rank == 0) best.finish(a, e);  // finisher
}

// The wide instance: bands past the cluster instance's CL_MAX CTAs (W >
// 16,384), or where the route finds it faster (engine/fill.py
// fill_instance), or named (FillArgs.rpt 0, any W > RPT_ROWS).  In one
// block a column's six scan values a row outrun the registers (6 W of them
// past 4095 rows, against 65,536 registers an SM), so the column lives in
// memory: prevM, prevO, the column's emissions and the scan rows, WIDE_ARRAYS
// W values, in dynamic shared memory where they fit (W <= 6,449 in f32,
// 3,223 in f64) and else in the event's slice of a device scratch [E,
// WIDE_ARRAYS, W] that the wrapper allocates.  One block of 1024 threads an
// event; every phase of a column strides over the band rows (thread t takes
// positions t, t + 1024, ...): the emissions, the scan elements, the scan
// itself level by level (common.cuh:mp_scan_mem, the same combine tree as
// the twin's _assoc_scan), then the outputs, the step bytes and the
// column's first argmax, then the previous-column arrays; block barriers
// between phases and scan levels (2 log2 W + 4 a column).  Each cell is
// computed as in fill_kernel, so the results are the same bit for bit.  A
// simple instance: its latency is the barriers' and the memory's (no loads
// in flight across a column).
template <typename T, bool BWD, bool STEPS>
__global__ void __launch_bounds__(1024) fill_wide_kernel(FillArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int W = a.W, C = a.C, E = a.E, Tlen = a.Tlen;
  const int e = blockIdx.x, t = threadIdx.x, nt = blockDim.x;
  const int lane = t & 31, warp = t >> 5, nw = nt >> 5;
  const size_t sw = (size_t)W;
  T* red_v = reinterpret_cast<T*>(smem_raw);            // [32] partials
  int* red_i = reinterpret_cast<int*>(red_v + 32);      // [32]
  T* prevM = a.scratch                                  // previous column,
      ? static_cast<T*>(a.scratch) + (size_t)e * WIDE_ARRAYS * sw  // by row
      : reinterpret_cast<T*>(red_i + 32);
  T* prevO = prevM + sw;
  T* evr = prevO + sw;          // the column's emission by row (0 off band)
  T* sc = evr + sw;             // [6][W] scan elements by position

  const T NB = neg_big<T>();
  const T* mean = static_cast<const T*>(a.mean) + (size_t)e * Tlen;
  const T* stdv = static_cast<const T*>(a.stdv) + (size_t)e * Tlen;
  const T* lsx = static_cast<const T*>(a.lsx) + (size_t)e * Tlen;
  const T lsk = static_cast<const T*>(a.lik[0])[e];
  const T lst = static_cast<const T*>(a.lik[1])[e];
  const T lex = static_cast<const T*>(a.lik[2])[e];
  const T lin = static_cast<const T*>(a.lik[3])[e];
  const T off = T(a.lik_offset);
  const bool act_e = a.active[e] != 0;
  T* Mo = static_cast<T*>(a.M);
  T* So = static_cast<T*>(a.S);
  T* cmax = static_cast<T*>(a.cmax);
  // position p's physical band row
  auto row_of = [&](int p) { return BWD ? W - 1 - p : p; };

  // the running best, carried by thread 0 (fill_kernel's finisher)
  Running<T> best;

  for (int r = t; r < W; r += nt) { prevM[r] = T(0); prevO[r] = T(0); }
  int p0 = 0, p1 = a.n0[e];     // the blank column [0, n0]
  __syncthreads();

  for (int tt = 0; tt < C; ++tt) {
    const int c = BWD ? C - 1 - tt : tt;
    const size_t ce = (size_t)c * E + e;
    if (a.is_pad[ce]) {         // dead column: zeros out, carry unchanged
      for (int r = t; r < W; r += nt) {
        const size_t base = ce * sw + r;
        Mo[base] = T(0);
        So[base] = T(0);
        if (STEPS) { a.steps_m[base] = 0; a.steps_s[base] = 0; }
      }
      if (t == 0) {
        cmax[ce] = NB;
        a.carg[ce] = 0;
        best.column(a, e, tt, c, NB, 0);
      }
      continue;
    }
    const int i0c = a.i0[(size_t)e * (C + 1) + c + 1];
    const int i1c = a.i1[(size_t)e * (C + 1) + c + 1];
    const int st = a.states[ce];
    const int stc = min(max(st, 0), 1023);
    T m[6];
#pragma unroll
    for (int k = 0; k < 6; ++k)
      m[k] = static_cast<const T*>(a.model[k])[(size_t)e * 1024 + stc];
    const int dv = i0c - p0;

    // each row's emission, 0 out of band
    for (int r = t; r < W; r += nt) {
      const int idx = i0c + r - 1;
      const bool ok = idx >= 0 && idx < Tlen;
      const T em = emission<T>(ok ? mean[idx] : T(0), ok ? stdv[idx] : T(1),
                               ok ? lsx[idx] : T(0), m[0], m[1], m[2], m[3],
                               m[4], m[5], off);
      evr[r] = i0c + r <= i1c ? em : T(0);
    }
    __syncthreads();            // the emissions (backward: row r+1's)

    // a row's previous-column candidates (implicit-zero local restarts) and
    // its within-column source emission: the cell's own (forward) or the
    // source i+1 cell's (backward)
    struct Cand {
      bool valid_i, valid_ul;
      T skip_c, match_c, ignore_c, esrc;
    };
    auto cand = [&](int r) {
      const int i = i0c + r;
      Cand k;
      k.valid_i = i >= p0 && i <= p1;
      T pm_i, pm_d;
      if (BWD) {
        pm_i = at_or_zero(prevM, r + min(max(dv, -DMAX), 0), W);
        const int sd = min(max(dv + 1, -DMAX + 1), 1);
        pm_d = at_or_zero(prevM, r + sd, W);
        const T pobs_d = at_or_zero(prevO, r + sd, W);
        k.valid_ul = i >= p0 && i < p1;
        k.match_c = k.valid_ul ? pm_d + pobs_d : T(0);
        k.esrc = r + 1 < W ? evr[r + 1] : T(0);
      } else {
        pm_i = at_or_zero(prevM, r + min(max(dv, 0), DMAX), W);
        pm_d = at_or_zero(prevM, r + min(max(dv - 1, -1), DMAX - 1), W);
        k.valid_ul = i > p0 && i <= p1;
        k.match_c = (k.valid_ul ? pm_d : T(0)) + evr[r];
        k.esrc = evr[r];
      }
      k.skip_c = (k.valid_i ? pm_i : T(0)) + lsk;
      k.ignore_c = k.valid_ul ? pm_d + lin : T(0);
      return k;
    };
    auto live_row = [&](int r) { return i0c + r <= i1c && st >= 0 && act_e; };

    // the scan elements, by position
    for (int p = t; p < W; p += nt) {
      const int r = row_of(p), i = i0c + r;
      const Cand k = cand(r);
      const T D = mx(mx(T(0), k.skip_c), mx(k.match_c, k.ignore_c));
      const bool cut = BWD ? (i >= i1c) : (r == 0);
      const T floor0 = (BWD ? (i == i1c) : cut) ? NB : T(0);
      const T a_stay = k.esrc + lst, a_ext = k.esrc + lex;
      sc[p] = cut ? NB : mx(lin, a_stay);
      sc[sw + p] = cut ? NB : a_ext;
      sc[2 * sw + p] = cut ? NB : a_stay;
      sc[3 * sw + p] = cut ? NB : a_ext;
      sc[4 * sw + p] = D;
      sc[5 * sw + p] = floor0;
    }
    __syncthreads();
    mp_scan_mem(sc, W);         // ends on a barrier: every position final

    // outputs, step bytes and the thread's first maximum (smallest row
    // among equals)
    T cv = NB;
    int ci = INT_MAX;
    for (int p = t; p < W; p += nt) {
      const int r = row_of(p);
      const bool live = live_row(r);
      const T Mv = live ? sc[4 * sw + p] : T(0);
      const T Sv = live ? sc[5 * sw + p] : T(0);
      const size_t base = ce * sw + r;
      Mo[base] = Mv;
      So[base] = Sv;
      if (STEPS) {
        // M, S of row r-1 (position p+1 backward, p-1 forward) as the
        // column left them
        const Cand k = cand(r);
        const int pm1 = BWD ? p + 1 : p - 1;
        const bool lm1 = r > 0 && live_row(r - 1);
        uint8_t stp, sstp;
        step_codes(k.skip_c, k.match_c, k.ignore_c, k.valid_i, k.valid_ul,
                   Sv, lm1 ? sc[4 * sw + pm1] : T(0),
                   lm1 ? sc[5 * sw + pm1] : T(0), k.esrc, r > 0, lin, lst,
                   lex, stp, sstp);
        a.steps_m[base] = live ? stp : 0;
        a.steps_s[base] = live ? sstp : 0;
      }
      const T ov = live ? Mv : NB;
      if (ov > cv || (ov == cv && r < ci)) { cv = ov; ci = r; }
    }
    warp_argmax(cv, ci);
    if (lane == 0) { red_v[warp] = cv; red_i[warp] = ci; }
    __syncthreads();            // every read of prevM, prevO and evr done

    for (int p = t; p < W; p += nt) {
      const int r = row_of(p);
      const bool live = live_row(r);
      prevM[r] = live ? sc[4 * sw + p] : T(0);
      prevO[r] = live ? evr[r] : T(0);
    }
    if (warp == 0) {            // the column's max and first argmax
      T v = lane < nw ? red_v[lane] : NB;
      int i = lane < nw ? red_i[lane] : INT_MAX;
      warp_argmax(v, i);
      if (lane == 0) {
        cmax[ce] = v;
        a.carg[ce] = i;
        best.column(a, e, tt, c, v, i);
      }
    }
    p0 = i0c;
    p1 = i1c;
    __syncthreads();            // prevM, prevO written; the partials read
  }
  if (t == 0) best.finish(a, e);
}

template <typename T, bool BWD, bool STEPS, bool XW, int RPT>
static int launch_block(const FillArgs& a, int threads, cudaStream_t stream) {
  const size_t smem = (size_t)(2 * a.W + 6 * 32 + 32 + 64) * sizeof(T) +
                      32 * sizeof(int);
  auto kern = fill_kernel<T, BWD, STEPS, XW, RPT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<a.E, threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// the wide instance: one block of 1024 threads an event, its column
// arrays in dynamic shared memory, or in a.scratch when the wrapper gives one
template <typename T, bool BWD, bool STEPS>
static int launch_wide(const FillArgs& a, cudaStream_t stream) {
  const size_t smem = 32 * (sizeof(T) + sizeof(int)) +
                      (a.scratch ? 0 : (size_t)WIDE_ARRAYS * a.W * sizeof(T));
  auto kern = fill_wide_kernel<T, BWD, STEPS>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<a.E, 1024, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// the cluster instance: a cluster of ceil(W / (CL_THREADS CL_RPT)) CTAs an
// event (cudaLaunchKernelEx with a cluster dimension; past 8 CTAs the
// card's non-portable sizes), refused (cudaErrorLaunchOutOfResources) where
// the card cannot place one such cluster; never another instance instead
template <typename T, bool BWD, bool STEPS>
static int launch_cluster(const FillArgs& a, cudaStream_t stream) {
  constexpr int SPAN = CL_THREADS * CL_RPT;
  const int n = (a.W + SPAN - 1) / SPAN;
  const size_t smem = (size_t)(2 * (SPAN + 2 * DMAX) + 6 * 32 + 32 + 64 +
                               6 * 32 + 2 + 6 + 32) * sizeof(T) +
                      64 * sizeof(int);
  auto kern = fill_kernel<T, BWD, STEPS, false, CL_RPT, true>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess && n > 8)
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.E * n);
  cfg.blockDim = dim3(CL_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int placed = 0;
  err = cudaOccupancyMaxActiveClusters(&placed, (void*)kern, &cfg);
  if (err != cudaSuccess) return (int)err;
  if (placed < 1) return (int)cudaErrorLaunchOutOfResources;
  err = cudaLaunchKernelEx(&cfg, kern, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// the instance a.rpt names (engine/fill.py fill_instance): band rows a
// thread 1, 2 or 4 (W <= 1024 rpt <= RPT_ROWS); 0, the wide instance (W >
// RPT_ROWS); RPT_CLUSTER, the cluster instance (RPT_ROWS < W <= CL_MAX CTAs
// of CL_THREADS CL_RPT rows)
template <typename T, bool BWD, bool STEPS>
static int launch_one(const FillArgs& a, cudaStream_t stream) {
  if (a.W < 1 || !(a.rpt == RPT_CLUSTER || a.rpt == 0 || a.rpt == 1 ||
                   a.rpt == 2 || a.rpt == 4) ||
      (a.rpt > 0 && a.W > 1024 * a.rpt) || (a.rpt <= 0 && a.W <= RPT_ROWS) ||
      (a.rpt == RPT_CLUSTER && a.W > CL_MAX * CL_THREADS * CL_RPT))
    return (int)cudaErrorInvalidValue;
  if (a.rpt == RPT_CLUSTER) return launch_cluster<T, BWD, STEPS>(a, stream);
  if (a.rpt == 0) return launch_wide<T, BWD, STEPS>(a, stream);
  const int rows = ((a.W + a.rpt - 1) / a.rpt + 31) / 32 * 32;
  if (a.rpt == 1) {
    if (rows + 32 <= 640)
      return launch_block<T, BWD, STEPS, true, 1>(a, rows + 32, stream);
    return launch_block<T, BWD, STEPS, false, 1>(a, rows, stream);
  }
  if (a.rpt == 2) return launch_block<T, BWD, STEPS, false, 2>(a, rows, stream);
  return launch_block<T, BWD, STEPS, false, 4>(a, rows, stream);
}

template <typename T>
static int launch(const FillArgs* a, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a->backward)
    return a->need_steps ? launch_one<T, true, true>(*a, s)
                         : launch_one<T, true, false>(*a, s);
  return a->need_steps ? launch_one<T, false, true>(*a, s)
                       : launch_one<T, false, false>(*a, s);
}

extern "C" int psq_fill_f32(const FillArgs* a, void* stream) {
  return launch<float>(a, stream);
}

extern "C" int psq_fill_f64(const FillArgs* a, void* stream) {
  return launch<double>(a, stream);
}
