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
//    block of at most 1024 threads still holds an event's band;
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
// Shared memory per block: (2W + 6*32 + 32 + 64) T + 32 int, i.e. 6,088
// bytes in f32 and 12,048 in f64 at W = 601 (66,040 in f64 at W = 4095).
// Registers (nvcc -Xptxas -v, sm_90a; chip_smoke.py prints them):
// the W <= 608 instances 71-81 in f32 and 96 in f64, no spills but 16
// and 108 bytes in the f64 backward fills; the wider instances are held
// to 64 by their 1024-thread launch bound and spill up to 24 bytes in f32
// and 500 in f64 at one row a thread, 128 and 1,228 at two, 440 and 2,032
// at four.
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
  int rpt;                 // band rows a thread: 1, 2 or 4
};

// the widest band: realign_width 2047 (engine/fill.py MAX_W)
constexpr int MAX_W = 4095;

// a column's band and state
struct Col {
  int pad, i0, i1, st;
};

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
// 2048, 4 up to 4095), adjacent scan positions (common.cuh:mp_scan).
template <typename T, bool BWD, bool STEPS, bool XW, int RPT>
__global__ void __launch_bounds__(XW ? 640 : 1024) fill_kernel(FillArgs a) {
  static_assert(!XW || RPT == 1, "the spare warp is for one row a thread");
  constexpr int LR = log2_rpt<RPT>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int W = a.W, C = a.C, E = a.E, Tlen = a.Tlen;
  T* prevM = reinterpret_cast<T*>(smem_raw);   // previous column, by row
  T* prevO = prevM + W;
  T* tails = prevO + W;                        // [6][32] mp_scan's
  T* red_v = tails + 6 * 32;                   // [32] argmax partials
  T* head = red_v + 32;                        // [2][32] warps' first M, S
  int* red_i = reinterpret_cast<int*>(head + 64);

  const int e = blockIdx.x, t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  // warps holding band rows
  const int nwr = (W + (32 << LR) - 1) >> (5 + LR);
  const bool tail_warp = XW && warp == nwr;
  // the thread's scan positions t RPT + j: row t RPT + j forward, row W-1-
  // (t RPT + j) backward (`row` is the physical band row, used for every
  // band test and every address)
  bool has[RPT];
  int row[RPT];
#pragma unroll
  for (int j = 0; j < RPT; ++j) {
    has[j] = t * RPT + j < W;
    row[j] = BWD ? W - 1 - (t * RPT + j) : t * RPT + j;
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
  // finishes the column argmax (the spare warp, else warp 0)
  T run = T(0);
  int c_star = 0, a_star = 0;
  auto running = [&](int tt, int c, T cv, int ci) {
    if (tt == 0 || cv > run) { run = cv; c_star = c; a_star = ci; }
    static_cast<T*>(a.best_pfx)[(size_t)c * E + e] = mx(run, T(0));
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
      running(tt, c, cv, ci);
    }
  };

#pragma unroll
  for (int j = 0; j < RPT; ++j)
    if (has[j]) { prevM[row[j]] = T(0); prevO[row[j]] = T(0); }
  int p0 = 0, p1 = a.n0[e];     // the blank column [0, n0]
  Col cur = col(0), nxt = col(1);
  T ev[RPT], esrc[RPT];
  emit(load(cur), cur, ev, esrc);
  __syncthreads();

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
        running(tt, c, NB, 0);
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
      if (t == 0) {
        cmax[ce] = NB;
        a.carg[ce] = 0;
        if (!XW) running(tt, c, NB, 0);
      }
      next_emission();
    } else {
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
        if (BWD) {
          pm_i = at_or_zero(prevM, r + min(max(dv, -DMAX), 0), W);
          const int sd = min(max(dv + 1, -DMAX + 1), 1);
          pm_d = at_or_zero(prevM, r + sd, W);
          const T pobs_d = at_or_zero(prevO, r + sd, W);
          valid_ul[j] = i >= p0 && i < p1;
          match_c[j] = valid_ul[j] ? pm_d + pobs_d : T(0);
        } else {
          pm_i = at_or_zero(prevM, r + min(max(dv, 0), DMAX), W);
          pm_d = at_or_zero(prevM, r + min(max(dv - 1, -1), DMAX - 1), W);
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
          }
        } else {
          Mx = __shfl_up_sync(FULL, Mv[RPT - 1], 1);
          Sx = __shfl_up_sync(FULL, Sv[RPT - 1], 1);
          if (lane == 0 && warp > 0) {
            const bool lm1 = i0c + row[0] - 1 <= i1c && st >= 0 && act_e;
            Mx = lm1 ? tails[4 * 32 + warp - 1] : T(0);
            Sx = lm1 ? tails[5 * 32 + warp - 1] : T(0);
          }
        }
#pragma unroll
        for (int j = 0; j < RPT; ++j) {
          if (!has[j]) continue;
          const T Mm1 = BWD ? (j == RPT - 1 ? Mx : Mv[j + 1])
                            : (j == 0 ? Mx : Mv[j - 1]);
          const T Sm1 = BWD ? (j == RPT - 1 ? Sx : Sv[j + 1])
                            : (j == 0 ? Sx : Sv[j - 1]);
          // backpointers: candidate walk in order 0..3 with strict >, then
          // the stay override
          const bool nfirst = row[j] > 0;
          const T ins_c = nfirst ? Mm1 + lin : T(0);
          const T s4 = nfirst ? Mm1 + esrc[j] + lst : NB;
          const T s5 = nfirst ? Sm1 + esrc[j] + lex : NB;
          T val = T(0);
          uint8_t stp = 0;
          if (skip_c[j] > val) {
            val = skip_c[j];
            stp = valid_i[j] ? SKIP : IMPLICIT;
          }
          if (match_c[j] > val) {
            val = match_c[j];
            stp = valid_ul[j] ? MATCH : IMPLICIT;
          }
          if (ins_c > val) { val = ins_c; stp = INSERT; }
          if (ignore_c[j] > val) { val = ignore_c[j]; stp = IGNORE; }
          if (Sv[j] > val) stp = STAY;
          T sval = nfirst ? T(0) : NB;
          uint8_t sstp = 0;
          if (s4 > sval) { sval = s4; sstp = STAY; }
          if (s5 > sval) sstp = EXTEND;
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
        prevM[row[j]] = Mv[j];  // its readers passed barrier A
        prevO[row[j]] = live[j] ? ev[j] : T(0);
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
      if (!XW && warp == 0) finish_argmax(tt, c);
    }
    cur = nxt;
    nxt = after;
#pragma unroll
    for (int j = 0; j < RPT; ++j) {
      ev[j] = ev_n[j];
      esrc[j] = esrc_n[j];
    }
  }
  if (t == (XW ? 32 * nwr : 0)) {  // the finisher: the event's best
    const bool hit = run > T(0);
    static_cast<T*>(a.best)[e] = mx(run, T(0));
    a.best_i[e] = hit ? a.i0[(size_t)e * (C + 1) + c_star + 1] + a_star : 0;
    a.best_j[e] = hit ? c_star + 1 : 0;
  }
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

// the instance of a.rpt band rows a thread (engine/fill.py
// rows_per_thread): W <= 1024 rpt, at most MAX_W
template <typename T, bool BWD, bool STEPS>
static int launch_one(const FillArgs& a, cudaStream_t stream) {
  if (a.W < 1 || a.W > MAX_W ||
      !(a.rpt == 1 || a.rpt == 2 || a.rpt == 4) || a.W > 1024 * a.rpt)
    return (int)cudaErrorInvalidValue;
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
