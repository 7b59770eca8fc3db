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
//    band test and every address);
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
// bytes in f32 and 12,048 in f64 at W = 601.  Registers (nvcc 12.9
// -Xptxas -v, sm_90a; chip_smoke.py prints them): the W <= 608 instances
// 69-76 in f32 and 94-96 in f64, no spills but 8 and 40 bytes in the f64
// fills with steps; the wider instances are held to 64 by their
// 1024-thread launch bound and spill up to 28 bytes in f32 and 528 in
// f64.
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
};

// a column's band and state
struct Col {
  int pad, i0, i1, st;
};

// a column's loaded emission operands: model values at its state and the
// level data at row-1 (and row, the backward source row r+1's)
template <typename T, bool BWD>
struct ColData {
  T m[6];
  T lv[3];
  T lv1[BWD ? 3 : 1];
};

// XW: the block has one warp more than its band rows need, which scans the
// chunk tails and finishes the column argmax, so that no warp holding rows
// does either (for W <= 608; the 640-thread launch bound leaves 96
// registers a thread); without it warp 0 does both (W up to 1024, 64
// registers)
template <typename T, bool BWD, bool STEPS, bool XW>
__global__ void __launch_bounds__(XW ? 640 : 1024) fill_kernel(FillArgs a) {
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
  const int nwr = (W + 31) >> 5;               // warps holding band rows
  const bool tail_warp = XW && warp == nwr;
  const bool has = t < W;
  const int row = BWD ? W - 1 - t : t;
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
  auto level = [&](T* lv, int idx) {
    const bool ok = has && idx >= 0 && idx < Tlen;
    lv[0] = ok ? mean[idx] : T(0);
    lv[1] = ok ? stdv[idx] : T(1);
    lv[2] = ok ? lsx[idx] : T(0);
  };
  auto load = [&](const Col& k) {
    ColData<T, BWD> d;
    const int stc = min(max(k.st, 0), 1023);
#pragma unroll
    for (int j = 0; j < 6; ++j) d.m[j] = mdl[j][stc];
    level(d.lv, k.i0 + row - 1);
    if constexpr (BWD) level(d.lv1, k.i0 + row);
    return d;
  };
  // the row's emission (0 out of band) and, backward, row r+1's (the
  // within-column source emission; 0 past the band or the last row)
  auto emit = [&](const ColData<T, BWD>& d, const Col& k, T& ev, T& esrc) {
    const T em = emission<T>(d.lv[0], d.lv[1], d.lv[2], d.m[0], d.m[1],
                             d.m[2], d.m[3], d.m[4], d.m[5], off);
    ev = has && k.i0 + row <= k.i1 ? em : T(0);
    if constexpr (BWD) {
      const T e1 = emission<T>(d.lv1[0], d.lv1[1], d.lv1[2], d.m[0], d.m[1],
                               d.m[2], d.m[3], d.m[4], d.m[5], off);
      esrc = has && row + 1 < W && k.i0 + row + 1 <= k.i1 ? e1 : T(0);
    } else {
      esrc = ev;
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

  if (has) { prevM[row] = T(0); prevO[row] = T(0); }
  int p0 = 0, p1 = a.n0[e];     // the blank column [0, n0]
  Col cur = col(0), nxt = col(1);
  T ev, esrc;
  emit(load(cur), cur, ev, esrc);
  __syncthreads();

  for (int tt = 0; tt < C; ++tt) {
    const int c = BWD ? C - 1 - tt : tt;
    const size_t ce = (size_t)c * E + e;
    const size_t base = ce * W + row;
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
    const ColData<T, BWD> dn = load(nxt);
    T ev_n, esrc_n;
    auto next_emission = [&]() { emit(dn, nxt, ev_n, esrc_n); };

    if (cur.pad) {              // dead column: zeros out, carry unchanged
      if (has) {
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
      const int i = i0c + row;
      const bool in_band = i <= i1c;
      const bool live = has && in_band && st >= 0 && act_e;

      // previous-column candidates (implicit-zero local restarts)
      const int dv = i0c - p0;
      const bool valid_i = i >= p0 && i <= p1;
      bool valid_ul;
      T pm_i, pm_d, match_c;
      if (BWD) {
        pm_i = at_or_zero(prevM, row + min(max(dv, -DMAX), 0), W);
        const int sd = min(max(dv + 1, -DMAX + 1), 1);
        pm_d = at_or_zero(prevM, row + sd, W);
        const T pobs_d = at_or_zero(prevO, row + sd, W);
        valid_ul = i >= p0 && i < p1;
        match_c = valid_ul ? pm_d + pobs_d : T(0);
      } else {
        pm_i = at_or_zero(prevM, row + min(max(dv, 0), DMAX), W);
        pm_d = at_or_zero(prevM, row + min(max(dv - 1, -1), DMAX - 1), W);
        valid_ul = i > p0 && i <= p1;
        match_c = (valid_ul ? pm_d : T(0)) + ev;
      }
      const T skip_c = (valid_i ? pm_i : T(0)) + lsk;
      const T ignore_c = valid_ul ? pm_d + lin : T(0);
      const T D = mx(mx(T(0), skip_c), mx(match_c, ignore_c));

      // within-column chain: the source emission is the cell's own
      // (forward) or the source i+1 cell's (backward)
      const bool cut = BWD ? (i >= i1c) : (row == 0);
      const T floor0 = (BWD ? (i == i1c) : cut) ? NB : T(0);
      const T a_stay = esrc + lst, a_ext = esrc + lex;
      T v[6] = {cut ? NB : mx(lin, a_stay), cut ? NB : a_ext,
                cut ? NB : a_stay, cut ? NB : a_ext, D, floor0};
      if constexpr (XW) {
        scan_up(v, tails, W);
        __syncthreads();        // A: the chunk tails written
        next_emission();        // while the tail warp scans them
        if (W >= 64) __syncthreads();     // B: the tails final
        scan_down(v, tails, W);
      } else {
        mp_scan(v, tails, W, next_emission);
      }
      const T Mv = live ? v[4] : T(0);
      const T Sv = live ? v[5] : T(0);

      if (STEPS) {
        // M, S of physical row r-1: the lane below (forward) or above
        // (backward); across a warp boundary, the previous chunk's tail
        // from mp_scan (forward) or the next warp's first lane (backward)
        T Mm1, Sm1;
        if (BWD) {
          Mm1 = __shfl_down_sync(FULL, Mv, 1);
          Sm1 = __shfl_down_sync(FULL, Sv, 1);
          if (lane == 0) { head[warp] = Mv; head[32 + warp] = Sv; }
          __syncthreads();
          if (lane == 31 && warp + 1 < nwr) {
            Mm1 = head[warp + 1];
            Sm1 = head[32 + warp + 1];
          }
        } else {
          Mm1 = __shfl_up_sync(FULL, Mv, 1);
          Sm1 = __shfl_up_sync(FULL, Sv, 1);
          if (lane == 0 && warp > 0) {
            const bool lm1 = i - 1 <= i1c && st >= 0 && act_e;
            Mm1 = lm1 ? tails[4 * 32 + warp - 1] : T(0);
            Sm1 = lm1 ? tails[5 * 32 + warp - 1] : T(0);
          }
        }
        if (has) {
          // backpointers: candidate walk in order 0..3 with strict >, then
          // the stay override
          const bool nfirst = row > 0;
          const T ins_c = nfirst ? Mm1 + lin : T(0);
          const T s4 = nfirst ? Mm1 + esrc + lst : NB;
          const T s5 = nfirst ? Sm1 + esrc + lex : NB;
          T val = T(0);
          uint8_t stp = 0;
          if (skip_c > val) { val = skip_c; stp = valid_i ? SKIP : IMPLICIT; }
          if (match_c > val) {
            val = match_c;
            stp = valid_ul ? MATCH : IMPLICIT;
          }
          if (ins_c > val) { val = ins_c; stp = INSERT; }
          if (ignore_c > val) { val = ignore_c; stp = IGNORE; }
          if (Sv > val) stp = STAY;
          T sval = nfirst ? T(0) : NB;
          uint8_t sstp = 0;
          if (s4 > sval) { sval = s4; sstp = STAY; }
          if (s5 > sval) sstp = EXTEND;
          a.steps_m[base] = live ? stp : 0;
          a.steps_s[base] = live ? sstp : 0;
        }
      }
      if (has) {
        Mo[base] = Mv;
        So[base] = Sv;
        prevM[row] = Mv;        // its readers passed barrier A
        prevO[row] = live ? ev : T(0);
      }
      T cv = live ? Mv : NB;
      int ci = has ? row : INT_MAX;
      warp_argmax(cv, ci);
      if (lane == 0) { red_v[warp] = cv; red_i[warp] = ci; }
      p0 = i0c;
      p1 = i1c;
      __syncthreads();          // C: prevM/prevO and the partials
      if (!XW && warp == 0) finish_argmax(tt, c);
    }
    cur = nxt;
    nxt = after;
    ev = ev_n;
    esrc = esrc_n;
  }
  if (t == (XW ? 32 * nwr : 0)) {  // the finisher: the event's best
    const bool hit = run > T(0);
    static_cast<T*>(a.best)[e] = mx(run, T(0));
    a.best_i[e] = hit ? a.i0[(size_t)e * (C + 1) + c_star + 1] + a_star : 0;
    a.best_j[e] = hit ? c_star + 1 : 0;
  }
}

template <typename T, bool BWD, bool STEPS>
static int launch_one(const FillArgs& a, cudaStream_t stream) {
  if (a.W < 1 || a.W > 1024) return (int)cudaErrorInvalidValue;
  const int rows = ((a.W + 31) / 32) * 32;
  const bool xw = rows + 32 <= 640;
  const int threads = xw ? rows + 32 : rows;
  const size_t smem = (size_t)(2 * a.W + 6 * 32 + 32 + 64) * sizeof(T) +
                      32 * sizeof(int);
  auto kern = xw ? fill_kernel<T, BWD, STEPS, true>
                 : fill_kernel<T, BWD, STEPS, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<a.E, threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
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
