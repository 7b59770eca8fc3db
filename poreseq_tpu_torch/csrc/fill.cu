// Banded pair-HMM fill, forward and backward (kernel 1 of the port).
//
// Replaces poreseq_tpu/engine/tpu/pallas_fill.py:_kernel (make_pallas_fill),
// with the semantics of its f64 twin dp.make_fill; the plain PyTorch twin is
// engine/dp.py:fill_reference.  Per band column it computes the emission from
// the column state's model values, the skip / match / ignore candidates with
// implicit local restarts from the previous column (band shifts of at most
// DMAX rows), the in-column (M, S) chain as a max-plus scan (reversed for the
// backward fill, which runs in forward coordinates), uint8 backpointers
// (forward), and the column's max and first argmax.  The running-best
// bookkeeping stays in the Python wrapper (engine/fill.py).
//
// What bounds it on this card: columns are sequential per event and the
// in-column chain is sequential per column, so one event is one thread
// block that walks its C columns with one thread per band row (W <= 1024).
// A column moves little data (W levels in, 2W lattice values and 2W step
// bytes out) but needs ~2*log2(W)+4 block barriers: barrier latency bounds
// it, not DRAM bandwidth.  The design keeps the previous column, the
// emission column and the scan operands in shared memory, indexes the level
// data directly at i0+row-1 (no sliding windows or refills: those were a
// workaround for gathers on the TPU), solves the chain with a block-wide
// max-plus scan on the combine tree of jax.lax.associative_scan (the
// twin's tree, so kernel and twin round alike), and runs several event
// blocks per SM to hide the barriers.
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
  int C, E, W, Tlen, backward, need_steps;
  double lik_offset;
};

template <typename T, bool BWD, bool STEPS>
__global__ void fill_kernel(FillArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int W = a.W, C = a.C, E = a.E;
  T* prevM = reinterpret_cast<T*>(smem_raw);
  T* prevO = prevM + W;
  T* e_col = prevO + W;
  T* scan = e_col + W;
  T* red_v = scan + 6 * W;
  int* red_i = reinterpret_cast<int*>(red_v + 32);

  const int e = blockIdx.x, r = threadIdx.x;
  const bool row = r < W;
  const T NB = neg_big<T>();
  const T* mean = static_cast<const T*>(a.mean) + (size_t)e * a.Tlen;
  const T* stdv = static_cast<const T*>(a.stdv) + (size_t)e * a.Tlen;
  const T* lsx = static_cast<const T*>(a.lsx) + (size_t)e * a.Tlen;
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

  if (row) { prevM[r] = T(0); prevO[r] = T(0); }
  int p0 = 0, p1 = a.n0[e];     // the blank column [0, n0]
  __syncthreads();

  for (int t = 0; t < C; ++t) {
    const int c = BWD ? C - 1 - t : t;
    const size_t ce = (size_t)c * E + e;
    const size_t base = ce * W;
    if (a.is_pad[ce]) {         // dead column: zeros out, carry unchanged
      if (row) {
        Mo[base + r] = T(0);
        So[base + r] = T(0);
        if (STEPS) { a.steps_m[base + r] = 0; a.steps_s[base + r] = 0; }
      }
      if (r == 0) { cmax[ce] = NB; a.carg[ce] = 0; }
      continue;
    }
    const int i0c = a.i0[(size_t)e * (C + 1) + c + 1];
    const int i1c = a.i1[(size_t)e * (C + 1) + c + 1];
    const int st = a.states[ce];
    const int stc = min(max(st, 0), 1023);
    const int i = i0c + r;
    const bool in_band = i <= i1c;

    T ev = T(0);
    if (row) {
      const int idx = i - 1;
      const bool ok = idx >= 0 && idx < a.Tlen;
      const T em = emission<T>(ok ? mean[idx] : T(0), ok ? stdv[idx] : T(1),
                               ok ? lsx[idx] : T(0), mdl[0][stc],
                               mdl[1][stc], mdl[2][stc], mdl[3][stc],
                               mdl[4][stc], mdl[5][stc], off);
      ev = in_band ? em : T(0);
      e_col[r] = ev;
    }
    const bool live = row && in_band && st >= 0 && act_e;

    // previous-column candidates (implicit-zero local restarts)
    const int dv = i0c - p0;
    const bool valid_i = i >= p0 && i <= p1;
    bool valid_ul;
    T pm_i, pm_d, match_c;
    if (BWD) {
      pm_i = at_or_zero(prevM, r + min(max(dv, -DMAX), 0), W);
      const int sd = min(max(dv + 1, -DMAX + 1), 1);
      pm_d = at_or_zero(prevM, r + sd, W);
      const T pobs_d = at_or_zero(prevO, r + sd, W);
      valid_ul = i >= p0 && i < p1;
      match_c = valid_ul ? pm_d + pobs_d : T(0);
    } else {
      pm_i = at_or_zero(prevM, r + min(max(dv, 0), DMAX), W);
      pm_d = at_or_zero(prevM, r + min(max(dv - 1, -1), DMAX - 1), W);
      valid_ul = i > p0 && i <= p1;
      match_c = (valid_ul ? pm_d : T(0)) + ev;
    }
    const T skip_c = (valid_i ? pm_i : T(0)) + lsk;
    const T ignore_c = valid_ul ? pm_d + lin : T(0);
    const T D = mx(mx(T(0), skip_c), mx(match_c, ignore_c));
    __syncthreads();            // e_col complete; prevM reads done

    // within-column source emission: the cell's own (forward) or the
    // source i+1 cell's (backward)
    const T esrc = BWD ? at_or_zero(e_col, r + 1, W) : ev;
    const bool cut = BWD ? (i >= i1c) : (r == 0);
    const T floor0 = (BWD ? (i == i1c) : cut) ? NB : T(0);
    const T a_stay = esrc + lst, a_ext = esrc + lex;
    T v[6] = {cut ? NB : mx(lin, a_stay), cut ? NB : a_ext,
              cut ? NB : a_stay, cut ? NB : a_ext, D, floor0};
    mp_scan<T>(v, scan, r, W, BWD);
    const T Mv = live ? v[4] : T(0);
    const T Sv = live ? v[5] : T(0);

    if (STEPS) {
      // backpointers: candidate walk in order 0..3 with strict >, then the
      // stay override (the scan scratch is free after mp_scan)
      if (row) { scan[r] = Mv; scan[W + r] = Sv; }
      __syncthreads();
      if (row) {
        const bool nfirst = r > 0;
        const T Mm1 = nfirst ? scan[r - 1] : T(0);
        const T Sm1 = nfirst ? scan[W + r - 1] : T(0);
        const T ins_c = nfirst ? Mm1 + lin : T(0);
        const T s4 = nfirst ? Mm1 + esrc + lst : NB;
        const T s5 = nfirst ? Sm1 + esrc + lex : NB;
        T val = T(0);
        uint8_t stp = 0;
        if (skip_c > val) { val = skip_c; stp = valid_i ? SKIP : IMPLICIT; }
        if (match_c > val) { val = match_c; stp = valid_ul ? MATCH : IMPLICIT; }
        if (ins_c > val) { val = ins_c; stp = INSERT; }
        if (ignore_c > val) { val = ignore_c; stp = IGNORE; }
        if (Sv > val) stp = STAY;
        T sval = nfirst ? T(0) : NB;
        uint8_t sstp = 0;
        if (s4 > sval) { sval = s4; sstp = STAY; }
        if (s5 > sval) sstp = EXTEND;
        a.steps_m[base + r] = live ? stp : 0;
        a.steps_s[base + r] = live ? sstp : 0;
      }
    }
    if (row) { Mo[base + r] = Mv; So[base + r] = Sv; }

    T cv = live ? Mv : NB;
    int ci = row ? r : INT_MAX;
    block_argmax(cv, ci, red_v, red_i);
    if (r == 0) { cmax[ce] = cv; a.carg[ce] = ci; }

    if (row) { prevM[r] = Mv; prevO[r] = live ? ev : T(0); }
    p0 = i0c;
    p1 = i1c;
    __syncthreads();
  }
}

template <typename T, bool BWD, bool STEPS>
static int launch_one(const FillArgs& a, cudaStream_t stream) {
  const int threads = ((a.W + 31) / 32) * 32;
  const size_t smem = (size_t)(9 * a.W + 32) * sizeof(T) + 32 * sizeof(int);
  auto kern = fill_kernel<T, BWD, STEPS>;
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
