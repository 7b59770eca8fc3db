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
// ceil32(Ws / RPT) threads), keeps
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
// f32 spills 28 bytes at one and two rows a thread and 160 at four, f64
// 192, 300 and 1,204.
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
  int rpt;                              // window rows a thread: 1, 2 or 4
};

// the widest scoring window: scoring_width 2047 (engine/mutscore.py MAX_WS)
constexpr int MAX_WS = 4095;

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return min(max(x, lo), hi);
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
};

// RPT: window rows a thread (1 for Ws <= 1024, 2 up to 2048, 4 up to
// 4095), adjacent scan positions (common.cuh:mp_scan)
template <typename T, int RPT>
__global__ void __launch_bounds__(1024) group_kernel(MutArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int Ws = a.Ws, W = a.W, P = a.P, K = a.K, E = a.E, C1 = a.C1;
  T* Mc = reinterpret_cast<T*>(smem_raw);     // carried refill column
  T* selM = Mc + Ws;                          // selected column (k_star)
  T* selS = selM + Ws;
  T* tails = selS + Ws;                       // [6][32] mp_scan's
  T* red_s = tails + 6 * 32;                  // [32] step column max
  T* red_j = red_s + 32;                      // [32] joins
  int* cik = reinterpret_cast<int*>(red_j + 32);   // [K] anchor per step

  const int g = blockIdx.x / a.E_g, el = blockIdx.x % a.E_g;
  const int r = threadIdx.x, nt = blockDim.x;
  const int lane = r & 31, warp = r >> 5, nw = nt >> 5;
  // the thread's window rows r RPT + j
  int wr[RPT];
#pragma unroll
  for (int j = 0; j < RPT; ++j) wr[j] = r * RPT + j;
  T* out = static_cast<T*>(a.deltas) + (size_t)g * P * a.E_g + el;
  const int greg = a.g_region[g];
  const int e = clampi(a.g_evoff[g], 0, E - a.E_g) + el;
  if (!(a.active[e] && a.ev_region[e] == greg)) {
    if (r < P) out[(size_t)r * a.E_g] = T(0);
    return;
  }

  const T NB = neg_big<T>();
  const T* Mf = static_cast<const T*>(a.Mf);
  const T* Sf = static_cast<const T*>(a.Sf);
  const T* Mb = static_cast<const T*>(a.Mb);
  const T* Sb = static_cast<const T*>(a.Sb);
  const T* bpf = static_cast<const T*>(a.bpf);
  const T* bpb = static_cast<const T*>(a.bpb);
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
  const int span = DMAX * a.DM + 64;
  const int JMIN = -span, JMAX = a.RS + span, CMIN = -span, CMAX = span;
  const int FSMIN = -64, FSMAX = a.RS + 64 + DMAX;

  // the band anchor step k shifts from: it advances whenever ANY slot of
  // the group (valid or not) is still refilling at step k
  if (r == 0) {
    int ci0 = wi0 + a.RS;
    for (int k = 0; k < K; ++k) {
      cik[k] = ci0;
      bool any = false;
      for (int p = 0; p < P; ++p) {
        const int gp = g * P + p, mlen = a.s_mlen[gp], nst = a.s_nst[gp];
        const int nfill = clampi(min(startind + mlen + 6, nst) - startind,
                                 0, K);
        any |= k < mlen + 6 && startind + 1 + k <= nst && k < nfill;
      }
      if (any) ci0 = i0r_e[clampi(st0 + 1 + k, 0, C1 - 1)];
    }
  }

  // old score: lag-0 join of the unmutated lattices at max(start-3, 1)
  T old;
  {
    const int q_old = clampi(max(start - 3, 1), 0, sS);
    const size_t base = ((size_t)clampi(q_old, 0, C1 - 1) * E + e) * W;
    const int fao = i0f_e[clampi(q_old, 0, C1 - 1)];
    T m = T(0);
    for (int rr = r; rr < W; rr += nt) {
      const int ii = fao + rr;
      if (ii >= 1 && ii <= n0e)
        m = mx(m, mx(Mf[base + rr] + Mb[base + rr],
                     Sf[base + rr] + Sb[base + rr]));
    }
    m = block_max(m, red_j);                  // valid in warp 0
    const size_t qe = (size_t)clampi(q_old, 0, C1 - 1) * E + e;
    old = mx(mx(mx(m, T(0)), bpf[qe]), bpb[qe]);
  }
  __syncthreads();              // cik visible

  for (int p = 0; p < P; ++p) {
    const int gp = g * P + p;
    if (!a.s_valid[gp]) {       // delta masked to 0
      if (r == 0) out[(size_t)p * a.E_g] = T(0);
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
        Mc[wr[j]] = T(0);
        selM[wr[j]] = T(0);
        selS[wr[j]] = T(0);
      }
    int sa = wi0 + a.RS;
    T sbest = wbest, cbest = wbest;   // meaningful in warp 0

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
    Step cur = step(0), nxt = step(1);
    T eo[RPT];
    emit(load(0, cur), cur, eo);
    __syncthreads();

    for (int k = 0; k < K; ++k) {
      // a slot stays active for a prefix of the steps
      if (!(k < mlen + 6 && startind + 1 + k <= nst && k < nfill)) break;
      // loads for the next two steps, in flight while this one is solved
      const Step after = step(k + 2);
      const StepData<T, RPT> dn = load(k + 1, nxt);
      T eo_n[RPT];
      auto next_emission = [&]() { emit(dn, nxt, eo_n); };

      const int i0c = cur.i0, i1c = cur.i1;
      T pm_i[RPT], pm_im1[RPT];
      int p0, p1;
      if (k == 0) {
        // wide copy of the forward column through the seam offset
        const int s = i0c - wi0 - 1;
        const bool inr = s >= FSMIN - 1 && s <= FSMAX;
#pragma unroll
        for (int j = 0; j < RPT; ++j) {
          pm_im1[j] = inr ? at_or_zero(Mw, wr[j] + s, W) : T(0);
          pm_i[j] = inr ? at_or_zero(Mw, wr[j] + s + 1, W) : T(0);
        }
        p0 = wi0;
        p1 = wi1;
      } else {
        // narrow carry: shifts d in [0, DMAX] (and d-1), else zeros
        const int ci0 = cik[k];
        const int d = i0c - ci0;
        const bool okd = d >= 0 && d <= DMAX;
#pragma unroll
        for (int j = 0; j < RPT; ++j) {
          pm_i[j] = okd ? at_or_zero(Mc, wr[j] + d, Ws) : T(0);
          pm_im1[j] = okd ? at_or_zero(Mc, wr[j] + d - 1, Ws) : T(0);
        }
        p0 = ci0;
        p1 = ci0 + Ws - 1;
      }
      T v[RPT][6];
      bool live[RPT];
#pragma unroll
      for (int j = 0; j < RPT; ++j) {
        const int i = i0c + wr[j];
        live[j] = wr[j] < Ws && i <= i1c && cur.st >= 0;
        const bool valid_i = i >= p0 && i <= p1;
        const bool valid_ul = i > p0 && i <= p1;
        const T skip_c = (valid_i ? pm_i[j] : T(0)) + lsk;
        const T match_c = (valid_ul ? pm_im1[j] : T(0)) + eo[j];
        const T ignore_c = valid_ul ? pm_im1[j] + lin : T(0);
        const T D = mx(mx(T(0), skip_c), mx(match_c, ignore_c));
        const T a_stay = eo[j] + lst, a_ext = eo[j] + lex;
        const bool cut = wr[j] == 0;
        v[j][0] = cut ? NB : mx(lin, a_stay);
        v[j][1] = cut ? NB : a_ext;
        v[j][2] = cut ? NB : a_stay;
        v[j][3] = cut ? NB : a_ext;
        v[j][4] = D;
        v[j][5] = cut ? NB : T(0);
      }
      mp_scan<T, RPT>(v, tails, Ws, next_emission);
      T lmax = live[0] ? v[0][4] : NB;   // the thread's column max
#pragma unroll
      for (int j = 0; j < RPT; ++j) {
        const T Mn = live[j] ? v[j][4] : T(0);
        const T Sn = live[j] ? v[j][5] : T(0);
        if (j > 0) lmax = mx(lmax, live[j] ? Mn : NB);
        if (wr[j] < Ws) {
          Mc[wr[j]] = Mn;       // its readers passed barrier A
          if (k == k_star) { selM[wr[j]] = Mn; selS[wr[j]] = Sn; }
        }
      }
      const T wmax = warp_max(lmax);
      if (lane == 0) red_s[warp] = wmax;
      if (k == k_star) sa = i0c;
      __syncthreads();          // Mc and the partial maxima visible
      if (warp == 0) {
        const T cmax = warp_max(lane < nw ? red_s[lane] : NB);
        const T bestn = mx(cmax, cbest);
        cbest = bestn;
        if (k == k_star) sbest = bestn;
      }
      cur = nxt;
      nxt = after;
#pragma unroll
      for (int j = 0; j < RPT; ++j) eo[j] = eo_n[j];
    }

    // new score: the selected refill column (or the copied column) vs the
    // back column at rab = nst - refind_used + 1
    const int rab_new = clampi(nst - refind_used + 1, 0, sS);
    const int q_b = clampi(sS - rab_new + 1, 0, C1 - 1);
    const size_t bb = ((size_t)q_b * E + e) * W;
    const int ba = i0f_e[q_b];
    const T bbest = bpb[(size_t)q_b * E + e];
    const bool use_sel = k_star >= 0;
    const int fa = use_sel ? sa : wi0;
    const T fbest = use_sel ? sbest : wbest;
    const int s = fa - ba;
    const bool inr = use_sel ? (s >= JMIN && s <= JMAX)
                             : (s >= CMIN && s <= CMAX);
    T m = T(0);
    for (int rr = r; rr < W; rr += nt) {
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
    m = block_max(m, red_j);                  // valid in warp 0
    const T newv = mx(mx(mx(m, T(0)), fbest), bbest);
    if (r == 0) out[(size_t)p * a.E_g] = newv - old;
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

// the group kernel's instance of a->rpt window rows a thread
// (engine/mutscore.py:rows_per_thread): Ws <= 1024 rpt, at most MAX_WS
template <typename T>
static int launch(const MutArgs* a, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a->Ws < 1 || a->Ws > MAX_WS ||
      !(a->rpt == 1 || a->rpt == 2 || a->rpt == 4) || a->Ws > 1024 * a->rpt)
    return (int)cudaErrorInvalidValue;
  const int err = a->rpt == 1   ? launch_groups<T, 1>(a, st)
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
