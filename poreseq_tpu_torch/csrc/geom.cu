// The scoring-band geometry after the backtrace and the scoring band's data
// windows (kernels 9 and 10 of the port).
//
// geom_kernel replaces poreseq_tpu/engine/tpu/mutscore.py:_geom_body (XLA);
// the plain PyTorch twin is engine/mutscore.py:geom_reference.  Per event: the
// anchors (ral > 0 at levels below n0), the first and last (ra0, ra1), the
// flank line al_m = (ral[ra1] - ral[ra0]) / (ra1 - ra0) (0/0 = NaN for one
// anchor, as in the reference), al_b = ral[ra0] - al_m ra0; ri, the
// update_refs interpolation (the flank line outside [ra0, ra1], m (t -
// left) + ral[left] between consecutive anchors when the left anchor is
// above level 0, else ral; +inf past n0 and on events without an anchor);
// for refinds 1..C the lower bound of the refind in ri by JAX's bisection
// (mutscore.bisect_left: ceil(log2(T + 1)) levels, the read at min(mid,
// T - 1), left when not ri[mid] < q, so NaN sorts last), clamped to [1,
// max(n0, 1)]; the band [imid - width, imid + width] clamped to [1, n0];
// the starts rate-limited (i0[j] = j DMAX + min over k <= j of lo[k] - k
// DMAX); i1 clamped to i0 + 2 width (column 0: i0 = 0, i1 = n0); columns
// past S_e frozen at column S_e's start with empty bands.  Outputs i0, i1
// [E, C+1] int32.  Built with --fmad=false, every float is the twin's
// expression tree and every search the twin's levels, so i0 and i1 equal
// the twin's in f32 and f64, NaN flanks and unsorted rows included.
//
// What bounds it on this card: the bytes (ral read once, i0 and i1 written
// once: about 1 MB at a Mutate round's E = 96, T = 1024, C = 1024 in f32,
// engine/roofline.py:geom_work), and the latency of
// one block an event, a chain of dependent phases with a barrier between
// each.  The design keeps each phase short.  (1) The event's ral row is
// staged in shared memory first, by 16-byte cp.async copies that are all
// in flight at once (the row's misaligned ends by plain loads), and no
// pass reads ral from device memory again.  (2) A thread takes a run of
// ceil(T / GNT) levels and finds its first and last anchors; four block
// scans of those, each a warp-shuffle step and then the NW warp totals
// through shared memory, give the carries: the exclusive prefix max of
// the last anchors (the left anchor before the run), the exclusive suffix
// min of the first anchors (the right anchor after it), and the block's
// min and max (ra0, ra1).  They are integer min and max, so their order
// does not matter.  (3) ri replaces ral in the same buffer: an anchor's ri
// is its own ral, and the interpolation reads anchors only (ra[left],
// ra[right], ra[ra0], ra[ra1]), so each thread overwrites the non-anchor
// levels of its own run as it walks it, reading its own levels' flags
// before it writes them; the right anchor comes from a look-ahead in the
// run, else the carry.  (4) The columns 1..min(S_e, C) go in passes of
// GNT CPT: a thread bisects its CPT consecutive columns together, their
// levels advancing in step so that CPT shared loads are in flight at
// once, then a block scan of the threads' run minima (with the earlier
// passes' carry) gives the rate limit's prefix minimum.  Columns past S_e
// are stored as column S_e's start with empty bands, unsearched.  Shared
// memory: T sizeof(T) + 16 bytes, so the staged instance takes at most
// 57,344 levels in f32 and 28,672 in f64 (engine/mutscore.py:
// GEOM_MAX_LEVELS); the launch raises the dynamic shared memory limit once
// per card and dtype, when a row needs more than 48 KB.  A longer row runs
// the second instance (STAGED false): the same phases on the row in device
// memory, ri written to a scratch row [E, T] that the wrapper allocates,
// every bisection level a load from L2 or device memory.
//
// windows_kernel replaces mutscore.py:build_windows (XLA gathers); the twin
// is engine/mutscore.py:windows_reference.  out[q, e, w] = src[e, i0r[e, q] - 1
// + w] for mean, stdv and lsr, 0 / 1 / 0 outside the event.  A copy, bound
// by the bytes it writes (about 160 MB at C = 1024, E = 64, Ws = 201 in
// f32): an elementwise grid-stride loop in output order, so consecutive
// threads write consecutive w and read consecutive levels.
#include <algorithm>

#include "common.cuh"

namespace {

using namespace psq;

constexpr int NT = 256;     // threads a windows block
// a geometry block's threads and the columns a thread bisects together
// (tools/sweep_constants.py, PERF.md §6)
constexpr int GNT = 512;
constexpr int CPT = 2;
constexpr int NW = GNT / 32;
// the longest ral row staged: 57,344 f32 or 28,672 f64 levels
constexpr int ROW_BYTES = 229376;

// an event's ral row [Tn] into shared memory at buf (Tn sizeof(T) + 16
// bytes): the 16-byte aligned body by cp.async, placed so that its shared
// address is 16-byte aligned too, and the few levels before and after it
// by plain loads; returns the staged row
template <typename T>
__device__ __forceinline__ T* stage_row(unsigned char* buf, const T* ra,
                                        int Tn) {
  constexpr int V = 16 / sizeof(T);
  const int k = threadIdx.x;
  const int head = min(
      Tn, (int)((16 - ((uintptr_t)ra & 15)) & 15) / (int)sizeof(T));
  T* s = reinterpret_cast<T*>(buf + ((16 - head * (int)sizeof(T)) & 15));
  const int nv = (Tn - head) / V, tail = head + nv * V;
  for (int j = k; j < nv; j += GNT)
    copy16_async(s + head + j * V, ra + head + j * V);
  if (k < head) s[k] = ra[k];
  if (k < Tn - tail) s[tail + k] = ra[tail + k];
  copies_wait();
  __syncthreads();
  return s;
}

// ral [E, Tn]; n0, S_e [E]; i0, i1 [E, C+1]; one block an event.
// STAGED: the row is staged in shared memory and ri rewrites it in place
// (Tn sizeof(T) <= ROW_BYTES); else the row is read from device memory and
// ri written to the event's row of scratch [E, Tn], every level of it (an
// anchor's and the level-0 quirk's ral too), with the same phases, scans,
// divides and bisection levels
template <typename T, bool STAGED>
__global__ void __launch_bounds__(GNT)
geom_kernel(const T* __restrict__ ral, const int* __restrict__ n0p,
            const int* __restrict__ S_ep, int* __restrict__ i0,
            int* __restrict__ i1, T* scratch, int Tn, int C, int width) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int s_first[NW], s_last[NW], s_min[2][NW], s_anchor;
  const int k = threadIdx.x, lane = k & 31, warp = k >> 5, e = blockIdx.x;
  const int n0 = n0p[e], S_e = S_ep[e];
  int* o0 = i0 + (size_t)e * (C + 1);
  int* o1 = i1 + (size_t)e * (C + 1);
  // the row read (s) and ri's (ri): one shared buffer when staged
  const T* s;
  T* ri;
  if constexpr (STAGED) {
    ri = stage_row(smem_raw, ral + (size_t)e * Tn, Tn);
    s = ri;
  } else {
    s = ral + (size_t)e * Tn;
    ri = scratch + (size_t)e * Tn;
  }
  // an anchor, read from a level its thread has not rewritten
  auto anch = [&](int t) { return t < n0 && s[t] > T(0); };

  // this thread's run of levels [t0, t1): its first and last anchors
  const int L = (Tn + GNT - 1) / GNT;
  const int t0 = min(k * L, Tn), t1 = min(t0 + L, Tn);
  int first = Tn, last = -1;
  for (int t = t0; t < t1; ++t) {
    if (anch(t)) { first = min(first, t); last = t; }
  }
  // the carries: prefix max of the last anchors, suffix min of the first
  int pmax = last, smin = first;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int a = __shfl_up_sync(FULL, pmax, d);
    const int b = __shfl_down_sync(FULL, smin, d);
    if (lane >= d) pmax = max(pmax, a);
    if (lane + d < 32) smin = min(smin, b);
  }
  if (lane == 31) s_last[warp] = pmax;
  if (lane == 0) s_first[warp] = smin;
  int left = __shfl_up_sync(FULL, pmax, 1);
  int right = __shfl_down_sync(FULL, smin, 1);
  if (lane == 0) left = -1;
  if (lane == 31) right = Tn;
  __syncthreads();
  int ra0 = Tn, ra1 = -1;
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    const int wf = s_first[w], wl = s_last[w];
    ra0 = min(ra0, wf);
    ra1 = max(ra1, wl);
    if (w < warp) left = max(left, wl);
    if (w > warp) right = min(right, wf);
  }
  const bool has = ra1 >= 0;
  T al_m = T(0), al_b = T(0);
  if (has) {                                 // anchors: never rewritten
    const T f0 = s[ra0], f1 = s[ra1];
    al_m = (f1 - f0) / T(ra1 - ra0);
    al_b = f0 - al_m * T(ra0);
  }

  // ri over the run, in place: lt the last anchor before t, rt the first
  // after it once looked up
  int lt = left, rt = -1;
  for (int t = t0; t < t1; ++t) {
    const T x = s[t];
    if (t < n0 && x > T(0)) {                // an anchor keeps its ral
      lt = t;
      if constexpr (!STAGED) ri[t] = x;
      continue;
    }
    T v;
    if (!(t < n0 && has)) {
      v = pos_inf<T>();
    } else if (t < ra0 || t > ra1) {
      v = al_m * T(t) + al_b;
    } else if (lt > 0) {
      if (rt < t) {
        rt = t + 1;
        while (rt < t1 && !anch(rt)) ++rt;
        if (rt == t1) rt = right;
      }
      const T lv = s[lt], rv = s[rt];
      const T m = (rv - lv) / T(rt - lt);
      v = m * T(t - lt) + lv;
    } else {                                 // the level-0 quirk: ral stays
      if constexpr (!STAGED) ri[t] = x;
      continue;
    }
    ri[t] = v;
  }
  __syncthreads();

  // columns 1..qmax: the band by CPT bisections in step, then the rate
  // limit's prefix minimum by a block scan with the earlier passes' carry
  const int nlev = 32 - __clz(Tn);
  const int qmax = max(min(S_e, C), 0);
  int carry = INT_MAX;
  for (int base = 0, p = 0; base < qmax; base += GNT * CPT, p ^= 1) {
    const int q0 = base + 1 + k * CPT;
    int low[CPT], high[CPT];
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      low[j] = 0;
      high[j] = Tn;
    }
    for (int l = 0; l < nlev; ++l) {
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int mid = (low[j] + high[j]) >> 1;
        if (!(ri[min(mid, Tn - 1)] < T(q0 + j))) high[j] = mid;
        else low[j] = mid;
      }
    }
    int lo[CPT], hi[CPT], run = INT_MAX;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int imid = min(max(high[j], 1), max(n0, 1));
      lo[j] = max(imid - width, 1);
      hi[j] = min(imid + width, n0);
      run = min(run, lo[j] - (q0 + j) * DMAX);
    }
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int a = __shfl_up_sync(FULL, run, d);
      if (lane >= d) run = min(run, a);
    }
    if (lane == 31) s_min[p][warp] = run;
    int ex = __shfl_up_sync(FULL, run, 1);
    if (lane == 0) ex = INT_MAX;
    __syncthreads();
    ex = min(ex, carry);
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const int wm = s_min[p][w];
      if (w < warp) ex = min(ex, wm);
      carry = min(carry, wm);
    }
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int q = q0 + j;
      ex = min(ex, lo[j] - q * DMAX);
      const int start = q * DMAX + ex;
      if (q <= qmax) {
        o0[q] = start;
        o1[q] = min(hi[j], start + 2 * width);
        if (q == qmax) s_anchor = start;
      }
    }
  }
  if (k == 0) {
    o0[0] = 0;
    o1[0] = min(n0, 2 * width);
  }
  __syncthreads();
  const int anchor = qmax > 0 ? s_anchor : 0;
  for (int c = qmax + 1 + k; c <= C; c += GNT) {
    o0[c] = anchor;
    o1[c] = 0;
  }
}

// mean, stdv, lsr [E, Tn]; i0r [E, Q1]; out [Q1, E, Ws] each
template <typename T>
__global__ void __launch_bounds__(NT)
windows_kernel(const T* __restrict__ mean, const T* __restrict__ stdv,
               const T* __restrict__ lsr, const int* __restrict__ i0r,
               T* __restrict__ wm, T* __restrict__ ws, T* __restrict__ wl,
               int E, int Tn, int Q1, int Ws) {
  const size_t n = (size_t)Q1 * E * Ws;
  for (size_t o = (size_t)blockIdx.x * NT + threadIdx.x; o < n;
       o += (size_t)gridDim.x * NT) {
    const size_t qe = o / Ws;
    const int w = (int)(o - qe * Ws);
    const int e = (int)(qe % E), q = (int)(qe / E);
    const int i = i0r[(size_t)e * Q1 + q] - 1 + w;
    const bool ok = i >= 0 && i < Tn;
    const size_t at = (size_t)e * Tn + (ok ? i : 0);
    wm[o] = ok ? mean[at] : T(0);
    ws[o] = ok ? stdv[at] : T(1);
    wl[o] = ok ? lsr[at] : T(0);
  }
}

// scratch null: the staged instance (Tn sizeof(T) <= ROW_BYTES); else the
// instance that reads the row from device memory and writes ri to scratch
// [E, Tn] (engine/mutscore.py:geom_cuda allocates it past GEOM_MAX_LEVELS)
template <typename T>
int launch_geom(const void* ral, const void* n0, const void* S_e, void* i0,
                void* i1, void* scratch, int E, int Tn, int C, int width,
                void* stream) {
  if (E == 0) return 0;
  if (Tn < 1 || C < 1 ||
      (!scratch && (size_t)Tn * sizeof(T) > ROW_BYTES))
    return (int)cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  if (scratch) {
    geom_kernel<T, false><<<E, GNT, 0, st>>>(
        static_cast<const T*>(ral), static_cast<const int*>(n0),
        static_cast<const int*>(S_e), static_cast<int*>(i0),
        static_cast<int*>(i1), static_cast<T*>(scratch), Tn, C, width);
    return (int)cudaGetLastError();
  }
  const size_t smem = (size_t)Tn * sizeof(T) + 16;
  if (smem > 48 * 1024) {
    // raise the limit to the longest row once per card (and dtype)
    static bool raised[64];
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev >= 64 || !raised[dev]) {
      err = cudaFuncSetAttribute(geom_kernel<T, true>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 ROW_BYTES + 16);
      if (err != cudaSuccess) return (int)err;
      if (dev < 64) raised[dev] = true;
    }
  }
  geom_kernel<T, true><<<E, GNT, smem, st>>>(
      static_cast<const T*>(ral), static_cast<const int*>(n0),
      static_cast<const int*>(S_e), static_cast<int*>(i0),
      static_cast<int*>(i1), nullptr, Tn, C, width);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_windows(const void* mean, const void* stdv, const void* lsr,
                   const void* i0r, void* wm, void* ws, void* wl, int E,
                   int Tn, int Q1, int Ws, void* stream) {
  const size_t n = (size_t)Q1 * E * Ws;
  if (n == 0) return 0;
  const int blocks = (int)std::min<size_t>((n + NT - 1) / NT, 132 * 16);
  const auto st = static_cast<cudaStream_t>(stream);
  windows_kernel<T><<<blocks, NT, 0, st>>>(
      static_cast<const T*>(mean), static_cast<const T*>(stdv),
      static_cast<const T*>(lsr), static_cast<const int*>(i0r),
      static_cast<T*>(wm), static_cast<T*>(ws), static_cast<T*>(wl), E, Tn,
      Q1, Ws);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int psq_geom_f32(const void* ral, const void* n0, const void* S_e,
                            void* i0, void* i1, void* scratch, int E, int Tn,
                            int C, int width, void* stream) {
  return launch_geom<float>(ral, n0, S_e, i0, i1, scratch, E, Tn, C, width,
                            stream);
}

extern "C" int psq_geom_f64(const void* ral, const void* n0, const void* S_e,
                            void* i0, void* i1, void* scratch, int E, int Tn,
                            int C, int width, void* stream) {
  return launch_geom<double>(ral, n0, S_e, i0, i1, scratch, E, Tn, C, width,
                             stream);
}

extern "C" int psq_windows_f32(const void* mean, const void* stdv,
                               const void* lsr, const void* i0r, void* wm,
                               void* ws, void* wl, int E, int Tn, int Q1,
                               int Ws, void* stream) {
  return launch_windows<float>(mean, stdv, lsr, i0r, wm, ws, wl, E, Tn, Q1,
                               Ws, stream);
}

extern "C" int psq_windows_f64(const void* mean, const void* stdv,
                               const void* lsr, const void* i0r, void* wm,
                               void* ws, void* wl, int E, int Tn, int Q1,
                               int Ws, void* stream) {
  return launch_windows<double>(mean, stdv, lsr, i0r, wm, ws, wl, E, Tn, Q1,
                                Ws, stream);
}
