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
// once: 0.8 MB at E = 64, T = 1280, C = 1024 in f32), and the latency of
// one block an event.  A thread takes a contiguous run of levels (then of
// columns): the anchors' carries across runs come from per-thread
// summaries in shared memory, so each thread walks its run once forward
// (left anchors) and once back (right anchors, then ri); ri sits in shared
// memory (the left anchors pass through it first), where every column's
// bisection reads it; the rate limit's prefix minimum takes a per-thread
// minimum and a carry the same way, with i0 and i1 staged in their
// outputs.  Shared memory: T sizeof(T) + 3 NT ints, so T is at most
// 57,344 levels in f32 and 28,672 in f64
// (engine/mutscore.py:GEOM_MAX_LEVELS).
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

constexpr int NT = 256;

// ral [E, Tn]; n0, S_e [E]; i0, i1 [E, C+1]
template <typename T>
__global__ void __launch_bounds__(NT)
geom_kernel(const T* __restrict__ ral, const int* __restrict__ n0p,
            const int* __restrict__ S_ep, int* __restrict__ i0,
            int* __restrict__ i1, int Tn, int C, int width) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int* s_first = reinterpret_cast<int*>(smem_raw);   // [NT] run summaries
  int* s_last = s_first + NT;
  int* s_min = s_last + NT;
  T* sri = reinterpret_cast<T*>(s_min + NT);          // [Tn]

  const int k = threadIdx.x, e = blockIdx.x;
  const int n0 = n0p[e], S_e = S_ep[e];
  const T* ra = ral + (size_t)e * Tn;
  int* o0 = i0 + (size_t)e * (C + 1);
  int* o1 = i1 + (size_t)e * (C + 1);
  auto anch = [&](int t) { return t < n0 && ra[t] > T(0); };

  // levels [t0, t1) of this thread
  const int L = (Tn + NT - 1) / NT;
  const int t0 = min(k * L, Tn), t1 = min(t0 + L, Tn);
  int first = INT_MAX, last = -1;
  for (int t = t0; t < t1; ++t) {
    if (anch(t)) { first = min(first, t); last = t; }
  }
  s_first[k] = first;
  s_last[k] = last;
  __syncthreads();
  int ra0 = INT_MAX, ra1 = -1, left = -1, right = Tn;
  for (int j = 0; j < NT; ++j) {
    ra0 = min(ra0, s_first[j]);
    ra1 = max(ra1, s_last[j]);
    if (j < k) left = max(left, s_last[j]);
    if (j > k) right = min(right, s_first[j]);
  }
  const bool has = ra1 >= 0;
  if (!has) { ra0 = 0; ra1 = Tn - 1; }
  const T f0 = ra[ra0], f1 = ra[ra1];
  const T al_m = (f1 - f0) / T(ra1 - ra0);
  const T al_b = f0 - al_m * T(ra0);
  for (int t = t0; t < t1; ++t) {            // left anchors, through sri
    if (anch(t)) left = t;
    sri[t] = T(left);
  }
  for (int t = t1 - 1; t >= t0; --t) {       // right anchors, then ri
    if (anch(t)) right = t;
    const int lt = (int)sri[t];
    T v;
    if (!(t < n0 && has)) {
      v = pos_inf<T>();
    } else if (t < ra0 || t > ra1) {
      v = al_m * T(t) + al_b;
    } else if (!anch(t) && lt > 0) {
      const T lv = ra[min(max(lt, 0), Tn - 1)];
      const T rv = ra[min(max(right, 0), Tn - 1)];
      const T m = (rv - lv) / T(right - lt);
      v = m * T(t - lt) + lv;
    } else {
      v = ra[t];
    }
    sri[t] = v;
  }
  __syncthreads();

  // columns [q0, q1) of 1..C: band, then the rate limit's run minimum
  const int nlev = 32 - __clz(Tn);
  const int Lc = (C + NT - 1) / NT;
  const int q0 = 1 + min(k * Lc, C), q1 = 1 + min(k * Lc + Lc, C);
  int run = INT_MAX;
  for (int q = q0; q < q1; ++q) {
    const T qv = T(q);
    int low = 0, high = Tn;
    for (int l = 0; l < nlev; ++l) {
      const int mid = (low + high) >> 1;
      if (!(sri[min(mid, Tn - 1)] < qv)) high = mid;
      else low = mid;
    }
    const int imid = min(max(high, 1), max(n0, 1));
    const int lo = max(imid - width, 1);
    o0[q] = lo;
    o1[q] = min(imid + width, n0);
    run = min(run, lo - q * DMAX);
  }
  s_min[k] = run;
  __syncthreads();
  run = INT_MAX;
  for (int j = 0; j < k; ++j) run = min(run, s_min[j]);
  for (int q = q0; q < q1; ++q) {
    run = min(run, o0[q] - q * DMAX);
    const int lo = q * DMAX + run;
    o0[q] = lo;
    o1[q] = min(o1[q], lo + 2 * width);
  }
  if (k == 0) {
    o0[0] = 0;
    o1[0] = min(n0, 2 * width);
  }
  __syncthreads();
  const int anchor = o0[min(S_e, C)];        // never a column rewritten below
  for (int c = S_e + 1 + k; c <= C; c += NT) {
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

template <typename T>
int launch_geom(const void* ral, const void* n0, const void* S_e, void* i0,
                void* i1, int E, int Tn, int C, int width, void* stream) {
  if (E == 0) return 0;
  if (Tn < 1 || C < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = 3 * NT * sizeof(int) + (size_t)Tn * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      geom_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const auto st = static_cast<cudaStream_t>(stream);
  geom_kernel<T><<<E, NT, smem, st>>>(
      static_cast<const T*>(ral), static_cast<const int*>(n0),
      static_cast<const int*>(S_e), static_cast<int*>(i0),
      static_cast<int*>(i1), Tn, C, width);
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
                            void* i0, void* i1, int E, int Tn, int C,
                            int width, void* stream) {
  return launch_geom<float>(ral, n0, S_e, i0, i1, E, Tn, C, width, stream);
}

extern "C" int psq_geom_f64(const void* ral, const void* n0, const void* S_e,
                            void* i0, void* i1, int E, int Tn, int C,
                            int width, void* stream) {
  return launch_geom<double>(ral, n0, S_e, i0, i1, E, Tn, C, width, stream);
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
