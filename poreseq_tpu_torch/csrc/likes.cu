// Per-base likes: the DP score of each event's last aligned level at or
// before every reference index (kernel 8 of the port).
//
// Replaces poreseq_tpu/engine/tpu/align.py:device_likes (XLA: two cummax
// and a searchsorted over the backtrace output); the plain PyTorch twin is
// engine/align.py:likes_reference.  For event e with ref_align ral[e] and
// ref_like rlk[e] over T levels: A[j] = max(0, the anchors ral > 0 at
// levels <= j) and I[j] the last anchored level <= j; vals[e, k-1] for k =
// 1..n_like is rlk[I[j]] at the last j with A[j] <= k when A[j] > 0, else 0.
// It compares and copies only, so it equals the twin bit for bit.
//
// What bounds it on this card: the bytes (ral and rlk read once, vals
// written once: about 1.1 MB for 96 events of 1024 levels at C = 1024 in
// f32, engine/roofline.py:likes_work), and at that size a launch's latency.
// The design has no serial walk: a block of NT = 1024 threads takes an
// event's levels NT at a time (a chunk, one level a thread, loads
// coalesced).  One block scan (warp shuffles, then the 32 warp totals
// through shared memory) gives each level A and I, with the carry of the
// chunks before; A and V[j] (rlk[I[j]] when A[j] > 0, else 0) stay in
// shared memory.  A is monotone, so the k a chunk answers are one range:
// from the least k >= A at its first level (k = 1 for the first chunk) to
// below A at the next chunk's first level (n_like for the last).  Then the
// outputs are written by output: thread t takes k = first + t, + NT, ...,
// finds the last level with A <= k by binary search in shared memory (the
// twin's searchsorted(A, k, right=True) - 1) and stores V there, or 0 when
// there is none; stores are coalesced, and every k is written once.
#include "common.cuh"

namespace {

using namespace psq;

constexpr int NT = 1024;    // threads a block, levels a chunk

// ral, rlk [E, Tn]; vals [E, n_like]; one block an event
template <typename T>
__global__ void __launch_bounds__(NT)
likes_kernel(const T* __restrict__ ral, const T* __restrict__ rlk,
             T* __restrict__ vals, int Tn, int n_like) {
  __shared__ T s_A[NT], s_V[NT], s_rl[NT], s_wA[NT / 32];
  __shared__ int s_wI[NT / 32];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const T* ra = ral + (size_t)blockIdx.x * Tn;
  const T* rl = rlk + (size_t)blockIdx.x * Tn;
  T* out = vals + (size_t)blockIdx.x * n_like;
  // the least k >= 1 with k >= a (n_like + 1 past the end)
  auto kceil = [&](T a) {
    if (!(a > T(1))) return 1;
    if (a > T(n_like)) return n_like + 1;
    return (int)ceil(a);
  };
  if (Tn == 0) {
    for (int k = t; k < n_like; k += NT) out[k] = T(0);
    return;
  }
  T cA = T(0), cV = T(0);       // A and V at the chunks' last level so far
  int klo = 1;
  for (int c0 = 0; c0 < Tn; c0 += NT) {
    const int n = min(NT, Tn - c0);
    T a = T(0);
    int I = -1;
    if (t < n) {
      const T x = ra[c0 + t];
      s_rl[t] = rl[c0 + t];
      if (x > T(0)) { a = x; I = t; }
    }
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {          // inclusive prefix max
      const T a2 = __shfl_up_sync(FULL, a, d);
      const int i2 = __shfl_up_sync(FULL, I, d);
      if (lane >= d) { a = mx(a, a2); I = max(I, i2); }
    }
    if (lane == 31) { s_wA[warp] = a; s_wI[warp] = I; }
    __syncthreads();
    if (warp == 0) {                            // the warp totals' prefix
      T wa = lane < NT / 32 ? s_wA[lane] : T(0);
      int wi = lane < NT / 32 ? s_wI[lane] : -1;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const T a2 = __shfl_up_sync(FULL, wa, d);
        const int i2 = __shfl_up_sync(FULL, wi, d);
        if (lane >= d) { wa = mx(wa, a2); wi = max(wi, i2); }
      }
      if (lane < NT / 32) { s_wA[lane] = wa; s_wI[lane] = wi; }
    }
    __syncthreads();
    if (warp > 0) { a = mx(a, s_wA[warp - 1]); I = max(I, s_wI[warp - 1]); }
    a = mx(a, cA);
    // the anchor of I is in this chunk, else (a > 0 from the carry) before
    const T V = a > T(0) ? (I >= 0 ? s_rl[I] : cV) : T(0);
    if (t < n) { s_A[t] = a; s_V[t] = V; }
    __syncthreads();
    const T aN = s_A[n - 1];
    int khi = n_like + 1;
    if (c0 + NT < Tn) {
      const T x = ra[c0 + NT];
      khi = kceil(mx(aN, x > T(0) ? x : T(0)));
    }
    for (int k = klo + t; k < khi; k += NT) {
      const T kv = T(k);
      int lo = 0, hi = n;                       // the count of A <= k
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (s_A[mid] <= kv) lo = mid + 1; else hi = mid;
      }
      out[k - 1] = lo > 0 ? s_V[lo - 1] : T(0);
    }
    klo = khi;
    cA = aN;
    cV = s_V[n - 1];
    __syncthreads();              // the next chunk overwrites shared memory
  }
}

template <typename T>
int launch(const void* ral, const void* rlk, void* vals, int E, int Tn,
           int n_like, void* stream) {
  if (E == 0 || n_like == 0) return 0;
  const auto st = static_cast<cudaStream_t>(stream);
  likes_kernel<T><<<E, NT, 0, st>>>(static_cast<const T*>(ral),
                                    static_cast<const T*>(rlk),
                                    static_cast<T*>(vals), Tn, n_like);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int psq_likes_f32(const void* ral, const void* rlk, void* vals,
                             int E, int Tn, int n_like, void* stream) {
  return launch<float>(ral, rlk, vals, E, Tn, n_like, stream);
}

extern "C" int psq_likes_f64(const void* ral, const void* rlk, void* vals,
                             int E, int Tn, int n_like, void* stream) {
  return launch<double>(ral, rlk, vals, E, Tn, n_like, stream);
}
