// Per-base likes: the DP score of each event's last aligned level at or
// before every reference index (kernel 8 of the port).
//
// Replaces poreseq_tpu/engine/tpu/align.py:device_likes (XLA: two cummax
// and a searchsorted over the backtrace output); the plain PyTorch twin is
// engine/align.py:likes_reference.  For event e with ref_align ral[e] and
// ref_like rlk[e] over T levels: A[j] = max(0, the anchors ral > 0 at
// levels <= j) and I[j] the last anchored level <= j; vals[e, k-1] for k =
// 1..n_like is rlk[I[j]] at the last j with A[j] <= k when A[j] > 0, else 0.
// A is monotone, so level j answers exactly the k with A[j] <= k <
// A[j+1] (the last level every k >= A[T-1]; no level the k < A[0]): the
// kernel walks the levels once and writes each k where it belongs.  It
// compares and copies only, so it equals the twin bit for bit.
//
// What bounds it on this card: the bytes (ral and rlk read once, vals
// written once: about 1.4 MB for 64 events of 1.3k levels at C = 1024 in
// f32), and the walk's latency.  One warp an event: each pass takes 32
// levels, the prefix max of A and I by shuffles, the carry from lane 31;
// a lane writes its level's k in order.
#include "common.cuh"

namespace {

using namespace psq;

// ral, rlk [E, Tn]; vals [E, n_like]; one warp a block, one block an event
template <typename T>
__global__ void __launch_bounds__(32)
likes_kernel(const T* __restrict__ ral, const T* __restrict__ rlk,
             T* __restrict__ vals, int Tn, int n_like) {
  const int lane = threadIdx.x;
  const T* ra = ral + (size_t)blockIdx.x * Tn;
  const T* rl = rlk + (size_t)blockIdx.x * Tn;
  T* out = vals + (size_t)blockIdx.x * n_like;
  auto anchor = [&](int j) { return ra[j] > T(0) ? ra[j] : T(0); };
  // write V at every k in [lo, hi) within [1, n_like]
  auto put = [&](T lo, T hi, T V) {
    if (lo > T(n_like)) return;
    for (int k = lo > T(1) ? (int)ceil(lo) : 1; k <= n_like && T(k) < hi;
         ++k)
      out[k - 1] = V;
  };
  if (lane == 0) put(-pos_inf<T>(), Tn > 0 ? anchor(0) : pos_inf<T>(), T(0));
  T cA = T(0);
  int cI = -1;
  for (int base = 0; base < Tn; base += 32) {
    const int j = base + lane;
    T A = j < Tn ? anchor(j) : T(0);
    int I = j < Tn && ra[j] > T(0) ? j : -1;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {          // inclusive prefix max
      const T a2 = __shfl_up_sync(FULL, A, d);
      const int i2 = __shfl_up_sync(FULL, I, d);
      if (lane >= d) { A = mx(A, a2); I = max(I, i2); }
    }
    A = mx(A, cA);
    I = max(I, cI);
    if (j < Tn) {
      const T next = j + 1 < Tn ? mx(A, anchor(j + 1)) : pos_inf<T>();
      put(A, next, A > T(0) ? rl[I] : T(0));
    }
    cA = __shfl_sync(FULL, A, 31);
    cI = __shfl_sync(FULL, I, 31);
  }
}

template <typename T>
int launch(const void* ral, const void* rlk, void* vals, int E, int Tn,
           int n_like, void* stream) {
  if (E == 0 || n_like == 0) return 0;
  const auto st = static_cast<cudaStream_t>(stream);
  likes_kernel<T><<<E, 32, 0, st>>>(static_cast<const T*>(ral),
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
