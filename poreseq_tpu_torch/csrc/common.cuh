// Device helpers shared by the port's kernels: sentinels, the emission
// model, the max-plus column scan and warp-first block reductions.  Every
// helper evaluates the expression tree of its PyTorch twin in engine/dp.py
// (the kernels are built with --fmad=false, so no multiply-add is fused).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>
#include <climits>

namespace psq {

constexpr int DMAX = 8;
constexpr unsigned FULL = 0xffffffffu;
enum : uint8_t { SKIP = 0, MATCH = 1, INSERT = 2, IGNORE = 3, STAY = 4,
                 EXTEND = 5, IMPLICIT = 255 };

// finite -inf sentinel (dp.neg_big): sums of sentinels stay finite
template <typename T> __device__ __forceinline__ T neg_big();
template <> __device__ __forceinline__ float neg_big<float>() { return -1e30f; }
template <> __device__ __forceinline__ double neg_big<double>() { return -1e300; }

template <typename T>
__device__ __forceinline__ T mx(T a, T b) { return a > b ? a : b; }

// x[i] inside [0, n), else 0 (a band shift with zero fill)
template <typename T>
__device__ __forceinline__ T at_or_zero(const T* x, int i, int n) {
  return (i >= 0 && i < n) ? x[i] : T(0);
}

// dp.emission: lognormpdf(mean; level) + logigpdf(stdv; sd) + lik_offset
template <typename T>
__device__ __forceinline__ T emission(T mean_v, T stdv_v, T logx_v, T lm,
                                      T ls, T ll, T sm, T lam, T llam,
                                      T lik_offset) {
  const T LOG2PI = T(1.8378770664093453);
  T d1 = (mean_v - lm) / ls;
  T ln = T(-0.5) * (d1 * d1 + LOG2PI) - ll;
  T d2 = (stdv_v - sm) / sm;
  T lig = T(0.5) * (llam - T(3.0) * logx_v - LOG2PI - d2 * d2 * lam / stdv_v);
  return ln + lig + lik_offset;
}

// dp._mp_combine: v <- rhs (v) applied after lhs (l); elements are
// (a11, a12, a21, a22, u1, u2)
template <typename T>
__device__ __forceinline__ void mp_combine(const T l[6], T v[6]) {
  T a11 = mx(v[0] + l[0], v[1] + l[2]);
  T a12 = mx(v[0] + l[1], v[1] + l[3]);
  T a21 = mx(v[2] + l[0], v[3] + l[2]);
  T a22 = mx(v[2] + l[1], v[3] + l[3]);
  T u1 = mx(mx(v[0] + l[4], v[1] + l[5]), v[4]);
  T u2 = mx(mx(v[2] + l[4], v[3] + l[5]), v[5]);
  v[0] = a11; v[1] = a12; v[2] = a21; v[3] = a22; v[4] = u1; v[5] = u2;
}

// the u part of mp_combine, all a down-sweep needs: a final prefix is only
// ever the source (lhs) of later down-sweep combines, whose u reads the
// lhs's u alone, so the A part of a down-sweep result is never read
template <typename T>
__device__ __forceinline__ void mp_combine_u(T l4, T l5, T v[6]) {
  T u1 = mx(mx(v[0] + l4, v[1] + l5), v[4]);
  T u2 = mx(mx(v[2] + l4, v[3] + l5), v[5]);
  v[4] = u1; v[5] = u2;
}

// the element 2^L positions below, from the lane 2^L below (lanes under
// 2^L get their own); every lane of the warp must call it
template <typename T>
__device__ __forceinline__ void shfl_up6(const T v[6], T s[6], int delta) {
#pragma unroll
  for (int k = 0; k < 6; ++k) s[k] = __shfl_up_sync(FULL, v[k], delta);
}

// position p (< n) is the destination of an up-sweep combine at level L
// (its source is p - 2^L): the tree's (k+1)*2^(L+1) - 1
__device__ __forceinline__ bool up_dst(int p, int L, int n) {
  return p < n && ((p + 1) & ((2 << L) - 1)) == 0;
}

// ... of a down-sweep combine at level L: the tree's (2m+1)*2^L - 1, m >= 1
__device__ __forceinline__ bool down_dst(int p, int L, int n) {
  const int q = (p + 1) >> L;
  return p < n && ((p + 1) & ((1 << L) - 1)) == 0 && (q & 1) && q >= 3;
}

// dp.column_solve: inclusive max-plus scan over logical positions [0, n),
// n <= 1024, with the combine tree of jax.lax.associative_scan (the twin's
// _assoc_scan): the up-sweep combines position (k+1)*2^(L+1)-1 with
// (2k+1)*2^L-1 at level L, the down-sweep (2m+1)*2^L-1 with 2m*2^L-1.
// Thread t (< 32*ceil(n/32)) holds position t in v (a reversed scan is the
// caller's mapping of rows to positions).  Levels L <= 4 pair positions
// inside one aligned chunk of 32, so each warp runs them on its chunk in
// registers with shuffles (scan_up, scan_down); every combine of a level
// L >= 5 touches only the chunk tails (positions = 31 mod 32), which one
// warp scans in registers between two block barriers (scan_tails).  In the
// down-sweep the only source in another warp is the previous chunk's tail,
// final by then.  The guards are exactly those of the tree (a destination
// below n), so the same combines happen on the same operands and the result
// is bit-equal to the twin's in its u part (M, S); the down-sweep computes
// only that part (mp_combine_u), so a final A part is stale.  mp_scan runs
// the three parts with warp 0 on the tails; a kernel with a warp to spare
// calls them itself.

// up-sweep levels 0-4 on this warp's chunk; its last lane writes the
// chunk's tail to tails[k*32 + warp] (k < 6).  Every lane must call it.
template <typename T>
__device__ __forceinline__ void scan_up(T v[6], T* tails, int n) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  T s[6];
#pragma unroll
  for (int L = 0; L < 5; ++L) {
    shfl_up6(v, s, 1 << L);
    if (up_dst(t, L, n)) mp_combine(s, v);
  }
  if (lane == 31) {
#pragma unroll
    for (int k = 0; k < 6; ++k) tails[k * 32 + warp] = v[k];
  }
}

// levels >= 5, up and down, on the full chunks' tails (lane q holds chunk
// q's), in one warp, their u parts written back final; a level with no
// destination below nt is skipped (a uniform branch)
template <typename T>
__device__ __forceinline__ void scan_tails(T* tails, int n) {
  const int lane = threadIdx.x & 31, nt = n >> 5;
  T x[6], s[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) x[k] = lane < nt ? tails[k * 32 + lane] : T(0);
#pragma unroll
  for (int L = 0; L < 5; ++L) {
    if ((2 << L) > nt) break;
    shfl_up6(x, s, 1 << L);
    if (up_dst(lane, L, nt)) mp_combine(s, x);
  }
#pragma unroll
  for (int L = 4; L >= 0; --L) {
    if ((3 << L) > nt) continue;
    const T s4 = __shfl_up_sync(FULL, x[4], 1 << L);
    const T s5 = __shfl_up_sync(FULL, x[5], 1 << L);
    if (down_dst(lane, L, nt)) mp_combine_u(s4, s5, x);
  }
  if (lane < nt) {
    tails[4 * 32 + lane] = x[4];
    tails[5 * 32 + lane] = x[5];
  }
}

// down-sweep levels 4-0 on this warp's chunk, after scan_tails (or right
// after scan_up's barrier when n < 64: one tail, already final); the last
// lane takes its final tail, lane 2^L - 1 reads the previous chunk's.
// tails keeps the full chunks' final u parts (k = 4, 5) until the next
// scan_up.
template <typename T>
__device__ __forceinline__ void scan_down(T v[6], const T* tails, int n) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  if (lane == 31 && warp < (n >> 5)) {
    v[4] = tails[4 * 32 + warp];
    v[5] = tails[5 * 32 + warp];
  }
#pragma unroll
  for (int L = 4; L >= 0; --L) {
    T s4 = __shfl_up_sync(FULL, v[4], 1 << L);
    T s5 = __shfl_up_sync(FULL, v[5], 1 << L);
    if (lane == (1 << L) - 1 && warp > 0) {   // source: the previous
      s4 = tails[4 * 32 + warp - 1];           // chunk's final tail
      s5 = tails[5 * 32 + warp - 1];
    }
    if (down_dst(t, L, n)) mp_combine_u(s4, s5, v);
  }
}

// the whole scan: block barrier A after scan_up; with two or more full
// chunks, warp 0 scans their tails and barrier B follows.  idle() runs once
// in every warp: in the others while warp 0 scans, in warp 0 after.  Every
// thread of the block (blockDim = 32 * ceil(n/32)) must call it.
template <typename T, typename Idle>
__device__ void mp_scan(T v[6], T* tails, int n, Idle idle) {
  scan_up(v, tails, n);
  __syncthreads();
  if (n >= 64) {
    const bool w0 = (threadIdx.x >> 5) == 0;
    if (w0) scan_tails(tails, n);
    else idle();
    __syncthreads();
    if (w0) idle();
  } else {
    idle();
  }
  scan_down(v, tails, n);
}

template <typename T>
__device__ __forceinline__ T warp_max(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = mx(v, __shfl_xor_sync(FULL, v, off));
  return v;
}

// warp-wide max with the FIRST index attaining it (ties -> smaller index);
// every lane gets the result
template <typename T>
__device__ __forceinline__ void warp_argmax(T& val, int& idx) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    T ov = __shfl_xor_sync(FULL, val, off);
    int oi = __shfl_xor_sync(FULL, idx, off);
    if (ov > val || (ov == val && oi < idx)) { val = ov; idx = oi; }
  }
}

// (v, s) takes (ov, os) if it comes first in torch.argmax's order: NaN
// above every number, then the larger value, then the smaller index
template <typename T>
__device__ __forceinline__ void first_max(T& v, int& s, T ov, int os) {
  const bool vn = v != v, on = ov != ov;
  if (vn || on) {
    if (on && (!vn || os < s)) { v = ov; s = os; }
  } else if (ov > v || (ov == v && os < s)) {
    v = ov;
    s = os;
  }
}

// The halving tree over 1024 states (engine/viterbi.py:halving_levels),
// level L: x[c] <- x[c] op x[c + 1024 >> L].  With thread t of 256 holding
// states t + 256q, levels 1-2 are in-thread and leave level-2 value t;
// tree_level4 takes levels 3-4 at c (< 64) from the 256 level-2 values in
// shared memory: l4[c] = (x[c] op x[c+128]) op (x[c+64] op x[c+192]).
template <typename T, typename Op>
__device__ __forceinline__ T tree_level4(const T* x, int c, Op op) {
  return op(op(x[c], x[c + 128]), op(x[c + 64], x[c + 192]));
}

// levels 3-10 of the tree's sum, in one warp, from the 256 level-2 values:
// level 5 in-thread, 6-10 as shuffles (strides 16 to 1).  Every lane of
// the warp must call it; lane 0 gets the total.
template <typename T>
__device__ __forceinline__ T tree_total(const T* x) {
  const int lane = threadIdx.x & 31;
  const auto add = [](T a, T b) { return a + b; };
  T v = tree_level4(x, lane, add) + tree_level4(x, lane + 32, add);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = v + __shfl_down_sync(FULL, v, off);
  return v;
}

// block-wide max (exact in any order): each warp reduces by shuffles, warp
// 0 reduces the warps' partials (red holds 32 values).  The result is valid
// in warp 0 only.  Every thread must call it; red must not be written again
// before the block's next barrier.
template <typename T>
__device__ T block_max(T val, T* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  val = warp_max(val);
  if (lane == 0) red[warp] = val;
  __syncthreads();
  if (warp == 0) {
    const int nw = (blockDim.x + 31) >> 5;
    val = warp_max(lane < nw ? red[lane] : neg_big<T>());
  }
  return val;
}

}  // namespace psq
