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

template <typename T> __device__ __forceinline__ T pos_inf();
template <> __device__ __forceinline__ float pos_inf<float>() {
  return __int_as_float(0x7f800000);
}
template <> __device__ __forceinline__ double pos_inf<double>() {
  return __longlong_as_double(0x7ff0000000000000LL);
}

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
// n <= 1024 RPT, with the combine tree of jax.lax.associative_scan (the
// twin's _assoc_scan): the up-sweep combines position (k+1)*2^(L+1)-1 with
// (2k+1)*2^L-1 at level L, the down-sweep (2m+1)*2^L-1 with 2m*2^L-1.
// Thread t (< 32*ceil(n/(32 RPT))) holds the RPT adjacent positions t RPT +
// j in v[j] (RPT = 1, 2 or 4; a reversed scan is the caller's mapping of
// rows to positions).  Levels L < LR = log2(RPT) pair positions inside one
// thread, so they run in its registers (up before, down after the rest);
// levels LR..LR+4 pair the threads' last positions (t RPT + RPT - 1) inside
// one aligned chunk of 32 RPT, so each warp runs them on its chunk with
// shuffles (scan_up, scan_down); every combine of a level L >= LR+5 touches
// only the chunk tails (positions = -1 mod 32 RPT), which one warp scans in
// registers between two block barriers (scan_tails).  In the down-sweep the
// only source in another warp is the previous chunk's tail, and the only
// source of an in-thread level in another thread is the previous thread's
// last position, both final by then.  The guards are exactly those of the
// tree (a destination below n), so the same combines happen on the same
// operands and the result is bit-equal to the twin's in its u part (M, S);
// the down-sweep computes only that part (mp_combine_u), so a final A part
// is stale.  mp_scan runs the three parts with warp 0 on the tails; a
// kernel with a warp to spare calls them itself.  RPT = 1 is the one-row-a-
// thread scan of the kernels' narrow instances (n <= 1024).

template <int RPT>
__host__ __device__ constexpr int log2_rpt() {
  static_assert(RPT == 1 || RPT == 2 || RPT == 4, "RPT is 1, 2 or 4");
  return RPT == 1 ? 0 : RPT == 2 ? 1 : 2;
}

// up-sweep levels 0-(LR+4) on this warp's chunk; its last lane writes the
// chunk's tail to tails[k*32 + warp] (k < 6).  Every lane must call it.
// base: the block's first position, a multiple of its blockDim RPT
// positions (the cluster instance's CTA k holds [k S, (k+1) S)), so every
// guard is the tree's on global positions.
template <typename T, int RPT>
__device__ __forceinline__ void scan_up(T (&v)[RPT][6], T* tails, int n,
                                        int base = 0) {
  constexpr int LR = log2_rpt<RPT>();
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int last = base + t * RPT + RPT - 1;
#pragma unroll
  for (int L = 0; L < LR; ++L) {
#pragma unroll
    for (int j = (2 << L) - 1; j < RPT; j += 2 << L)
      if (up_dst(last - (RPT - 1) + j, L, n)) mp_combine(v[j - (1 << L)], v[j]);
  }
  T* x = v[RPT - 1];
  T s[6];
#pragma unroll
  for (int L = 0; L < 5; ++L) {
    shfl_up6(x, s, 1 << L);
    if (up_dst(last, L + LR, n)) mp_combine(s, x);
  }
  if (lane == 31) {
#pragma unroll
    for (int k = 0; k < 6; ++k) tails[k * 32 + warp] = x[k];
  }
}

// levels >= LR+5, up and down, on the full chunks' tails (lane q holds
// chunk q's), in one warp, their u parts written back final; a level with
// no destination below nt is skipped (a uniform branch)
template <typename T, int RPT = 1>
__device__ __forceinline__ void scan_tails(T* tails, int n) {
  const int lane = threadIdx.x & 31, nt = n >> (5 + log2_rpt<RPT>());
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

// down-sweep levels (LR+4)-0 on this warp's chunk, after scan_tails (or
// right after scan_up's barrier when n < 64 RPT: one tail, already final);
// the last lane takes its final tail, lane 2^L - 1 reads the previous
// chunk's; then the in-thread levels, whose one outside source is the
// previous thread's last position (lane 0: the previous chunk's tail).
// tails keeps the full chunks' final u parts (k = 4, 5) until the next
// scan_up.  base as in scan_up; prev: the final u part at base - 1 (the
// cluster instance's previous CTA's last position), warp 0's outside
// source, or null (base 0).
template <typename T, int RPT>
__device__ __forceinline__ void scan_down(T (&v)[RPT][6], const T* tails,
                                          int n, int base = 0,
                                          const T* prev = nullptr) {
  constexpr int LR = log2_rpt<RPT>();
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int last = base + t * RPT + RPT - 1;
  T* x = v[RPT - 1];
  if (lane == 31 && warp + (base >> (5 + LR)) < (n >> (5 + LR))) {
    x[4] = tails[4 * 32 + warp];
    x[5] = tails[5 * 32 + warp];
  }
#pragma unroll
  for (int L = 4; L >= 0; --L) {
    T s4 = __shfl_up_sync(FULL, x[4], 1 << L);
    T s5 = __shfl_up_sync(FULL, x[5], 1 << L);
    if (lane == (1 << L) - 1 && (warp > 0 || prev)) {  // source: the
      s4 = warp > 0 ? tails[4 * 32 + warp - 1] : prev[0];  // previous
      s5 = warp > 0 ? tails[5 * 32 + warp - 1] : prev[1];  // chunk's tail
    }
    if (down_dst(last, L + LR, n)) mp_combine_u(s4, s5, x);
  }
  if constexpr (RPT > 1) {
    T q4 = __shfl_up_sync(FULL, x[4], 1);
    T q5 = __shfl_up_sync(FULL, x[5], 1);
    if (lane == 0 && (warp > 0 || prev)) {
      q4 = warp > 0 ? tails[4 * 32 + warp - 1] : prev[0];
      q5 = warp > 0 ? tails[5 * 32 + warp - 1] : prev[1];
    }
#pragma unroll
    for (int L = LR - 1; L >= 0; --L) {
#pragma unroll
      for (int j = (1 << L) - 1; j < RPT - 1; j += 2 << L) {
        if (!down_dst(last - (RPT - 1) + j, L, n)) continue;
        if (j < (1 << L)) mp_combine_u(q4, q5, v[j]);
        else mp_combine_u(v[j - (1 << L)][4], v[j - (1 << L)][5], v[j]);
      }
    }
  }
}

// the whole scan: block barrier A after scan_up; with two or more full
// chunks, warp 0 scans their tails and barrier B follows.  idle() runs once
// in every warp: in the others while warp 0 scans, in warp 0 after.  Every
// thread of the block (blockDim = 32 * ceil(n/(32 RPT))) must call it.
template <typename T, int RPT, typename Idle>
__device__ void mp_scan(T (&v)[RPT][6], T* tails, int n, Idle idle) {
  scan_up<T, RPT>(v, tails, n);
  __syncthreads();
  if (n >= 64 * RPT) {
    const bool w0 = (threadIdx.x >> 5) == 0;
    if (w0) scan_tails<T, RPT>(tails, n);
    else idle();
    __syncthreads();
    if (w0) idle();
  } else {
    idle();
  }
  scan_down<T, RPT>(v, tails, n);
}

// The wide instances' scan (bands past 1024 RPT rows, whose six scan values
// a column outrun the registers): the same combine tree on positions [0, n)
// held in memory, sc[k * n + p] (k < 6; shared memory, or a block's slice
// of a device scratch), level by level: up-sweep level L combines position
// (k+1)*2^(L+1)-1 with (2k+1)*2^L-1 for every k < n >> (L+1), down-sweep
// level L (2m+1)*2^L-1 with 2m*2^L-1 for every m >= 1 below n; the threads
// of the block stride over a level's pairs, whose destinations and sources
// are disjoint, with a block barrier after each level.  As in mp_scan the
// down-sweep computes the u part only.  Every thread of the block must call
// it, after a barrier that makes sc's elements visible; for n >= 2 it ends on
// one.
template <typename T>
__device__ void mp_scan_mem(T* sc, int n) {
  const int t = threadIdx.x, nt = blockDim.x;
  const size_t sn = (size_t)n;
  int L = 0;
  for (; (2 << L) <= n; ++L) {
    const int np = n >> (L + 1);
    for (int k = t; k < np; k += nt) {
      const int d = ((k + 1) << (L + 1)) - 1, s = d - (1 << L);
      T l[6], v[6];
#pragma unroll
      for (int j = 0; j < 6; ++j) {
        l[j] = sc[j * sn + s];
        v[j] = sc[j * sn + d];
      }
      mp_combine(l, v);
#pragma unroll
      for (int j = 0; j < 6; ++j) sc[j * sn + d] = v[j];
    }
    __syncthreads();
  }
  for (--L; L >= 0; --L) {
    const int nd = ((n >> L) - 1) >> 1;
    for (int m = 1 + t; m <= nd; m += nt) {
      const int d = ((2 * m + 1) << L) - 1, s = d - (1 << L);
      T v[6];
#pragma unroll
      for (int j = 0; j < 6; ++j) v[j] = sc[j * sn + d];
      mp_combine_u(sc[4 * sn + s], sc[5 * sn + s], v);
      sc[4 * sn + d] = v[4];
      sc[5 * sn + d] = v[5];
    }
    __syncthreads();
  }
}

// Thread-block clusters (sm_90): the CTA's rank in its cluster, the
// cluster barrier in two halves (arrive releases the caller's earlier
// writes, shared and distributed; wait acquires every other thread's; each
// thread alternates them), and a pointer into another CTA's shared memory
// (the generic address of the same variable in CTA `rank`).
__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait;" ::: "memory");
}
template <typename P>
__device__ __forceinline__ P* cluster_map(P* p, unsigned rank) {
  uint64_t out;
  asm volatile("mapa.u64 %0, %1, %2;"
               : "=l"(out)
               : "l"(reinterpret_cast<uint64_t>(p)), "r"(rank));
  return reinterpret_cast<P*>(out);
}

// The cluster instance's scan (fill.cu, bands past 4095 rows): positions
// [0, n) over the `ncta` CTAs of a cluster, CTA `rank` holding [base, base
// + S), S = blockDim RPT a power of two, thread t its positions base + t RPT
// + j, with the combine tree of mp_scan (the twin's _assoc_scan).  The
// levels below log2 S pair positions of one CTA: the in-thread and warp
// levels run as in mp_scan (scan_up, scan_down on global positions), the
// chunk tails' levels in warp 0.  The levels above pair CTA tails (last
// positions, (k+1) S - 1), whose up-sweep values are the full CTAs'
// totals: each full CTA sends its total to every higher rank's tops
// ([6][32], lane k: rank k's), and after the cluster barrier warp 0 of
// every CTA runs those levels over the totals of ranks up to its own
// (lanes above zero: a lane's result reads only lanes below it, so its own
// and rank - 1's are the tree's).  Its own lane's u part is its last
// position's final value (written to its tails, where scan_down takes
// it); rank - 1's, the previous CTA's last position, is the one outside
// source of its down-sweep (pref[2]): the first destination of each level
// below log2 S.  The same combines on the same operands, so the u part is
// bit-equal to the twin's (a NumPy model, tests/test_torch_warp_scan.py
// cluster_scan_model, holds the schedule).  Block barriers A and B as in
// mp_scan, one cluster barrier; idle() runs in the other warps while
// warp 0 waits on it, in warp 0 after B.  Every thread of every CTA must
// call it; tops must not be written again before the cluster's next
// barrier.
template <typename T, int RPT, typename Idle>
__device__ void mp_scan_cluster(T (&v)[RPT][6], T* tails, T* tops, T* pref,
                                int n, int base, unsigned rank,
                                unsigned ncta, Idle idle) {
  constexpr int LR = log2_rpt<RPT>();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nch = blockDim.x >> 5;              // chunks a CTA
  const int c0 = base >> (5 + LR), ntg = n >> (5 + LR);
  const unsigned nfull = n / (nch << (5 + LR));  // full CTAs
  scan_up<T, RPT>(v, tails, n, base);
  __syncthreads();                               // A
  T x[6], s[6];
  if (warp == 0) {              // the chunk tails' up-sweep
    const bool mine = lane < nch, full = mine && c0 + lane < ntg;
#pragma unroll
    for (int k = 0; k < 6; ++k) x[k] = full ? tails[k * 32 + lane] : T(0);
#pragma unroll
    for (int L = 0; L < 5; ++L) {
      if ((2 << L) > nch) break;
      shfl_up6(x, s, 1 << L);
      if (mine && up_dst(c0 + lane, L, ntg)) mp_combine(s, x);
    }
    T tot[6];                   // the CTA's total: its last chunk's tail
#pragma unroll
    for (int k = 0; k < 6; ++k) tot[k] = __shfl_sync(FULL, x[k], nch - 1);
    if (rank < nfull && lane > (int)rank && lane < (int)ncta) {
      T* dst = cluster_map(tops, lane);
#pragma unroll
      for (int k = 0; k < 6; ++k) dst[k * 32 + rank] = tot[k];
    }
    cluster_arrive();
    cluster_wait();
    T y[6];                     // the levels above log2 S
#pragma unroll
    for (int k = 0; k < 6; ++k)
      y[k] = lane < (int)rank ? tops[k * 32 + lane]
                              : lane == (int)rank && rank < nfull ? tot[k]
                                                                  : T(0);
#pragma unroll
    for (int L = 0; L < 5; ++L) {
      if ((2 << L) > (int)nfull) break;
      shfl_up6(y, s, 1 << L);
      if (up_dst(lane, L, nfull)) mp_combine(s, y);
    }
#pragma unroll
    for (int L = 4; L >= 0; --L) {
      if ((3 << L) > (int)nfull) continue;
      const T s4 = __shfl_up_sync(FULL, y[4], 1 << L);
      const T s5 = __shfl_up_sync(FULL, y[5], 1 << L);
      if (down_dst(lane, L, nfull)) mp_combine_u(s4, s5, y);
    }
    const int pl = rank > 0 ? rank - 1 : 0;
    const T p4 = __shfl_sync(FULL, y[4], pl);
    const T p5 = __shfl_sync(FULL, y[5], pl);
    const T o4 = __shfl_sync(FULL, y[4], rank);
    const T o5 = __shfl_sync(FULL, y[5], rank);
    // the chunk tails' down-sweep, from the previous CTA's last position
#pragma unroll
    for (int L = 4; L >= 0; --L) {
      if ((2 << L) > nch) continue;
      T s4 = __shfl_up_sync(FULL, x[4], 1 << L);
      T s5 = __shfl_up_sync(FULL, x[5], 1 << L);
      if (lane == (1 << L) - 1 && rank > 0) { s4 = p4; s5 = p5; }
      if (mine && down_dst(c0 + lane, L, ntg)) mp_combine_u(s4, s5, x);
    }
    if (lane == nch - 1 && rank < nfull) { x[4] = o4; x[5] = o5; }
    if (full) {
      tails[4 * 32 + lane] = x[4];
      tails[5 * 32 + lane] = x[5];
    }
    if (lane == 0) { pref[0] = p4; pref[1] = p5; }
  } else {
    cluster_arrive();
    idle();
    cluster_wait();
  }
  __syncthreads();                               // B
  if (warp == 0) idle();
  scan_down<T, RPT>(v, tails, n, base, rank > 0 ? pref : nullptr);
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
// level L: x[c] <- x[c] op x[c + 1024 >> L].  The Viterbi kernels' lane
// layout (viterbi_sweep.cu: a team of 8 warps; viterbi_sample.cu: 4).
// A chain runs on a team of TEAM warps, the block's first.  Lane l of warp
// w holds the states l + 32m, m = w + TEAM q for q < 32 / TEAM.  Level L
// (1..5) of the halving tree pairs state c with c + (1024 >> L), that is m
// with m + (16 >> (L-1)) on the same lane: it is in-thread while that
// stride is a multiple of TEAM (levels 1-2 for 8 warps, 1-3 for 4), then
// each warp's one remaining value goes through shared memory once and every
// warp finishes levels up to 5 itself; levels 6-10 (strides 16 to 1) are
// shuffles.  Each level keeps the tree's pairs, so every result is the
// twin's bit for bit.
template <int TEAM>
__device__ __forceinline__ int team_state(int l, int w, int q) {
  static_assert(TEAM == 4 || TEAM == 8, "a team is 4 or 8 warps");
  return l + 32 * (w + TEAM * q);
}

// named barrier id (never __syncthreads' 0) over n threads: wait for all
// n, or arrive without waiting; both order the caller's shared-memory
// accesses before the barrier's completion
__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(n) : "memory");
}

// the team's barrier: named barrier 1 over its TEAM * 32 threads, the
// block's first warps
template <int TEAM>
__device__ __forceinline__ void team_sync() {
  named_sync(1, TEAM * 32);
}

// (value, state) of a first-max tree
template <typename T>
struct ValIdx {
  T v;
  int s;
};

template <typename T>
__device__ __forceinline__ ValIdx<T> first_of(ValIdx<T> a, ValIdx<T> b) {
  first_max(a.v, a.s, b.v, b.s);
  return a;
}

template <typename T>
__device__ __forceinline__ T shfl_down(T v, int d) {
  return __shfl_down_sync(FULL, v, d);
}
template <typename T>
__device__ __forceinline__ ValIdx<T> shfl_down(ValIdx<T> e, int d) {
  return {__shfl_down_sync(FULL, e.v, d), __shfl_down_sync(FULL, e.s, d)};
}

// in-thread level L of a lane's values: x[q] = op(x[q], x[q + n]) for
// q < n = (16 >> (L - 1)) / TEAM (m and m + TEAM n, the tree's pair)
template <int TEAM, int L, typename E, typename Op>
__device__ __forceinline__ void level_in(E* x, Op op) {
  constexpr int n = (16 >> (L - 1)) / TEAM;
#pragma unroll
  for (int q = 0; q < n; ++q) x[q] = op(x[q], x[q + n]);
}

// the in-thread levels (1-2 for 8 warps, 1-3 for 4) on a lane's 32 / TEAM
// values; returns the last, the value at l + 32w.  With g1 the level-2
// values are stored at their tree index l + 32(w + TEAM q).
template <int TEAM, typename E, typename Op>
__device__ __forceinline__ E thread_levels(E* x, Op op, E* g1, int l, int w) {
  level_in<TEAM, 1>(x, op);
  level_in<TEAM, 2>(x, op);
  if (g1) {
#pragma unroll
    for (int q = 0; q < 8 / TEAM; ++q) g1[team_state<TEAM>(l, w, q)] = x[q];
  }
  if constexpr (TEAM == 4) level_in<TEAM, 3>(x, op);
  return x[0];
}

// the rest of levels 1-5 from xb, the team's values at l + 32m' (m' <
// TEAM), computed by every warp; with g2 the level-4 values go to g2[c],
// c < 64.  Returns level 5 at c = l.
template <int TEAM, typename E, typename Op>
__device__ __forceinline__ E exchange_levels(const E* xb, Op op, E* g2,
                                             int l) {
  E y[TEAM];
#pragma unroll
  for (int m = 0; m < TEAM; ++m) y[m] = xb[l + 32 * m];
  if constexpr (TEAM == 8) level_in<1, 3>(y, op);
  level_in<1, 4>(y, op);
  if (g2) {
    g2[l] = y[0];
    g2[l + 32] = y[1];
  }
  level_in<1, 5>(y, op);
  return y[0];
}

// a / tot, tot a row's total, tot_ok whether it is positive and finite
// (the same on every lane), with the divide's bits.  The divide's check
// sends a zero or subnormal numerator to its slow path, and about half of
// a row's numerators are zero, so a plain divide set the pace of both
// Viterbi chains (PERF.md §6).  Here a zero numerator never reaches the
// divide (1 stands in for it; 0 / tot is that zero when tot_ok), and in
// f32 the quotient is taken in f64, where an f32 subnormal is normal, then
// rounded to f32: the same bits as the f32 divide, since f64 carries more
// than 2 * 24 + 2 bits (so rounding the quotient twice is innocuous).
template <typename T>
__device__ __forceinline__ T div_total(T a, T tot, bool tot_ok) {
  const bool zero = a == T(0) && tot_ok;
  if constexpr (sizeof(T) == 4) {
    const double q = (zero ? 1.0 : (double)a) / (double)tot;
    return zero ? a : (T)q;
  } else {
    const T q = (zero ? T(1) : a) / tot;
    return zero ? a : q;
  }
}

// torch.argmax's order as an unsigned key: NaN above every number, -0
// equal to +0, a larger value a larger key (the sign-magnitude bits made
// monotone)
__device__ __forceinline__ uint32_t order_key(float v) {
  const uint32_t u = __float_as_uint(v + 0.0f);
  return v != v ? 0xFFFFFFFFu : (u >> 31 ? ~u : u | 0x80000000u);
}
__device__ __forceinline__ uint64_t order_key(double v) {
  const uint64_t u = (uint64_t)__double_as_longlong(v + 0.0);
  return v != v ? ~0ull : (u >> 63 ? ~u : u | (1ull << 63));
}

// the warp's first maximum of (key, state), torch.argmax's winner: the
// largest key, the smallest state among its holders, by the hardware's
// integer reductions (a 64-bit key in two halves); every lane gets it
__device__ __forceinline__ void warp_first_max(uint32_t& key, int& s) {
  const uint32_t k = __reduce_max_sync(FULL, key);
  s = __reduce_min_sync(FULL, key == k ? s : INT_MAX);
  key = k;
}
__device__ __forceinline__ void warp_first_max(uint64_t& key, int& s) {
  const uint32_t hi = __reduce_max_sync(FULL, (uint32_t)(key >> 32));
  const uint32_t lo = __reduce_max_sync(
      FULL, (uint32_t)(key >> 32) == hi ? (uint32_t)key : 0u);
  const uint64_t k = ((uint64_t)hi << 32) | lo;
  s = __reduce_min_sync(FULL, key == k ? s : INT_MAX);
  key = k;
}

// levels 6-10 of a sum by xor shuffles: every lane gets the total (a + b
// equals b + a, so the upper half of each pair holds the same value)
template <typename T>
__device__ __forceinline__ T shuffle_total(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = v + __shfl_xor_sync(FULL, v, off);
  return v;
}

// 16 bytes from device to shared memory, asynchronously (cp.async)
__device__ __forceinline__ void copy16_async(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d), "l"(src)
               : "memory");
}
__device__ __forceinline__ void copies_wait() {
  asm volatile("cp.async.wait_all;" ::: "memory");
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
