// Device helpers shared by the port's kernels: sentinels, the emission
// model, the max-plus column scan and block reductions.  Every helper
// evaluates the expression tree of its PyTorch twin in engine/dp.py (the
// kernels are built with --fmad=false, so no multiply-add is fused).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>
#include <climits>

namespace psq {

constexpr int DMAX = 8;
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

// one combine in place: x[d] <- x[d] applied after x[s]
template <typename T>
__device__ __forceinline__ void combine_at(T* x, int n, int s, int d) {
  T l[6], v[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) { l[k] = x[k * n + s]; v[k] = x[k * n + d]; }
  mp_combine(l, v);
#pragma unroll
  for (int k = 0; k < 6; ++k) x[k * n + d] = v[k];
}

// dp.column_solve: inclusive max-plus scan over rows [0, n) with the
// combine tree of jax.lax.associative_scan (the twin's _assoc_scan), in
// place: an up-sweep combines adjacent pairs level by level (element k of
// level L sits at position (k+1)*2^L - 1), a down-sweep fills in the even
// elements.  reverse=True scans rows n-1 down to 0.  Thread r holds row r's
// element in v; scratch holds 6*n values.  Every thread of the block must
// call it.
template <typename T>
__device__ void mp_scan(T v[6], T* scratch, int r, int n, bool reverse) {
  if (r < n) {
#pragma unroll
    for (int k = 0; k < 6; ++k) scratch[k * n + r] = v[k];
  }
  __syncthreads();
  int nl[12];
  int levels = 0;
  nl[0] = n;
  while (nl[levels] >= 2) { nl[levels + 1] = nl[levels] >> 1; ++levels; }
  auto phys = [&](int p) { return reverse ? n - 1 - p : p; };
  for (int L = 0; L < levels; ++L) {
    for (int k = threadIdx.x; k < nl[L + 1]; k += blockDim.x)
      combine_at(scratch, n, phys(((2 * k + 1) << L) - 1),
                 phys(((k + 1) << (L + 1)) - 1));
    __syncthreads();
  }
  for (int L = levels - 1; L >= 0; --L) {
    for (int m = threadIdx.x + 1; 2 * m < nl[L]; m += blockDim.x)
      combine_at(scratch, n, phys(((2 * m) << L) - 1),
                 phys(((2 * m + 1) << L) - 1));
    __syncthreads();
  }
  if (r < n) {
#pragma unroll
    for (int k = 0; k < 6; ++k) v[k] = scratch[k * n + r];
  }
  __syncthreads();
}

// block-wide max with the FIRST index attaining it (ties -> smaller index);
// red_v / red_i hold 32 entries.  Every thread must call it; all get the
// result.
template <typename T>
__device__ void block_argmax(T& val, int& idx, T* red_v, int* red_i) {
  const unsigned full = 0xffffffffu;
  for (int off = 16; off > 0; off >>= 1) {
    T ov = __shfl_down_sync(full, val, off);
    int oi = __shfl_down_sync(full, idx, off);
    if (ov > val || (ov == val && oi < idx)) { val = ov; idx = oi; }
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) { red_v[warp] = val; red_i[warp] = idx; }
  __syncthreads();
  if (warp == 0) {
    const int nw = (blockDim.x + 31) >> 5;
    val = lane < nw ? red_v[lane] : neg_big<T>();
    idx = lane < nw ? red_i[lane] : INT_MAX;
    for (int off = 16; off > 0; off >>= 1) {
      T ov = __shfl_down_sync(full, val, off);
      int oi = __shfl_down_sync(full, idx, off);
      if (ov > val || (ov == val && oi < idx)) { val = ov; idx = oi; }
    }
    if (lane == 0) { red_v[0] = val; red_i[0] = idx; }
  }
  __syncthreads();
  val = red_v[0];
  idx = red_i[0];
  __syncthreads();
}

// block-wide max (exact in any order)
template <typename T>
__device__ T block_max(T val, T* red_v) {
  int idx = 0;
  int* scratch_i = reinterpret_cast<int*>(red_v + 32);
  block_argmax(val, idx, red_v, scratch_i);
  return val;
}

}  // namespace psq
