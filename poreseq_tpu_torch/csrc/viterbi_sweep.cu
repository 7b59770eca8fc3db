// The 1024-state Viterbi sweep over a region's positions (kernel 4 of the
// port).
//
// Replaces poreseq_tpu/engine/tpu/viterbi.py:_viterbi_sweep_multi (XLA, a
// vmapped lax.scan over positions; with backpointers, :_viterbi_sweep;
// reference Viterbi.cpp:239-426); the plain PyTorch twin is
// engine/viterbi.py:viterbi_sweep_reference, a Python loop of about 34 torch
// ops per position.  Per row: the 1/2/3-step predecessor group maxima of
// liks (and, with backpointers, their first argmax states), the stay move,
// newlik = ob + best, and the forward probabilities f = ((sp1 g1 + sp2 g2) +
// sp3 g3) + stay fwd, f *= exp(ob), f /= total(f).  Rows past a region's
// end pass the carry (their backpointers are still computed, from it).
//
// What bounds it on this card: a chain of dependent rows, each a handful of
// 1024-wide reductions, so latency (barriers and shuffle levels), not bytes
// or operations: a region reads 4 KB of obs and writes 4 KB of fwds a row.
// The design keeps a region's liks and fwd on chip across the whole sweep,
// one block per region, 256 threads of 4 states each (thread t holds states
// t + 256q), and runs the loop over rows inside the kernel, so a call is
// one launch instead of about 34 per position.  Every reduction is the
// twin's halving tree (x <- x[:n/2] op x[n/2:]): levels 1-2 are in-thread,
// levels 3-5 one warp takes from shared memory, levels 6-10 (strides 16 to
// 1) are that warp's shuffles; levels 2, 4 and 6 are the group reductions
// for j = 1, 2, 3 and level 10 the total, so sums equal the twin's bit for
// bit (--fmad=false keeps every product and sum its own rounding).  The
// next row of obs is loaded while the current one is reduced.  Four block
// barriers a row.
#include "common.cuh"

using namespace psq;

namespace {

constexpr int NT = 256;

__device__ __forceinline__ float ex(float x) { return expf(x); }
__device__ __forceinline__ double ex(double x) { return exp(x); }

template <typename T, bool BP>
__global__ void __launch_bounds__(NT)
sweep_kernel(const T* __restrict__ obs, const int64_t* __restrict__ n_real,
             T* __restrict__ liks_out, T* __restrict__ fwds,
             int64_t* __restrict__ bps, int R, T lsp1, T lsp2, T lsp3,
             T stay_lik, T sp1, T sp2, T sp3, T stay_p) {
  const int b = blockIdx.x, t = threadIdx.x, lane = t & 31;
  const bool w0 = t < 32;
  __shared__ T gs1[256], gs2[64], gs3[16];   // group sums of fwd
  __shared__ T gm1[256], gm2[64], gm3[16];   // group maxima of liks
  __shared__ int ga1[BP ? 256 : 1], ga2[BP ? 64 : 1], ga3[BP ? 16 : 1];
  __shared__ T red[256];
  __shared__ T total;

  const int n = (int)n_real[b];
  const T* ob_b = obs + (size_t)b * R * 1024;
  T* fw_b = fwds + (size_t)b * R * 1024;
  T lk[4], fw[4], ob[4], nx[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    lk[q] = T(0);
    fw[q] = T(1.0 / 1024.0);
    nx[q] = R > 0 ? ob_b[t + 256 * q] : T(0);
  }
  const auto add = [](T a, T c) { return a + c; };
  const auto mxo = [](T a, T c) { return mx(a, c); };

  for (int row = 0; row < R; ++row) {
    T* out = fw_b + (size_t)row * 1024;
    const bool real = row < n;
    if (!BP && !real) {             // block-uniform: pass the carry
#pragma unroll
      for (int q = 0; q < 4; ++q) out[t + 256 * q] = fw[q];
      continue;
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      ob[q] = nx[q];
      if (row + 1 < R) nx[q] = ob_b[(size_t)(row + 1) * 1024 + t + 256 * q];
    }
    // levels 1-2 in-thread: level 1 pairs c = t (q 0, 2) and c = t + 256
    // (q 1, 3), level 2 pairs those two
    gs1[t] = (fw[0] + fw[2]) + (fw[1] + fw[3]);
    gm1[t] = mx(mx(lk[0], lk[2]), mx(lk[1], lk[3]));
    if (BP) {
      T va = lk[0], vb = lk[1];
      int sa = t, sb = t + 256;
      first_max(va, sa, lk[2], t + 512);
      first_max(vb, sb, lk[3], t + 768);
      first_max(va, sa, vb, sb);
      ga1[t] = sa;
    }
    __syncthreads();
    if (w0) {
      // level 4 at c = lane and lane + 32, level 5 at lane, level 6 by one
      // shuffle (lanes < 16)
      const T s4a = tree_level4(gs1, lane, add);
      const T s4b = tree_level4(gs1, lane + 32, add);
      gs2[lane] = s4a;
      gs2[lane + 32] = s4b;
      T s5 = s4a + s4b;
      s5 = s5 + __shfl_down_sync(FULL, s5, 16);
      if (lane < 16) gs3[lane] = s5;
      const T m4a = tree_level4(gm1, lane, mxo);
      const T m4b = tree_level4(gm1, lane + 32, mxo);
      gm2[lane] = m4a;
      gm2[lane + 32] = m4b;
      T m5 = mx(m4a, m4b);
      m5 = mx(m5, __shfl_down_sync(FULL, m5, 16));
      if (lane < 16) gm3[lane] = m5;
      if (BP) {
        int a4[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int c = lane + 32 * h;
          T v = gm1[c];
          int s = ga1[c];
          first_max(v, s, gm1[c + 128], ga1[c + 128]);
          T v2 = gm1[c + 64];
          int s2 = ga1[c + 64];
          first_max(v2, s2, gm1[c + 192], ga1[c + 192]);
          first_max(v, s, v2, s2);
          a4[h] = s;
          ga2[c] = s;
        }
        T v = m4a;
        int s = a4[0];
        first_max(v, s, m4b, a4[1]);
        const T ov = __shfl_down_sync(FULL, v, 16);
        const int os = __shfl_down_sync(FULL, s, 16);
        first_max(v, s, ov, os);
        if (lane < 16) ga3[lane] = s;
      }
    }
    __syncthreads();
    T f[4], nl[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int s = t + 256 * q;
      const T m1 = gm1[s >> 2] + lsp1, m2 = gm2[s >> 4] + lsp2;
      const T m3 = gm3[s >> 6] + lsp3, mstay = lk[q] + stay_lik;
      nl[q] = ob[q] + mx(mx(m1, m2), mx(m3, mstay));
      if (BP) {
        int bp = ga1[s >> 2];
        T cur = m1;
        if (m2 > cur) { bp = ga2[s >> 4]; cur = m2; }
        if (m3 > cur) { bp = ga3[s >> 6]; cur = m3; }
        if (mstay > cur) bp = s;
        bps[((size_t)b * R + row) * 1024 + s] = bp;
      }
      f[q] = ((sp1 * gs1[s >> 2] + sp2 * gs2[s >> 4]) + sp3 * gs3[s >> 6]) +
             stay_p * fw[q];
      f[q] = f[q] * ex(ob[q]);
    }
    red[t] = (f[0] + f[2]) + (f[1] + f[3]);
    __syncthreads();
    if (w0) {
      const T x = tree_total(red);
      if (lane == 0) total = x;
    }
    __syncthreads();
    const T tot = total;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (real) {
        lk[q] = nl[q];
        fw[q] = f[q] / tot;
      }
      out[t + 256 * q] = fw[q];
    }
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) liks_out[(size_t)b * 1024 + t + 256 * q] = lk[q];
}

template <typename T>
int launch(const void* obs, const void* n_real, void* liks, void* fwds,
           void* bps, int B, int R, double lsp1, double lsp2, double lsp3,
           double stay_lik, double sp1, double sp2, double sp3,
           double stay_p, void* stream) {
  if (B == 0) return 0;
  const auto st = static_cast<cudaStream_t>(stream);
  const T* o = static_cast<const T*>(obs);
  const int64_t* n = static_cast<const int64_t*>(n_real);
  if (bps)
    sweep_kernel<T, true><<<B, NT, 0, st>>>(
        o, n, static_cast<T*>(liks), static_cast<T*>(fwds),
        static_cast<int64_t*>(bps), R, T(lsp1), T(lsp2), T(lsp3),
        T(stay_lik), T(sp1), T(sp2), T(sp3), T(stay_p));
  else
    sweep_kernel<T, false><<<B, NT, 0, st>>>(
        o, n, static_cast<T*>(liks), static_cast<T*>(fwds), nullptr, R,
        T(lsp1), T(lsp2), T(lsp3), T(stay_lik), T(sp1), T(sp2), T(sp3),
        T(stay_p));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int psq_viterbi_sweep_f32(const void* obs, const void* n_real,
                                     void* liks, void* fwds, void* bps,
                                     int B, int R, double lsp1, double lsp2,
                                     double lsp3, double stay_lik, double sp1,
                                     double sp2, double sp3, double stay_p,
                                     void* stream) {
  return launch<float>(obs, n_real, liks, fwds, bps, B, R, lsp1, lsp2, lsp3,
                       stay_lik, sp1, sp2, sp3, stay_p, stream);
}

extern "C" int psq_viterbi_sweep_f64(const void* obs, const void* n_real,
                                     void* liks, void* fwds, void* bps,
                                     int B, int R, double lsp1, double lsp2,
                                     double lsp3, double stay_lik, double sp1,
                                     double sp2, double sp3, double stay_p,
                                     void* stream) {
  return launch<double>(obs, n_real, liks, fwds, bps, B, R, lsp1, lsp2, lsp3,
                        stay_lik, sp1, sp2, sp3, stay_p, stream);
}
