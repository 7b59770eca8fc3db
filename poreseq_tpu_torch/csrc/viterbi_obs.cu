// The Viterbi observations: per-state trimmed-mean emission log-likelihoods
// (kernel 7 of the port).
//
// Replaces poreseq_tpu/engine/tpu/viterbi.py:_obs_device (batched in
// :_obs_multi_fn), an XLA program that builds [B, R, E, 1024] emissions and
// sorts them over events; the plain PyTorch twin is
// engine/viterbi.py:obs_multi_reference.  For region b, row r and state s:
// the emission of every valid event e (dp.emission with the stdv clamped to
// 1e-30, no offset), the nskip = floor(nlik / 4) smallest (value, event
// index) pairs dropped (none when that leaves fewer than 2 or nlik <= 1; of
// equal values the lower index goes first), the rest summed in event index
// order and divided by max(nlik - nskip, 1).  Built with --fmad=false, the
// emission is the twin's expression tree and the sum its order, so the
// result equals the twin's bit for bit.
//
// What bounds it on this card: the operations, about 20 an emission (three
// of them IEEE divides) over the valid (row, event, state) triples: at
// phase 2b's shape (8 regions, 960 rows, E_pad 14, about 5 valid events a
// real row) 36 M emissions, 0.011 ms at the f32 peak
// (engine/roofline.py:viterbi_obs_work, which counts the model tables once
// per valid (region, event)).  The tables [B, 6, E, 1024] belong to the
// region, not the row, so the design reads them once per tile of rows and
// computes each emission once:
//
// - The tiled path (E <= CAP = 32, which max_coverage = 30 reads keeps):
//   a block owns one region, NS = 128 states and RT = 16 rows, with RG = 2
//   threads a state (thread group g takes rows g, g + RG, ... of the tile:
//   two warps a state slice double the warps that the staged tables allow
//   an SM).  It stages the region's tables for its states in shared memory
//   [6][E][NS] with cp.async (16 bytes a copy, all in flight at once; a
//   thread reads its own column: no bank conflict) and each row's valid
//   events, compacted in event order by one warp ballot (mean, clamped
//   stdv, its log, the event index; every row's loads in flight before the
//   ballots), then walks its rows.  A row's emissions go into registers
//   v[CAP] (loops unrolled over the cap with an exit at the row's nlik, so
//   no array is indexed dynamically); nskip passes over them mark the
//   least not yet dropped, the first of equal values (a bit mask), and the
//   kept values are summed in event order.  Every branch on the row is
//   uniform over the thread group.  Shared memory: RT E 16 (f32) or 32
//   (f64) bytes of row data and 6 E NS sizeof(T) of tables: 213 KB at
//   E = 32 in f64.  The loop over a row's events is a chain of shared
//   memory loads (the event, then its tables) and divides: it is bound by
//   their latency, which the warps an SM can hold (32 at E_pad 14)
//   hide only in part.
// - The general paths (E > CAP; the main path does not reach them): a block
//   holds one row's 256 states and reads the tables from device memory.
//   The staged path (E <= STAGED_EVENTS) keeps the row's level data in
//   shared memory (E (3 sizeof(T) + 1) bytes); past it the level data is
//   read from device memory as each emission needs it (every thread of a
//   block reads the same event at a time: one broadcast load a warp), the
//   stdv's clamp and log recomputed with the emission.  A row with a trim
//   finds the drop threshold, the nskip-th smallest (value, index), in a
//   sorted list of KBUF registers (nskip <= KBUF), or else by bisecting the
//   values' order keys (common.cuh:order_key: a larger value a larger key,
//   -0 and +0 one key): one pass over the row's emissions a key bit (32 in
//   f32, 64 in f64) counts the valid events below the bit's midpoint, then
//   one pass finds the rank-th event of the threshold's key in event order
//   (the tie by index), so O(E bits) emissions where nskip passes took
//   O(E nskip); then it recomputes each emission and sums those after the
//   threshold, in event order.  Each pass streams the block's tables from
//   device memory again (6 E NT sizeof(T) bytes), 34 passes in f32 and 66
//   in f64 for a trimmed row: a simple path that is right, not a fast one.
#include "common.cuh"

namespace {

using namespace psq;

constexpr int CAP = 32;     // the tiled path's events a row at most
constexpr int NS = 128;     // states per block, tiled path
constexpr int RG = 2;       // row groups per block, tiled path
constexpr int RT = 16;      // rows per block, tiled path
constexpr int NW = NS * RG / 32;     // warps per block, tiled path
constexpr int RW = RT / NW;          // rows each warp stages
static_assert(RT % NW == 0, "a whole number of rows for each warp to stage");
constexpr int NT = 256;     // states per block, general paths
constexpr int KBUF = 8;     // the general paths' register drop list
// the staged path's events a row at most (engine/viterbi.py obs_path)
constexpr int STAGED_EVENTS = 8192;
enum Path : int { TILED = 0, STAGED = 1, UNSTAGED = 2 };

__device__ __forceinline__ float lg(float x) { return logf(x); }
__device__ __forceinline__ double lg(double x) { return log(x); }

// (a, ia) comes before (b, ib): by value, then by event index
template <typename T>
__device__ __forceinline__ bool before(T a, int ia, T b, int ib) {
  return a < b || (a == b && ia < ib);
}

// one valid event of a row: mean, clamped stdv, its log, the event index
template <typename T>
struct alignas(16) Ev {
  T lvl, sdc, lsd;
  int e;
};

// tiled path.  lvl, sd, valid [B, R, E]; tabs [B, 6, E, 1024]; obs [B, R,
// 1024]; grid (1024 / NS, ceil(R / RT), B)
template <typename T>
__global__ void __launch_bounds__(NS * RG)
obs_kernel(const T* __restrict__ lvl, const T* __restrict__ sd,
           const uint8_t* __restrict__ valid, const T* __restrict__ tabs,
           T* __restrict__ obs, int R, int E) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Ev<T>* s_ev = reinterpret_cast<Ev<T>*>(smem_raw);          // [RT][E]
  T* s_tab = reinterpret_cast<T*>(s_ev + RT * E);             // [6][E][NS]
  int* s_nlik = reinterpret_cast<int*>(s_tab + 6 * E * NS);   // [RT]

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int s = t % NS, g = t / NS;
  const int s0 = blockIdx.x * NS, r0 = blockIdx.y * RT, b = blockIdx.z;
  const int nr = min(RT, R - r0);

  // tabs[b, k, e, s0 + s] -> s_tab[(k E + e) NS + s], 16 bytes a copy, all
  // in flight at once
  constexpr int PER = 16 / sizeof(T), ROW = NS / PER;   // copies a (k, e)
  const T* tb = tabs + (size_t)b * 6 * E * 1024 + s0;
  for (int c = t; c < 6 * E * ROW; c += NS * RG) {
    const int ke = c / ROW, w = (c % ROW) * PER;
    copy16_async(s_tab + ke * NS + w, tb + (size_t)ke * 1024 + w);
  }
  // a warp stages rows warp, warp + NW, ...: lane e loads event e of
  // each (all loads in flight), then a ballot a row ranks the valid ones
  bool ok[RW];
  T lv[RW], sv[RW];
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    const int r = warp + i * NW;
    const size_t at = ((size_t)b * R + r0 + r) * E + lane;
    ok[i] = r < nr && lane < E && valid[at];
    if (ok[i]) { lv[i] = lvl[at]; sv[i] = sd[at]; }
  }
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    const int r = warp + i * NW;
    const unsigned m = __ballot_sync(FULL, ok[i]);
    if (ok[i]) {
      const T sdc = mx(sv[i], T(1e-30));
      s_ev[r * E + __popc(m & ((1u << lane) - 1u))] =
          Ev<T>{lv[i], sdc, lg(sdc), lane};
    }
    if (lane == 0 && r < nr) s_nlik[r] = __popc(m);
  }
  copies_wait();
  __syncthreads();

  const T* tt = s_tab + s;
  const int kst = E * NS;
  for (int r = g; r < nr; r += RG) {
    const int nlik = s_nlik[r];
    int nskip = nlik / 4;
    if (nskip > nlik - 2 || nlik <= 1) nskip = 0;
    const Ev<T>* ev = s_ev + r * E;
    T v[CAP];
#pragma unroll
    for (int j = 0; j < CAP; ++j) {
      if (j >= nlik) break;
      const Ev<T> x = ev[j];
      const T* q = tt + x.e * NS;
      v[j] = emission<T>(x.lvl, x.sdc, x.lsd, q[0], q[kst], q[2 * kst],
                         q[3 * kst], q[4 * kst], q[5 * kst], T(0));
    }
    // nskip passes, each dropping the least value not yet dropped (of equal
    // values the first: the lower event index)
    unsigned drop = 0;
    for (int k = 0; k < nskip; ++k) {
      T mv = pos_inf<T>();
      int mj = -1;
#pragma unroll
      for (int j = 0; j < CAP; ++j) {
        if (j >= nlik) break;
        if (!((drop >> j) & 1u) && (mj < 0 || v[j] < mv)) {
          mv = v[j];
          mj = j;
        }
      }
      drop |= 1u << mj;
    }
    T acc = T(0);
#pragma unroll
    for (int j = 0; j < CAP; ++j) {
      if (j >= nlik) break;
      if (!((drop >> j) & 1u)) acc = acc + v[j];
    }
    obs[((size_t)b * R + r0 + r) * 1024 + s0 + s] =
        acc / T(max(nlik - nskip, 1));
  }
}

// the drop threshold of a row's trim past KBUF: the nskip-th smallest
// (value, event index) of its valid events (ok(e)) as (tv, ti), by
// bisecting the values' order keys bit by bit from the top (the events
// whose key agrees with the threshold's above bit b and has 0 there are
// counted: rank fewer or more sets the bit), then the rank-th event of the
// threshold's key in event order.  Every pass recomputes the emissions
// (em(e)).
template <typename T, typename Ok, typename Em>
__device__ void bisect_threshold(int E, int nskip, Ok ok, Em em, T& tv,
                                 int& ti) {
  using Key = decltype(order_key(T(0)));
  constexpr int BITS = 8 * sizeof(Key);
  Key key = 0;
  int rank = nskip;
  for (int b = BITS - 1; b >= 0; --b) {
    int below = 0;
    for (int e = 0; e < E; ++e)
      if (ok(e)) below += (order_key(em(e)) >> b) == (key >> b);
    if (below < rank) {
      key |= Key(1) << b;
      rank -= below;
    }
  }
  for (int e = 0; e < E; ++e) {
    if (!ok(e)) continue;
    const T v = em(e);
    if (order_key(v) == key && --rank == 0) {
      tv = v;
      ti = e;
      return;
    }
  }
}

// general paths.  The same operands; grid (1024 / NT, R, B).  STAGED_ROW:
// the row's level data staged in shared memory, else read from device
// memory with each emission.
template <typename T, bool STAGED_ROW>
__global__ void __launch_bounds__(NT)
obs_rows_kernel(const T* __restrict__ lvl, const T* __restrict__ sd,
                const uint8_t* __restrict__ valid, const T* __restrict__ tabs,
                T* __restrict__ obs, int R, int E) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s_lvl = reinterpret_cast<T*>(smem_raw);
  T* s_sdc = s_lvl + E;
  T* s_lsd = s_sdc + E;
  uint8_t* s_ok = reinterpret_cast<uint8_t*>(s_lsd + E);

  const int s = blockIdx.x * NT + threadIdx.x;
  const size_t row = (size_t)blockIdx.z * R + blockIdx.y;
  const T* r_lvl = lvl + row * E;
  const T* r_sd = sd + row * E;
  const uint8_t* r_ok = valid + row * E;
  if constexpr (STAGED_ROW) {
    for (int e = threadIdx.x; e < E; e += NT) {
      const T sdc = mx(r_sd[e], T(1e-30));
      s_lvl[e] = r_lvl[e];
      s_sdc[e] = sdc;
      s_lsd[e] = lg(sdc);
      s_ok[e] = r_ok[e];
    }
    __syncthreads();
  }
  auto ok = [&](int e) -> bool {
    if constexpr (STAGED_ROW) return s_ok[e]; else return r_ok[e];
  };

  int nlik = 0;
  for (int e = 0; e < E; ++e) nlik += ok(e);
  int nskip = nlik / 4;
  if (nskip > nlik - 2 || nlik <= 1) nskip = 0;

  // tabs[b, k, e, s] = tb[(k E + e) 1024]
  const T* tb = tabs + (size_t)blockIdx.z * 6 * E * 1024 + s;
  const size_t kst = (size_t)E * 1024;
  auto em = [&](int e) {
    const T* t = tb + (size_t)e * 1024;
    T x, sdc, lsd;
    if constexpr (STAGED_ROW) {
      x = s_lvl[e];
      sdc = s_sdc[e];
      lsd = s_lsd[e];
    } else {
      x = r_lvl[e];
      sdc = mx(r_sd[e], T(1e-30));
      lsd = lg(sdc);
    }
    return emission<T>(x, sdc, lsd, t[0], t[kst], t[2 * kst], t[3 * kst],
                       t[4 * kst], t[5 * kst], T(0));
  };

  // the threshold: (tv, ti) the last dropped pair, every pair after it kept
  T tv = -pos_inf<T>();
  int ti = -1;
  if (nskip > 0 && nskip <= KBUF) {
    T bv[KBUF];
    int bi[KBUF];
#pragma unroll
    for (int j = 0; j < KBUF; ++j) { bv[j] = pos_inf<T>(); bi[j] = INT_MAX; }
    for (int e = 0; e < E; ++e) {
      if (!ok(e)) continue;
      T v = em(e);
      int ie = e;
#pragma unroll
      for (int j = 0; j < KBUF; ++j) {         // insert, the list sorted
        if (before(v, ie, bv[j], bi[j])) {
          const T x = bv[j]; bv[j] = v; v = x;
          const int k = bi[j]; bi[j] = ie; ie = k;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < KBUF; ++j) {
      if (j == nskip - 1) { tv = bv[j]; ti = bi[j]; }
    }
  } else if (nskip > 0) {
    bisect_threshold(E, nskip, ok, em, tv, ti);
  }

  T acc = T(0);
  for (int e = 0; e < E; ++e) {
    if (!ok(e)) continue;
    const T v = em(e);
    if (before(tv, ti, v, e)) acc = acc + v;
  }
  obs[row * 1024 + s] = acc / T(max(nlik - nskip, 1));
}

// path: engine/viterbi.py obs_path's choice, checked against E
template <typename T>
int launch(const void* lvl, const void* sd, const void* valid,
           const void* tabs, void* obs, int B, int R, int E, int path,
           void* stream) {
  if (B == 0 || R == 0) return 0;
  if (E < 0 || B > 65535) return (int)cudaErrorInvalidValue;
  if (path != (E <= CAP ? TILED : E <= STAGED_EVENTS ? STAGED : UNSTAGED))
    return (int)cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto a = static_cast<const T*>(lvl);
  const auto d = static_cast<const T*>(sd);
  const auto ok = static_cast<const uint8_t*>(valid);
  const auto tb = static_cast<const T*>(tabs);
  const auto out = static_cast<T*>(obs);
  if (path == TILED) {
    const int tiles = (R + RT - 1) / RT;
    if (tiles > 65535) return (int)cudaErrorInvalidValue;
    const size_t smem = (size_t)RT * E * sizeof(Ev<T>) +
                        (size_t)6 * E * NS * sizeof(T) + RT * sizeof(int);
    cudaError_t err = cudaFuncSetAttribute(
        obs_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    obs_kernel<T><<<dim3(1024 / NS, tiles, B), NS * RG, smem, st>>>(
        a, d, ok, tb, out, R, E);
  } else if (path == STAGED) {
    if (R > 65535) return (int)cudaErrorInvalidValue;
    const size_t smem = (size_t)E * (3 * sizeof(T) + 1);
    cudaError_t err = cudaFuncSetAttribute(
        obs_rows_kernel<T, true>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    obs_rows_kernel<T, true><<<dim3(1024 / NT, R, B), NT, smem, st>>>(
        a, d, ok, tb, out, R, E);
  } else {
    if (R > 65535) return (int)cudaErrorInvalidValue;
    obs_rows_kernel<T, false><<<dim3(1024 / NT, R, B), NT, 0, st>>>(
        a, d, ok, tb, out, R, E);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int psq_viterbi_obs_f32(const void* lvl, const void* sd,
                                   const void* valid, const void* tabs,
                                   void* obs, int B, int R, int E, int path,
                                   void* stream) {
  return launch<float>(lvl, sd, valid, tabs, obs, B, R, E, path, stream);
}

extern "C" int psq_viterbi_obs_f64(const void* lvl, const void* sd,
                                   const void* valid, const void* tabs,
                                   void* obs, int B, int R, int E, int path,
                                   void* stream) {
  return launch<double>(lvl, sd, valid, tabs, obs, B, R, E, path, stream);
}
