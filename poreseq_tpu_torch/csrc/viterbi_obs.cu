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
// per valid (region, event)).  E_pad is the batch's largest event count, two
// event rows (template and complement) a read, and the loader keeps up to
// max_coverage = 30 reads a region: up to 60 event rows, so from about 15X
// on a batch passes 32.  The tables [B, 6, E, 1024] belong to the region,
// not the row, so every instance reads them once per tile of rows, from
// shared memory:
//
// - The tiled instances (E <= CAP = 32, "tiled"; E <= CAP_WIDE = 64,
//   "tiled64"): a block owns one region, NS states (f64 at CAP_WIDE:
//   NS_WIDE_F64) and TILES tiles of RT = 16 rows (tiled64: TILES_WIDE),
//   with RG threads a state (tiled64: RG_WIDE; thread group g takes rows g,
//   g + RG, ... of a tile).  It stages the region's tables for its states
//   in shared memory [6][E][NS] once, with cp.async (16 bytes a copy, all
//   in flight at once; a thread reads its own column: no bank conflict),
//   and then, a tile at a time, each row's valid events compacted in event
//   order by one warp ballot per 32 events (mean, clamped stdv, its log,
//   the event index; every row's loads in flight before the ballots; the
//   list padded to a multiple of ILP with a harmless event), and walks the
//   tile's rows.  A row's emissions go into registers v[CAP] ILP at a time
//   (loops unrolled over the cap with an exit at the row's nlik, so no
//   array is indexed dynamically); nskip passes over them mark the least
//   not yet dropped, the first of equal values (a bit mask), and the kept
//   values are summed in event order.  Every branch on the row is uniform
//   over the thread group.  Shared memory: RT EP 16 (f32) or 32 (f64)
//   bytes of row data (EP: E rounded up to ILP) and 6 E NS sizeof(T) of
//   tables: 213 KB at CAP_WIDE in f32 (NS 128) and 229 KB in f64 (NS 64),
//   one block an SM, so tiled64 takes 4 row groups (16 warps in f32, 8 in
//   f64) where 2 ran it 1.6x slower, and 4 tiles a block; its selection
//   costs about as much as its emissions at 30X (the loader's events of
//   the coverage phase's regions: sum of nlik nskip 1.38 M against 245 k
//   emissions a state; after refinement the engine's launch trims more
//   than 8 in 2,459 of 12,101 rows, the loader's batch in 538 of 13,637).
//   Measured on an NVIDIA H100 80GB HBM3 at 700 W (tools/sweep_constants.py
//   --obs-shape 30X, PERF.md §6): tiled64 on the coverage phase's largest
//   launch, f32, 1.615 ms with ILP_WIDE = 1 and TILES_WIDE = 4 (ILP 2 and
//   4: 1.654 and 1.685 ms; 2 tiles 1.611-1.667; RG_WIDE 2: 2.51-2.62 ms;
//   f64 3.747 ms, ILP 2 3.771); the tiled instance at phase 2b's shape
//   0.133 ms with ILP = 1, 0.153 with 4 (its rows hold about 5 events:
//   padding to 4 costs more than the overlap buys).
// - The chunked instance (any E, "chunked"): a block owns one region, 32
//   states and CR = 8 rows, a warp a row (every branch on the row is
//   uniform over the warp).  It walks the events in chunks of EC (f32; f64
//   EC / 2) staged as the tiled instances stage them (the tables of the
//   chunk's events for the block's states, each warp its row's valid events
//   of the chunk compacted; once for all passes when E fits one chunk).  The
//   drop threshold, the nskip-th smallest (value, index), is found in
//   passes over the chunks, each computing every emission once: a row
//   whose remaining rank is at most KBUF collects the smallest KBUF pairs
//   of its bucket in a sorted register list (one pass: nskip <= KBUF, the
//   rows up to 35 valid events, need no other); else it counts its bucket's
//   order keys (common.cuh:order_key: a larger value a larger key, -0 and +0
//   one key) by the next DIGIT bits in a histogram of its own in shared
//   memory (16 bins a thread), keeps the digit where the rank falls and the
//   rank within it, and goes on until the rank is at most KBUF (then a
//   collect pass) or the key is whole (then the rank-th pair of that key in
//   event order is the threshold).  Emissions of one sign and a few
//   exponents share their top bits, so a bucket of E events shrinks to
//   KBUF in 3-5 passes: 5-7 emission passes with the sum's, where bisecting
//   the key bit by bit took 34 in f32 and 66 in f64.  The last pass sums the
//   pairs after the threshold in event order.  Shared memory: 6 EC 32 4
//   bytes of tables, CR EC 16 bytes of row data and 16 32 CR 4 bytes of
//   histograms: 72 KB, three blocks an SM, which the registers allow only
//   at CHUNK_BLOCKS = 3 (79 / 80 registers; 132 bytes spilled in f64) with
//   one emission at a time: at E = 100, f32, 3.920 ms against 5.077 at one
//   block an SM and 9.498 with 4 emissions in flight (143 registers).  Past the tiled64 cap it is the only instance; at E <=
//   64 it takes 2.2-3.5x tiled64's time (PERF.md §6), so the route gives
//   it E > 64 only.
#include <type_traits>

#include "common.cuh"

namespace {

using namespace psq;

constexpr int CAP = 32;       // the tiled instance's events a row at most
constexpr int CAP_WIDE = 64;  // the tiled64 instance's
constexpr int NS = 128;       // states per block, tiled instances
constexpr int NS_WIDE_F64 = 64;  // states per block, tiled64 in f64
constexpr int RG = 2;         // row groups per block, tiled
constexpr int RG_WIDE = 4;    // row groups per block, tiled64
constexpr int RT = 16;        // rows a tile, tiled instances
constexpr int TILES = 1;      // row tiles per block, tiled
constexpr int TILES_WIDE = 4;  // row tiles per block, tiled64
constexpr int ILP = 1;        // emissions computed together, tiled
constexpr int ILP_WIDE = 1;   // emissions computed together, tiled64
constexpr int CHUNK_BLOCKS = 3;  // blocks an SM the chunked registers allow
constexpr int CR = 8;         // rows per block (a warp each), chunked
constexpr int EC = 64;        // events a chunk in f32 (f64: EC / 2), chunked
constexpr int KBUF = 8;       // the chunked instance's register list
constexpr int DIGIT = 4;      // key bits a histogram pass, chunked
enum Path : int { TILED = 0, TILED_WIDE = 1, CHUNKED = 2 };

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

__host__ __device__ constexpr int round_up(int n, int m) {
  return (n + m - 1) / m * m;
}

// tiled instances.  lvl, sd, valid [B, R, E]; tabs [B, 6, E, 1024]; obs
// [B, R, 1024]; grid (1024 / NSB, ceil(R / (TL RT)), B): a block stages its
// tables once and walks TL tiles of RT rows
template <typename T, int CAPB, int NSB, int RGB, int TL, int ILPB>
__global__ void __launch_bounds__(NSB * RGB)
obs_kernel(const T* __restrict__ lvl, const T* __restrict__ sd,
           const uint8_t* __restrict__ valid, const T* __restrict__ tabs,
           T* __restrict__ obs, int R, int E) {
  constexpr int NW = NSB * RGB / 32;   // warps per block
  constexpr int RW = RT / NW;          // rows each warp stages
  constexpr int H = CAPB / 32;         // ballots a row
  static_assert(RT % NW == 0, "a whole number of rows for each warp to stage");
  static_assert(CAPB % ILPB == 0, "the register list in whole groups");
  using Mask = std::conditional_t<(CAPB > 32), unsigned long long, unsigned>;
  const int EP = round_up(E, ILPB);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Ev<T>* s_ev = reinterpret_cast<Ev<T>*>(smem_raw);          // [RT][EP]
  T* s_tab = reinterpret_cast<T*>(s_ev + RT * EP);            // [6][E][NSB]
  int* s_nlik = reinterpret_cast<int*>(s_tab + 6 * E * NSB);  // [RT]

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int s = t % NSB, g = t / NSB;   // state, row group
  const int s0 = blockIdx.x * NSB, b = blockIdx.z;

  // tabs[b, k, e, s0 + s] -> s_tab[(k E + e) NSB + s], 16 bytes a copy, all
  // in flight at once
  constexpr int PER = 16 / sizeof(T), ROW = NSB / PER;   // copies a (k, e)
  const T* tb = tabs + (size_t)b * 6 * E * 1024 + s0;
  for (int c = t; c < 6 * E * ROW; c += NSB * RGB) {
    const int ke = c / ROW, w = (c % ROW) * PER;
    copy16_async(s_tab + ke * NSB + w, tb + (size_t)ke * 1024 + w);
  }
  const T* tt = s_tab + s;
  const int kst = E * NSB;
  for (int tile = 0; tile < TL; ++tile) {
    const int r0 = (blockIdx.y * TL + tile) * RT;
    if (r0 >= R) break;
    const int nr = min(RT, R - r0);
    if (tile > 0) __syncthreads();    // the last tile's rows are read
    // a warp stages rows warp, warp + NW, ...: lane l loads events l, l +
    // 32, ... of each (all loads in flight), then a ballot per 32 events
    // ranks the valid ones
    bool ok[RW][H];
    T lv[RW][H], sv[RW][H];
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      const int r = warp + i * NW;
#pragma unroll
      for (int h = 0; h < H; ++h) {
        const int e = 32 * h + lane;
        const size_t at = ((size_t)b * R + r0 + r) * E + e;
        ok[i][h] = r < nr && e < E && valid[at];
        if (ok[i][h]) { lv[i][h] = lvl[at]; sv[i][h] = sd[at]; }
      }
    }
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      const int r = warp + i * NW;
      int n = 0;
#pragma unroll
      for (int h = 0; h < H; ++h) {
        const unsigned m = __ballot_sync(FULL, ok[i][h]);
        if (ok[i][h]) {
          const T sdc = mx(sv[i][h], T(1e-30));
          s_ev[r * EP + n + __popc(m & ((1u << lane) - 1u))] =
              Ev<T>{lv[i][h], sdc, lg(sdc), 32 * h + lane};
        }
        n += __popc(m);
      }
      if (r < nr) {
        if (lane < round_up(n, ILPB) - n)
          s_ev[r * EP + n + lane] = Ev<T>{T(0), T(1), T(0), 0};  // finite
        if (lane == 0) s_nlik[r] = n;
      }
    }
    copies_wait();
    __syncthreads();

    for (int r = g; r < nr; r += RGB) {
      const int nlik = s_nlik[r];
      int nskip = nlik / 4;
      if (nskip > nlik - 2 || nlik <= 1) nskip = 0;
      const Ev<T>* ev = s_ev + r * EP;
      T v[CAPB];
#pragma unroll
      for (int j = 0; j < CAPB; j += ILPB) {
        if (j >= nlik) break;
#pragma unroll
        for (int k = 0; k < ILPB; ++k) {
          const Ev<T> x = ev[j + k];
          const T* q = tt + x.e * NSB;
          v[j + k] = emission<T>(x.lvl, x.sdc, x.lsd, q[0], q[kst],
                                 q[2 * kst], q[3 * kst], q[4 * kst],
                                 q[5 * kst], T(0));
        }
      }
      // nskip passes, each dropping the least value not yet dropped (of
      // equal values the first: the lower event index)
      Mask drop = 0;
      for (int k = 0; k < nskip; ++k) {
        T mv = pos_inf<T>();
        int mj = -1;
#pragma unroll
        for (int j = 0; j < CAPB; ++j) {
          if (j >= nlik) break;
          if (!((drop >> j) & 1u) && (mj < 0 || v[j] < mv)) {
            mv = v[j];
            mj = j;
          }
        }
        drop |= Mask(1) << mj;
      }
      T acc = T(0);
#pragma unroll
      for (int j = 0; j < CAPB; ++j) {
        if (j >= nlik) break;
        if (!((drop >> j) & 1u)) acc = acc + v[j];
      }
      obs[((size_t)b * R + r0 + r) * 1024 + s0 + s] =
          acc / T(max(nlik - nskip, 1));
    }
  }
}

// a chunked row's selection state (per state): SUM, the threshold (tv, ti)
// known; KEYED, the threshold is the rank-th pair of key pfx in event order;
// COLLECT, the next pass collects the bucket's smallest KBUF pairs; RADIX,
// the next pass counts the bucket's keys by their DIGIT bits at sh
enum Mode : int { SUM = 0, KEYED = 1, COLLECT = 2, RADIX = 3 };

// chunked instance.  The same operands; grid (32, ceil(R / CR), B)
template <typename T>
__global__ void __launch_bounds__(32 * CR, CHUNK_BLOCKS)
obs_chunk_kernel(const T* __restrict__ lvl, const T* __restrict__ sd,
                 const uint8_t* __restrict__ valid,
                 const T* __restrict__ tabs, T* __restrict__ obs, int R,
                 int E) {
  using Key = decltype(order_key(T(0)));
  constexpr int BITS = 8 * sizeof(Key), NB = 1 << DIGIT, NT = 32 * CR;
  constexpr int ECT = EC * 4 / (int)sizeof(T);     // events a chunk
  static_assert(ECT % 32 == 0, "whole ballots");
  static_assert(BITS % DIGIT == 0, "whole digits");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s_tab = reinterpret_cast<T*>(smem_raw);                // [6][ECT][32]
  Ev<T>* s_ev = reinterpret_cast<Ev<T>*>(s_tab + 6 * ECT * 32);  // [CR][ECT]
  unsigned* s_hist =
      reinterpret_cast<unsigned*>(s_ev + CR * ECT);            // [NB][NT]

  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  const int s0 = blockIdx.x * 32, r = blockIdx.y * CR + w, b = blockIdx.z;
  const bool real = r < R;
  const size_t row = ((size_t)b * R + (real ? r : 0)) * E;
  const T* tb = tabs + (size_t)b * 6 * E * 1024 + s0;
  const int nch = (E + ECT - 1) / ECT;

  int nlik = 0;
  if (real) {
    for (int e = lane; e < E; e += 32) nlik += valid[row + e];
    nlik = (int)__reduce_add_sync(FULL, (unsigned)nlik);
  }
  int nskip = nlik / 4;
  if (nskip > nlik - 2 || nlik <= 1) nskip = 0;
  int mode = nskip == 0 ? SUM : nskip <= KBUF ? COLLECT : RADIX;
  int rank = nskip, sh = BITS - DIGIT;
  Key pfx = 0, hi = 0;     // the bucket: keys equal to pfx under the mask hi
  T tv = -pos_inf<T>();
  int ti = -1;
  T bv[KBUF];
  int bi[KBUF];
  unsigned* hist = s_hist + t;    // bin d at hist[d NT]

  // chunk c into shared memory: the tables of its events for the block's
  // 32 states (cp.async, 16 bytes a copy) and each warp its row's valid
  // events compacted in event order; returns the warp's count.  The
  // block's barrier ends it.
  auto stage = [&](int c) {
    const int e0 = c * ECT, n = min(ECT, E - e0);
    constexpr int PER = 16 / sizeof(T), ROWC = 32 / PER;
    for (int i = t; i < 6 * n * ROWC; i += NT) {
      const int k = i / (n * ROWC), q = i % (n * ROWC);
      const int e = q / ROWC, x = (q % ROWC) * PER;
      copy16_async(s_tab + (k * ECT + e) * 32 + x,
                   tb + ((size_t)k * E + e0 + e) * 1024 + x);
    }
    int m = 0;
    if (real) {
      for (int h = 0; h < n; h += 32) {
        const int e = e0 + h + lane;
        const bool ok = h + lane < n && valid[row + e];
        T lv = T(0), sv = T(0);
        if (ok) { lv = lvl[row + e]; sv = sd[row + e]; }
        const unsigned bal = __ballot_sync(FULL, ok);
        if (ok) {
          const T sdc = mx(sv, T(1e-30));
          s_ev[w * ECT + m + __popc(bal & ((1u << lane) - 1u))] =
              Ev<T>{lv, sdc, lg(sdc), e};
        }
        m += __popc(bal);
      }
    }
    copies_wait();
    __syncthreads();
    return m;
  };
  // one pass over the chunks: f(v, e) for each valid event of the warp's row
  // in event order, where active (uniform over the warp)
  int m_once = -1;     // the count of the one chunk, once staged
  auto walk = [&](bool active, auto&& f) {
    for (int c = 0; c < nch; ++c) {
      int m = m_once;
      if (m < 0) {
        __syncthreads();          // the last chunk's readers are done
        m = stage(c);
        if (nch == 1) m_once = m;
      }
      if (!active) continue;
      const Ev<T>* ev = s_ev + w * ECT;
      const int e0 = c * ECT;
      constexpr int kst = ECT * 32;
      for (int j = 0; j < m; ++j) {
        const Ev<T> x = ev[j];
        const T* q = s_tab + (x.e - e0) * 32 + lane;
        f(emission<T>(x.lvl, x.sdc, x.lsd, q[0], q[kst], q[2 * kst],
                      q[3 * kst], q[4 * kst], q[5 * kst], T(0)), x.e);
      }
    }
  };

  // selection passes, while any row of the block has a bucket to narrow
  while (__syncthreads_or(mode >= COLLECT)) {
    if (mode == RADIX) {
#pragma unroll
      for (int d = 0; d < NB; ++d) hist[d * NT] = 0u;
    } else if (mode == COLLECT) {
#pragma unroll
      for (int j = 0; j < KBUF; ++j) { bv[j] = pos_inf<T>(); bi[j] = INT_MAX; }
    }
    walk(__any_sync(FULL, mode >= COLLECT), [&](T v, int e) {
      const Key key = order_key(v);
      if (mode < COLLECT || ((key ^ pfx) & hi) != 0) return;
      if (mode == RADIX) {
        hist[(int)((key >> sh) & Key(NB - 1)) * NT] += 1u;
      } else if (before(v, e, bv[KBUF - 1], bi[KBUF - 1])) {
#pragma unroll
        for (int j = 0; j < KBUF; ++j) {       // insert, the list sorted
          if (before(v, e, bv[j], bi[j])) {
            const T x = bv[j]; bv[j] = v; v = x;
            const int k = bi[j]; bi[j] = e; e = k;
          }
        }
      }
    });
    if (mode == RADIX) {
      // the digit where the rank falls, and the rank within its bin
      unsigned below = 0;
      int dsel = -1;
#pragma unroll
      for (int d = 0; d < NB; ++d) {
        const unsigned c = hist[d * NT];
        if (dsel < 0) {
          if (below + c >= (unsigned)rank) dsel = d; else below += c;
        }
      }
      rank -= (int)below;
      pfx |= Key(dsel) << sh;
      hi |= Key(NB - 1) << sh;
      sh -= DIGIT;
      mode = rank <= KBUF ? COLLECT : sh < 0 ? KEYED : RADIX;
    } else if (mode == COLLECT) {
#pragma unroll
      for (int j = 0; j < KBUF; ++j)
        if (j == rank - 1) { tv = bv[j]; ti = bi[j]; }
      mode = SUM;
    }
  }

  // the pairs after the threshold, summed in event order
  T acc = T(0);
  int seen = 0;
  walk(real, [&](T v, int e) {
    bool keep;
    if (mode == KEYED) {
      const Key key = order_key(v);
      keep = key > pfx || (key == pfx && ++seen > rank);
    } else {
      keep = before(tv, ti, v, e);
    }
    if (keep) acc = acc + v;
  });
  if (real)
    obs[((size_t)b * R + r) * 1024 + s0 + lane] =
        acc / T(max(nlik - nskip, 1));
}

template <typename T, int CAPB, int NSB, int RGB, int TL, int ILPB>
cudaError_t launch_tiled(const T* a, const T* d, const uint8_t* ok,
                         const T* tb, T* out, int B, int R, int E,
                         cudaStream_t st) {
  const int tiles = (R + TL * RT - 1) / (TL * RT);
  if (tiles > 65535) return cudaErrorInvalidValue;
  const size_t smem = (size_t)RT * round_up(E, ILPB) * sizeof(Ev<T>) +
                      (size_t)6 * E * NSB * sizeof(T) + RT * sizeof(int);
  const auto kernel = obs_kernel<T, CAPB, NSB, RGB, TL, ILPB>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(1024 / NSB, tiles, B), NSB * RGB, smem, st>>>(a, d, ok, tb,
                                                              out, R, E);
  return cudaSuccess;
}

// path: engine/viterbi.py obs_path's choice (or a caller's instance),
// checked against E: the tiled instances up to their caps, the chunked one
// at any E
template <typename T>
int launch(const void* lvl, const void* sd, const void* valid,
           const void* tabs, void* obs, int B, int R, int E, int path,
           void* stream) {
  if (B == 0 || R == 0) return 0;
  if (E < 0 || B > 65535) return (int)cudaErrorInvalidValue;
  if ((path == TILED && E > CAP) || (path == TILED_WIDE && E > CAP_WIDE) ||
      path < TILED || path > CHUNKED)
    return (int)cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto a = static_cast<const T*>(lvl);
  const auto d = static_cast<const T*>(sd);
  const auto ok = static_cast<const uint8_t*>(valid);
  const auto tb = static_cast<const T*>(tabs);
  const auto out = static_cast<T*>(obs);
  cudaError_t err = cudaSuccess;
  if (path == TILED) {
    err = launch_tiled<T, CAP, NS, RG, TILES, ILP>(a, d, ok, tb, out, B, R,
                                                   E, st);
  } else if (path == TILED_WIDE) {
    constexpr int NSW = sizeof(T) == 4 ? NS : NS_WIDE_F64;
    err = launch_tiled<T, CAP_WIDE, NSW, RG_WIDE, TILES_WIDE, ILP_WIDE>(
        a, d, ok, tb, out, B, R, E, st);
  } else {
    const int tiles = (R + CR - 1) / CR;
    if (tiles > 65535) return (int)cudaErrorInvalidValue;
    constexpr int ECT = EC * 4 / (int)sizeof(T);
    const size_t smem = (size_t)6 * ECT * 32 * sizeof(T) +
                        (size_t)CR * ECT * sizeof(Ev<T>) +
                        (size_t)(1 << DIGIT) * 32 * CR * sizeof(unsigned);
    err = cudaFuncSetAttribute(obs_chunk_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    obs_chunk_kernel<T><<<dim3(32, tiles, B), 32 * CR, smem, st>>>(
        a, d, ok, tb, out, R, E);
  }
  if (err != cudaSuccess) return (int)err;
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
