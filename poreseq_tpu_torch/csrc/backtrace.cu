// Best-path backtrace over the forward fill (kernel 3 of the port).
//
// Replaces poreseq_tpu/engine/tpu/align.py:backtrace_core (XLA, a vmapped
// lax.scan of C + 2T + 8 steps per event; reference Alignment.cpp:516-624);
// the plain PyTorch twin is engine/align.py:backtrace_reference.  From each
// event's best cell it walks the M / S lattices and their backpointer bytes
// back to the start, writing ref_align (the 1-based reference index, or -1
// for an inserted level) and ref_like (the lattice score) at every emitted
// level, 0 elsewhere.
//
// What bounds it on this card: the walk is a chain of dependent steps (each
// step's cell depends on the previous step's move), about C + T of them per
// event, with no arithmetic to speak of; read one cell at a time from the
// lattices (hundreds of MB, far beyond L2), each step waits on two
// dependent loads (the column's band start, then the cell), which is memory
// latency, not bytes.  The design
// takes the loads and the tests off the chain:
//  - one warp per event, four events per block; a warp whose event has no
//    best cell only zeroes its output rows;
//  - a tile of K = 16 columns along a diagonal band: for column ja - d the
//    32 rows ia - d + UP - l (lane l), so lane l holds the band's diagonal
//    offset UP - l; a run of matches stays on the diagonal, skips and
//    inserts drift across the 32 offsets.  The warp loads a tile's M, S and
//    both move-code arrays with one coalesced load per column and array;
//  - when a tile is staged in shared memory, every lane decodes its 32
//    cells (two lattices x 16 columns): the twin's tests (column and row in
//    range, in the band, score > 0) and its move code become one byte of
//    flags (go on, emit, emit the column, step left, switch lattice), so
//    lane 0's walk is two shared-memory loads and a few bit operations a
//    step until the path leaves the tile;
//  - the next tile down the same diagonal is loaded into registers before
//    the walk starts and decoded after it, so its loads overlap the walk; a
//    path that leaves through the tile's left edge (the usual exit: skips
//    and inserts roughly balance) continues in it, one that drifts off the
//    band is re-anchored at its exit cell with a fresh load;
//  - the band starts and ends come from a window of 256 columns of i0 / i1
//    in shared memory (coalesced loads, refilled when a tile runs past it);
//  - outputs: the warp zeroes its event's rows with coalesced stores, lane 0
//    writes each emitted level (stores never stall the walk).
// The moves, their order and every test are those of the twin, so ref_align
// and ref_like equal it exactly.
#include "common.cuh"

using namespace psq;

namespace {

constexpr int WARPS = 4;    // events per block
constexpr int K = 16;       // columns per tile
constexpr int UP = 8;       // lane UP holds the tile's diagonal
constexpr int WIN = 256;    // columns of band starts and ends kept on chip

// a decoded cell: the flags of the twin's step from it (0: the walk stops)
enum : uint8_t { GO = 1, EMIT = 2, REF = 4, LEFT = 8, SWAP = 16, KNOWN = 32 };

// the flags of each move code (SKIP .. EXTEND, one byte each) in lattice M
// (arr 0) or S (arr 1) at a cell that passes the twin's tests: emit (i -= 1)
// the column or -1, j -= 1, switch lattice; a code the twin does not know
// ends the walk after its step.  A table, not a switch: lanes decode
// different codes at once, and a branch per code would serialize them.
__host__ __device__ constexpr uint64_t flag_table(int arr) {
  return (uint64_t)(GO | LEFT | KNOWN) << 8 * SKIP |
         (uint64_t)(GO | EMIT | REF | LEFT | KNOWN) << 8 * MATCH |
         (uint64_t)(GO | EMIT | KNOWN) << 8 * INSERT |
         (uint64_t)(GO | EMIT | LEFT | KNOWN) << 8 * IGNORE |
         (uint64_t)(arr ? GO | EMIT | REF | SWAP | KNOWN : GO | SWAP | KNOWN)
             << 8 * STAY |
         (uint64_t)(GO | EMIT | REF | KNOWN) << 8 * EXTEND;
}

template <int ARR>
__device__ __forceinline__ uint8_t move_flags(uint8_t stp) {
  return stp <= EXTEND ? (uint8_t)(flag_table(ARR) >> 8 * stp) : GO;
}

template <typename T>
struct Tile {
  T v[2][K][32];            // M, S at (column ja - d, row ia - d + UP - l)
  uint8_t f[2][K][32];      // their decoded flags
  int wlo[WIN], whi[WIN];   // columns wtop, wtop - 1, ... of i0 / i1
};

// one lane's share of a tile in flight: its row of each column, and (lane
// d < K) column ja - d's band
template <typename T>
struct Pending {
  T m[K], s[K];
  uint8_t a[K], b[K];
  int lo, hi;
};

struct Walk {
  const int *i0, *i1;       // this event's [C + 1] band rows
  int C, E, W, e, lane;
};

template <typename T>
__device__ void load_window(Tile<T>& w, const Walk& g, int wtop) {
  __syncwarp();
  for (int k = g.lane; k < WIN; k += 32) {
    const int c = wtop - k;
    const bool in = c >= 1 && c <= g.C;
    w.wlo[k] = in ? g.i0[c] : 0;
    w.whi[k] = in ? g.i1[c] : 0;
  }
  __syncwarp();
}

// issue the loads of the tile anchored at (ia, ja); the window must cover
// its columns in [1, C]
template <typename T>
__device__ __forceinline__ void fetch(Pending<T>& p, const Tile<T>& w,
                                      const Walk& g, const T* M, const T* S,
                                      const uint8_t* sm, const uint8_t* ss,
                                      int wtop, int ia, int ja) {
#pragma unroll
  for (int d = 0; d < K; ++d) {
    const int c = ja - d;
    if (c >= 1 && c <= g.C) {
      const int lo = w.wlo[wtop - c];
      const int row = min(max(ia - d + UP - g.lane - lo, 0), g.W - 1);
      const size_t cell = ((size_t)(c - 1) * g.E + g.e) * g.W + row;
      p.m[d] = M[cell];
      p.s[d] = S[cell];
      p.a[d] = sm[cell];
      p.b[d] = ss[cell];
    }
  }
  const int c = ja - g.lane;
  const bool in = g.lane < K && c >= 1 && c <= g.C;
  p.lo = in ? w.wlo[wtop - c] : 0;
  p.hi = in ? w.whi[wtop - c] : 0;
}

// stage the tile anchored at (ia, ja) from p and decode its cells: the
// twin's ok = i > 0 && 1 <= j <= C && in band && score > 0
template <typename T>
__device__ __forceinline__ void stash(Tile<T>& w, const Pending<T>& p,
                                      const Walk& g, int ia, int ja) {
#pragma unroll
  for (int d = 0; d < K; ++d) {
    const int c = ja - d, i = ia - d + UP - g.lane;
    const int lo = __shfl_sync(FULL, p.lo, d), hi = __shfl_sync(FULL, p.hi, d);
    const int rw = i - lo;
    const bool in = c >= 1 && c <= g.C && i > 0 && rw >= 0 && rw < g.W &&
                    i <= hi && i >= lo;
    w.v[0][d][g.lane] = p.m[d];
    w.v[1][d][g.lane] = p.s[d];
    w.f[0][d][g.lane] = in && p.m[d] > T(0) ? move_flags<0>(p.a[d]) : 0;
    w.f[1][d][g.lane] = in && p.s[d] > T(0) ? move_flags<1>(p.b[d]) : 0;
  }
  __syncwarp();
}

// make the window cover the columns of a tile whose top column is ja (a
// path that drifts off the band can exit above a window moved down for the
// prefetch)
template <typename T>
__device__ __forceinline__ void cover(Tile<T>& w, const Walk& g, int& wtop,
                                      int ja) {
  if (ja > wtop || max(ja - K + 1, 1) < wtop - WIN + 1) {
    wtop = ja;
    load_window(w, g, wtop);
  }
}

enum : int { DONE = 0, NEXT = 1, DRIFT = 2 };

template <typename T>
__global__ void __launch_bounds__(WARPS * 32)
backtrace_kernel(const T* __restrict__ M, const T* __restrict__ S,
                 const uint8_t* __restrict__ steps_m,
                 const uint8_t* __restrict__ steps_s,
                 const int* __restrict__ i0, const int* __restrict__ i1,
                 const int* __restrict__ best_i,
                 const int* __restrict__ best_j, T* ral, T* rlk, int C, int E,
                 int W, int Tpad, int max_steps) {
  __shared__ Tile<T> tiles[WARPS];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int e = blockIdx.x * WARPS + warp;
  if (e >= E) return;                        // warp-uniform
  Tile<T>& w = tiles[warp];
  T* ral_e = ral + (size_t)e * Tpad;
  T* rlk_e = rlk + (size_t)e * Tpad;
  for (int t = lane; t < Tpad; t += 32) {
    ral_e[t] = T(0);
    rlk_e[t] = T(0);
  }
  int i = best_i[e], j = best_j[e], arr = 0, step = 0;
  if (i <= 0) return;
  __syncwarp();                              // zeros before lane 0's writes
  const Walk g{i0 + (size_t)e * (C + 1), i1 + (size_t)e * (C + 1), C, E, W, e,
               lane};
  int ia = i, ja = j, wtop = max(min(j, C), 1);
  load_window(w, g, wtop);
  Pending<T> p;
  fetch(p, w, g, M, S, steps_m, steps_s, wtop, ia, ja);
  stash(w, p, g, ia, ja);
  for (;;) {
    // the next tile down the diagonal, in flight while lane 0 walks
    if (ja - K >= 1) {
      cover(w, g, wtop, ja - K);
      fetch(p, w, g, M, S, steps_m, steps_s, wtop, ia - K, ja - K);
    }
    int kind = DONE;
    if (lane == 0) {
      for (;;) {
        const int d = ja - j, l = UP - (i - ia + d);
        if (d >= K || l < 0 || l >= 32) {
          if (i > 0 && j >= 1) kind = d == K && l >= 0 ? NEXT : DRIFT;
          break;
        }
        const uint8_t fl = w.f[arr][d][l];
        const T sc = w.v[arr][d][l];
        if (step >= max_steps || !(fl & GO)) break;
        if (fl & EMIT) {
          ral_e[i - 1] = fl & REF ? T(j) : T(-1);
          rlk_e[i - 1] = sc;
          i -= 1;
        }
        j -= (fl & LEFT) != 0;
        arr ^= (fl & SWAP) != 0;
        ++step;
        if (!(fl & KNOWN)) break;
      }
    }
    __syncwarp();
    kind = __shfl_sync(FULL, kind, 0);
    if (kind == DONE) return;
    i = __shfl_sync(FULL, i, 0);
    j = __shfl_sync(FULL, j, 0);
    arr = __shfl_sync(FULL, arr, 0);
    step = __shfl_sync(FULL, step, 0);
    if (kind == NEXT) {                      // the prefetched tile
      ia -= K;
      ja -= K;
    } else {                                 // re-anchor at the exit cell
      ia = i;
      ja = j;
      cover(w, g, wtop, ja);
      fetch(p, w, g, M, S, steps_m, steps_s, wtop, ia, ja);
    }
    stash(w, p, g, ia, ja);
  }
}

template <typename T>
int launch(const void* M, const void* S, const void* sm, const void* ss,
           const void* i0, const void* i1, const void* bi, const void* bj,
           void* ral, void* rlk, int C, int E, int W, int Tpad, int max_steps,
           void* stream) {
  if (E == 0) return 0;
  backtrace_kernel<T><<<(E + WARPS - 1) / WARPS, WARPS * 32, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(M), static_cast<const T*>(S),
      static_cast<const uint8_t*>(sm), static_cast<const uint8_t*>(ss),
      static_cast<const int*>(i0), static_cast<const int*>(i1),
      static_cast<const int*>(bi), static_cast<const int*>(bj),
      static_cast<T*>(ral), static_cast<T*>(rlk), C, E, W, Tpad, max_steps);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int psq_backtrace_f32(const void* M, const void* S, const void* sm,
                                 const void* ss, const void* i0,
                                 const void* i1, const void* bi,
                                 const void* bj, void* ral, void* rlk, int C,
                                 int E, int W, int Tpad, int max_steps,
                                 void* stream) {
  return launch<float>(M, S, sm, ss, i0, i1, bi, bj, ral, rlk, C, E, W, Tpad,
                       max_steps, stream);
}

extern "C" int psq_backtrace_f64(const void* M, const void* S, const void* sm,
                                 const void* ss, const void* i0,
                                 const void* i1, const void* bi,
                                 const void* bj, void* ral, void* rlk, int C,
                                 int E, int W, int Tpad, int max_steps,
                                 void* stream) {
  return launch<double>(M, S, sm, ss, i0, i1, bi, bj, ral, rlk, C, E, W, Tpad,
                        max_steps, stream);
}
