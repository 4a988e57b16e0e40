// Fused masked-Hamming match resolution for Hopper (sm_90a).
//
// Replaces the TPU kernel `hamming_resolve_pallas` (libcml_tpu/ops/
// pallas_match.py:107, body `_make_kernel` :39-103). For a masked (N, M)
// Hamming-distance matrix over 256-bit ORB descriptors it computes, in one
// launch and without ever storing the matrix:
//   d1[i], d2[i]  best and second-best distance of query row i
//                 (second best = second smallest of the row's multiset, so
//                 two columns tied at the best give d2 == d1),
//   idx[i]        first column reaching d1 (ties -> lowest column),
//   col_row[j]    first row reaching the minimum of column j (mutual check).
// A masked entry counts 257 (> any 256-bit distance), so a fully masked row
// gives (257, 257, 0) and a fully masked column gives row 0, as argmin does.
// Only the live entries (query, train and pair mask all true) can change a
// result, so the kernel computes those and no others.
//
// What bounds it on this card, and what the design does about each:
//   - With a pair mask (match_projection, match_window, match_epipolar) the
//     live entries are few (1 in 347 under phase 2's match radius), and the
//     bound is reading, once, the pair-mask rows of the query rows whose
//     mask is true. A warp owns one query row: its lanes read the row's
//     pair-mask bytes as aligned 16-byte granules, four in flight a lane
//     (a row starts at any byte; the bytes of a granule outside the row's
//     chunk are masked off by address), fold the nonzero bytes into a bit
//     set, queue the set bits of all the granules in shared memory, spread
//     them over the 32 lanes, load each one's train-mask byte and
//     descriptor in one round trip, and compute the 8 popcounts only where
//     the train mask is true. The train mask is not staged per block: every
//     block would read the same bytes, a hot spot in L2. A masked query row
//     reads no pair byte and no descriptor; a unit whose rows are all masked
//     writes (257, 257, 0) and reads nothing more.
//   - Without a pair mask (match_descriptors) every live entry needs its 8
//     popcounts: the popcount pipe (16 per clock and SM on sm_90) bounds it.
//     Each lane owns one query row; a block compacts its chunk's live train
//     columns and their descriptors into shared memory, and its warps sweep
//     them with the descriptor broadcast to all lanes. A block whose rows are
//     all masked stages nothing.
//   - At small sizes the launch and a chain of dependent memory round trips
//     bound it: one launch a call, and every load that does not depend on
//     another is issued with it. The work is cut into (row group, column
//     chunk) units, one block each, enough to put work on every SM; a row
//     group takes rows g, g + groups, g + 2 groups, ..., so a map padded
//     with masked slots spreads its live rows over all blocks. Row partials
//     merge across chunks lexicographically on (d1, column) with
//     d2 = min(winner.d2, loser.d1), an associative and commutative merge,
//     so the order of blocks cannot change a result. Column minima reduce as
//     64-bit keys (d << 32) | row, first in the block (a warp's redux.sync,
//     or a shared atomicMin per live entry), then one global atomicMin per
//     touched column and block; a masked entry takes no atomic. The last
//     block of a row group (and of a column chunk), found by an atomic
//     ticket, merges the row partials (and unpacks col_row), so no second
//     kernel runs.
// Scratch, all from the wrapper: `row_part` (chunks x N partials, written
// before it is read); `col_best` (M keys) and `tickets` (groups + chunks
// counters), which must hold (257 << 32) and 0 on entry. The kernel leaves
// them so on exit: the last block of each chunk resets its keys and every
// last block resets its ticket. The wrapper keeps one pair of them per
// device and stream, filled once when it is made.
// The 16-byte pair granules are aligned by address, so one may run up to
// 15 bytes past a row's end or the tensor's end, never past the aligned
// 16 bytes that hold a valid byte (allocations are 256-byte aligned).
// A tensor-core (b1 mma, AND + POPC) formulation of the dense path is later
// work.
//
// Pair tests computed in the kernel (no pair mask written or read). Two
// callers test each (query, train) pair with a formula of their pixels,
// which the XLA program (libcml_tpu/models/indirect/matching.py:185
// match_projection, :223 match_epipolar) evaluates as an (N, M) mask before
// the Pallas resolve; here each warp evaluates it over its chunk's columns:
//   MODE_EPI   the epipolar band: l = F [uv_q, 1] per query row, and
//              (l . [uv_t, 1])^2 / max(l0^2 + l1^2, 1e-9) <= epi_tol. F is
//              read (9 floats) or made from the two poses, T_10 = T_new
//              T_0^-1 and F = K^-T [t_10]x R_10 K^-1 (block 0 writes them
//              for the triangulation kernel, csrc/triangulate.cu);
//   MODE_PROJ  the projection window: X_c = R X_w + t per query row (a map
//              point), its pixel (written to uv_p), the row visible when
//              valid, z > 1e-6 and 2 px inside the frame; then
//              |uv_p - uv_f|^2 <= (radius 1.5^level_p)^2 and
//              |level_p - level_f| <= 1.
// Both evaluate in double from the float32 inputs, so a pair sits on
// float64's side of its limit; the plain float32 forms can flip a pair
// within ~1e-5 of it, and the card's checks count those pairs. The launch
// (pairs_kernel) also applies matching._finish: the distance gate, the Lowe
// ratio (d1 < ratio d2 in float32) and the mutual check, and writes the
// row's column as int64 and the number of matches, so a predicate match is
// one launch.
// What bounds the pair modes on this card: latency. Phase 4's projection
// match (4096 map rows, ~650 visible, x 1536 corners) reads ~0.2 MB once and
// tests ~1e6 pairs; its time is the launch, a few dependent round trips and
// a live row's 48 ballots (the stamps of the design before this one: two
// waves of blocks, a live warp ~0.12 us a ballot, a one-block finish of
// 5.9 us). So the launch is one
// wave (at most PAIR_BLOCKS_PER_SM blocks an SM, ops/hamming_match.py
// pair_plan), with one column chunk of up to PAIR_CW columns (dynamic
// shared memory) at the hybrid's sizes, so no row partial is merged; each
// block stages its chunk's train pixels (NaN where masked, which fails
// every test) and levels once, their loads in flight while its threads
// test their rows (a thread a row of its row group, at most PAIR_ROWS); the
// live rows are listed in shared memory and, when the warps outnumber them,
// each row's columns are cut into parts that several warps take (their
// partials merged as chunks merge), so an invisible or masked row costs its
// test only and a live row's ballots spread. A warp's lanes test 32 columns
// at once, BALLOTS groups before their ballots, and queue the live ones;
// the queue is drained as in the mask mode. Each row also writes its
// (d1, d2, idx) packed (`rec`) for the finish. With one chunk its last
// block (one ticket) loads the column keys and its threads' first
// FIN_ROWS records together, keeps the keys in shared memory and finishes
// from there; with more chunks a row group's last unit merges its rows, a
// chunk's last unit unpacks its columns and the last block of all (a third
// ticket) finishes.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int MASKED = 257;
constexpr int INIT = 258;                        // loses to every real entry
constexpr unsigned long long COL_INIT = (unsigned long long)MASKED << 32;
constexpr int SPARSE_ROWS = WARPS;               // rows per unit with a pair mask (a warp each)
constexpr int DENSE_ROWS = 32;                   // rows per unit without (a lane each)
constexpr int SPARSE_CW = 2048;                  // most columns per unit
constexpr int DENSE_CW = 512;
constexpr int PAIR_CW = 2048;                    // most columns per unit with a pair test
constexpr int PAIR_ROWS = 64;                    // most rows per row group with a pair test
constexpr int PAIR_BLOCKS_PER_SM = 3;            // the pair modes' resident blocks an SM
constexpr int FIN_ROWS = 16;                     // rows a thread of the finish loads at once
constexpr int BALLOTS = 4;                       // a pair-test warp's ballots in flight
// the kernel's modes: no pair mask, a pair mask, the epipolar and the
// projection pair tests (ops/hamming_match.py MODE_*)
constexpr int MODE_DENSE = 0, MODE_MASK = 1, MODE_EPI = 2, MODE_PROJ = 3;
constexpr int UNROLL = 4;                        // 16-byte pair loads in flight a lane
constexpr int QUEUE = 32 * 16;                   // a warp's queued live columns: one
                                                 // granule's worth for every lane
constexpr int DRAIN = 2;                         // queued entries a lane loads at once
constexpr int MIN_BLOCKS = 4;                    // resident blocks an SM: 512 at 132 SMs

struct Best {
  int d1;
  int i1;
  int d2;
};

struct Args {
  const uint32_t* q;
  const uint8_t* qmask;
  const uint32_t* t;
  const uint8_t* tmask;
  const uint8_t* pair;        // nullptr: no pair mask
  int N, M, groups, chunks, cw;
  int32_t* d1;
  int32_t* d2;
  int32_t* idx;
  int32_t* col_row;
  int2* row_part;             // chunks * N partials (chunks > 1 only)
  unsigned long long* col_best;
  unsigned int* tickets;      // [groups] row-group, [chunks] column-chunk, then
                              // one for the finish
  // the pair tests (MODE_EPI, MODE_PROJ)
  const float* uv_q;          // (N, 2) query pixels (MODE_EPI)
  const float* uv_t;          // (M, 2) train pixels
  const float* Xw;            // (N, 3) map points (MODE_PROJ)
  const int32_t* level_q;     // (N,) (MODE_PROJ)
  const int32_t* level_t;     // (M,) (MODE_PROJ)
  const float* R1;            // MODE_PROJ: the pose; MODE_EPI: T_new
  const float* t1;
  const float* R0;            // MODE_EPI: T_0
  const float* t0;
  const float* F;             // MODE_EPI: F given (then no poses)
  float fx, fy, cx, cy;
  int width, height;
  float tol;                  // epi_tol, or the projection radius
  float* uv_p;                // (N, 2) projected pixels (MODE_PROJ)
  double* geom;               // MODE_EPI from poses: F, R_10, t_10, |t_10|
  float* t_norm;              // () |t_10| (MODE_EPI from poses)
  // the finish (nullptr ok: none)
  int max_dist;
  float ratio;
  int64_t* best;              // (N,) idx as int64
  uint8_t* ok;                // (N,) bool
  int64_t* num;               // () matches
  int2* rec;                  // (N,) the pair modes' rows for the finish: (d1 | d2 << 16, idx)
};

struct SparseSmem {
  unsigned long long col[SPARSE_CW];
  uint16_t queue[WARPS][QUEUE];
};

struct DenseSmem {
  uint4 t[DENSE_CW][2];
  int cols[DENSE_CW];
  Best part[WARPS][DENSE_ROWS];
  uint32_t tbits[DENSE_CW / 32];  // train-mask bits, word w: columns c0 + 32 w + 0..31
};

union Smem {
  SparseSmem s;
  DenseSmem d;
};

// The pair modes' shared memory: the unit's columns in dynamic shared
// memory (pair_smem_bytes), the rest static.
struct PairCols {
  unsigned long long* col;    // the unit's column keys
  float2* uv;                 // the chunk's train pixels (NaN where masked)
  int* lev;                   // and levels
};

constexpr size_t pair_smem_bytes(int cw) {
  return (size_t)cw * (sizeof(unsigned long long) + sizeof(float2) + sizeof(int));
}

// the partial of no live entry
__device__ __forceinline__ Best empty() { return Best{INIT, INT_MAX, INIT}; }

__device__ __forceinline__ Best merge(Best a, Best b) {
  const bool a_wins = (a.d1 < b.d1) || (a.d1 == b.d1 && a.i1 < b.i1);
  Best w = a_wins ? a : b;
  const Best l = a_wins ? b : a;
  w.d2 = min(w.d2, l.d1);
  return w;
}

// merge(b, {d, col, none}): entries may arrive in any order
__device__ __forceinline__ void push(Best& b, int d, int col) {
  if (d < b.d1 || (d == b.d1 && col < b.i1)) {
    b.d2 = b.d1;
    b.d1 = d;
    b.i1 = col;
  } else {
    b.d2 = min(b.d2, d);
  }
}

__device__ __forceinline__ int dist(const uint32_t (&q)[8], uint4 a, uint4 b) {
  return __popc(q[0] ^ a.x) + __popc(q[1] ^ a.y) + __popc(q[2] ^ a.z) +
         __popc(q[3] ^ a.w) + __popc(q[4] ^ b.x) + __popc(q[5] ^ b.y) +
         __popc(q[6] ^ b.z) + __popc(q[7] ^ b.w);
}

__device__ __forceinline__ void load_row(const uint32_t* q, int row, uint32_t (&qr)[8]) {
  const uint4* p = reinterpret_cast<const uint4*>(q + (size_t)row * 8);
  const uint4 a = __ldg(p), b = __ldg(p + 1);
  qr[0] = a.x; qr[1] = a.y; qr[2] = a.z; qr[3] = a.w;
  qr[4] = b.x; qr[5] = b.y; qr[6] = b.z; qr[7] = b.w;
}

// bit k set iff byte k of w is nonzero (k = 0..3)
__device__ __forceinline__ uint32_t nonzero_bytes(uint32_t w) {
  const uint32_t x = (((w & 0x7f7f7f7fu) + 0x7f7f7f7fu) | w) & 0x80808080u;
  return ((x >> 7) | (x >> 14) | (x >> 21) | (x >> 28)) & 0xfu;
}

__device__ __forceinline__ Best warp_merge(Best b) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    Best o;
    o.d1 = __shfl_xor_sync(0xffffffffu, b.d1, off);
    o.i1 = __shfl_xor_sync(0xffffffffu, b.i1, off);
    o.d2 = __shfl_xor_sync(0xffffffffu, b.d2, off);
    b = merge(b, o);
  }
  return b;
}

__device__ __forceinline__ void write_final(const Args& a, int row, Best b) {
  const int d1 = min(b.d1, MASKED), d2 = min(b.d2, MASKED), idx = b.d1 < MASKED ? b.i1 : 0;
  a.d1[row] = d1;
  a.d2[row] = d2;
  a.idx[row] = idx;
  if (a.rec) a.rec[row] = make_int2(d1 | (d2 << 16), idx);
}

// a unit's partial for one row: the result itself when there is one chunk
__device__ __forceinline__ void emit_row(const Args& a, int chunk, int row, Best b) {
  if (a.chunks == 1)
    write_final(a, row, b);
  else
    a.row_part[(size_t)chunk * a.N + row] = make_int2(b.d1 | (b.d2 << 16), b.i1);
}

__device__ __forceinline__ Best unpack_row(int2 p) { return Best{p.x & 0xffff, p.y, p.x >> 16}; }

// With a pair mask: a warp per query row, lanes over the pair-mask bytes.
__device__ void sparse_unit(const Args& a, SparseSmem& s, int group, int chunk, int c0,
                            int c1) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = group + warp * a.groups;
  const bool in = row < a.N;
  const bool live = in && a.qmask[row] != 0;
  const int ncols = c1 - c0;
  for (int c = threadIdx.x; c < ncols; c += THREADS) s.col[c] = COL_INIT;
  if (!__syncthreads_or(live)) {               // every row masked: read no pair byte
    if (in && lane == 0) emit_row(a, chunk, row, empty());
    return;
  }
  if (live) {
    uint32_t qr[8];
    load_row(a.q, row, qr);
    Best b = empty();
    const uintptr_t base = reinterpret_cast<uintptr_t>(a.pair) + (size_t)row * a.M;
    const uintptr_t lo = base + c0, hi = base + c1;
    // the queued live entries: their descriptor loads go out together
    uint16_t* queue = s.queue[warp];
    int queued = 0;                             // warp-uniform
    auto drain = [&]() {
      __syncwarp();
      for (int k0 = lane; k0 < queued; k0 += 32 * DRAIN) {
        // each entry's train-mask byte comes with its descriptor, and a
        // lane's DRAIN entries load together: one round trip
        int col[DRAIN];
        uint8_t tm[DRAIN];
        uint4 t0[DRAIN], t1[DRAIN];
#pragma unroll
        for (int j = 0; j < DRAIN; ++j) {
          const int k = k0 + 32 * j;
          col[j] = c0 + queue[min(k, queued - 1)];
          const uint4* tp = reinterpret_cast<const uint4*>(a.t + (size_t)col[j] * 8);
          tm[j] = k < queued ? a.tmask[col[j]] : 0;
          t0[j] = __ldg(tp);
          t1[j] = __ldg(tp + 1);
        }
#pragma unroll
        for (int j = 0; j < DRAIN; ++j) {
          if (tm[j] == 0) continue;
          const int d = dist(qr, t0[j], t1[j]);
          push(b, d, col[j]);
          atomicMin(&s.col[col[j] - c0], ((unsigned long long)d << 32) | (unsigned)row);
        }
      }
      __syncwarp();
      queued = 0;
    };
    // warp-uniform trips: the shuffles below need every lane
    for (uintptr_t g0 = lo & ~(uintptr_t)15; g0 < hi; g0 += 16 * 32 * UNROLL) {
      const uintptr_t g = g0 + 16 * lane;
      uint4 v[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const uintptr_t p = g + 16 * 32 * u;
        v[u] = p < hi ? __ldcs(reinterpret_cast<const uint4*>(p)) : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const uintptr_t p = g + 16 * 32 * u;
        uint32_t bits = 0;
        if (p < hi) {
          bits = nonzero_bytes(v[u].x) | (nonzero_bytes(v[u].y) << 4) |
                 (nonzero_bytes(v[u].z) << 8) | (nonzero_bytes(v[u].w) << 12);
          // the granule's bytes outside the row's chunk
          if (p < lo) bits &= 0xffffu << (unsigned)(lo - p);
          if (hi - p < 16) bits &= (1u << (unsigned)(hi - p)) - 1u;
        }
        // queue the warp's live columns; they are spread over the lanes
        const int n = __popc(bits);
        int end = n;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const int o = __shfl_up_sync(0xffffffffu, end, off);
          if (lane >= off) end += o;
        }
        const int total = __shfl_sync(0xffffffffu, end, 31);
        if (total == 0) continue;                // warp-uniform
        if (queued + total > QUEUE) drain();     // total <= QUEUE
        for (int k = queued + end - n; bits; ++k, bits &= bits - 1)
          queue[k] = (uint16_t)((int)(p - lo) + __ffs(bits) - 1);
        queued += total;
      }
    }
    if (queued) drain();
    b = warp_merge(b);
    if (lane == 0) emit_row(a, chunk, row, b);
  } else if (in && lane == 0) {
    emit_row(a, chunk, row, empty());
  }
  __syncthreads();
  for (int c = threadIdx.x; c < ncols; c += THREADS) {
    const unsigned long long key = s.col[c];
    if (key < COL_INIT) atomicMin(&a.col_best[c0 + c], key);
  }
}

// Without a pair mask: a lane per query row, warps over the chunk's live
// train columns.
__device__ void dense_unit(const Args& a, DenseSmem& s, int group, int chunk, int c0,
                           int c1) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = group + lane * a.groups;
  const bool in = row < a.N;
  const bool live = in && a.qmask[row] != 0;
  uint32_t qr[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  if (in) load_row(a.q, row, qr);
  // the chunk's train mask as bit words, every load issued before a ballot
  constexpr int WORDS = DENSE_CW / 32;
  uint8_t tm[WORDS / WARPS];
#pragma unroll
  for (int i = 0; i < WORDS / WARPS; ++i) {
    const int col = c0 + 32 * (warp + i * WARPS) + lane;
    tm[i] = col < c1 ? a.tmask[col] : 0;
  }
#pragma unroll
  for (int i = 0; i < WORDS / WARPS; ++i) {
    const unsigned bits = __ballot_sync(0xffffffffu, tm[i] != 0);
    if (lane == 0) s.tbits[warp + i * WARPS] = bits;
  }
  if (!__syncthreads_or(live)) {               // every row masked: stage nothing
    if (warp == 0 && in) emit_row(a, chunk, row, empty());
    return;
  }
  // compact the live columns in increasing order, staging their descriptors
  const int ncols = c1 - c0;
  int n = 0;
#pragma unroll
  for (int w = 0; w < WORDS; ++w) n += __popc(s.tbits[w]);
  for (int c = threadIdx.x; c < ncols; c += THREADS) {
    const uint32_t word = s.tbits[c >> 5];
    if (!((word >> (c & 31)) & 1u)) continue;
    int pos = __popc(word & ((1u << (c & 31)) - 1u));
    for (int w = 0; w < (c >> 5); ++w) pos += __popc(s.tbits[w]);
    const uint4* tp = reinterpret_cast<const uint4*>(a.t + (size_t)(c0 + c) * 8);
    s.cols[pos] = c0 + c;
    s.t[pos][0] = __ldg(tp);
    s.t[pos][1] = __ldg(tp + 1);
  }
  __syncthreads();

  Best b = empty();
  for (int k = warp; k < n; k += WARPS) {
    const int col = s.cols[k];
    const int d = dist(qr, s.t[k][0], s.t[k][1]);
    if (live) push(b, d, col);
    // (d, lane) orders as (d, row): rows grow with the lane
    const unsigned m = __reduce_min_sync(0xffffffffu, live ? ((unsigned)d << 5) | lane : ~0u);
    if (lane == 0)
      atomicMin(&a.col_best[col], ((unsigned long long)(m >> 5) << 32) |
                                      (unsigned)(group + (int)(m & 31u) * a.groups));
  }
  s.part[warp][lane] = b;
  __syncthreads();
  if (warp == 0 && in) {
#pragma unroll
    for (int w = 1; w < WARPS; ++w) b = merge(b, s.part[w][lane]);
    emit_row(a, chunk, row, b);
  }
}

// MODE_EPI: F in double, read or made from the two poses (T_10 = T_new
// T_0^-1 as SE3.compose(T0.inverse()), F = K^-T [t_10]x R_10 K^-1); block 0
// writes F, R_10, t_10 and |t_10| when `geom` is given
__device__ void epi_geometry(const Args& a, double* F) {
  if (a.F) {
    for (int k = 0; k < 9; ++k) F[k] = a.F[k];
    return;
  }
  double R1[9], R0[9], t1[3], t0[3], R10[9], ti[3], t10[3];
  for (int k = 0; k < 9; ++k) {
    R1[k] = __ldg(a.R1 + k);
    R0[k] = __ldg(a.R0 + k);
  }
  for (int k = 0; k < 3; ++k) {
    t1[k] = __ldg(a.t1 + k);
    t0[k] = __ldg(a.t0 + k);
  }
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      R10[3 * i + j] = R1[3 * i] * R0[3 * j] + R1[3 * i + 1] * R0[3 * j + 1] +
                       R1[3 * i + 2] * R0[3 * j + 2];
  for (int i = 0; i < 3; ++i) ti[i] = -(R0[i] * t0[0] + R0[3 + i] * t0[1] + R0[6 + i] * t0[2]);
  for (int i = 0; i < 3; ++i)
    t10[i] = R1[3 * i] * ti[0] + R1[3 * i + 1] * ti[1] + R1[3 * i + 2] * ti[2] + t1[i];
  const double tx[9] = {0.0, -t10[2], t10[1], t10[2], 0.0, -t10[0], -t10[1], t10[0], 0.0};
  const double ifx = 1.0 / (double)a.fx, ify = 1.0 / (double)a.fy;
  const double Ki[9] = {ifx, 0.0, -(double)a.cx * ifx, 0.0, ify, -(double)a.cy * ify,
                        0.0, 0.0, 1.0};
  double A[9], B[9];
  for (int i = 0; i < 3; ++i)          // A = [t]x R_10
    for (int j = 0; j < 3; ++j)
      A[3 * i + j] = tx[3 * i] * R10[j] + tx[3 * i + 1] * R10[3 + j] + tx[3 * i + 2] * R10[6 + j];
  for (int i = 0; i < 3; ++i)          // B = A K^-1
    for (int j = 0; j < 3; ++j)
      B[3 * i + j] = A[3 * i] * Ki[j] + A[3 * i + 1] * Ki[3 + j] + A[3 * i + 2] * Ki[6 + j];
  for (int i = 0; i < 3; ++i)          // F = K^-T B
    for (int j = 0; j < 3; ++j)
      F[3 * i + j] = Ki[i] * B[j] + Ki[3 + i] * B[3 + j] + Ki[6 + i] * B[6 + j];
  if (blockIdx.x == 0 && a.geom) {
    const double n = sqrt(t10[0] * t10[0] + t10[1] * t10[1] + t10[2] * t10[2]);
    for (int k = 0; k < 9; ++k) {
      a.geom[k] = F[k];
      a.geom[9 + k] = R10[k];
    }
    for (int k = 0; k < 3; ++k) a.geom[18 + k] = t10[k];
    a.geom[21] = n;
    *a.t_norm = (float)n;
  }
}

// a query row's side of the pair test: MODE_EPI its line (l0, l1, l2) from
// its pixel x and lim = epi_tol max(l0^2 + l1^2, 1e-9); MODE_PROJ its
// pixel, lim = r^2 and its level, and whether the row is live.
struct RowTest {
  double p0, p1, p2, lim;
  int lev;
};

__device__ __forceinline__ void epi_row(const Args& a, const double* F, float2 x, RowTest& rt) {
  const double u = x.x, v = x.y;
  rt.p0 = F[0] * u + F[1] * v + F[2];
  rt.p1 = F[3] * u + F[4] * v + F[5];
  rt.p2 = F[6] * u + F[7] * v + F[8];
  rt.lim = (double)a.tol * fmax(rt.p0 * rt.p0 + rt.p1 * rt.p1, 1e-9);
  rt.lev = 0;
}

// PinholeCamera.project and in_bounds(border=2) in double; the row's test
// in chunk 0 writes its pixel (every row, visible or not, as the plain form)
__device__ __forceinline__ bool proj_row(const Args& a, int row, bool write, RowTest& rt) {
  const double X = a.Xw[3 * row], Y = a.Xw[3 * row + 1], Z = a.Xw[3 * row + 2];
  double c[3];
  for (int i = 0; i < 3; ++i)
    c[i] = (double)a.R1[3 * i] * X + (double)a.R1[3 * i + 1] * Y + (double)a.R1[3 * i + 2] * Z +
           (double)a.t1[i];
  const double z = c[2];
  const double iz = 1.0 / (fabs(z) < 1e-12 ? 1e-12 : z);
  const double u = (double)a.fx * c[0] * iz + (double)a.cx;
  const double v = (double)a.fy * c[1] * iz + (double)a.cy;
  if (write) reinterpret_cast<float2*>(a.uv_p)[row] = make_float2((float)u, (float)v);
  // radius 1.5^level in float32 (exact for small levels), squared
  const int lev = a.level_q[row];
  float r = a.tol;
  for (int k = 0; k < lev; ++k) r = __fmul_rn(r, 1.5f);
  rt.p0 = u;
  rt.p1 = v;
  rt.p2 = 0.0;
  rt.lim = (double)__fmul_rn(r, r);
  rt.lev = lev;
  return a.qmask[row] != 0 && z > 1e-6 && u >= 2.0 && u <= (double)(a.width - 3) && v >= 2.0 &&
         v <= (double)(a.height - 3);
}

template <int MODE>
__device__ __forceinline__ bool pair_test(const RowTest& rt, const PairCols& s, int c) {
  const float2 x = s.uv[c];
  if constexpr (MODE == MODE_EPI) {
    const double n = rt.p0 * (double)x.x + rt.p1 * (double)x.y + rt.p2;
    return n * n <= rt.lim;
  } else {
    const double du = (double)x.x - rt.p0, dv = (double)x.y - rt.p1;
    return du * du + dv * dv <= rt.lim && abs(rt.lev - s.lev[c]) <= 1;
  }
}

struct PairSmem {
  uint16_t queue[WARPS][QUEUE];
  RowTest rt[PAIR_ROWS];      // the live rows' tests
  int rows[PAIR_ROWS];        // and the rows
  Best part[WARPS];           // a split row's slices' partials
  double F[9];
  int n_live;
  int wsum[WARPS];
  unsigned int last;
};

// With a pair test: the unit's rows tested a thread a row (row j of the
// group is row group + j groups), its columns staged meanwhile; the live
// rows listed in shared memory and taken a warp at a time, its lanes over
// the chunk's columns 32 at a time, the live columns queued by ballot and
// drained as sparse_unit drains them; then the unit's column keys to the
// global ones.
template <int MODE>
__device__ void pair_unit(const Args& a, PairSmem& s, const PairCols& sc, int group, int chunk,
                          int c0, int c1) {
  // stage: pair_start
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ncols = c1 - c0;
  // MODE_EPI: thread 0 makes the geometry first, its loads ahead of the
  // staging's
  if (MODE == MODE_EPI && threadIdx.x == 0) epi_geometry(a, s.F);
  // the chunk's columns, every load in flight before the row tests
  constexpr int PER = PAIR_CW / THREADS;
  float2 uv[PER];
  int lev[PER];
  uint8_t tm[PER];
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int c = (int)threadIdx.x + k * THREADS;
    if (c < ncols) {
      uv[k] = __ldg(reinterpret_cast<const float2*>(a.uv_t) + c0 + c);
      tm[k] = a.tmask[c0 + c];
      if constexpr (MODE == MODE_PROJ) lev[k] = __ldg(a.level_t + c0 + c);
    }
  }
  const int row = group + (int)threadIdx.x * a.groups;
  const bool in = threadIdx.x < PAIR_ROWS && row < a.N;
  // MODE_EPI: the row's pixel and mask in flight with the geometry
  float2 xq = make_float2(0.f, 0.f);
  bool qm = false;
  if (MODE == MODE_EPI && in) {
    xq = __ldg(reinterpret_cast<const float2*>(a.uv_q) + row);
    qm = a.qmask[row] != 0;
  }
  if (threadIdx.x == 0) s.n_live = 0;
  __syncthreads();
  // stage: pair_zero_geometry
  RowTest rt{};
  bool live = false;
  if (in) {
    if constexpr (MODE == MODE_EPI) {
      epi_row(a, s.F, xq, rt);
      live = qm;
    } else {
      live = proj_row(a, row, chunk == 0, rt);
    }
  }
  // list the live rows (any order: a row's result does not depend on its
  // warp), emit the others
  if (live) {
    const int k = atomicAdd(&s.n_live, 1);
    s.rt[k] = rt;
    s.rows[k] = row;
  } else if (in) {
    emit_row(a, chunk, row, empty());
  }
  if (!__syncthreads_or(live)) return;         // every row masked: stage nothing
  // stage: pair_row_test
  // a masked column's pixel staged as NaN, which fails every pair test
  // (as does a NaN pixel itself), so the tests need no mask
  const float nan = __int_as_float(0x7fc00000);
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int c = (int)threadIdx.x + k * THREADS;
    if (c < ncols) {
      sc.col[c] = COL_INIT;
      sc.uv[c] = tm[k] ? uv[k] : make_float2(nan, nan);
      if constexpr (MODE == MODE_PROJ) sc.lev[c] = lev[k];
    }
  }
  __syncthreads();
  // stage: pair_staging
  // the work: a live row's columns in `slices` parts when the warps
  // outnumber the live rows, item w = (row w / slices, part w % slices), in
  // granules of 32 BALLOTS columns
  const int n_live = s.n_live;
  const int slices = max(1, WARPS / n_live);
  const int granules = (ncols + 32 * BALLOTS - 1) / (32 * BALLOTS);
  uint16_t* queue = s.queue[warp];
  for (int w = warp; w < n_live * slices; w += WARPS) {
    const int k = w / slices, part = w % slices;
    const RowTest rk = s.rt[k];
    const int r = s.rows[k];
    const int g0 = part * granules / slices, g1 = (part + 1) * granules / slices;
    uint32_t qr[8];
    load_row(a.q, r, qr);
    Best b = empty();
    int queued = 0;                             // warp-uniform
    auto drain = [&]() {
      __syncwarp();
      for (int k0 = lane; k0 < queued; k0 += 32 * DRAIN) {
        int col[DRAIN];
        uint4 t0[DRAIN], t1[DRAIN];
#pragma unroll
        for (int j = 0; j < DRAIN; ++j) {
          col[j] = c0 + queue[min(k0 + 32 * j, queued - 1)];
          const uint4* tp = reinterpret_cast<const uint4*>(a.t + (size_t)col[j] * 8);
          t0[j] = __ldg(tp);
          t1[j] = __ldg(tp + 1);
        }
#pragma unroll
        for (int j = 0; j < DRAIN; ++j) {
          if (k0 + 32 * j >= queued) continue;
          const int d = dist(qr, t0[j], t1[j]);
          push(b, d, col[j]);
          atomicMin(&sc.col[col[j] - c0], ((unsigned long long)d << 32) | (unsigned)r);
        }
      }
      __syncwarp();
      queued = 0;
    };
    // warp-uniform trips: the ballots need every lane; BALLOTS groups of
    // 32 columns tested before their ballots, without branches, so that
    // their tests overlap
    for (int base = 32 * BALLOTS * g0; base < 32 * BALLOTS * g1; base += 32 * BALLOTS) {
      bool p[BALLOTS];
#pragma unroll
      for (int u = 0; u < BALLOTS; ++u) {
        const int c = base + 32 * u + lane;
        p[u] = (c < ncols) & pair_test<MODE>(rk, sc, min(c, ncols - 1));
      }
#pragma unroll
      for (int u = 0; u < BALLOTS; ++u) {
        const unsigned bits = __ballot_sync(0xffffffffu, p[u]);
        if (bits == 0) continue;                 // warp-uniform
        const int n = __popc(bits);
        if (queued + n > QUEUE) drain();
        if (p[u]) queue[queued + __popc(bits & ((1u << lane) - 1u))] =
            (uint16_t)(base + 32 * u + lane);
        queued += n;
      }
    }
    // stage: pair_ballots
    if (queued) drain();
    b = warp_merge(b);
    if (lane == 0) {
      if (slices == 1)
        emit_row(a, chunk, r, b);
      else
        s.part[w] = b;
    }
    // stage: pair_drains
  }
  __syncthreads();
  // a split row's parts merged (order-free) and emitted
  if (slices > 1 && (int)threadIdx.x < n_live) {
    Best b = s.part[threadIdx.x * slices];
    for (int q = 1; q < slices; ++q) b = merge(b, s.part[threadIdx.x * slices + q]);
    emit_row(a, chunk, s.rows[threadIdx.x], b);
  }
  for (int c = threadIdx.x; c < ncols; c += THREADS) {
    const unsigned long long key = sc.col[c];
    if (key < COL_INIT) atomicMin(&a.col_best[c0 + c], key);
  }
  // stage: pair_col_atomics
}

// a thread's FIN_ROWS rows' records from row i0 on (rows i0 + k THREADS)
__device__ __forceinline__ void load_recs(const Args& a, int i0, int2 (&rec)[FIN_ROWS]) {
#pragma unroll
  for (int k = 0; k < FIN_ROWS; ++k) {
    const int i = i0 + k * THREADS;
    rec[k] = i < a.N ? __ldcg(a.rec + i) : make_int2(0, 0);
  }
}

// matching._finish over every row: d1 <= max_dist, float(d1) < ratio
// float(d2) in float32, and the chosen column's best row is this row; the
// column as int64 and the number of matches. A row's (d1, d2, idx) from
// its record, `rec` holding the thread's first FIN_ROWS already; the
// column's best row from the unpacked keys `keys` (columns 0..M-1, one
// chunk) or from col_row.
__device__ void finish(const Args& a, PairSmem& s, const unsigned long long* keys,
                       int2 (&rec)[FIN_ROWS]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int n = 0;
  for (int i0 = threadIdx.x; i0 < a.N; i0 += THREADS * FIN_ROWS) {
    if (i0 != (int)threadIdx.x) load_recs(a, i0, rec);
    int cr[FIN_ROWS];
#pragma unroll
    for (int k = 0; k < FIN_ROWS; ++k)
      if (i0 + k * THREADS < a.N) {
        const int j = rec[k].y;
        cr[k] = keys ? (int32_t)(uint32_t)(keys[j] & 0xffffffffull) : __ldcg(a.col_row + j);
      }
#pragma unroll
    for (int k = 0; k < FIN_ROWS; ++k) {
      const int i = i0 + k * THREADS;
      if (i >= a.N) continue;
      const int d1 = rec[k].x & 0xffff, d2 = rec[k].x >> 16, j = rec[k].y;
      const bool ok = d1 <= a.max_dist && (float)d1 < __fmul_rn(a.ratio, (float)d2) && cr[k] == i;
      a.ok[i] = ok;
      a.best[i] = j;
      n += ok;
    }
  }
  n = __reduce_add_sync(0xffffffffu, n);
  if (lane == 0) s.wsum[warp] = n;
  __syncthreads();
  if (threadIdx.x == 0) {
    long long total = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) total += s.wsum[w];
    *a.num = total;
  }
  // stage: finish
}

// the last unit of a row group: a warp per row, lanes over the chunks;
// every first load in flight at once
__device__ void merge_rows(const Args& a, int group, int rows_per_group) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int j0 = 0; j0 < rows_per_group; j0 += WARPS) {
    const int row = group + (j0 + warp) * a.groups;
    if (j0 + warp >= rows_per_group || row >= a.N) continue;   // warp-uniform
    Best b = lane < a.chunks ? unpack_row(__ldcg(&a.row_part[(size_t)lane * a.N + row]))
                             : empty();
    for (int c = lane + 32; c < a.chunks; c += 32)
      b = merge(b, unpack_row(__ldcg(&a.row_part[(size_t)c * a.N + row])));
    b = warp_merge(b);
    if (lane == 0) write_final(a, row, b);
  }
}

// the last unit of a column chunk: its keys unpacked into col_row and reset,
// and kept in `keys` (shared memory) when given
__device__ void unpack_cols(const Args& a, int c0, int c1, unsigned long long* keys) {
  constexpr int PER = PAIR_CW / THREADS;
  unsigned long long key[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int j = c0 + (int)threadIdx.x + i * THREADS;
    key[i] = j < c1 ? __ldcg(&a.col_best[j]) : 0ull;
  }
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int j = c0 + (int)threadIdx.x + i * THREADS;
    if (j < c1) {
      a.col_row[j] = (int32_t)(uint32_t)(key[i] & 0xffffffffull);
      a.col_best[j] = COL_INIT;
      if (keys) keys[j - c0] = key[i];
    }
  }
}

// The pair modes: (row group, column chunk) units, then the tickets.
template <int MODE>
__global__ void __launch_bounds__(THREADS, PAIR_BLOCKS_PER_SM) pairs_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char dyn[];
  __shared__ PairSmem s;
  const int chunk = blockIdx.x % a.chunks, group = blockIdx.x / a.chunks;
  const int c0 = chunk * a.cw, c1 = min(c0 + a.cw, a.M);
  const PairCols sc{reinterpret_cast<unsigned long long*>(dyn),
                    reinterpret_cast<float2*>(dyn + (size_t)a.cw * 8),
                    reinterpret_cast<int*>(dyn + (size_t)a.cw * 16)};
  pair_unit<MODE>(a, s, sc, group, chunk, c0, c1);

  // tickets: the last unit of a row group merges its rows, the last unit
  // of a column chunk unpacks its columns; with one chunk that unit is the
  // last of all and finishes. The barrier, then one thread's fences around
  // its tickets (the pattern of cooperative groups' grid barrier), order the
  // block's writes before the ticket and the last block's reads after it.
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    unsigned int l = 0;
    if (a.chunks > 1 && atomicAdd(&a.tickets[group], 1u) == (unsigned)a.chunks - 1u) l |= 1u;
    if (atomicAdd(&a.tickets[a.groups + chunk], 1u) == (unsigned)a.groups - 1u) l |= 2u;
    if (l) __threadfence();
    s.last = l;
  }
  __syncthreads();
  const unsigned int l = s.last;
  // stage: tickets
  if (l & 1u) {
    merge_rows(a, group, min(PAIR_ROWS, (a.N - group + a.groups - 1) / a.groups));
    if (threadIdx.x == 0) a.tickets[group] = 0;
    // stage: row_merge
  }
  if (l & 2u) {
    // with one chunk, the finish's first rows load with the keys
    int2 rec[FIN_ROWS];
    if (a.chunks == 1) load_recs(a, threadIdx.x, rec);
    unpack_cols(a, c0, c1, a.chunks == 1 ? sc.col : nullptr);
    if (threadIdx.x == 0) a.tickets[a.groups + chunk] = 0;
    // stage: col_unpack
    if (a.chunks == 1) {
      __syncthreads();
      finish(a, s, sc.col, rec);
      return;
    }
  }
  if (a.chunks == 1) return;
  // the finish: the last block of all, after every row and column is final
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    const bool fin = atomicAdd(&a.tickets[a.groups + a.chunks], 1u) == gridDim.x - 1u;
    if (fin) __threadfence();
    s.last = fin;
  }
  __syncthreads();
  if (s.last) {
    int2 rec[FIN_ROWS];
    load_recs(a, threadIdx.x, rec);
    finish(a, s, nullptr, rec);
    if (threadIdx.x == 0) a.tickets[a.groups + a.chunks] = 0;
  }
}

template <int MODE>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS) hamming_resolve_kernel(const Args a) {
  __shared__ Smem sm;
  __shared__ unsigned int last;
  constexpr bool SPARSE = MODE != MODE_DENSE;
  const int chunk = blockIdx.x % a.chunks, group = blockIdx.x / a.chunks;
  const int c0 = chunk * a.cw, c1 = min(c0 + a.cw, a.M);
  if constexpr (MODE == MODE_MASK)
    sparse_unit(a, sm.s, group, chunk, c0, c1);
  else
    dense_unit(a, sm.d, group, chunk, c0, c1);

  // tickets: the last unit of a row group merges its rows, the last unit
  // of a column chunk unpacks its columns. The barrier, then one thread's
  // fences around its tickets (the pattern of cooperative groups' grid
  // barrier), order the block's writes before the ticket and the last
  // block's reads after it.
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    unsigned int l = 0;
    if (a.chunks > 1 && atomicAdd(&a.tickets[group], 1u) == (unsigned)a.chunks - 1u) l |= 1u;
    if (atomicAdd(&a.tickets[a.groups + chunk], 1u) == (unsigned)a.groups - 1u) l |= 2u;
    if (l) __threadfence();
    last = l;
  }
  __syncthreads();
  const unsigned int l = last;
  if (l == 0) return;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (l & 1u) {
    // a warp per row, lanes over the chunks; every first load in flight at once
    constexpr int RPW = (SPARSE ? SPARSE_ROWS : DENSE_ROWS) / WARPS;
    int2 p[RPW];
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const int row = group + (warp + r * WARPS) * a.groups;
      p[r] = row < a.N && lane < a.chunks ? __ldcg(&a.row_part[(size_t)lane * a.N + row])
                                         : make_int2(INIT | (INIT << 16), INT_MAX);
    }
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const int row = group + (warp + r * WARPS) * a.groups;
      if (row >= a.N) continue;                  // warp-uniform
      Best b = unpack_row(p[r]);
      for (int c = lane + 32; c < a.chunks; c += 32)
        b = merge(b, unpack_row(__ldcg(&a.row_part[(size_t)c * a.N + row])));
      b = warp_merge(b);
      if (lane == 0) write_final(a, row, b);
    }
    if (threadIdx.x == 0) a.tickets[group] = 0;
  }
  if (l & 2u) {
    constexpr int PER = (SPARSE ? SPARSE_CW : DENSE_CW) / THREADS;
    unsigned long long key[PER];
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int j = c0 + (int)threadIdx.x + i * THREADS;
      key[i] = j < c1 ? __ldcg(&a.col_best[j]) : 0ull;
    }
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int j = c0 + (int)threadIdx.x + i * THREADS;
      if (j < c1) {
        a.col_row[j] = (int32_t)(uint32_t)(key[i] & 0xffffffffull);
        a.col_best[j] = COL_INIT;
      }
    }
    if (threadIdx.x == 0) a.tickets[a.groups + chunk] = 0;
  }
}

}  // namespace

// C entry point (bound with ctypes). One launch on `stream`; returns the
// CUDA error code (0 on success). `pair` may be null. The plan (groups,
// chunks, cw) comes from the wrapper: groups = ceil(N / 8) with a pair mask
// and ceil(N / 32) without, cw <= 2048 and 512, chunks = ceil(M / cw).
extern "C" int hamming_resolve_launch(const void* q, const void* qmask, const void* t,
                                      const void* tmask, const void* pair, int N, int M,
                                      int groups, int chunks, int cw, void* d1, void* d2,
                                      void* idx, void* col_row, void* row_part,
                                      void* col_best, void* tickets, void* stream) {
  const int rows = pair ? SPARSE_ROWS : DENSE_ROWS;
  if (N <= 0 || M <= 0 || groups <= 0 || chunks <= 0 || cw <= 0 ||
      (long long)groups * rows < N || cw > (pair ? SPARSE_CW : DENSE_CW) ||
      (long long)chunks * cw < M || (long long)(chunks - 1) * cw >= M ||
      (chunks > 1 && row_part == nullptr))
    return (int)cudaErrorInvalidValue;
  Args a{static_cast<const uint32_t*>(q), static_cast<const uint8_t*>(qmask),
         static_cast<const uint32_t*>(t), static_cast<const uint8_t*>(tmask),
         static_cast<const uint8_t*>(pair), N, M, groups, chunks, cw,
         static_cast<int32_t*>(d1), static_cast<int32_t*>(d2), static_cast<int32_t*>(idx),
         static_cast<int32_t*>(col_row), static_cast<int2*>(row_part),
         static_cast<unsigned long long*>(col_best), static_cast<unsigned int*>(tickets)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned int blocks = (unsigned int)groups * (unsigned int)chunks;
  if (pair)
    hamming_resolve_kernel<MODE_MASK><<<blocks, THREADS, 0, s>>>(a);
  else
    hamming_resolve_kernel<MODE_DENSE><<<blocks, THREADS, 0, s>>>(a);
  return (int)cudaGetLastError();
}

// C entry point of the pair-test modes (bound with ctypes): one launch on
// `stream`, returns the CUDA error code. `p` holds the pointers in the
// order of ops/hamming_match.py PRED_POINTERS, `f` the floats (fx, fy, cx,
// cy, tol, ratio), `i` the ints (mode, N, M, groups, chunks, cw, width,
// height, max_dist). The plan (ops/hamming_match.py pair_plan): groups >=
// ceil(N / PAIR_ROWS), cw <= PAIR_CW, chunks = ceil(M / cw); tickets holds
// groups + chunks + 1 counters.
extern "C" int hamming_pairs_launch(void* const* p, const double* f, const int* i,
                                    void* stream) {
  const int mode = i[0], N = i[1], M = i[2], groups = i[3], chunks = i[4], cw = i[5];
  if ((mode != MODE_EPI && mode != MODE_PROJ) || N <= 0 || M <= 0 || groups <= 0 ||
      chunks <= 0 || cw <= 0 || (long long)groups * PAIR_ROWS < N || cw > PAIR_CW ||
      (long long)chunks * cw < M || (long long)(chunks - 1) * cw >= M ||
      (chunks > 1 && p[9] == nullptr) || p[26] == nullptr || p[28] == nullptr ||
      (mode == MODE_EPI && p[21] == nullptr && (p[17] == nullptr || p[19] == nullptr)) ||
      (mode == MODE_PROJ && (p[14] == nullptr || p[22] == nullptr)))
    return (int)cudaErrorInvalidValue;
  Args a{};
  a.q = static_cast<const uint32_t*>(p[0]);
  a.qmask = static_cast<const uint8_t*>(p[1]);
  a.t = static_cast<const uint32_t*>(p[2]);
  a.tmask = static_cast<const uint8_t*>(p[3]);
  a.pair = nullptr;
  a.N = N; a.M = M; a.groups = groups; a.chunks = chunks; a.cw = cw;
  a.d1 = static_cast<int32_t*>(p[5]);
  a.d2 = static_cast<int32_t*>(p[6]);
  a.idx = static_cast<int32_t*>(p[7]);
  a.col_row = static_cast<int32_t*>(p[8]);
  a.row_part = static_cast<int2*>(p[9]);
  a.col_best = static_cast<unsigned long long*>(p[10]);
  a.tickets = static_cast<unsigned int*>(p[11]);
  a.uv_q = static_cast<const float*>(p[12]);
  a.uv_t = static_cast<const float*>(p[13]);
  a.Xw = static_cast<const float*>(p[14]);
  a.level_q = static_cast<const int32_t*>(p[15]);
  a.level_t = static_cast<const int32_t*>(p[16]);
  a.R1 = static_cast<const float*>(p[17]);
  a.t1 = static_cast<const float*>(p[18]);
  a.R0 = static_cast<const float*>(p[19]);
  a.t0 = static_cast<const float*>(p[20]);
  a.F = static_cast<const float*>(p[21]);
  a.uv_p = static_cast<float*>(p[22]);
  a.geom = static_cast<double*>(p[23]);
  a.t_norm = static_cast<float*>(p[24]);
  a.best = static_cast<int64_t*>(p[25]);
  a.ok = static_cast<uint8_t*>(p[26]);
  a.num = static_cast<int64_t*>(p[27]);
  a.rec = static_cast<int2*>(p[28]);
  a.fx = (float)f[0]; a.fy = (float)f[1]; a.cx = (float)f[2]; a.cy = (float)f[3];
  a.tol = (float)f[4];
  a.ratio = (float)f[5];
  a.width = i[6]; a.height = i[7]; a.max_dist = i[8];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned int blocks = (unsigned int)groups * (unsigned int)chunks;
  const size_t smem = pair_smem_bytes(cw);
  // the columns' dynamic shared memory and the static part may pass the
  // default 48 KB (on the current device)
  const int most = (int)pair_smem_bytes(PAIR_CW);
  const cudaError_t e =
      mode == MODE_EPI
          ? cudaFuncSetAttribute(pairs_kernel<MODE_EPI>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, most)
          : cudaFuncSetAttribute(pairs_kernel<MODE_PROJ>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, most);
  if (e != cudaSuccess) return (int)e;
  if (mode == MODE_EPI)
    pairs_kernel<MODE_EPI><<<blocks, THREADS, smem, s>>>(a);
  else
    pairs_kernel<MODE_PROJ><<<blocks, THREADS, smem, s>>>(a);
  return (int)cudaGetLastError();
}
