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
  unsigned int* tickets;      // [groups] row-group, then [chunks] column-chunk
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
  a.d1[row] = min(b.d1, MASKED);
  a.d2[row] = min(b.d2, MASKED);
  a.idx[row] = b.d1 < MASKED ? b.i1 : 0;
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

template <bool SPARSE>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS) hamming_resolve_kernel(const Args a) {
  __shared__ Smem sm;
  __shared__ unsigned int last;
  const int chunk = blockIdx.x % a.chunks, group = blockIdx.x / a.chunks;
  const int c0 = chunk * a.cw, c1 = min(c0 + a.cw, a.M);
  if constexpr (SPARSE)
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
    hamming_resolve_kernel<true><<<blocks, THREADS, 0, s>>>(a);
  else
    hamming_resolve_kernel<false><<<blocks, THREADS, 0, s>>>(a);
  return (int)cudaGetLastError();
}
