// Fused masked-Hamming match resolution for Hopper (sm_90a).
//
// Replaces the TPU kernel `hamming_resolve_pallas` (libcml_tpu/ops/
// pallas_match.py:107, body `_make_kernel` :39-103). For a masked (N, M)
// Hamming-distance matrix over 256-bit ORB descriptors it computes, in one
// sweep and without ever storing the matrix:
//   d1[i], d2[i]  best and second-best distance of query row i
//                 (second best = second smallest of the row's multiset, so
//                 two columns tied at the best give d2 == d1),
//   idx[i]        first column reaching d1 (ties -> lowest column),
//   col_row[j]    first row reaching the minimum of column j (mutual check).
// A masked entry counts 257 (> any 256-bit distance), so a fully masked row
// gives (257, 257, 0) and a fully masked column gives row 0, as argmin does.
//
// What bounds it on this card. Work: 8 XOR, 8 population counts and 8 adds
// per entry. On sm_90 population count issues at 16 per clock and SM, XOR
// and integer add at 64, so the popcount pipe is the operations floor:
// 8 * entries / (SMs * 16 * SM clock). Bytes: the (N, M) pair mask (6.3 MB
// at 4096 x 1536) plus (N + M) * 32 bytes of descriptors. This kernel
// computes every entry, masked or not, so its own floor is the popcounts of
// all N * M entries, and it stays a few times above that (PERF.md): 16 rows
// per block leave the SMs under-occupied (256 blocks at 4096 rows, 96 at
// 1536) and the word-major staging has 8-way bank conflicts. The result
// needs only the entries that pass every mask (under the match radius a
// small fraction), so a design that skips masked entries would be bound by
// reading the pair mask instead.
//
// Design. The TPU version walks train tiles IN ORDER on one core and
// carries each row's top-2 across grid steps in VMEM. Hopper blocks run in
// no order, so instead:
//   - each block owns ROWS query rows (WARPS warps x ROWS_PER_WARP rows)
//     and loops over the whole train set in tiles of TILE columns staged in
//     shared memory, transposed (word-major) so a warp's lanes read
//     consecutive banks;
//   - a lane visits its columns in increasing order and keeps, per row, a
//     partial (d1, i1, d2); partials merge lexicographically on (d, index)
//     with d2 = min(winner.d2, loser.d1) — first-occurrence ties and the
//     reference's d2 — by a butterfly of warp shuffles at the end;
//   - the per-column best row crosses blocks: each block first reduces its
//     rows into shared memory with 64-bit atomicMin on
//     (dist << 32) | row, then one global 64-bit atomicMin per column and
//     tile; a second tiny kernel unpacks the row index.
// The query rows stay in registers, the pair mask is read once, coalesced.
// A tensor-core (int8/b1 mma) formulation is later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int WORDS = 8;
constexpr int WARPS = 8;
constexpr int ROWS_PER_WARP = 2;
constexpr int ROWS = WARPS * ROWS_PER_WARP;      // query rows per block
constexpr int TILE = 256;                        // train columns per tile
constexpr int THREADS = WARPS * 32;
constexpr int MASKED = 257;
constexpr int INIT = 258;                        // loses to every real entry

struct Best {
  int d1;
  int i1;
  int d2;
};

__device__ __forceinline__ Best merge(Best a, Best b) {
  const bool a_wins = (a.d1 < b.d1) || (a.d1 == b.d1 && a.i1 < b.i1);
  Best w = a_wins ? a : b;
  const Best l = a_wins ? b : a;
  w.d2 = min(w.d2, l.d1);
  return w;
}

__global__ void __launch_bounds__(THREADS)
hamming_resolve_kernel(const uint32_t* __restrict__ q,
                       const uint8_t* __restrict__ qmask,
                       const uint32_t* __restrict__ t,
                       const uint8_t* __restrict__ tmask,
                       const uint8_t* __restrict__ pair,   // nullptr: no pair mask
                       int N, int M,
                       int32_t* __restrict__ d1_out,
                       int32_t* __restrict__ d2_out,
                       int32_t* __restrict__ idx_out,
                       unsigned long long* __restrict__ col_best) {
  __shared__ uint32_t t_s[WORDS][TILE];
  __shared__ uint8_t tm_s[TILE];
  __shared__ unsigned long long col_s[TILE];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * ROWS + warp * ROWS_PER_WARP;

  uint32_t qr[ROWS_PER_WARP][WORDS];
  bool qok[ROWS_PER_WARP];
  bool in_range[ROWS_PER_WARP];
  Best best[ROWS_PER_WARP];
#pragma unroll
  for (int r = 0; r < ROWS_PER_WARP; ++r) {
    const int row = row0 + r;
    in_range[r] = row < N;
    qok[r] = in_range[r] && qmask[row] != 0;
#pragma unroll
    for (int w = 0; w < WORDS; ++w) qr[r][w] = in_range[r] ? q[row * WORDS + w] : 0u;
    best[r] = Best{INIT, 0x7fffffff, INIT};
  }

  for (int base = 0; base < M; base += TILE) {
    // stage the tile, word-major
    for (int k = threadIdx.x; k < TILE * WORDS; k += THREADS) {
      const int c = k / WORDS, w = k % WORDS;
      const int col = base + c;
      t_s[w][c] = col < M ? t[col * WORDS + w] : 0u;
    }
    for (int c = threadIdx.x; c < TILE; c += THREADS) {
      const int col = base + c;
      tm_s[c] = col < M ? tmask[col] : 0;
      col_s[c] = ~0ull;
    }
    __syncthreads();

    for (int c = lane; c < TILE; c += 32) {
      const int col = base + c;
      if (col >= M) break;
      unsigned long long ckey = ~0ull;
#pragma unroll
      for (int r = 0; r < ROWS_PER_WARP; ++r) {
        if (!in_range[r]) continue;
        const int row = row0 + r;
        int d = 0;
#pragma unroll
        for (int w = 0; w < WORDS; ++w) d += __popc(qr[r][w] ^ t_s[w][c]);
        const bool ok = qok[r] && tm_s[c] != 0 &&
                        (pair == nullptr || pair[(size_t)row * M + col] != 0);
        d = ok ? d : MASKED;
        // columns arrive in increasing order per lane: strict < keeps the
        // first occurrence, and a tie with d1 becomes the second best
        if (d < best[r].d1) {
          best[r].d2 = best[r].d1;
          best[r].d1 = d;
          best[r].i1 = col;
        } else if (d < best[r].d2) {
          best[r].d2 = d;
        }
        const unsigned long long key =
            ((unsigned long long)d << 32) | (unsigned long long)(uint32_t)row;
        ckey = key < ckey ? key : ckey;
      }
      if (ckey != ~0ull) atomicMin(&col_s[c], ckey);
    }
    __syncthreads();
    for (int c = threadIdx.x; c < TILE; c += THREADS) {
      const int col = base + c;
      if (col < M && col_s[c] != ~0ull) atomicMin(&col_best[col], col_s[c]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < ROWS_PER_WARP; ++r) {
    Best b = best[r];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      Best o;
      o.d1 = __shfl_xor_sync(0xffffffffu, b.d1, off);
      o.i1 = __shfl_xor_sync(0xffffffffu, b.i1, off);
      o.d2 = __shfl_xor_sync(0xffffffffu, b.d2, off);
      b = merge(b, o);
    }
    const int row = row0 + r;
    if (lane == 0 && row < N) {
      d1_out[row] = b.d1;
      d2_out[row] = min(b.d2, MASKED);
      idx_out[row] = b.i1;
    }
  }
}

__global__ void unpack_col_kernel(const unsigned long long* __restrict__ col_best,
                                  int M, int32_t* __restrict__ col_row) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j < M) col_row[j] = (int32_t)(uint32_t)(col_best[j] & 0xffffffffull);
}

}  // namespace

// C entry point (bound with ctypes). Launches on `stream`; returns the CUDA
// error code of the launches (0 on success). `pair` may be null.
// `col_scratch` holds M 64-bit words.
extern "C" int hamming_resolve_launch(const void* q, const void* qmask,
                                      const void* t, const void* tmask,
                                      const void* pair, int N, int M,
                                      void* d1, void* d2, void* idx,
                                      void* col_row, void* col_scratch,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(col_scratch, 0xff,
                                    sizeof(unsigned long long) * (size_t)M, s);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (N + ROWS - 1) / ROWS;
  hamming_resolve_kernel<<<blocks, THREADS, 0, s>>>(
      static_cast<const uint32_t*>(q), static_cast<const uint8_t*>(qmask),
      static_cast<const uint32_t*>(t), static_cast<const uint8_t*>(tmask),
      static_cast<const uint8_t*>(pair), N, M,
      static_cast<int32_t*>(d1), static_cast<int32_t*>(d2),
      static_cast<int32_t*>(idx),
      static_cast<unsigned long long*>(col_scratch));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  unpack_col_kernel<<<(M + 255) / 256, 256, 0, s>>>(
      static_cast<const unsigned long long*>(col_scratch), M,
      static_cast<int32_t*>(col_row));
  return (int)cudaGetLastError();
}
