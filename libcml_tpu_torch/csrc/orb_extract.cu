// ORB extraction on a pyramid, three launches a call, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package leaves ORB extraction to XLA,
// which fuses `extract_orb` (libcml_tpu/models/indirect/orb.py:137), the
// `_extract_level` it runs per level (:116: `fast_score_map`, fast.py:46,
// the 3x3 NMS, `_grid_topk` :93, `lax.top_k` :125, `ic_angle` :59,
// `brief_descriptor` :76) into a few device programs a level. Its plain
// PyTorch form is `extract_orb_plain` in libcml_tpu_torch/models/indirect/
// orb.py (same arguments and results); `extract_orb` dispatches between the
// two by the pyramid's device.
//
// Per level l (H x W, Hc = H / 16 by Wc = W / 16 cells), for B = budget:
//   1. fast_cells_kernel, a block a 16 x 16 cell, every level in one launch.
//      The cell's image tile with a 4-pixel halo (3 for the circle, 1 for
//      the NMS) goes to shared memory; the FAST-9 score of the cell and its
//      one-pixel ring: the 16 circle samples (fast.py _CIRCLE, clockwise
//      from 12 o'clock), brighter (v > c + t) and darker (v < c - t) as
//      16-bit masks, "9 contiguous" as an AND of the doubled mask shifted by
//      0..8 (no scan), the masked sums of (v - c) - t and (c - v) - t added
//      in lane order, the larger of the two that pass, 0 on the 3-pixel
//      border. NMS keeps s where s >= every neighbour inside the image and
//      s > 0 (the plain form's 3x3 max with -inf padding). The cell's top 4
//      by (score, lower row-major index first): a non-negative float orders
//      as its bits, so four rounds a warp of a redux.sync maximum over the
//      bits and a ballot for the lowest lane holding it, then four over the
//      eight warps' picks: the candidates c * 4 + r of the level, as
//      `_grid_topk`'s stable top-k orders them.
//   2. level_rank_kernel: a candidate's rank in its level is the number of
//      candidates with a greater score plus those with an equal score and a
//      lower index: `lax.top_k`'s (and the stable sort's) order exactly,
//      without a sort. A block ranks 32 candidates, a lane each, its 32
//      warps splitting the level's scores (staged in shared memory, 8,192
//      a pass, read four at a time) and adding their counts in a fixed
//      order. A rank under B owns slot `rank` of the level: its pixel and
//      score are written there.
//   3. describe_kernel, a warp a slot (L x B warps, pads included: the
//      plain form orients and describes every slot). Slot j < min(B, n)
//      takes the pixel and score its owner wrote, a later slot is a pad
//      (pixel (0, 0), score 0). The intensity-centroid moments: lane k
//      loads the pixels at the 31 x 31 offsets q = k, k + 32, ... inside
//      the radius-15 disk (at an integer point the plain bilinear sample
//      is the pixel at the clamped coordinate, exactly), all before the
//      first sum, adds v * dx and v * dy in that order, then a butterfly of
//      shuffles in a fixed order; angle = atan2f(m01, m10). Steered BRIEF:
//      lane k loads pairs 32 w + k (w = 0..7), rotates them by the angle,
//      samples both points with ops/image.bilinear's clamps and roundings
//      (no contraction), and __ballot_sync of v_p < v_q is word w, LSB
//      first. Lane 0 writes the level-0 pixel (uv + 0.5) 2^l - 0.5, the
//      level, angle, score and validity (score > 0), lanes 0-7 the words,
//      at l * B + j of the concatenated outputs.
// No atomics and no shared result has two writers, so a call's bits repeat.
// The optional probe buffer receives every level's FAST score map (before
// the NMS) over the cropped cells and the one-pixel ring outside them that
// the NMS reads (each such pixel written once, by the nearest cell's block);
// ops/orb_extract.parity reads it.
//
// What bounds it on the H100: not bytes (the three levels at 640 x 480 are
// 1.6 MB, the 1,536 slots' outputs 81 kB: ~0.5 us at 3.35 TB/s), barely
// the f32 operations (~80 MFLOP of FAST, NMS, moments and BRIEF samples,
// ~1.2 us at 67 TFLOP/s), but three dependent launches (a floor of a few us
// each) and the chains of dependent steps inside each: a cell's tile,
// scores, NMS and eight rounds of maxima; a slot's pixel, its 709 texel
// loads, the moments' sums and shuffles, then 16 bilinear samples a lane.
// Step 2 compares every pair of a level's candidates (4,800^2 at level 0),
// four a broadcast shared-memory read. PERF.md gives each kernel's time
// alone (chip_smoke.py phase 17, through the entry point's stage mask).
// Merging 2 into 3, a sort-free bucketed rank and fewer loads a slot are
// later work.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int MAX_LEVELS = 8;
constexpr int CELL = 16;
constexpr int PER_CELL = 4;
constexpr int ARC = 9;
constexpr int HALO = 4;                       // 3 for the circle, 1 for the NMS
constexpr int TILE = CELL + 2 * HALO;         // 24 x 24 image tile
constexpr int RING = CELL + 2;                // the cell and its NMS ring: 18 x 18 scores
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int RANK_WARPS = 32;                // level_rank_kernel: 32 candidates, 32 warps
constexpr int RANK_THREADS = RANK_WARPS * 32;
constexpr int RANK_TILE = 8192;               // candidate scores staged a pass (32 kB)
constexpr int PATCH_HALF = 15;                // the 31 x 31 orientation patch
constexpr int PATCH = 2 * PATCH_HALF + 1;
constexpr int DISK_ROUNDS = (PATCH * PATCH + 31) / 32;   // a lane's offsets q = lane + 32 r
constexpr int PAIRS = 256;
constexpr unsigned FULL = 0xFFFFFFFFu;

struct Level {
  const float* img;
  int H, W, Hc, Wc;
  int cell0;       // the level's first cell among all levels'
  int rank0;       // its first level_rank_kernel block
  int probe0;      // its map's offset in the probe buffer
};

struct Args {
  Level lv[MAX_LEVELS];
  int L, budget;
  float t;
  const float* pattern;     // (256, 2, 2): p (x, y), q (x, y)
  float* probe;             // nullptr: no probe
  float* cand_score;        // 4 x cells
  int32_t* cand_pix;        // 4 x cells: (v << 16) | u in the level's pixels
  int32_t* slot_pix;        // L x B: the pixel of the candidate owning the slot
  float* slot_score;        // L x B: its score
  float* uv;
  int32_t* level;
  float* angle;
  float* score;
  int32_t* desc;
  uint8_t* valid;
};

__device__ __forceinline__ int level_of_cell(const Args& a, int g) {
  int l = 0;
  while (l + 1 < a.L && g >= a.lv[l + 1].cell0) ++l;
  return l;
}

__device__ __forceinline__ int level_of_rank_block(const Args& a, int b) {
  int l = 0;
  while (l + 1 < a.L && b >= a.lv[l + 1].rank0) ++l;
  return l;
}

// "arc" contiguous set bits on the circular 16-bit mask
__device__ __forceinline__ bool arc_reaches(unsigned m) {
  const unsigned x = m | (m << 16);
  unsigned r = x;
#pragma unroll
  for (int k = 1; k < ARC; ++k) r &= x >> k;
  return (r & 0xFFFFu) != 0u;
}

// FAST-9 score of the pixel at tile (ty, tx): fast.py fast_score_map's f32
// operations, its 16-term sums taken in lane order
__device__ float fast_score(const float* tile, int ty, int tx, float t) {
  constexpr int dy[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};
  constexpr int dx[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};
  const float c = tile[ty * TILE + tx];
  const float hi = __fadd_rn(c, t), lo = __fsub_rn(c, t);
  unsigned bm = 0u, dm = 0u;
  float sb = 0.f, sd = 0.f;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const float v = tile[(ty + dy[i]) * TILE + tx + dx[i]];
    const bool b = v > hi, d = v < lo;
    bm |= (unsigned)b << i;
    dm |= (unsigned)d << i;
    sb = __fadd_rn(sb, b ? __fsub_rn(__fsub_rn(v, c), t) : 0.f);
    sd = __fadd_rn(sd, d ? __fsub_rn(__fsub_rn(c, v), t) : 0.f);
  }
  return fmaxf(arc_reaches(bm) ? sb : 0.f, arc_reaches(dm) ? sd : 0.f);
}

// One round of a stable top-k over the warp's keys (key 0: taken): the
// greatest key by a redux.sync maximum, and the lowest lane holding it by a
// ballot (keys come in index order over the lanes, so the lowest lane is the
// lowest index). Returns that lane; the key is taken.
__device__ __forceinline__ int take_max(unsigned& key, unsigned& best) {
  best = __reduce_max_sync(FULL, key);
  const int src = __ffs(__ballot_sync(FULL, key == best)) - 1;
  if ((int)(threadIdx.x & 31) == src) key = 0u;
  return src;
}

__global__ void __launch_bounds__(THREADS) fast_cells_kernel(Args a) {
  __shared__ float tile[TILE * TILE];
  __shared__ float ring[RING * RING];
  __shared__ unsigned pick_key[WARPS * PER_CELL];
  __shared__ int pick_idx[WARPS * PER_CELL];
  const int g = blockIdx.x;
  const Level lv = a.lv[level_of_cell(a, g)];
  const int c = g - lv.cell0, cy = c / lv.Wc, cx = c % lv.Wc;
  const int y0 = cy * CELL - HALO, x0 = cx * CELL - HALO;
  for (int i = threadIdx.x; i < TILE * TILE; i += THREADS) {
    const int y = y0 + i / TILE, x = x0 + i % TILE;
    tile[i] = (y >= 0 && y < lv.H && x >= 0 && x < lv.W) ? __ldg(lv.img + (size_t)y * lv.W + x)
                                                         : 0.f;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < RING * RING; i += THREADS) {
    const int ry = i / RING, rx = i % RING;
    const int y = y0 + HALO - 1 + ry, x = x0 + HALO - 1 + rx;
    float s;
    if (y < 0 || y >= lv.H || x < 0 || x >= lv.W) {
      s = -INFINITY;                            // outside the image: not a neighbour
    } else {
      s = (y < 3 || y >= lv.H - 3 || x < 3 || x >= lv.W - 3)
              ? 0.f : fast_score(tile, ry + HALO - 1, rx + HALO - 1, a.t);
      // the probe: each pixel of the cells and of the ring outside them once
      if (a.probe != nullptr && min(y / CELL, lv.Hc - 1) == cy && min(x / CELL, lv.Wc - 1) == cx &&
          ((ry >= 1 && ry <= CELL && rx >= 1 && rx <= CELL) ||
           y >= lv.Hc * CELL || x >= lv.Wc * CELL))
        a.probe[lv.probe0 + y * lv.W + x] = s;
    }
    ring[i] = s;
  }
  __syncthreads();
  const int iy = threadIdx.x / CELL, ix = threadIdx.x % CELL;
  const float s = ring[(iy + 1) * RING + ix + 1];
  float m = -INFINITY;
#pragma unroll
  for (int dy = 0; dy < 3; ++dy)
#pragma unroll
    for (int dx = 0; dx < 3; ++dx)
      if (dy != 1 || dx != 1) m = fmaxf(m, ring[(iy + dy) * RING + ix + dx]);
  const float v = (s >= m && s > 0.f) ? s : 0.f;
  // a non-negative float orders as its bits; + 1 keeps 0 for a taken key
  unsigned key = __float_as_uint(v) + 1u, best;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int r = 0; r < PER_CELL; ++r) {
    const int src = take_max(key, best);
    if (lane == 0) {
      pick_key[warp * PER_CELL + r] = best;
      pick_idx[warp * PER_CELL + r] = warp * 32 + src;
    }
  }
  __syncthreads();
  if (warp == 0) {
    // WARPS x PER_CELL == 32 picks, in index order among equal keys
    key = pick_key[lane];
    const int idx = pick_idx[lane];
#pragma unroll
    for (int r = 0; r < PER_CELL; ++r) {
      const int src = take_max(key, best);
      const int at = __shfl_sync(FULL, idx, src);
      if (lane == r) {
        a.cand_score[g * PER_CELL + r] = __uint_as_float(best - 1u);
        a.cand_pix[g * PER_CELL + r] = ((cy * CELL + at / CELL) << 16) | (cx * CELL + at % CELL);
      }
    }
  }
}

__global__ void __launch_bounds__(RANK_THREADS) level_rank_kernel(Args a) {
  __shared__ float4 scores[RANK_TILE / 4];
  __shared__ int counts[RANK_WARPS][32];
  const int l = level_of_rank_block(a, blockIdx.x);
  const Level lv = a.lv[l];
  const int n = lv.Hc * lv.Wc * PER_CELL;
  const float* cs = a.cand_score + lv.cell0 * PER_CELL;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int i = (blockIdx.x - lv.rank0) * 32 + lane;
  const float si = i < n ? cs[i] : 0.f;
  float* staged = reinterpret_cast<float*>(scores);
  int count = 0;
  for (int t0 = 0; t0 < n; t0 += RANK_TILE) {
    const int tn = min(RANK_TILE, n - t0);
    __syncthreads();
    // past the level's end: -inf, which no score (all >= 0) counts
    for (int k = threadIdx.x; k < RANK_TILE; k += RANK_THREADS)
      staged[k] = k < tn ? cs[t0 + k] : -INFINITY;
    __syncthreads();
    for (int k = warp; 4 * k < tn; k += RANK_WARPS) {
      const float4 q = scores[k];
      const int j = t0 + 4 * k;
      count += (q.x > si || (q.x == si && j < i)) + (q.y > si || (q.y == si && j + 1 < i)) +
               (q.z > si || (q.z == si && j + 2 < i)) + (q.w > si || (q.w == si && j + 3 < i));
    }
  }
  counts[warp][lane] = count;
  __syncthreads();
  if (warp == 0 && i < n) {
    int rank = 0;
#pragma unroll
    for (int w = 0; w < RANK_WARPS; ++w) rank += counts[w][lane];
    if (rank < a.budget) {
      a.slot_pix[l * a.budget + rank] = a.cand_pix[lv.cell0 * PER_CELL + i];
      a.slot_score[l * a.budget + rank] = si;
    }
  }
}

// ops/image.bilinear at (x, y): its clamps (a NaN coordinate samples pixel
// 0 with NaN weights) and its roundings, nothing contracted
__device__ __forceinline__ float bilinear(const float* img, int H, int W, float x, float y) {
  float x0f = floorf(x), y0f = floorf(y);
  x0f = x0f < 0.f ? 0.f : (x0f > (float)(W - 2) ? (float)(W - 2) : x0f);
  y0f = y0f < 0.f ? 0.f : (y0f > (float)(H - 2) ? (float)(H - 2) : y0f);
  if (x0f != x0f) x0f = 0.f;
  if (y0f != y0f) y0f = 0.f;
  float dx = __fsub_rn(x, x0f), dy = __fsub_rn(y, y0f);
  dx = dx < 0.f ? 0.f : (dx > 1.f ? 1.f : dx);
  dy = dy < 0.f ? 0.f : (dy > 1.f ? 1.f : dy);
  const float* p = img + (size_t)(int)y0f * W + (int)x0f;
  const float v00 = __ldg(p), v01 = __ldg(p + 1), v10 = __ldg(p + W), v11 = __ldg(p + W + 1);
  const float ex = __fsub_rn(1.f, dx), ey = __fsub_rn(1.f, dy);
  const float top = __fadd_rn(__fmul_rn(v00, ex), __fmul_rn(v01, dx));
  const float bot = __fadd_rn(__fmul_rn(v10, ex), __fmul_rn(v11, dx));
  return __fadd_rn(__fmul_rn(top, ey), __fmul_rn(bot, dy));
}

__global__ void __launch_bounds__(THREADS) describe_kernel(Args a) {
  const int lane = threadIdx.x & 31;
  const int slot = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (slot >= a.L * a.budget) return;
  const int l = slot / a.budget, j = slot % a.budget;
  const Level lv = a.lv[l];
  const int n = lv.Hc * lv.Wc * PER_CELL;
  int ui = 0, vi = 0;
  float s = 0.f;
  if (j < min(a.budget, n)) {
    const int pix = a.slot_pix[slot];
    s = a.slot_score[slot];
    ui = pix & 0xFFFF;
    vi = pix >> 16;
  }
  // intensity-centroid moments over the radius-15 disk: every sample loaded
  // first, then the lane's sums in offset order. An offset outside the disk
  // adds +-0, which leaves the sum as skipping it would: the sum is never -0
  float v_at[DISK_ROUNDS];
#pragma unroll
  for (int r = 0; r < DISK_ROUNDS; ++r) {
    const int q = lane + 32 * r;
    const int oy = q / PATCH - PATCH_HALF, ox = q % PATCH - PATCH_HALF;
    const int y = min(max(vi + oy, 0), lv.H - 1), x = min(max(ui + ox, 0), lv.W - 1);
    v_at[r] = (q < PATCH * PATCH && ox * ox + oy * oy <= PATCH_HALF * PATCH_HALF)
                  ? __ldg(lv.img + (size_t)y * lv.W + x) : 0.f;
  }
  float m10 = 0.f, m01 = 0.f;
#pragma unroll
  for (int r = 0; r < DISK_ROUNDS; ++r) {
    const int q = lane + 32 * r;
    m10 = __fadd_rn(m10, __fmul_rn(v_at[r], (float)(q % PATCH - PATCH_HALF)));
    m01 = __fadd_rn(m01, __fmul_rn(v_at[r], (float)(q / PATCH - PATCH_HALF)));
  }
#pragma unroll
  for (int o = 16; o; o >>= 1) {
    m10 = __fadd_rn(m10, __shfl_xor_sync(FULL, m10, o));
    m01 = __fadd_rn(m01, __shfl_xor_sync(FULL, m01, o));
  }
  const float ang = atan2f(m01, m10);
  const float ca = cosf(ang), sa = sinf(ang), nsa = -sa;
  const float u = (float)ui, v = (float)vi;
  float4 pairs[PAIRS / 32];
#pragma unroll
  for (int w = 0; w < PAIRS / 32; ++w)
    pairs[w] = __ldg(reinterpret_cast<const float4*>(a.pattern) + w * 32 + lane);
  uint32_t word = 0u;
#pragma unroll
  for (int w = 0; w < PAIRS / 32; ++w) {
    const float4 pq = pairs[w];
    const float px = __fadd_rn(u, __fadd_rn(__fmul_rn(ca, pq.x), __fmul_rn(nsa, pq.y)));
    const float py = __fadd_rn(v, __fadd_rn(__fmul_rn(sa, pq.x), __fmul_rn(ca, pq.y)));
    const float qx = __fadd_rn(u, __fadd_rn(__fmul_rn(ca, pq.z), __fmul_rn(nsa, pq.w)));
    const float qy = __fadd_rn(v, __fadd_rn(__fmul_rn(sa, pq.z), __fmul_rn(ca, pq.w)));
    const bool bit = bilinear(lv.img, lv.H, lv.W, px, py) < bilinear(lv.img, lv.H, lv.W, qx, qy);
    const uint32_t ballot = __ballot_sync(FULL, bit);
    if (lane == w) word = ballot;
  }
  if (lane < PAIRS / 32) a.desc[slot * (PAIRS / 32) + lane] = (int32_t)word;
  if (lane == 0) {
    const float scale = (float)(1 << l);
    a.uv[2 * slot] = __fsub_rn(__fmul_rn(__fadd_rn(u, 0.5f), scale), 0.5f);
    a.uv[2 * slot + 1] = __fsub_rn(__fmul_rn(__fadd_rn(v, 0.5f), scale), 0.5f);
    a.level[slot] = l;
    a.angle[slot] = ang;
    a.score[slot] = s;
    a.valid[slot] = s > 0.f ? 1 : 0;
  }
}

// The launch's arguments from the C interface (false where they are refused),
// with the number of cells and of level_rank_kernel blocks.
bool make_args(int L, const void* const* imgs, const int* dims, int budget, float threshold,
               const void* pattern, void* probe, void* const* scratch, void* const* out,
               Args& a, long long& cells, long long& rank_blocks) {
  if (L <= 0 || L > MAX_LEVELS || budget <= 0) return false;
  a = Args{};
  a.L = L;
  a.budget = budget;
  a.t = threshold;
  a.pattern = static_cast<const float*>(pattern);
  a.probe = static_cast<float*>(probe);
  a.cand_score = static_cast<float*>(scratch[0]);
  a.cand_pix = static_cast<int32_t*>(scratch[1]);
  a.slot_pix = static_cast<int32_t*>(scratch[2]);
  a.slot_score = static_cast<float*>(scratch[3]);
  a.uv = static_cast<float*>(out[0]);
  a.level = static_cast<int32_t*>(out[1]);
  a.angle = static_cast<float*>(out[2]);
  a.score = static_cast<float*>(out[3]);
  a.desc = static_cast<int32_t*>(out[4]);
  a.valid = static_cast<uint8_t*>(out[5]);
  long long pixels = 0;
  cells = rank_blocks = 0;
  for (int l = 0; l < L; ++l) {
    const int H = dims[2 * l], W = dims[2 * l + 1];
    if (H < 2 || W < 2 || H >= (1 << 15) || W >= (1 << 15)) return false;
    Level& lv = a.lv[l];
    lv.img = static_cast<const float*>(imgs[l]);
    lv.H = H;
    lv.W = W;
    lv.Hc = H / CELL;
    lv.Wc = W / CELL;
    lv.cell0 = (int)cells;
    lv.rank0 = (int)rank_blocks;
    lv.probe0 = (int)pixels;
    const long long n = (long long)lv.Hc * lv.Wc * PER_CELL;
    cells += (long long)lv.Hc * lv.Wc;
    rank_blocks += (n + 31) / 32;
    pixels += (long long)H * W;
  }
  return pixels < (1LL << 31) && (long long)L * budget * (PAIRS / 32) < (1LL << 31);
}

// Launch kernel `stage` (0 fast_cells, 1 level_rank, 2 describe) on `s`.
cudaError_t launch_stage(int stage, const Args& a, long long cells, long long rank_blocks,
                         cudaStream_t s) {
  if (stage == 0)
    fast_cells_kernel<<<(unsigned)cells, THREADS, 0, s>>>(a);
  else if (stage == 1)
    level_rank_kernel<<<(unsigned)rank_blocks, RANK_THREADS, 0, s>>>(a);
  else
    describe_kernel<<<(unsigned)(((long long)a.L * a.budget + WARPS - 1) / WARPS), THREADS, 0,
                      s>>>(a);
  return cudaGetLastError();
}

}  // namespace

// imgs: L level pointers (H x W float32 each); dims: H, W per level; scratch:
// cand_score, cand_pix (4 x cells each), slot_pix, slot_score (L x budget
// each); out: uv, level, angle, score, desc, valid; probe: nullptr or the
// levels' maps concatenated. stages: a mask of the kernels to launch, bit k
// for kernel k (7, all three, is a call; one bit launches that kernel alone
// on what the scratch holds, to time it). Returns the first CUDA error of
// the launches.
extern "C" int orb_extract_launch(int stages, int L, const void* const* imgs, const int* dims,
                                  int budget, float threshold, const void* pattern, void* probe,
                                  void* const* scratch, void* const* out, void* stream) {
  Args a;
  long long cells, rank_blocks;
  if (stages <= 0 || stages > 7 ||
      !make_args(L, imgs, dims, budget, threshold, pattern, probe, scratch, out, a, cells,
                 rank_blocks))
    return (int)cudaErrorInvalidValue;
  if (cells == 0) stages &= 4;                // no cell: every slot is a pad
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int stage = 0; stage < 3; ++stage) {
    if (!(stages >> stage & 1)) continue;
    const cudaError_t err = launch_stage(stage, a, cells, rank_blocks, s);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
