// ORB extraction on a pyramid, one cooperative launch a call, for Hopper
// (sm_90a).
//
// Replaces no Pallas kernel: the JAX package leaves ORB extraction to XLA,
// which fuses `extract_orb` (libcml_tpu/models/indirect/orb.py:137, the
// `_extract_level` it runs per level: :116, `fast_score_map` fast.py:46,
// the 3x3 NMS, `_grid_topk` :93, `lax.top_k` :125, `ic_angle` :59,
// `brief_descriptor` :76) into a few device programs a level. Its plain
// PyTorch form is `extract_orb_plain` in libcml_tpu_torch/models/indirect/
// orb.py (same arguments and results); `extract_orb` dispatches between the
// two by the pyramid's device.
//
// One grid of co-resident blocks (3 an SM, 8 warps each) runs three passes,
// a grid barrier (grid_barrier.cuh) between them. Per level l (H x W,
// Hc = H / 16 by Wc = W / 16 cells), for B = budget:
//   1. the cells: a team of two warps a 16 x 16 cell, every level's cells
//      walked grid-stride. The cell's image tile with a 4-pixel halo (3 for
//      the circle, 1 for the NMS) goes to shared memory by cp.async, 16
//      bytes a copy where the level's rows allow it (a 16-byte aligned
//      level whose width is a multiple of 4: x0 = 16 cx - 4 is then a
//      multiple of 4 floats), else 4 bytes a copy. Each warp takes half of
//      the cell's 18 x 18 ring (the cell and the pixels its NMS reads): a
//      pixel outside the image is -inf (no neighbour), one on the 3-pixel
//      border 0, and so is one that fails the compass test (9 contiguous
//      circle samples hold 2 of the 4 at 0, 4, 8 and 12, so with fewer than
//      2 brighter and 2 darker there no arc is reached); the rest are
//      listed and scored, two a lane at a time: the FAST-9 score, the 16
//      circle samples (fast.py _CIRCLE, clockwise from 12 o'clock) brighter
//      (v > c + t) or darker (v < c - t) as 16-bit masks, "9 contiguous" as
//      an AND of the doubled mask with itself shifted 1, 2, 4, then 8, the
//      sums of (v - c) - t and (c - v) - t over the samples that pass, in
//      lane order, the larger of the two that reach 9. NMS keeps s where
//      s >= every neighbour inside the image and s > 0 (the plain form's 3x3
//      max with -inf padding). Each warp's top 4 of its 128 pixels by
//      (score, lower row-major index first; a non-negative float orders as
//      its bits) by redux.sync maxima and minima, then the cell's from the
//      two warps' 8: the candidates c * 4 + r of the level, as `_grid_topk`'s
//      stable top-k orders them.
//   2. the selection, the grid's blocks shared among the levels (a level
//      whose candidates overflow a block's list in shared memory takes
//      SELECT_PARTS blocks, their lists in the global scratch): slot r of
//      level l holds the candidate of rank r by (score descending, lower
//      index first), `lax.top_k`'s order. Each block of the level counts a
//      histogram of the nonzero scores' bits shifted by 20 (2,048 buckets:
//      the exponent and 3 bits of the mantissa) in shared memory, takes its
//      suffix sums and the bucket b* that holds rank B - 1. Where a bucket
//      at or above b* holds more than REFINE_AT keys (on 640 x 480 noise one
//      holds 3,224 of level 0's 4,800), it counts the keys at or above b*
//      again in up to 2,048 finer buckets over the range they span (still
//      in key order). It lists those keys (the ones that can rank under B)
//      in bucket order, and each listed candidate of the block's own range
//      of indices takes rank = (keys in higher buckets) + (keys of its
//      bucket greater than its own, or equal at a lower index), a warp
//      counting over the bucket's run: integer counts, so the order of the
//      list's atomics, which differs from block to block, never shows. With
//      fewer than B nonzero scores, block 0 of the level places the zero
//      scores after them in index order (a block scan a round). A rank
//      under B owns slot `rank`: its pixel and score go there.
//   3. the slots, a warp a slot, walked grid-stride: the plain form orients
//      and describes every slot, pads included. Slot j < min(B, n) takes
//      the pixel and score its owner wrote; a later slot is a pad (pixel
//      (0, 0), score 0). All pads of a level have the same outputs, so a
//      warp describes the first of PAD_CHUNK pads and copies its outputs to
//      the rest (at 640 x 480 and B = 2000, 2,520 of the 6,000 slots). The
//      intensity-centroid moments: lane k takes the 31 x 31 offsets q = k,
//      k + 32, ... inside the radius-15 disk (at an integer point the plain
//      bilinear sample is the pixel at the clamped coordinate, exactly),
//      all 31 in flight at once by cp.async into shared memory, adds v * dx
//      and v * dy in that order, then a butterfly of shuffles (16, 8, 4, 2,
//      1); angle = atan2f(m01, m10). Steered BRIEF: lane k takes pairs
//      32 w + k (w = 0..7), rotates them by the angle, samples both points
//      with ops/image.bilinear's clamps and roundings (no contraction), and
//      __ballot_sync of v_p < v_q is word w, LSB first. Lane 0 writes the level-0 pixel
//      (uv + 0.5) 2^l - 0.5, the level, angle, score and validity
//      (score > 0), lanes 0-7 the words, at l * B + j of the outputs.
// Every output is the earlier three-launch design's bit for bit: the same
// scores, NMS, top-k order, moments and BRIEF arithmetic in the same order
// (a FAST term that does not pass is skipped rather than added as +0, and
// the darker term is -((v - c) + t): round-to-nearest is symmetric and
// neither sum is ever -0, so the sums keep their bits). No result has two
// writers and the only atomics are integer counts, so a call's bits repeat.
// The optional probe buffer receives every level's FAST score map (before
// the NMS) over the cropped cells and the one-pixel ring outside them that
// the NMS reads (each such pixel written once, by the nearest cell's team);
// ops/orb_extract.parity reads it.
//
// What bounds it on the H100: not bytes (the three levels at 640 x 480 are
// 1.6 MB, the 1,536 slots' outputs 81 kB: ~0.5 us at 3.35 TB/s), barely
// the f32 operations (~83 MFLOP of FAST, NMS, moments and BRIEF samples,
// ~1.2 us at 67 TFLOP/s), but latency: the launch, two grid barriers (~1
// us each), and inside each pass a chain of dependent steps that every
// warp walks at a few instructions a cycle's share: a cell's tile, compass
// test, scores, NMS and eight rounds of maxima; a level's histogram, scans,
// list and counts in each block; a slot's pixel, its texels, the
// moments' sums and shuffles, then 16 bilinear samples a lane. `// stage:
// NAME` marks the passes' boundaries: tools/ba_stages.py's instrument
// turns them into %globaltimer stamps in a copy of the source
// (chip_smoke.py phase 17 prints them); PERF.md gives the stamps and times.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

#include "grid_barrier.cuh"

namespace {

constexpr int MAX_LEVELS = 8;
constexpr int CELL = 16;
constexpr int PER_CELL = 4;
constexpr int HALO = 4;                       // 3 for the circle, 1 for the NMS
constexpr int TILE = CELL + 2 * HALO;         // 24 x 24 image tile
constexpr int RING = CELL + 2;                // the cell and its NMS ring: 18 x 18 scores
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int MIN_BLOCKS = 3;                 // blocks an SM holds (registers: 80 a thread)
constexpr int KEY_SHIFT = 20;                 // a score's bucket: its bits >> 20
constexpr int NB = 1 << (31 - KEY_SHIFT);     // 2,048 buckets (scores are non-negative)
constexpr int SELECT_PARTS = 4;               // blocks a level too large for a block's list
constexpr int REFINE_AT = 128;                // a listed bucket's keys past which they are counted finer
constexpr int BUCKETS_PER_THREAD = NB / THREADS;
constexpr int PATCH_HALF = 15;                // the 31 x 31 orientation patch
constexpr int PATCH = 2 * PATCH_HALF + 1;
constexpr int DISK_ROUNDS = (PATCH * PATCH + 31) / 32;   // a lane's offsets q = lane + 32 r
constexpr int PAIRS = 256;
constexpr int PAD_CHUNK = 128;                // a level's pads a warp describes once and copies
constexpr unsigned FULL = 0xFFFFFFFFu;

// the dynamic shared memory, one pass's working memory at a time; a team's
// cell: its tile, ring scores, the warps' picks and the ring pixels each
// warp scores (16-bit indices), in a multiple of 16 bytes
constexpr int CELL_TEAM = 2;                  // warps a cell
constexpr int RING_HALF = (RING * RING + CELL_TEAM - 1) / CELL_TEAM;   // ring pixels a warp
constexpr int CELL_TEAM_FLOATS =
    (TILE * TILE + RING * RING + 2 * CELL_TEAM * PER_CELL + (RING * RING + 1) / 2 + 3) / 4 * 4;
constexpr int CELLS_BYTES = WARPS / CELL_TEAM * CELL_TEAM_FLOATS * 4;
constexpr int SELECT_HEAD = (2 * NB + 64) * 4;           // hist, above, scratch
constexpr int KEY_LOADS = 5;                  // 16-byte key loads in flight a thread
constexpr int SMEM_BYTES = 64512;             // a block's: 3 an SM
// a level's candidates that a block's list holds in shared memory (a larger
// level's list goes to the global scratch, one a block for SELECT_PARTS blocks)
constexpr int LIST_CAP = (SMEM_BYTES - SELECT_HEAD) / 8;
static_assert(CELLS_BYTES <= SMEM_BYTES && WARPS * DISK_ROUNDS * 32 * 4 <= SMEM_BYTES &&
              LIST_CAP > 0, "shared memory layout");
constexpr int SCRATCH_BSTAR = WARPS;          // select: the bucket holding rank B - 1

struct Level {
  const float* img;
  int H, W, Hc, Wc;
  int cell0;       // the level's first cell among all levels'
  int probe0;      // its map's offset in the probe buffer
  int vec;         // 16-byte copies: the level is 16-byte aligned and W % 4 == 0
};

struct Args {
  Level lv[MAX_LEVELS];
  int L, budget, cells, stages;
  float t;
  const float* pattern;     // (256, 2, 2): p (x, y), q (x, y)
  float* probe;             // nullptr: no probe
  float* cand_score;        // 4 x cells
  int32_t* cand_pix;        // 4 x cells: (v << 16) | u in the level's pixels
  uint2* sorted;            // 4 x cells: the selection's list where shared memory is short
  int32_t* slot_pix;        // L x B: the pixel of the candidate owning the slot
  float* slot_score;        // L x B: its score
  unsigned* bar;            // the grid barrier (grid_barrier.cuh): 0 between launches
  float* uv;
  int32_t* level;
  float* angle;
  float* score;
  int32_t* desc;
  uint8_t* valid;
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" :: "r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" :: "r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

__device__ __forceinline__ int level_of_cell(const Args& a, const Level* lvs, int g) {
  int l = 0;
  while (l + 1 < a.L && g >= lvs[l + 1].cell0) ++l;
  return l;
}

// "9 contiguous" set bits on the circular 16-bit mask: bit i of r survives
// the ANDs iff bits i..i+8 of the doubled mask are all set
__device__ __forceinline__ bool arc_reaches(unsigned m) {
  const unsigned x = m | (m << 16);
  unsigned r = x & (x >> 1);                  // runs of 2
  r &= r >> 2;                                // 4
  r &= r >> 4;                                // 8
  r &= x >> 8;                                // 9
  return (r & 0xFFFFu) != 0u;
}

// FAST-9 score of the pixel at tile (ty, tx): fast.py fast_score_map's f32
// operations, its 16-term sums taken in lane order. A term that does not
// pass is skipped rather than added as +0, and the darker term is
// -((v - c) + t) = (c - v) - t: round-to-nearest is symmetric, so each term
// has the plain form's bits (up to the sign of a zero), and neither sum is
// ever -0, so the sums have the plain form's bits.
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
    const float e = __fsub_rn(v, c);
    if (v > hi) {
      bm |= 1u << i;
      sb = __fadd_rn(sb, __fsub_rn(e, t));
    }
    if (v < lo) {
      dm |= 1u << i;
      sd = __fsub_rn(sd, __fadd_rn(e, t));
    }
  }
  return fmaxf(arc_reaches(bm) ? sb : 0.f, arc_reaches(dm) ? sd : 0.f);
}

// Cell (cy, cx)'s image tile into `tile` (24 x 24, 0 outside the image),
// by cp.async copies split between the team's two warps (thread k of 64):
// the caller waits (cp_async_wait_all, then the team's barrier).
__device__ __forceinline__ void fetch_tile(const Level& lv, int cy, int cx, int k, float* tile) {
  const int y0 = cy * CELL - HALO, x0 = cx * CELL - HALO;
  if (lv.vec) {
    // a 4-float group lies wholly inside or wholly outside the image
    for (int i = k; i < TILE * TILE / 4; i += CELL_TEAM * 32) {
      const int y = y0 + i / (TILE / 4), x = x0 + 4 * (i % (TILE / 4));
      if (y >= 0 && y < lv.H && x >= 0 && x < lv.W)
        cp_async16(tile + 4 * i, lv.img + (size_t)y * lv.W + x);
      else
        *reinterpret_cast<float4*>(tile + 4 * i) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  } else {
    for (int i = k; i < TILE * TILE; i += CELL_TEAM * 32) {
      const int y = y0 + i / TILE, x = x0 + i % TILE;
      if (y >= 0 && y < lv.H && x >= 0 && x < lv.W)
        cp_async4(tile + i, lv.img + (size_t)y * lv.W + x);
      else
        tile[i] = 0.f;
    }
  }
}

// Whether the pixel at tile (ty, tx) can be a corner at all: 9 contiguous
// samples of the 16 hold at least 2 of the 4 compass samples (0, 4, 8, 12),
// so with fewer than 2 brighter and fewer than 2 darker neither arc is
// reached and the score is the 0 that the whole test gives.
__device__ __forceinline__ bool may_be_corner(const float* tile, int ty, int tx, float t) {
  const float c = tile[ty * TILE + tx];
  const float hi = __fadd_rn(c, t), lo = __fsub_rn(c, t);
  const float n = tile[(ty - 3) * TILE + tx], e = tile[ty * TILE + tx + 3];
  const float s = tile[(ty + 3) * TILE + tx], w = tile[ty * TILE + tx - 3];
  return (n > hi) + (e > hi) + (s > hi) + (w > hi) >= 2 ||
         (n < lo) + (e < lo) + (s < lo) + (w < lo) >= 2;
}

// The probe: ring pixel (ry, rx) at image (y, x) of cell (cy, cx), written
// where it lies in the cell or in the ring outside the cropped cells, so
// that each pixel is written once.
__device__ __forceinline__ void probe_at(const Args& a, const Level& lv, int cy, int cx, int ry,
                                         int rx, int y, int x, float s) {
  if (a.probe != nullptr && min(y / CELL, lv.Hc - 1) == cy && min(x / CELL, lv.Wc - 1) == cx &&
      ((ry >= 1 && ry <= CELL && rx >= 1 && rx <= CELL) || y >= lv.Hc * CELL ||
       x >= lv.Wc * CELL))
    a.probe[lv.probe0 + y * lv.W + x] = s;
}

// The barrier of the team's two warps: named barrier 1 + team (barrier 0 is
// __syncthreads').
__device__ __forceinline__ void team_sync(int team) {
  asm volatile("bar.sync %0, %1;" :: "r"(1 + team), "r"(CELL_TEAM * 32) : "memory");
}

// Pass 1, a team of two warps a cell: every cell's four candidates
// (cand_score, cand_pix), and the probe's maps. Each warp takes half of the
// tile's copies, of the ring and of the cell's pixels; the warps' top 4
// meet in shared memory.
__device__ __forceinline__ void cells_pass(const Args& a, const Level* lvs, unsigned char* smem) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int team = warp / CELL_TEAM, half = warp % CELL_TEAM;
  float* tile = reinterpret_cast<float*>(smem) + team * CELL_TEAM_FLOATS;
  float* ring = tile + TILE * TILE;
  unsigned* pick_key = reinterpret_cast<unsigned*>(ring + RING * RING);
  unsigned* pick_at = pick_key + CELL_TEAM * PER_CELL;
  unsigned short* todo = reinterpret_cast<unsigned short*>(pick_at + CELL_TEAM * PER_CELL) +
                         half * RING_HALF;
  const int r0 = half * RING_HALF, r1 = min(r0 + RING_HALF, RING * RING);
  // cell g to team g / gridDim.x of block g % gridDim.x: every SM takes a share
  for (int g = team * gridDim.x + blockIdx.x; g < a.cells; g += gridDim.x * (WARPS / CELL_TEAM)) {
    const Level& lv = lvs[level_of_cell(a, lvs, g)];
    const int c = g - lv.cell0, cy = c / lv.Wc, cx = c % lv.Wc;
    const int y0 = cy * CELL - 1, x0 = cx * CELL - 1;      // the ring's first pixel
    fetch_tile(lv, cy, cx, half * 32 + lane, tile);
    cp_async_wait_all();
    team_sync(team);
    // stage: cells_tile
    // the warp's half of the ring: -inf outside the image (not a
    // neighbour), 0 on the 3-pixel border and where the compass test fails;
    // the rest listed to score
    int todo_n = 0;
    const bool inner = a.probe == nullptr && y0 >= 3 && y0 + RING <= lv.H - 3 && x0 >= 3 &&
                       x0 + RING <= lv.W - 3;
    for (int i0 = r0; i0 < r1; i0 += 64) {                  // two pixels a lane a round
      bool listed[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = i0 + 32 * h + lane, ry = i / RING, rx = i % RING, y = y0 + ry, x = x0 + rx;
        listed[h] = false;
        if (i < r1) {
          float s = 0.f;
          if (inner) {
            // inside the image and off its border, no probe
            listed[h] = may_be_corner(tile, ry + HALO - 1, rx + HALO - 1, a.t);
          } else if (y < 0 || y >= lv.H || x < 0 || x >= lv.W) {
            s = -INFINITY;
          } else {
            listed[h] = y >= 3 && y < lv.H - 3 && x >= 3 && x < lv.W - 3 &&
                        may_be_corner(tile, ry + HALO - 1, rx + HALO - 1, a.t);
            if (!listed[h]) probe_at(a, lv, cy, cx, ry, rx, y, x, 0.f);
          }
          ring[i] = s;
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const unsigned ball = __ballot_sync(FULL, listed[h]);
        if (listed[h])
          todo[todo_n + __popc(ball & ((1u << lane) - 1u))] = (unsigned short)(i0 + 32 * h + lane);
        todo_n += __popc(ball);
      }
    }
    __syncwarp();
    // stage: cells_listed
    // two pixels a lane a round: two independent chains of sums in flight
    for (int j = lane; j < todo_n; j += 64) {
      const int i0 = todo[j], i1 = todo[j + 32 < todo_n ? j + 32 : j];
      const float s0 = fast_score(tile, i0 / RING + HALO - 1, i0 % RING + HALO - 1, a.t);
      const float s1 = fast_score(tile, i1 / RING + HALO - 1, i1 % RING + HALO - 1, a.t);
      ring[i0] = s0;
      probe_at(a, lv, cy, cx, i0 / RING, i0 % RING, y0 + i0 / RING, x0 + i0 % RING, s0);
      if (j + 32 < todo_n) {
        ring[i1] = s1;
        probe_at(a, lv, cy, cx, i1 / RING, i1 % RING, y0 + i1 / RING, x0 + i1 % RING, s1);
      }
    }
    team_sync(team);
    // stage: cells_ring
    // the NMS of the warp's half of the cell, pixel p = 128 half + lane + 32
    // k (row-major): its key, the kept score's bits + 1 (a non-negative
    // float orders as its bits; 0 marks a key taken)
    unsigned key[CELL * CELL / 32 / CELL_TEAM];
#pragma unroll
    for (int k = 0; k < CELL * CELL / 32 / CELL_TEAM; ++k) {
      const int p = half * (CELL * CELL / CELL_TEAM) + lane + 32 * k, iy = p / CELL, ix = p % CELL;
      const float s = ring[(iy + 1) * RING + ix + 1];
      float m = -INFINITY;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int dx = 0; dx < 3; ++dx)
          if (dy != 1 || dx != 1) m = fmaxf(m, ring[(iy + dy) * RING + ix + dx]);
      key[k] = __float_as_uint((s >= m && s > 0.f) ? s : 0.f) + 1u;
    }
    // the warp's top 4 by (score, lower pixel index first): each lane's
    // greatest key (its lowest pixel among equal ones), the warp's greatest
    // by a redux.sync maximum, the lowest pixel holding it by a minimum
#pragma unroll
    for (int r = 0; r < PER_CELL; ++r) {
      unsigned mine = 0u;
      int mk = 0;
#pragma unroll
      for (int k = 0; k < CELL * CELL / 32 / CELL_TEAM; ++k)
        if (key[k] > mine) {
          mine = key[k];
          mk = k;
        }
      const unsigned best = __reduce_max_sync(FULL, mine);
      const unsigned at = __reduce_min_sync(FULL, mine == best ? (unsigned)(lane + 32 * mk) : ~0u);
      const int taken = (int)(at % 32) == lane ? (int)(at / 32) : -1;
#pragma unroll
      for (int k = 0; k < CELL * CELL / 32 / CELL_TEAM; ++k) key[k] = k == taken ? 0u : key[k];
      if (lane == 0) {
        pick_key[half * PER_CELL + r] = best;
        pick_at[half * PER_CELL + r] = half * (CELL * CELL / CELL_TEAM) + at;
      }
    }
    team_sync(team);
    // stage: cells_top4
    if (half == 0) {
      // the cell's top 4 from the two warps' 8 picks, the same way
      unsigned mine = lane < CELL_TEAM * PER_CELL ? pick_key[lane] : 0u;
      const unsigned p = lane < CELL_TEAM * PER_CELL ? pick_at[lane] : ~0u;
#pragma unroll
      for (int r = 0; r < PER_CELL; ++r) {
        const unsigned best = __reduce_max_sync(FULL, mine);
        const unsigned at = __reduce_min_sync(FULL, mine == best ? p : ~0u);
        if (p == at) mine = 0u;
        if (lane == r) {
          a.cand_score[g * PER_CELL + r] = __uint_as_float(best - 1u);
          a.cand_pix[g * PER_CELL + r] =
              ((cy * CELL + (int)at / CELL) << 16) | (cx * CELL + (int)at % CELL);
        }
      }
    }
    // stage: cells_written
  }
}

// The sum of v over the block's threads above this one (by index), and the
// total. `scratch` holds WARPS ints; every thread calls it.
__device__ __forceinline__ int block_sum_above(int v, int* scratch, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int s = v;                                  // the warp's lanes >= lane
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_down_sync(FULL, s, o);
    if (lane + o < 32) s += y;
  }
  if (lane == 0) scratch[warp] = s;
  __syncthreads();
  int above = 0;
  total = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    const int t = scratch[w];
    total += t;
    above += w > warp ? t : 0;
  }
  __syncthreads();
  return above + s - v;
}

// Whether the listed key o ranks before me: greater, or equal at a lower index.
__device__ __forceinline__ int outranks(uint2 o, uint2 me) {
  return (o.x > me.x) | ((o.x == me.x) & (o.y < me.y));
}

__device__ __forceinline__ void own_slot(const Args& a, int l, int rank, int pix, float s) {
  a.slot_pix[l * a.budget + rank] = pix;
  a.slot_score[l * a.budget + rank] = s;
}

// The largest of v over the block's threads; every thread calls it.
__device__ __forceinline__ int block_max(int v, int* scratch) {
  v = __reduce_max_sync(FULL, v);
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  int m = scratch[0];
#pragma unroll
  for (int w = 1; w < WARPS; ++w) m = max(m, scratch[w]);
  __syncthreads();
  return m;
}

// f(key bits, index) for each of a level's n candidates (n a multiple of
// 4), by the block: KEY_LOADS 16-byte loads in flight a thread.
template <class F>
__device__ __forceinline__ void for_each_key(const float* cs, int n, F f) {
  const uint4* cs4 = reinterpret_cast<const uint4*>(cs);
  for (int i0 = 0; i0 < n / 4; i0 += KEY_LOADS * THREADS) {
    uint4 q[KEY_LOADS];
#pragma unroll
    for (int u = 0; u < KEY_LOADS; ++u) {
      const int i = i0 + u * THREADS + threadIdx.x;
      q[u] = i < n / 4 ? __ldcg(cs4 + i) : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < KEY_LOADS; ++u) {
      const unsigned k4[4] = {q[u].x, q[u].y, q[u].z, q[u].w};
      const int i = 4 * (i0 + u * THREADS + threadIdx.x);
#pragma unroll
      for (int c = 0; c < 4; ++c) f(k4[c], i + c);   // past n: key 0, never listed
    }
  }
}

// The runs of the buckets in `hist` (counts), from the highest bucket down:
// above[b] = the count in higher buckets (where b's run starts), hist[b] the
// same (a cursor), h the thread's own buckets' counts; returns the count in
// higher buckets than the thread's. The caller synchronizes before reading.
__device__ __forceinline__ int bucket_runs(int* hist, int* above, int* scratch,
                                           int (&h)[BUCKETS_PER_THREAD], int& total) {
  int all = 0;
#pragma unroll
  for (int j = 0; j < BUCKETS_PER_THREAD; ++j) {
    h[j] = hist[threadIdx.x * BUCKETS_PER_THREAD + j];
    all += h[j];
  }
  const int first = block_sum_above(all, scratch, total);
  int run = first;
#pragma unroll
  for (int j = BUCKETS_PER_THREAD - 1; j >= 0; --j) {
    const int b = threadIdx.x * BUCKETS_PER_THREAD + j;
    above[b] = run;
    hist[b] = run;
    run += h[j];
  }
  return first;
}

// Pass 2 for level l, part `part` of its `parts` blocks: slot r gets the
// candidate of rank r. Every part counts the level's histogram, finds b*
// (and, where one bucket at or above b* holds more than REFINE_AT keys,
// counts those keys again in up to NB finer buckets), and lists the
// level's nonzero candidates at or above b* in bucket order (a run a
// bucket; inside a run, in the order of the atomics, which differs from
// part to part); it ranks the listed candidates of its own range of
// indices, a warp a candidate; part 0 also places the zero scores.
__device__ __forceinline__ void select_level(const Args& a, const Level* lvs, int l, int part,
                                             int parts, unsigned char* smem) {
  const Level& lv = lvs[l];
  const int n = lv.Hc * lv.Wc * PER_CELL, B = a.budget;
  if (n == 0) return;
  int* hist = reinterpret_cast<int*>(smem);            // keys a bucket; then its run's end
  int* above = hist + NB;                              // keys in higher buckets: its run's start
  int* scratch = above + NB;
  uint2* list = n <= LIST_CAP ? reinterpret_cast<uint2*>(scratch + 64)
                              : a.sorted + (size_t)(lv.cell0 * PER_CELL) * SELECT_PARTS +
                                    (size_t)part * n;
  const float* cs = a.cand_score + lv.cell0 * PER_CELL;
  const int* cp = a.cand_pix + lv.cell0 * PER_CELL;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int b = tid; b < NB; b += THREADS) hist[b] = 0;
  __syncthreads();
  // the histogram of the nonzero keys by their bits >> KEY_SHIFT (a score
  // is non-negative: the mask never acts)
  for_each_key(cs, n, [&](unsigned k, int) {
    if (k != 0u) atomicAdd(hist + ((k >> KEY_SHIFT) & (NB - 1)), 1);
  });
  __syncthreads();
  // stage: select_counted
  int h[BUCKETS_PER_THREAD], nz;
  int run = bucket_runs(hist, above, scratch, h, nz);
  for (int j = BUCKETS_PER_THREAD - 1; j >= 0; --j) {
    if (run < B && B <= run + h[j]) scratch[SCRATCH_BSTAR] = tid * BUCKETS_PER_THREAD + j;
    run += h[j];
  }
  if (nz < B && tid == 0) scratch[SCRATCH_BSTAR] = 0;            // every nonzero key owns a slot
  __syncthreads();
  const int bstar = scratch[SCRATCH_BSTAR];
  // a listed key's bucket: (bits >> shift) - base, the coarse one unless a
  // listed bucket is full, then the listed coarse buckets' range split into
  // up to NB finer ones (still in key order)
  int fullest = 0, top = 0, low = 0;         // low: NB - 1 - the lowest nonempty bucket
#pragma unroll
  for (int j = 0; j < BUCKETS_PER_THREAD; ++j) {
    const int b = tid * BUCKETS_PER_THREAD + j;
    fullest = max(fullest, b >= bstar ? h[j] : 0);
    top = h[j] > 0 ? b : top;
    low = max(low, h[j] > 0 ? NB - 1 - b : 0);
  }
  int shift = KEY_SHIFT, base = 0;
  if (block_max(fullest, scratch) > REFINE_AT) {
    const int first = max(bstar, NB - 1 - block_max(low, scratch));   // the lowest listed bucket
    const int span = block_max(top, scratch) + 1 - first;
    int finer = 0;
    while (finer < KEY_SHIFT && (span << (finer + 1)) <= NB) ++finer;
    shift = KEY_SHIFT - finer;
    base = first << finer;
    for (int b = tid; b < NB; b += THREADS) hist[b] = 0;
    __syncthreads();
    for_each_key(cs, n, [&](unsigned k, int) {
      if (k != 0u && (int)(k >> KEY_SHIFT) >= bstar) atomicAdd(hist + ((int)(k >> shift) - base), 1);
    });
    __syncthreads();
    int total;
    bucket_runs(hist, above, scratch, h, total);
    __syncthreads();
  }
  // stage: select_scanned
  // the candidates that can rank under B, into bucket order
  for_each_key(cs, n, [&](unsigned k, int i) {
    if (k != 0u && (int)(k >> KEY_SHIFT) >= bstar)
      list[atomicAdd(hist + ((int)(k >> shift) - base), 1)] = make_uint2(k, (unsigned)i);
  });
  __syncthreads();
  // stage: select_scattered
  // bucket b's run is now [above[b], hist[b]); a key's rank: the keys in
  // higher buckets, and those of its own bucket greater than it or equal at
  // a lower index, counted by a warp over the run (four entries in flight a
  // lane) and summed. The part's candidates are indices [i_lo, i_hi): lane
  // k of warp w takes i_lo + r + WARPS k + w in round r, which spreads the
  // listed ones over the warps
  const int span = (n + parts - 1) / parts;
  const int i_lo = min(part * span, n), i_hi = min(i_lo + span, n);
  for (int r = 0; i_lo + r < i_hi; r += THREADS) {
    const int i = i_lo + r + WARPS * lane + warp;
    const unsigned k = i < i_hi ? __float_as_uint(__ldcg(cs + i)) : 0u;
    const bool listed = k != 0u && (int)(k >> KEY_SHIFT) >= bstar;
    for (unsigned todo = __ballot_sync(FULL, listed); todo; todo &= todo - 1) {
      const int src = __ffs(todo) - 1;
      const uint2 me = make_uint2(__shfl_sync(FULL, k, src), (unsigned)__shfl_sync(FULL, i, src));
      const int b = (int)(me.x >> shift) - base;
      const int start = above[b], end = hist[b];
      int count = 0, j = start + lane;
      for (; j + 96 < end; j += 128) {
        const uint2 o0 = list[j], o1 = list[j + 32], o2 = list[j + 64], o3 = list[j + 96];
        count += outranks(o0, me) + outranks(o1, me) + outranks(o2, me) + outranks(o3, me);
      }
      for (; j < end; j += 32) count += outranks(list[j], me);
      const int rank = start + __reduce_add_sync(FULL, count);
      if (lane == 0 && rank < B) own_slot(a, l, rank, __ldcg(cp + me.y), __uint_as_float(me.x));
    }
  }
  if (part != 0) return;
  // the zero scores, in index order, after the nonzero ones: KEY_LOADS
  // rounds of THREADS candidates loaded at once, then placed round by round
  for (int base0 = nz, c0 = 0; base0 < B && c0 < n; c0 += KEY_LOADS * THREADS) {
    unsigned kz[KEY_LOADS];
#pragma unroll
    for (int u = 0; u < KEY_LOADS; ++u) {
      const int i = c0 + u * THREADS + tid;
      kz[u] = i < n ? __float_as_uint(__ldcg(cs + i)) : 1u;    // 1: not a zero score
    }
#pragma unroll
    for (int u = 0; u < KEY_LOADS; ++u) {
      if (base0 >= B) break;
      const int i = c0 + u * THREADS + tid;
      const bool z = kz[u] == 0u;
      const unsigned ball = __ballot_sync(FULL, z);
      __syncthreads();
      if (lane == 0) scratch[warp] = __popc(ball);
      __syncthreads();
      int before = 0, total = 0;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) {
        const int t = scratch[w];
        total += t;
        before += w < warp ? t : 0;
      }
      const int rank = base0 + before + __popc(ball & ((1u << lane) - 1u));
      if (z && rank < B) own_slot(a, l, rank, __ldcg(cp + i), 0.f);
      base0 += total;
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

// A slot's angle (lane 0's is written) and its descriptor word w (in lane w).
struct Described {
  float angle;
  uint32_t word;
};

// One slot's outputs, by a warp, its moment texels staged in `texels` (the
// warp's DISK_ROUNDS x 32 floats of shared memory). Not inlined: the slot
// loop around it would otherwise hoist the lanes' 31 texel offsets and keep
// them live (in local memory).
__device__ __noinline__ Described describe_slot(const Args& a, const Level& lv, int slot, int l,
                                                float* texels) {
  const int lane = threadIdx.x & 31;
  const int j = slot % a.budget, n = lv.Hc * lv.Wc * PER_CELL;
  int ui = 0, vi = 0;
  float s = 0.f;
  if (j < min(a.budget, n)) {
    const int pix = __ldcg(a.slot_pix + slot);
    s = __ldcg(a.slot_score + slot);
    ui = pix & 0xFFFF;
    vi = pix >> 16;
  }
  // stage: describe_record
  // intensity-centroid moments over the radius-15 disk: every sample in
  // flight at once (cp.async, L1-allocating, into the lane's own column of
  // `texels`), then the lane's sums in offset order. An offset outside the
  // disk adds +-0, which leaves the sum as skipping it would: the sum is
  // never -0
#pragma unroll
  for (int r = 0; r < DISK_ROUNDS; ++r) {
    const int q = lane + 32 * r;
    const int oy = q / PATCH - PATCH_HALF, ox = q % PATCH - PATCH_HALF;
    const int y = min(max(vi + oy, 0), lv.H - 1), x = min(max(ui + ox, 0), lv.W - 1);
    if (q < PATCH * PATCH && ox * ox + oy * oy <= PATCH_HALF * PATCH_HALF)
      cp_async4(texels + q, lv.img + (size_t)y * lv.W + x);
    else
      texels[q] = 0.f;
  }
  cp_async_wait_all();
  __syncwarp();
  // stage: describe_texels
  float m10 = 0.f, m01 = 0.f;
#pragma unroll
  for (int r = 0; r < DISK_ROUNDS; ++r) {
    const int q = lane + 32 * r;
    const float val = texels[q];
    m10 = __fadd_rn(m10, __fmul_rn(val, (float)(q % PATCH - PATCH_HALF)));
    m01 = __fadd_rn(m01, __fmul_rn(val, (float)(q / PATCH - PATCH_HALF)));
  }
#pragma unroll
  for (int o = 16; o; o >>= 1) {
    m10 = __fadd_rn(m10, __shfl_xor_sync(FULL, m10, o));
    m01 = __fadd_rn(m01, __shfl_xor_sync(FULL, m01, o));
  }
  const float ang = atan2f(m01, m10);
  const float ca = cosf(ang), sa = sinf(ang), nsa = -sa;
  // stage: describe_angle
  const float u = (float)ui, v = (float)vi;
  uint32_t word = 0u;
#pragma unroll 4
  for (int w = 0; w < PAIRS / 32; ++w) {
    const float4 pq = __ldg(reinterpret_cast<const float4*>(a.pattern) + w * 32 + lane);
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
  __syncwarp();                               // the texels are read before the next slot's copies
  return Described{ang, word};
}

// Pad slot `first`'s outputs, described by this warp (`d`), copied to the
// pads first + 1 .. first + count - 1 of level l, a lane a pad: every pad of
// a level has pixel (0, 0) and score 0, so the same outputs.
__device__ __forceinline__ void copy_pads(const Args& a, int l, int first, int count, Described d) {
  const int lane = threadIdx.x & 31;
  int32_t words[PAIRS / 32];
#pragma unroll
  for (int w = 0; w < PAIRS / 32; ++w) words[w] = (int32_t)__shfl_sync(FULL, d.word, w);
  const float angle = __shfl_sync(FULL, d.angle, 0);
  const float uv = __fsub_rn(__fmul_rn(__fadd_rn(0.f, 0.5f), (float)(1 << l)), 0.5f);
  for (int j = first + 1 + lane; j < first + count; j += 32) {
#pragma unroll
    for (int w = 0; w < PAIRS / 32; ++w) a.desc[(size_t)j * (PAIRS / 32) + w] = words[w];
    a.uv[2 * j] = uv;
    a.uv[2 * j + 1] = uv;
    a.level[j] = l;
    a.angle[j] = angle;
    a.score[j] = 0.f;
    a.valid[j] = 0;
  }
}

// Pass 3: every slot's outputs, a warp an item: the levels' owned slots
// (j < min(B, n)), then their pads by chunks of PAD_CHUNK, the first pad
// of a chunk described and its outputs copied to the rest.
__device__ __forceinline__ void describe_pass(const Args& a, const Level* lvs,
                                              unsigned char* smem) {
  const int warp = threadIdx.x >> 5, B = a.budget;
  float* texels = reinterpret_cast<float*>(smem) + warp * DISK_ROUNDS * 32;
  int owned = 0, chunks = 0;
  for (int l = 0; l < a.L; ++l) {
    const int o = min(B, lvs[l].Hc * lvs[l].Wc * PER_CELL);
    owned += o;
    chunks += (B - o + PAD_CHUNK - 1) / PAD_CHUNK;
  }
  // item t to warp t / gridDim.x of block t % gridDim.x: every SM takes a share
  for (int t = warp * gridDim.x + blockIdx.x; t < owned + chunks; t += gridDim.x * WARPS) {
    int l = 0, u = t < owned ? t : t - owned;
    for (;; ++l) {
      const int o = min(B, lvs[l].Hc * lvs[l].Wc * PER_CELL);
      const int items = t < owned ? o : (B - o + PAD_CHUNK - 1) / PAD_CHUNK;
      if (u < items) {
        if (t < owned) {
          describe_slot(a, lvs[l], l * B + u, l, texels);
        } else {
          const int first = l * B + o + u * PAD_CHUNK;
          const Described d = describe_slot(a, lvs[l], first, l, texels);
          copy_pads(a, l, first, min(PAD_CHUNK, B - o - u * PAD_CHUNK), d);
        }
        break;
      }
      u -= items;
    }
  }
}

// The passes whose bits are set in a.stages (bit k: pass k + 1 above), a
// grid barrier between two that both run.
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS) orb_kernel(const __grid_constant__ Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ unsigned arrived;                // grid_sync's count
  __shared__ Level lvs[MAX_LEVELS];           // the levels, read by index (not from the
                                              // parameters, which an index would copy)
  // stage: start
  if (threadIdx.x == 0) arrived = 0u;
#pragma unroll
  for (int l = 0; l < MAX_LEVELS; ++l)
    if (threadIdx.x == l) lvs[l] = a.lv[l];
  __syncthreads();
  // stage: levels
  if (a.stages & 1) cells_pass(a, lvs, smem);
  // stage: cells_done
  if ((a.stages & 1) && (a.stages & 6)) gridbar::grid_sync(a.bar, arrived);
  // stage: select_start
  if (a.stages & 2) {
    // a level's share of the grid's blocks (SELECT_PARTS where its list
    // does not fit in shared memory)
    const int parts = max(1, (int)gridDim.x / a.L);
    for (int k = blockIdx.x; k < a.L * parts; k += gridDim.x) {
      const int l = k / parts, part = k % parts;
      const int lp = lvs[l].Hc * lvs[l].Wc * PER_CELL <= LIST_CAP ? parts
                                                                  : min(parts, SELECT_PARTS);
      if (part < lp) select_level(a, lvs, l, part, lp, smem);
      __syncthreads();                        // the shared memory is reused by the next level
    }
  }
  // stage: select_done
  if ((a.stages & 4) && (a.stages & 3)) gridbar::grid_sync(a.bar, arrived);
  // stage: describe_start
  if (a.stages & 4) describe_pass(a, lvs, smem);
  // stage: describe_done
  gridbar::finish_sync(a.bar);
}

// Whether the kernel copies a level's rows 16 bytes at a time: the level is
// 16-byte aligned and its width a multiple of 4 floats.
bool vector_rows(const void* img, int W) {
  return W % 4 == 0 && reinterpret_cast<uintptr_t>(img) % 16 == 0;
}

// The launch's arguments from the C interface (false where they are refused).
bool make_args(int stages, int L, const void* const* imgs, const int* dims, int budget,
               float threshold, const void* pattern, void* probe, void* const* scratch,
               void* const* out, Args& a) {
  if (L <= 0 || L > MAX_LEVELS || budget <= 0 || stages <= 0 || stages > 7) return false;
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
  a.sorted = static_cast<uint2*>(scratch[4]);
  a.bar = static_cast<unsigned*>(scratch[5]);
  a.uv = static_cast<float*>(out[0]);
  a.level = static_cast<int32_t*>(out[1]);
  a.angle = static_cast<float*>(out[2]);
  a.score = static_cast<float*>(out[3]);
  a.desc = static_cast<int32_t*>(out[4]);
  a.valid = static_cast<uint8_t*>(out[5]);
  long long pixels = 0, cells = 0;
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
    lv.probe0 = (int)pixels;
    lv.vec = vector_rows(imgs[l], W);
    cells += (long long)lv.Hc * lv.Wc;
    pixels += (long long)H * W;
  }
  a.cells = (int)cells;
  // no cell: every slot is a pad
  a.stages = cells == 0 ? stages & 4 : stages;
  return pixels < (1LL << 31) && (long long)L * budget * (PAIRS / 32) < (1LL << 31);
}

// The co-resident grid on the current device: its SMs times the blocks an
// SM holds (found once a device).
cudaError_t grid_blocks(int* blocks) {
  static int cached[64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 64 && cached[dev] > 0) {
    *blocks = cached[dev];
    return cudaSuccess;
  }
  int sms = 0, per_sm = 0;
  e = cudaFuncSetAttribute(orb_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, reinterpret_cast<const void*>(orb_kernel), THREADS, SMEM_BYTES);
  if (e != cudaSuccess) return e;
  if (per_sm == 0) return cudaErrorLaunchOutOfResources;
  *blocks = sms * per_sm;
  if (dev < 64) cached[dev] = *blocks;
  return cudaSuccess;
}

}  // namespace

// imgs: L level pointers (H x W float32 each); dims: H, W per level; scratch:
// cand_score, cand_pix (4 x cells each), slot_pix, slot_score (L x budget
// each), sorted (4 x cells uint2), the grid barrier (BAR_WORDS unsigned, 0);
// out: uv, level, angle, score, desc, valid; probe: nullptr or the levels'
// maps concatenated. stages: a mask of the passes to run, bit k for pass k
// (7, all three, is a call; one bit runs that pass alone on what the scratch
// holds, to time it). One cooperative launch on `stream`; returns its CUDA
// error.
extern "C" int orb_extract_launch(int stages, int L, const void* const* imgs, const int* dims,
                                  int budget, float threshold, const void* pattern, void* probe,
                                  void* const* scratch, void* const* out, void* stream) {
  Args a;
  if (!make_args(stages, L, imgs, dims, budget, threshold, pattern, probe, scratch, out, a))
    return (int)cudaErrorInvalidValue;
  if (a.stages == 0) return 0;                // only passes of the cells, and there are none
  int blocks = 0;
  const cudaError_t e = grid_blocks(&blocks);
  if (e != cudaSuccess) return (int)e;
  void* params[] = {&a};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(orb_kernel), dim3(blocks), dim3(THREADS), params, SMEM_BYTES,
      static_cast<cudaStream_t>(stream));
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

// For each of the L levels, 1 where the kernel copies its rows 16 bytes at
// a time, else 0 (4 bytes a copy), into vec[l].
extern "C" int orb_extract_vector_levels(int L, const void* const* imgs, const int* dims,
                                         int* vec) {
  if (L <= 0 || L > MAX_LEVELS) return (int)cudaErrorInvalidValue;
  for (int l = 0; l < L; ++l) vec[l] = vector_rows(imgs[l], dims[2 * l + 1]) ? 1 : 0;
  return 0;
}

// The blocks of the kernel's co-resident grid on the current device, into
// *out.
extern "C" int orb_extract_grid_blocks(int* out) { return (int)grid_blocks(out); }
