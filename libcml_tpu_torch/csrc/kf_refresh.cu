// The post-keyframe refresh of the direct path, one launch a call, for
// Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package runs `_refresh_after_kf`
// (libcml_tpu/runtime/odometry.py:461) as one jitted program, XLA fusing
// `_window_points_in_frame` (:334, its 4x4-cell z-buffer :371),
// `make_tracker_ref` (models/direct/tracker.py:67), `_working_rho_range`
// (:407, a nanmedian), `select_points` (models/direct/selector.py:52, the
// regional quantiles of `_regional_threshold` :28 and `lax.top_k` :90) and
// `seed_immatures` (models/direct/tracer.py:157). The port's plain PyTorch
// form is `_refresh_after_kf_plain` (runtime/odometry.py), ~422 launches a
// call; its pieces dispatch one by one as well (`_tracker_ref_in_frame`,
// `make_tracker_ref`, `_working_rho_range`, `select_points`,
// `seed_immatures`), each a launch of this kernel with a stage mask.
// ops/kf_programs.py is the wrapper.
//
// Stages (bit k of `stages`: one of them, or all four), in up to three
// phases with a grid barrier (grid_barrier.cuh) between them; a mask whose
// work is all in phase 1 (B, D, A of given points) is a plain launch:
//   A (1) the tracker reference: the P window points projected into frame
//     `slot` (phase 2: a thread a point, its pixel, inverse depth, validity
//     and 4x4 cell kept, its inverse depth's bits max-ed into the cell
//     table, which phase 1 zeroed: a positive float orders as its bits),
//     then (phase 3, a thread a (level, point)) kept where its inverse
//     depth exceeds 0.8 of its cell's largest, and sampled at every level;
//     given points (make_tracker_ref) are sampled in phase 1.
//   B (2) the working inverse-depth range: the median of the valid points'
//     inverse depths (phase 1, one block: the keys at the two middle ranks
//     of torch.nanquantile's interpolation by a radix selection,
//     select_ranks), 1.0 when there is none; [med / 8, med x 8] clamped to
//     the config.
//   C (4) the candidate selection: each 32x32 region's gradient-magnitude
//     quantile (phase 1, a block a region: its two ranks by select_ranks,
//     torch.quantile's interpolation; a NaN in the region gives NaN), then
//     (phase 2) the regions' thresholds smoothed 3x3 with the edge
//     replicated in the plain form's order, squared, and each pot x pot
//     cell's first maximum of the masked squared gradient (a warp a cell,
//     two redux.sync), then (phase 3) the stable top k of the cells' maxima
//     by rank (a warp a cell counts the greater maxima and the equal ones
//     at a lower index: lax.top_k's order), the rest padded.
//   D (8) the seed: the 8 pattern colours of channel 0 at each selected
//     pixel, written into row `slot` of new arena tensors with the range,
//     zero counts and the validity, the other rows copied (phase 1). In a
//     refresh the warp that ranks a cell under k seeds its position (lanes
//     0-7 a tap each) in phase 3, and B's range is read there.
// So `_refresh_after_kf` is one launch (15) with two grid barriers and no
// host read; the pieces are launches of one stage.
//
// Bound: bytes. The keyframe's level-0 gradient image is read (3.7 MB at
// 640 x 480) for the selection, the window's points and the arena once;
// the 1,036 ranks' ~1.1 M comparisons and the selections are a few
// microseconds. What it costs is latency, and the design keeps it short:
// a selection takes four histogram passes (one __syncthreads each) where a
// bitonic sort of 1,024 keys took 55 dependent stages; the grid is sized to
// the units of the mask (at 640 x 480 a refresh is 1 + 300 blocks of 256);
// only the blocks that own cells build the threshold table, each from the
// 300 quantiles copied into shared memory once (in the sorting design of
// commit cb7cc16 each of 396 blocks read every quantile 9 times from L2);
// the scattered gathers (samples, seeds) are spread over every block, since
// one SM serves a warp's 32 scattered lines one at a time (that design's
// 512 seeds in one block: 9 us).
//
// Numerics: every product, sum and quotient is rounded on its own as the
// plain form's separate PyTorch operations round them on the card
// (__fmul_rn, __fadd_rn, __fdiv_rn, __fsqrt_rn): a division by a Python
// float is a product with its float32 reciprocal there (PyTorch's CUDA
// division by a CPU scalar), `c2 / x` is x.reciprocal() * c2, the point
// transforms are the plain form's matrix products as cuBLAS rounds them
// (dot3, gemv3). A selection gives the sorted keys' own values at its
// ranks, so every output is the plain form's bit for bit on the smoke's
// calls; ops/kf_programs.py still holds the reference's pixels within a
// stated tolerance and its validity within a stated edge, since the
// cuBLAS kernels' orders are measured, not documented.

#include <cuda_runtime.h>

#include <algorithm>

#include "grid_barrier.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int REGION = 32, REGION_N = REGION * REGION;
constexpr int MAX_LEVELS = 8;
constexpr int SMEM_WORDS = 16384;          // the largest launch's tables: 64 KB
constexpr int SMEM_BYTES = SMEM_WORDS * 4;
constexpr int BINS = 256;                  // a radix pass's digits
constexpr int SELECT_WORDS = 3 * BINS;     // a selection's three histograms
constexpr int RANGE_KEYS = 8;              // B's keys a thread held in registers
constexpr int GATHER = 64;                 // gathered items a block (samples, seeds)
constexpr int CELL_CHUNK = 8;              // a lane's cell pixels loaded at once
constexpr unsigned NO_KEY = 0xFFFFFFFFu;
constexpr int ST_REF = 1, ST_RANGE = 2, ST_SELECT = 4, ST_SEED = 8, ST_ALL = 15;
__constant__ float PAT_U[8] = {0.f, -1.f, 1.f, -2.f, 0.f, 2.f, -1.f, 0.f};
__constant__ float PAT_V[8] = {-2.f, -1.f, -1.f, 0.f, 0.f, 0.f, 1.f, 2.f};

struct Args {
  int stages;
  int ref_points;               // A samples given points (make_tracker_ref)
  // the camera at level 0 (1 / fx, 1 / fy: float32 reciprocals)
  int W, H;
  float fx, fy, cx, cy, ifx, ify;
  // the window (A, B): P points, F frame slots, the keyframe's slot
  int P, F, slot;
  const float* ba_uv;           // (P, 2)
  const float* ba_idepth;
  const int* ba_host;
  const unsigned char* ba_pv;
  const float* T_R;             // (F, 3, 3)
  const float* T_t;             // (F, 3)
  // A with ref_points: P given points
  const float* pt_uv;
  const float* pt_idepth;
  const unsigned char* pt_valid;
  // the keyframe's gradient pyramid: L levels of (lh, lw, 3), the levels'
  // camera bounds (cam.level(l).width, .height)
  int L;
  const float* pyr[MAX_LEVELS];
  int lh[MAX_LEVELS], lw[MAX_LEVELS], cam_w[MAX_LEVELS], cam_h[MAX_LEVELS];
  float c2, idepth_min, idepth_max;
  // A: outputs (uv (L, P, 2), colour, weight, validity (L, P), inverse depth (P,))
  float* r_uv;
  float* r_color;
  float* r_weight;
  unsigned char* r_valid;
  float* r_idepth;
  // A: scratch: the cell table ((H+3)/4 x (W+3)/4 unsigned), per point pixel, inverse depth, cell, validity
  int Wc4, Hc4;
  unsigned* cells;
  float* s_uv;
  float* s_rho;
  int* s_cid;
  unsigned char* s_ok;
  // B: outputs (0-d)
  float* rho_lo;
  float* rho_hi;
  // C: on pyr[0] (H, W, 3): quantile ranks and weight, threshold add, border,
  // regions, cells, budget
  int q_lo, q_hi;
  float q_w, th_add;
  int border, Hr, Wr, pot, Hc, Wc, n_points, k;
  float* q_region;              // scratch (Hr Wr)
  float* cell_best;             // scratch (Hc Wc)
  int* cell_arg;
  float* sel_uv;                // outputs (n_points, 2), (n_points,), (n_points,)
  unsigned char* sel_valid;
  float* sel_score;
  // D: the arena (Fi, Ki), its image (channel 0 of an (sh, sw, 3) image),
  // the seeds and the range (pointers to C's and B's outputs in a refresh)
  int Fi, Ki, sh, sw;
  const float* seed_img;
  const float* seed_uv;
  const unsigned char* seed_valid;
  const float* seed_lo;
  const float* seed_hi;
  const float* im_uv;
  const float* im_color;
  const float* im_lo;
  const float* im_hi;
  const int* im_nok;
  const int* im_nfail;
  const unsigned char* im_valid;
  float* o_uv;
  float* o_color;
  float* o_lo;
  float* o_hi;
  int* o_nok;
  int* o_nfail;
  unsigned char* o_valid;
  unsigned* bar;                // grid_barrier.cuh's buffer, 0 between launches
};

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float clamp_nan(float x, float lo, float hi) {
  return isnan(x) ? x : fminf(fmaxf(x, lo), hi);
}
__device__ __forceinline__ float max_nan(float x, float lo) { return isnan(x) ? x : fmaxf(x, lo); }
__device__ __forceinline__ float min_nan(float x, float hi) { return isnan(x) ? x : fminf(x, hi); }

// The card's roundings of a 3-term product: in a matrix product (cuBLAS's
// gemm, (P, 3) @ (3, 3)) a fused chain in index order from the first
// product; in einsum("pji,pj->pi") (cuBLAS's gemv kernel) the first and
// third terms fused, then the second product added (tools/rounding_probe.py
// on the card: no other order of the three products gives their bits)
__device__ __forceinline__ float dot3(float a0, float a1, float a2, float b0, float b1,
                                      float b2) {
  return __fmaf_rn(a2, b2, __fmaf_rn(a1, b1, mul(a0, b0)));
}
__device__ __forceinline__ float gemv3(float a0, float a1, float a2, float b0, float b1,
                                       float b2) {
  return add(mul(a1, b1), __fmaf_rn(a2, b2, mul(a0, b0)));
}

// ops/image.py bilinear at (x, y) of an (H, W, 3) image, channels [c0, c1)
template <int C0, int C1>
__device__ __forceinline__ void bilinear(const float* img, int H, int W, float x, float y,
                                         float* out) {
  const float x0f = isnan(x) ? 0.f : fminf(fmaxf(floorf(x), 0.f), (float)(W - 2));
  const float y0f = isnan(y) ? 0.f : fminf(fmaxf(floorf(y), 0.f), (float)(H - 2));
  const long long x0 = (long long)x0f, y0 = (long long)y0f;
  const float dx = clamp_nan(sub(x, x0f), 0.f, 1.f), dy = clamp_nan(sub(y, y0f), 0.f, 1.f);
  const float ex = sub(1.f, dx), ey = sub(1.f, dy);
  const float* p = img + (y0 * W + x0) * 3;
  const float* q = p + (long long)W * 3;
#pragma unroll
  for (int c = C0; c < C1; ++c) {
    const float top = add(mul(__ldg(p + c), ex), mul(__ldg(p + 3 + c), dx));
    const float bot = add(mul(__ldg(q + c), ex), mul(__ldg(q + 3 + c), dx));
    out[c - C0] = add(mul(top, ey), mul(bot, dy));
  }
}

// the gradient weight sqrt(c2 / (c2 + gx^2 + gy^2)) as PyTorch rounds it
__device__ __forceinline__ float grad_weight(float gx, float gy, float c2) {
  const float gsq = add(mul(gx, gx), mul(gy, gy));
  return __fsqrt_rn(mul(__frcp_rn(add(gsq, c2)), c2));
}

// the squared gradient norm of pixel i of an (H, W, 3) image
__device__ __forceinline__ float grad2(const float* img, long long i) {
  const float gx = __ldg(img + 3 * i + 1), gy = __ldg(img + 3 * i + 2);
  return add(mul(gx, gx), mul(gy, gy));
}

// torch.lerp(lo, hi, w) as its CUDA kernel contracts it
__device__ __forceinline__ float lerp(float lo, float hi, float w) {
  return fabsf(w) < 0.5f ? __fmaf_rn(w, sub(hi, lo), lo)
                         : __fmaf_rn(-sub(hi, lo), sub(1.f, w), hi);
}

// a float's bits in an order that sorts as the values (-0 before +0)
__device__ __forceinline__ unsigned order_key(float v) {
  const unsigned u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}
__device__ __forceinline__ float order_value(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7FFFFFFFu) : ~k);
}

// The keys at ranks r0 and r1 (r1 = r0 or r0 + 1, both under the count of
// keys) of the keys that `each` hands this block's threads, as an ascending
// sort of them holds them. `each(f)` calls f(key, present) for every slot
// (a slot without a key: present false). A radix selection from the top
// digit: four passes, each a shared histogram of the 8-bit digit of the
// keys that match the digits found so far (one atomic a key: a region's
// magnitudes share a few top digits, yet counting a warp's equal digits
// once, by __match_any_sync or by lane 0's digit, was slower), which every warp
// scans for the bin holding the rank (lane l sums bins 8l..8l+7, a shuffle
// scan, a ballot for the lane, that lane's walk); three histograms in turn,
// the next cleared while the current is counted, so a pass takes one
// __syncthreads. The key at r1 is the same key where its equal keys reach
// r1, else the least key above it (a block-wide minimum).
// ops/kf_programs.py model_select_ranks follows the passes. `sm`:
// SELECT_WORDS words; `red`: a word a warp.
template <class Each>
__device__ uint2 select_ranks(Each each, int r0, int r1, unsigned* sm, unsigned* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < 2 * BINS; i += THREADS) sm[i] = 0u;
  __syncthreads();
  unsigned prefix = 0u, mask = 0u, equal = 0u;
  int r = r0;   // the rank among the keys that match `prefix`
#pragma unroll
  for (int pass = 0; pass < 4; ++pass) {
    const int shift = 24 - 8 * pass;
    unsigned* h = sm + (pass % 3) * BINS;
    each([&](unsigned k, bool present) {
      if (present && (k & mask) == prefix) atomicAdd(h + ((k >> shift) & 0xFFu), 1u);
    });
    if (pass == 1 || pass == 2)   // the histogram of pass + 1, read last in pass - 2
      for (int i = threadIdx.x; i < BINS; i += THREADS) sm[((pass + 1) % 3) * BINS + i] = 0u;
    __syncthreads();
    const uint4 lo4 = reinterpret_cast<const uint4*>(h)[2 * lane];
    const uint4 hi4 = reinterpret_cast<const uint4*>(h)[2 * lane + 1];
    const unsigned c[8] = {lo4.x, lo4.y, lo4.z, lo4.w, hi4.x, hi4.y, hi4.z, hi4.w};
    unsigned sum = 0u;
#pragma unroll
    for (int j = 0; j < 8; ++j) sum += c[j];
    unsigned incl = sum;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned y = __shfl_up_sync(FULL, incl, o);
      if (lane >= o) incl += y;
    }
    const int at = __ffs(__ballot_sync(FULL, (unsigned)r < incl)) - 1;
    unsigned before = incl - sum, bin_count = 0u;
    int digit = 7;
    bool found = false;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (!found && before + c[j] > (unsigned)r) {
        found = true;
        digit = j;
        bin_count = c[j];
      }
      if (!found) before += c[j];
    }
    prefix |= (unsigned)(8 * at + __shfl_sync(FULL, digit, at)) << shift;
    mask |= 0xFFu << shift;
    equal = __shfl_sync(FULL, bin_count, at);
    r -= (int)__shfl_sync(FULL, before, at);
  }
  unsigned k1 = prefix;
  if ((unsigned)(r + (r1 - r0)) >= equal) {   // block-uniform: r1 is past the equal keys
    unsigned m = NO_KEY;
    each([&](unsigned k, bool present) {
      if (present && k > prefix) m = min(m, k);
    });
    m = __reduce_min_sync(FULL, m);
    if (lane == 0) red[warp] = m;
    __syncthreads();
    k1 = red[0];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) k1 = min(k1, red[w]);
  }
  return make_uint2(prefix, k1);
}

// B: the median of the valid, non-NaN inverse depths, as
// torch.nanquantile(·, 0.5) takes it; 1.0 when there are none; the range.
// The keys are each point's order_key (the others are left out: they sort
// after every valid key in the plain form's sorted array), held in
// registers up to RANGE_KEYS a thread, else read again each pass.
__device__ void range_unit(const Args& a, unsigned* sm, unsigned* red) {
  const bool regs = a.P <= RANGE_KEYS * THREADS;
  unsigned key[RANGE_KEYS];
  int mine = 0;
#pragma unroll
  for (int j = 0; j < RANGE_KEYS; ++j) {
    const int i = threadIdx.x + j * THREADS;
    const bool in = regs && i < a.P;
    const float v = in ? __ldg(a.ba_idepth + i) : 0.f;
    const bool ok = in && __ldg(a.ba_pv + i) && !isnan(v);
    key[j] = ok ? order_key(v) : NO_KEY;
    mine += ok;
  }
  auto global = [&](auto f) {   // every lane of a warp runs the same iterations
    for (int i0 = 0; i0 < a.P; i0 += THREADS) {
      const int i = i0 + threadIdx.x;
      const float v = i < a.P ? __ldg(a.ba_idepth + i) : 0.f;
      f(order_key(v), i < a.P && __ldg(a.ba_pv + i) && !isnan(v));
    }
  };
  if (!regs) global([&](unsigned, bool present) { mine += present; });
  mine = __reduce_add_sync(FULL, mine);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = (unsigned)mine;
  __syncthreads();
  int m = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) m += (int)red[w];
  float med = __int_as_float(0x7FC00000);
  if (m > 0) {   // the rank q (m - 1) in float32, its floor and ceiling
    const float rank = mul(0.5f, (float)(m - 1));
    const int lo = (int)rank, hi = (int)ceilf(rank);
    const uint2 k = regs ? select_ranks([&](auto f) {
#pragma unroll
                             for (int j = 0; j < RANGE_KEYS; ++j) f(key[j], key[j] != NO_KEY);
                           }, lo, hi, sm, red)
                         : select_ranks(global, lo, hi, sm, red);
    med = lerp(order_value(k.x), order_value(k.y), sub(rank, (float)lo));
  }
  if (!isfinite(med)) med = 1.f;
  if (threadIdx.x == 0) {
    *a.rho_lo = max_nan(mul(med, 0.125f), a.idepth_min);
    *a.rho_hi = min_nan(mul(med, 8.f), a.idepth_max);
  }
}

// C, phase 1: region r's gradient-magnitude quantile (NaN if any value is);
// the magnitudes are >= +0, so their bits order as the values
__device__ void region_unit(const Args& a, int r, unsigned* sm, unsigned* red) {
  const int ry = r / a.Wr, rx = r - ry * a.Wr;
  const float* img = a.pyr[0];
  constexpr int PER = REGION_N / THREADS;
  unsigned key[PER];
  int nan = 0;
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int i = threadIdx.x + k * THREADS;
    const int y = ry * REGION + (i >> 5), x = rx * REGION + (i & 31);
    const float g = __fsqrt_rn(grad2(img, (long long)y * a.W + x));
    nan |= isnan(g);
    key[k] = __float_as_uint(g);
  }
  // also the barrier before this block's previous selection's histograms are cleared
  if (__syncthreads_or(nan)) {
    if (threadIdx.x == 0) a.q_region[r] = __int_as_float(0x7FC00000);
    return;
  }
  const uint2 k = select_ranks([&](auto f) {
#pragma unroll
    for (int j = 0; j < PER; ++j) f(key[j], true);
  }, a.q_lo, a.q_hi, sm, red);
  if (threadIdx.x == 0)
    a.q_region[r] = lerp(__uint_as_float(k.x), __uint_as_float(k.y), a.q_w);
}

// A, phase 2: point p projected into the keyframe, into the cell table
__device__ void project_point(const Args& a, int p) {
  const float u = a.ba_uv[2 * p], v = a.ba_uv[2 * p + 1];
  const float depth = __frcp_rn(max_nan(a.ba_idepth[p], 1e-12f));
  const float xh = mul(mul(sub(u, a.cx), a.ifx), depth);
  const float yh = mul(mul(sub(v, a.cy), a.ify), depth);
  int h = a.ba_host[p];
  h = h < 0 ? 0 : (h >= a.F ? a.F - 1 : h);
  const float* Rh = a.T_R + 9 * h;
  const float* th = a.T_t + 3 * h;
  const float d0 = sub(xh, th[0]), d1 = sub(yh, th[1]), d2 = sub(depth, th[2]);
  // X_w = R_h^T (X_h - t_h)
  const float w0 = gemv3(Rh[0], Rh[3], Rh[6], d0, d1, d2);
  const float w1 = gemv3(Rh[1], Rh[4], Rh[7], d0, d1, d2);
  const float w2 = gemv3(Rh[2], Rh[5], Rh[8], d0, d1, d2);
  const float* Rl = a.T_R + 9 * a.slot;
  const float* tl = a.T_t + 3 * a.slot;
  const float x = add(dot3(w0, w1, w2, Rl[0], Rl[1], Rl[2]), tl[0]);
  const float y = add(dot3(w0, w1, w2, Rl[3], Rl[4], Rl[5]), tl[1]);
  const float z = add(dot3(w0, w1, w2, Rl[6], Rl[7], Rl[8]), tl[2]);
  const float iz = __frcp_rn(fabsf(z) < 1e-12f ? 1e-12f : z);
  const float ul = add(mul(mul(a.fx, x), iz), a.cx);
  const float vl = add(mul(mul(a.fy, y), iz), a.cy);
  const bool inb = ul >= 3.f && ul <= (float)(a.W - 4) && vl >= 3.f && vl <= (float)(a.H - 4);
  const bool ok = a.ba_pv[p] && z > 1e-6f && inb && z > 1e-4f;
  const float rho = __frcp_rn(max_nan(z, 1e-4f));
  // float -> int32 truncates (saturating; NaN -> 0, as nan_to_num does first)
  const int ix = __float2int_rz(ul), iy = __float2int_rz(vl);
  const int cx = min(max(ix >> 2, 0), a.Wc4 - 1), cy = min(max(iy >> 2, 0), a.Hc4 - 1);
  const int cid = cy * a.Wc4 + cx;
  a.s_uv[2 * p] = ul;
  a.s_uv[2 * p + 1] = vl;
  a.s_rho[p] = rho;
  a.s_cid[p] = cid;
  a.s_ok[p] = ok;
  if (ok) atomicMax(a.cells + cid, __float_as_uint(rho));
}

// A, phase 3 (given points: phase 1): point p at level l
__device__ void sample_point(const Args& a, int l, int p) {
  float u0, v0, rho;
  bool ok;
  if (a.ref_points) {
    u0 = a.pt_uv[2 * p];
    v0 = a.pt_uv[2 * p + 1];
    rho = 0.f;
    ok = a.pt_valid[p] != 0;
  } else {
    u0 = __ldcg(a.s_uv + 2 * p);
    v0 = __ldcg(a.s_uv + 2 * p + 1);
    rho = __ldcg(a.s_rho + p);
    const float cmax = __uint_as_float(__ldcg(a.cells + __ldcg(a.s_cid + p)));
    ok = __ldcg(a.s_ok + p) && rho > mul(0.8f, cmax);
    if (l == 0) a.r_idepth[p] = rho;
  }
  const float s = __uint_as_float((unsigned)(127 - l) << 23);   // 0.5^l
  const float ul = sub(mul(add(u0, 0.5f), s), 0.5f), vl = sub(mul(add(v0, 0.5f), s), 0.5f);
  float smp[3];
  bilinear<0, 3>(a.pyr[l], a.lh[l], a.lw[l], add(ul, 0.f), add(vl, 0.f), smp);
  const long long o = (long long)l * a.P + p;
  a.r_uv[2 * o] = ul;
  a.r_uv[2 * o + 1] = vl;
  a.r_color[o] = smp[0];
  a.r_weight[o] = grad_weight(smp[1], smp[2], a.c2);
  a.r_valid[o] = ok && ul >= 3.f && ul <= (float)(a.cam_w[l] - 4) && vl >= 3.f &&
                 vl <= (float)(a.cam_h[l] - 4);
}

// C, phase 2: the regions' smoothed squared thresholds into shared memory
// (the quantiles copied there first, so that the block reads each from L2
// once), and their maximum (NaN if any is); returns the maximum
__device__ float threshold_table(const Args& a, float* th2, float* q, unsigned* red) {
  const int n = a.Hr * a.Wr;
  for (int r = threadIdx.x; r < n; r += THREADS) q[r] = __ldcg(a.q_region + r);
  __syncthreads();
  const float inv9 = 1.f / 9.f;   // float32(1 / 9): PyTorch's CUDA division by a Python float
  unsigned mx = 0u;
  bool nan = false;
  for (int r = threadIdx.x; r < n; r += THREADS) {
    const int i = r / a.Wr, j = r - i * a.Wr;
    float sm = 0.f;
#pragma unroll
    for (int di = 0; di < 3; ++di)
#pragma unroll
      for (int dj = 0; dj < 3; ++dj) {
        const int ii = min(max(i + di - 1, 0), a.Hr - 1), jj = min(max(j + dj - 1, 0), a.Wr - 1);
        const float t = add(q[ii * a.Wr + jj], a.th_add);
        sm = (di == 0 && dj == 0) ? t : add(sm, t);
      }
    const float t2 = mul(mul(sm, inv9), mul(sm, inv9));
    th2[r] = t2;
    if (isnan(t2)) nan = true;
    else mx = max(mx, __float_as_uint(t2));   // t2 >= +0
  }
  mx = __reduce_max_sync(FULL, mx);
  const bool any_nan = __any_sync(FULL, nan);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = any_nan ? NO_KEY : mx;
  __syncthreads();
  unsigned out = 0u;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) out = max(out, red[w]);   // NO_KEY: a NaN threshold
  return out == NO_KEY ? __int_as_float(0x7FC00000) : __uint_as_float(out);
}

// C, phase 2: cell c's first maximum of the masked squared gradient (a warp)
__device__ void cell_max(const Args& a, int c, const float* th2, float th_out) {
  const int lane = threadIdx.x & 31;
  const int cy = c / a.Wc, cx = c - cy * a.Wc;
  const float* img = a.pyr[0];
  float best = -1.f;   // a lane without a pixel keeps -1: key 0, no index
  int arg = 0x7FFFFFFF;
  const int n = a.pot * a.pot;
  // the lane's pixel (oy, ox) in the cell, stepped 32 pixels at a time
  // without a division
  const int q32 = 32 / a.pot, r32 = 32 - q32 * a.pot;
  int oy = lane / a.pot, ox = lane - oy * a.pot;
  for (int o0 = lane; o0 < n; o0 += 32 * CELL_CHUNK) {   // a chunk's loads, then its tests
    float gx[CELL_CHUNK], gy[CELL_CHUNK];
    int ys[CELL_CHUNK], xs[CELL_CHUNK];
#pragma unroll
    for (int u = 0; u < CELL_CHUNK; ++u) {
      const bool in = o0 + 32 * u < n;
      ys[u] = cy * a.pot + (in ? oy : 0);
      xs[u] = cx * a.pot + (in ? ox : 0);
      const long long i = (long long)ys[u] * a.W + xs[u];
      gx[u] = __ldg(img + 3 * i + 1);
      gy[u] = __ldg(img + 3 * i + 2);
      ox += r32;
      oy += q32;
      if (ox >= a.pot) {
        ox -= a.pot;
        ++oy;
      }
    }
#pragma unroll
    for (int u = 0; u < CELL_CHUNK; ++u) {
      const int o = o0 + 32 * u;
      if (o >= n) break;
      const int y = ys[u], x = xs[u];
      const float g2 = add(mul(gx[u], gx[u]), mul(gy[u], gy[u]));
      float th = th_out;
      if (y < a.Hr * REGION && x < a.Wr * REGION) {
        th = th2[((unsigned)y / REGION) * a.Wr + (unsigned)x / REGION];
        if (isinf(th)) th = th_out;
      }
      const bool ok = g2 > th && x >= a.border && x < a.W - a.border && y >= a.border &&
                      y < a.H - a.border;
      const float sc = ok ? g2 : 0.f;
      if (sc > best) {
        best = sc;
        arg = o;
      }
    }
  }
  // scores are >= +0 and never NaN: their bits order as the values
  const unsigned key = best < 0.f ? 0u : __float_as_uint(best);
  const unsigned kb = __reduce_max_sync(FULL, key);
  const unsigned ka = __reduce_min_sync(FULL, key == kb ? (unsigned)arg : ~0u);
  if (lane == 0) {
    a.cell_best[c] = __uint_as_float(kb);
    a.cell_arg[c] = (int)ka;
  }
}

// D: pattern tap t of seed position i at pixel (u, v), and the position's
// other fields (the seeded row `slot`)
__device__ __forceinline__ void seed_tap(const Args& a, int i, float u, float v, int t) {
  float c;
  bilinear<0, 1>(a.seed_img, a.sh, a.sw, add(u, PAT_U[t]), add(v, PAT_V[t]), &c);
  a.o_color[8 * ((long long)a.slot * a.Ki + i) + t] = c;
}
__device__ __forceinline__ void seed_fields(const Args& a, int i, float u, float v,
                                            unsigned char valid, float lo, float hi) {
  const long long o = (long long)a.slot * a.Ki + i;
  a.o_uv[2 * o] = u;
  a.o_uv[2 * o + 1] = v;
  a.o_lo[o] = lo;
  a.o_hi[o] = hi;
  a.o_nok[o] = 0;
  a.o_nfail[o] = 0;
  a.o_valid[o] = valid;
}

// C, phase 3: cell c's rank among the cells' maxima (greater ones, and
// equal ones at a lower index), and its slot when it ranks under k (a
// warp); with `seed` the warp also seeds that position (lanes 0-7 a tap)
__device__ void rank_cell(const Args& a, int c, const float* best, bool seed, float lo,
                          float hi) {
  const int lane = threadIdx.x & 31, n = a.Hc * a.Wc;
  const int off = __ldcg(a.cell_arg + c);   // issued before the count, used after it
  const float me = best[c];
  unsigned cnt = 0;
  for (int j = lane; j < n; j += 32) {
    const float o = best[j];
    cnt += (o > me) | ((o == me) & (j < c));
  }
  const unsigned rank = __reduce_add_sync(FULL, cnt);
  if (rank >= (unsigned)a.k) return;
  const int oy = off / a.pot, ox = off - oy * a.pot;
  const int cy = c / a.Wc, cx = c - cy * a.Wc;
  const float u = (float)(cx * a.pot + ox), v = (float)(cy * a.pot + oy);
  if (lane == 0) {
    a.sel_uv[2 * rank] = u;
    a.sel_uv[2 * rank + 1] = v;
    a.sel_valid[rank] = me > 0.f;
    a.sel_score[rank] = me;
  }
  if (seed) {
    if (lane < 8) seed_tap(a, (int)rank, u, v, lane);
    if (lane == 0) seed_fields(a, (int)rank, u, v, me > 0.f, lo, hi);
  }
}

// an arena entry copied (its loads first: a store may alias a later load,
// so interleaved each would wait a round trip)
struct Entry {
  float2 uv;
  float4 c0, c1;
  float lo, hi;
  int nok, nfail;
  unsigned char valid;
};
__device__ __forceinline__ Entry load_entry(const Args& a, long long o) {
  Entry e;
  e.uv = reinterpret_cast<const float2*>(a.im_uv)[o];
  e.c0 = reinterpret_cast<const float4*>(a.im_color)[2 * o];
  e.c1 = reinterpret_cast<const float4*>(a.im_color)[2 * o + 1];
  e.lo = a.im_lo[o];
  e.hi = a.im_hi[o];
  e.nok = a.im_nok[o];
  e.nfail = a.im_nfail[o];
  e.valid = a.im_valid[o];
  return e;
}
__device__ __forceinline__ void store_entry(const Args& a, long long o, const Entry& e) {
  reinterpret_cast<float2*>(a.o_uv)[o] = e.uv;
  reinterpret_cast<float4*>(a.o_color)[2 * o] = e.c0;
  reinterpret_cast<float4*>(a.o_color)[2 * o + 1] = e.c1;
  a.o_lo[o] = e.lo;
  a.o_hi[o] = e.hi;
  a.o_nok[o] = e.nok;
  a.o_nfail[o] = e.nfail;
  a.o_valid[o] = e.valid;
}

// Three blocks an SM, so that a 640 x 480 refresh's 301 blocks are
// co-resident, and no fewer registers than that allows (at the compiler's
// default of 64 it spilled).
__global__ void __launch_bounds__(THREADS, 3) refresh_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned smem[];
  __shared__ unsigned red[WARPS];
  __shared__ unsigned arrived;
  if (threadIdx.x == 0) arrived = 0u;   // grid_sync's count (its __syncthreads orders this)
  const int gtid = blockIdx.x * THREADS + threadIdx.x, gstride = gridDim.x * THREADS;
  // a gathered item's thread: consecutive items on consecutive blocks
  const int sid = blockIdx.x + gridDim.x * threadIdx.x;
  const bool ref = a.stages & ST_REF, window = ref && !a.ref_points;
  const bool sel = a.stages & ST_SELECT, seed = a.stages & ST_SEED;
  const bool seed_row = seed && a.slot >= 0 && a.slot < a.Fi;
  const int n_cells = a.Hc * a.Wc;
  const bool cell_block = sel && blockIdx.x * WARPS < n_cells;   // owns cells in phases 2, 3
  // stage: refresh_start

  // phase 1: the range (unit 0), the regions' quantiles (units 1..), the
  // cell table zeroed, the arena's other rows copied (the first entry's
  // loads issued before the unit, its stores after it), the seeds without
  // a selection (8 threads a position), given points sampled
  if (window)
    for (int i = gtid; i < a.Wc4 * a.Hc4; i += gstride) a.cells[i] = 0u;
  const long long n_arena = seed ? (long long)a.Fi * a.Ki : 0;
  auto copied = [&](long long o) { return !seed_row || o / a.Ki != a.slot; };
  Entry held;
  const bool hold = gtid < n_arena && copied(gtid);
  if (hold) held = load_entry(a, gtid);
  const int first = (a.stages & ST_RANGE) ? 1 : 0, units = first + (sel ? a.Hr * a.Wr : 0);
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    if (u < first) range_unit(a, smem, red);
    else region_unit(a, u - first, smem, red);
  }
  // stage: units
  if (hold) store_entry(a, gtid, held);
  for (long long o = gtid + gstride; o < n_arena; o += gstride)
    if (copied(o)) store_entry(a, o, load_entry(a, o));
  if (seed_row && !sel) {
    const float lo = __ldg(a.seed_lo), hi = __ldg(a.seed_hi);
    for (int g = gtid; g < 8 * a.Ki; g += gstride) {
      const int i = g >> 3, t = g & 7;
      const float u = __ldg(a.seed_uv + 2 * i), v = __ldg(a.seed_uv + 2 * i + 1);
      const unsigned char valid = __ldg(a.seed_valid + i);
      seed_tap(a, i, u, v, t);
      if (t == 0) seed_fields(a, i, u, v, valid, lo, hi);
    }
  }
  if (ref && a.ref_points)
    for (int i = sid; i < a.L * a.P; i += gstride) sample_point(a, i / a.P, i % a.P);
  // stage: phase1
  if (!window && !sel) return;   // no barrier was taken, none is left to reset

  // phase 2: the points into the cell table; the cells' maxima
  gridbar::grid_sync(a.bar, arrived);
  // stage: barrier1
  if (window)
    for (int p = sid; p < a.P; p += gstride) project_point(a, p);
  if (cell_block) {
    float* th2 = reinterpret_cast<float*>(smem);
    const float th_out = threshold_table(a, th2, th2 + a.Hr * a.Wr, red);
    // stage: thresholds
    for (int c = blockIdx.x * WARPS + (threadIdx.x >> 5); c < n_cells; c += gridDim.x * WARPS)
      cell_max(a, c, th2, th_out);
  }
  // stage: phase2

  // phase 3: the z-buffer test and the levels' samples; the ranks (with the
  // seeds in a refresh) and the padded positions
  gridbar::grid_sync(a.bar, arrived);
  // stage: barrier2
  if (window)
    for (int i = sid; i < a.L * a.P; i += gstride) sample_point(a, i / a.P, i % a.P);
  if (sel) {
    const float lo = seed_row ? __ldcg(a.seed_lo) : 0.f, hi = seed_row ? __ldcg(a.seed_hi) : 0.f;
    if (cell_block) {
      float* best = reinterpret_cast<float*>(smem);
      for (int c = threadIdx.x; c < n_cells; c += THREADS) best[c] = __ldcg(a.cell_best + c);
      __syncthreads();
      // stage: maxima
      for (int c = blockIdx.x * WARPS + (threadIdx.x >> 5); c < n_cells; c += gridDim.x * WARPS)
        rank_cell(a, c, best, seed_row, lo, hi);
    }
    for (int r = a.k + sid; r < a.n_points; r += gstride) {
      a.sel_uv[2 * r] = 0.f;
      a.sel_uv[2 * r + 1] = 0.f;
      a.sel_valid[r] = 0;
      a.sel_score[r] = 0.f;
      if (seed_row) {
        for (int t = 0; t < 8; ++t) seed_tap(a, r, 0.f, 0.f, t);
        seed_fields(a, r, 0.f, 0.f, 0, lo, hi);
      }
    }
  }
  // stage: phase3
  gridbar::finish_sync(a.bar);
}

// The blocks an SM holds at `smem` bytes of dynamic shared memory on the
// current device (found once a device and 4 KB step of shared memory).
cudaError_t blocks_per_sm(int smem, int* sms, int* per_sm) {
  static int cached_sms[64], cached[64][SMEM_BYTES / 4096 + 1];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const int step = (smem + 4095) / 4096;
  if (dev < 64 && cached[dev][step] > 0) {
    *sms = cached_sms[dev];
    *per_sm = cached[dev][step];
    return cudaSuccess;
  }
  e = cudaFuncSetAttribute(refresh_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           SMEM_BYTES);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        per_sm, reinterpret_cast<const void*>(refresh_kernel), THREADS, step * 4096);
  if (e != cudaSuccess) return e;
  if (*per_sm == 0) return cudaErrorLaunchOutOfResources;
  if (dev < 64) {
    cached_sms[dev] = *sms;
    cached[dev][step] = *per_sm;
  }
  return cudaSuccess;
}

long long cdiv(long long n, long long d) { return (n + d - 1) / d; }

}  // namespace

// One launch on `stream` of a stage mask (one stage or all four; the
// wrapper, ops/kf_programs.py, fills Args through a ctypes structure of the
// same fields): a cooperative launch of the blocks its units need (at most
// the co-resident grid) when it holds a grid barrier (A of the window's
// points, C), else a plain one. Returns the CUDA error of the launch.
extern "C" int kf_refresh_launch(const void* args, void* stream) {
  const Args& a = *static_cast<const Args*>(args);
  const int s = a.stages;
  if ((s != ST_REF && s != ST_RANGE && s != ST_SELECT && s != ST_SEED && s != ST_ALL) ||
      a.L < 1 || a.L > MAX_LEVELS)
    return (int)cudaErrorInvalidValue;
  const bool window = (s & ST_REF) && !a.ref_points, sel = s & ST_SELECT;
  const int n_reg = a.Hr * a.Wr, n_cells = a.Hc * a.Wc;
  if (sel && (2 * n_reg > SMEM_WORDS || n_cells > SMEM_WORDS || a.Hr < 1 || a.Wr < 1 ||
              a.Hc < 1 || a.Wc < 1))
    return (int)cudaErrorInvalidValue;
  // the units of each phase: blocks (B, the regions), warps (the cells),
  // threads (the cell table, the arena), gathered items (samples, seeds)
  long long blocks = ((s & ST_RANGE) ? 1 : 0) + (sel ? n_reg : 0);
  if (sel) blocks = std::max(blocks, cdiv(n_cells, WARPS));
  if (s & ST_REF) blocks = std::max(blocks, cdiv((long long)a.L * a.P, GATHER));
  if (window) blocks = std::max(blocks, cdiv((long long)a.Wc4 * a.Hc4, THREADS));
  if (s & ST_SEED)
    blocks = std::max({blocks, cdiv((long long)a.Fi * a.Ki, THREADS), cdiv(8LL * a.Ki, THREADS)});
  blocks = std::max(blocks, 1LL);
  int words = (s & (ST_RANGE | ST_SELECT)) ? SELECT_WORDS : 0;
  if (sel) words = std::max({words, 2 * n_reg, n_cells});
  const int smem = 4 * words;
  Args copy = a;
  void* params[] = {&copy};
  cudaError_t err;
  if (window || sel) {
    int sms = 0, per_sm = 0;
    err = blocks_per_sm(smem, &sms, &per_sm);
    if (err != cudaSuccess) return (int)err;
    blocks = std::min(blocks, (long long)sms * per_sm);
    err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(refresh_kernel),
                                      dim3((unsigned)blocks), dim3(THREADS), params, smem,
                                      static_cast<cudaStream_t>(stream));
  } else {
    if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
    err = cudaLaunchKernel(reinterpret_cast<const void*>(refresh_kernel), dim3((unsigned)blocks),
                           dim3(THREADS), params, smem, static_cast<cudaStream_t>(stream));
  }
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

// The blocks of the kernel's co-resident grid on the current device at the
// largest shared memory a launch takes.
extern "C" int kf_refresh_grid_blocks(int* out) {
  int sms = 0, per_sm = 0;
  const cudaError_t e = blocks_per_sm(SMEM_BYTES, &sms, &per_sm);
  if (e == cudaSuccess) *out = sms * per_sm;
  return (int)e;
}

// sizeof(Args), for the wrapper's check of its structure.
extern "C" int kf_refresh_args_size() { return (int)sizeof(Args); }
