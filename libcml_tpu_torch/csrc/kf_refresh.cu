// The post-keyframe refresh of the direct path, one cooperative launch a
// call, for Hopper (sm_90a).
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
// Stages (bit k of `stages`), run in four phases with a grid barrier
// (grid_barrier.cuh) between phases that hold work:
//   A (1) the tracker reference: the P window points projected into frame
//     `slot` (phase 2: a thread a point, its pixel, inverse depth, validity
//     and 4x4 cell kept, its inverse depth's bits max-ed into the cell
//     table, which phase 1 zeroed: a positive float orders as its bits),
//     then (phase 3, a thread a (level, point)) kept where its inverse
//     depth exceeds 0.8 of its cell's largest, and sampled at every level;
//     with `ref_points`, given points are sampled (make_tracker_ref).
//   B (2) the working inverse-depth range: the median of the valid points'
//     inverse depths (phase 1, one block: a bitonic sort of the P keys in
//     shared memory, the invalid and NaN ones last, then
//     torch.nanquantile's interpolation between the two middle values),
//     1.0 when there is none; [med / 8, med x 8] clamped to the config.
//   C (4) the candidate selection: each 32x32 region's gradient-magnitude
//     quantile (phase 1, a block a region: a bitonic sort of its 1,024
//     values, torch.quantile's interpolation; a NaN in the region gives
//     NaN), then (phase 2) the regions' thresholds smoothed 3x3 with the
//     edge replicated in the plain form's order, squared, and each
//     pot x pot cell's first maximum of the masked squared gradient (a warp
//     a cell, two redux.sync), then (phase 3) the stable top k of the
//     cells' maxima by rank (a warp a cell counts the greater maxima and
//     the equal ones at a lower index: lax.top_k's order), the rest padded.
//   D (8) the seed (phase 4, a thread a position): the 8 pattern colours of
//     channel 0 at each selected pixel, written into row `slot` of new
//     arena tensors with the range, zero counts and the validity; phase 1
//     copies the other rows.
// So `_refresh_after_kf` is one launch (15) with no host read; the pieces
// are launches of one stage.
//
// Bound: bytes. The keyframe's level-0 gradient image is read (3.7 MB at
// 640 x 480) for the selection, the window's points and the arena once;
// the 1,036 ranks' ~1.1 M comparisons and the sorts are a few
// microseconds of one block each. What it costs is latency: the sorts'
// dependent stages, three grid barriers, the launch.
//
// Numerics: every product, sum and quotient is rounded on its own as the
// plain form's separate PyTorch operations round them on the card
// (__fmul_rn, __fadd_rn, __fdiv_rn, __fsqrt_rn): a division by a Python
// float is a product with its float32 reciprocal there (PyTorch's CUDA
// division by a CPU scalar), `c2 / x` is x.reciprocal() * c2, the point
// transforms are the plain form's matrix products as cuBLAS rounds them
// (dot3, gemv3). Every output is the plain form's bit for bit on the
// smoke's calls; ops/kf_programs.py still holds the reference's pixels
// within a stated tolerance and its validity within a stated edge, since
// the cuBLAS kernels' orders are measured, not documented.

#include <cuda_runtime.h>

#include "grid_barrier.cuh"

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int REGION = 32, REGION_N = REGION * REGION;
constexpr int MAX_LEVELS = 8;
constexpr int SMEM_WORDS = 16384;          // 64 KB of dynamic shared memory
constexpr int SMEM_BYTES = SMEM_WORDS * 4;
constexpr int BLOCKS_PER_SM = 3;
constexpr int ST_REF = 1, ST_RANGE = 2, ST_SELECT = 4, ST_SEED = 8;
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

// Ascending bitonic sort of n (a power of two) keys in shared memory.
__device__ void bitonic_sort(unsigned* key, int n) {
  for (int k = 2; k <= n; k <<= 1)
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < n; i += THREADS) {
        const int l = i ^ j;
        if (l > i) {
          const unsigned x = key[i], y = key[l];
          if ((x > y) == ((i & k) == 0)) {
            key[i] = y;
            key[l] = x;
          }
        }
      }
      __syncthreads();
    }
}

// a float's bits in an order that sorts as the values (-0 before +0)
__device__ __forceinline__ unsigned order_key(float v) {
  const unsigned u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}
__device__ __forceinline__ float order_value(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7FFFFFFFu) : ~k);
}

// B: the median of the valid, non-NaN inverse depths, as
// torch.nanquantile(·, 0.5) takes it; 1.0 when there are none; the range.
__device__ void range_unit(const Args& a, unsigned* key) {
  __shared__ int s_count;
  int n = 1;
  while (n < a.P) n <<= 1;
  if (threadIdx.x == 0) s_count = 0;
  __syncthreads();
  int mine = 0;
  for (int base = threadIdx.x; base < n; base += 4 * THREADS) {   // 4 loads, then 4 stores
    float v[4];
    bool ok[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = base + u * THREADS;
      ok[u] = i < a.P && a.ba_pv[i];
      v[u] = i < a.P ? a.ba_idepth[i] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = base + u * THREADS;
      const bool real = ok[u] && !isnan(v[u]);
      mine += real;
      if (i < n) key[i] = real ? order_key(v[u]) : 0xFFFFFFFFu;   // +inf is 0xFF800000
    }
  }
  if (mine) atomicAdd(&s_count, mine);
  __syncthreads();
  bitonic_sort(key, n);
  if (threadIdx.x == 0) {
    const int m = s_count;
    float med = __int_as_float(0x7FC00000);
    if (m > 0) {   // the rank q (m - 1) in float32, its floor and ceiling
      const float rank = mul(0.5f, (float)(m - 1));
      const int lo = (int)rank, hi = (int)ceilf(rank);
      med = lerp(order_value(key[lo]), order_value(key[hi]), sub(rank, (float)lo));
    }
    if (!isfinite(med)) med = 1.f;
    *a.rho_lo = max_nan(mul(med, 0.125f), a.idepth_min);
    *a.rho_hi = min_nan(mul(med, 8.f), a.idepth_max);
  }
  __syncthreads();
}

// C, phase 1: region r's gradient-magnitude quantile (NaN if any value is).
__device__ void region_unit(const Args& a, int r, unsigned* key) {
  const int ry = r / a.Wr, rx = r - ry * a.Wr;
  const float* img = a.pyr[0];
  int nan = 0;
  constexpr int PER = REGION_N / THREADS;
  float g[PER];
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int i = threadIdx.x + k * THREADS;
    const int y = ry * REGION + (i >> 5), x = rx * REGION + (i & 31);
    g[k] = __fsqrt_rn(grad2(img, (long long)y * a.W + x));
  }
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    nan |= isnan(g[k]);
    key[threadIdx.x + k * THREADS] = isnan(g[k]) ? 0xFFFFFFFFu : __float_as_uint(g[k]);   // g >= +0
  }
  nan = __syncthreads_or(nan);
  bitonic_sort(key, REGION_N);
  if (threadIdx.x == 0)
    a.q_region[r] = nan ? __int_as_float(0x7FC00000)
                        : lerp(__uint_as_float(key[a.q_lo]), __uint_as_float(key[a.q_hi]), a.q_w);
  __syncthreads();
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

// A, phase 3: point p at level l
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

// C, phase 2: the regions' smoothed squared thresholds into shared memory,
// and their maximum (NaN if any is); returns the maximum
__device__ float threshold_table(const Args& a, float* th2) {
  __shared__ unsigned s_max;
  __shared__ int s_nan;
  if (threadIdx.x == 0) {
    s_max = 0u;
    s_nan = 0;
  }
  __syncthreads();
  const float inv9 = 1.f / 9.f;   // float32(1 / 9): PyTorch's CUDA division by a Python float
  unsigned mx = 0u;
  int nan = 0;
  for (int r = threadIdx.x; r < a.Hr * a.Wr; r += THREADS) {
    const int i = r / a.Wr, j = r - i * a.Wr;
    float sm = 0.f;
#pragma unroll
    for (int di = 0; di < 3; ++di)
#pragma unroll
      for (int dj = 0; dj < 3; ++dj) {
        const int ii = min(max(i + di - 1, 0), a.Hr - 1), jj = min(max(j + dj - 1, 0), a.Wr - 1);
        const float t = add(__ldcg(a.q_region + ii * a.Wr + jj), a.th_add);
        sm = (di == 0 && dj == 0) ? t : add(sm, t);
      }
    const float t2 = mul(mul(sm, inv9), mul(sm, inv9));
    th2[r] = t2;
    if (isnan(t2)) nan = 1;
    else mx = max(mx, __float_as_uint(t2));   // t2 >= +0
  }
  atomicMax(&s_max, mx);
  if (nan) atomicOr(&s_nan, 1);
  __syncthreads();
  return s_nan ? __int_as_float(0x7FC00000) : __uint_as_float(s_max);
}

// C, phase 2: cell c's first maximum of the masked squared gradient (a warp)
__device__ void cell_max(const Args& a, int c, const float* th2, float th_out) {
  const int lane = threadIdx.x & 31;
  const int cy = c / a.Wc, cx = c - cy * a.Wc;
  const float* img = a.pyr[0];
  float best = -1.f;   // a lane without a pixel keeps -1: key 0, no index
  int arg = 0x7FFFFFFF;
  for (int o = lane; o < a.pot * a.pot; o += 32) {
    const int oy = o / a.pot, ox = o - oy * a.pot;
    const int y = cy * a.pot + oy, x = cx * a.pot + ox;
    const float g2 = grad2(img, (long long)y * a.W + x);
    float th = th_out;
    if (y < a.Hr * REGION && x < a.Wr * REGION) {
      th = th2[(y / REGION) * a.Wr + x / REGION];
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
  // scores are >= +0 and never NaN: their bits order as the values
  const unsigned key = best < 0.f ? 0u : __float_as_uint(best);
  const unsigned kb = __reduce_max_sync(FULL, key);
  const unsigned ka = __reduce_min_sync(FULL, key == kb ? (unsigned)arg : ~0u);
  if (lane == 0) {
    a.cell_best[c] = __uint_as_float(kb);
    a.cell_arg[c] = (int)ka;
  }
}

// C, phase 3: cell c's rank among the cells' maxima (greater ones, and
// equal ones at a lower index), and its slot when it ranks under k (a warp)
__device__ void rank_cell(const Args& a, int c, const float* best) {
  const int lane = threadIdx.x & 31, n = a.Hc * a.Wc;
  const float me = best[c];
  unsigned cnt = 0;
  for (int j = lane; j < n; j += 32) {
    const float o = best[j];
    cnt += (o > me) | ((o == me) & (j < c));
  }
  const unsigned rank = __reduce_add_sync(FULL, cnt);
  if (lane == 0 && rank < (unsigned)a.k) {
    const int off = __ldcg(a.cell_arg + c);
    const int oy = off / a.pot, ox = off - oy * a.pot;
    const int cy = c / a.Wc, cx = c - cy * a.Wc;
    a.sel_uv[2 * rank] = (float)(cx * a.pot + ox);
    a.sel_uv[2 * rank + 1] = (float)(cy * a.pot + oy);
    a.sel_valid[rank] = me > 0.f;
    a.sel_score[rank] = me;
  }
}

// D, phase 4: position i of row `slot` (every load before the stores: a
// store may alias a later load, so interleaved each would wait a round trip)
__device__ void seed_position(const Args& a, int i) {
  const long long o = (long long)a.slot * a.Ki + i;
  const float u = __ldcg(a.seed_uv + 2 * i), v = __ldcg(a.seed_uv + 2 * i + 1);
  const float lo = __ldcg(a.seed_lo), hi = __ldcg(a.seed_hi);
  const unsigned char valid = __ldcg(a.seed_valid + i);
  float c[8];
#pragma unroll
  for (int k = 0; k < 8; ++k)
    bilinear<0, 1>(a.seed_img, a.sh, a.sw, add(u, PAT_U[k]), add(v, PAT_V[k]), c + k);
  a.o_uv[2 * o] = u;
  a.o_uv[2 * o + 1] = v;
#pragma unroll
  for (int k = 0; k < 8; ++k) a.o_color[8 * o + k] = c[k];
  a.o_lo[o] = lo;
  a.o_hi[o] = hi;
  a.o_nok[o] = 0;
  a.o_nfail[o] = 0;
  a.o_valid[o] = valid;
}

__device__ void copy_row(const Args& a, long long o) {
  const float u = a.im_uv[2 * o], v = a.im_uv[2 * o + 1];
  float c[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) c[k] = a.im_color[8 * o + k];
  const float lo = a.im_lo[o], hi = a.im_hi[o];
  const int nok = a.im_nok[o], nfail = a.im_nfail[o];
  const unsigned char valid = a.im_valid[o];
  a.o_uv[2 * o] = u;
  a.o_uv[2 * o + 1] = v;
#pragma unroll
  for (int k = 0; k < 8; ++k) a.o_color[8 * o + k] = c[k];
  a.o_lo[o] = lo;
  a.o_hi[o] = hi;
  a.o_nok[o] = nok;
  a.o_nfail[o] = nfail;
  a.o_valid[o] = valid;
}

__global__ void __launch_bounds__(THREADS) refresh_kernel(const Args a) {
  extern __shared__ unsigned smem[];
  __shared__ unsigned arrived;
  if (threadIdx.x == 0) arrived = 0u;
  __syncthreads();
  const int gtid = blockIdx.x * THREADS + threadIdx.x, gstride = gridDim.x * THREADS;
  const int gwarp = blockIdx.x * WARPS + (threadIdx.x >> 5), nwarps = gridDim.x * WARPS;
  const bool ref = a.stages & ST_REF, window = ref && !a.ref_points;
  const bool sel = a.stages & ST_SELECT, seed = a.stages & ST_SEED;
  const bool seed_row = seed && a.slot >= 0 && a.slot < a.Fi;
  bool did = false;

  // phase 1: the range (unit 0), the regions' quantiles (units 1..), the
  // cell table zeroed, the arena's other rows copied
  if (window || (a.stages & ST_RANGE) || sel || seed) {
    const int n_reg = sel ? a.Hr * a.Wr : 0, first = (a.stages & ST_RANGE) ? 1 : 0;
    for (int u = blockIdx.x; u < first + n_reg; u += gridDim.x) {
      if (u < first) range_unit(a, smem);
      else region_unit(a, u - first, smem);
    }
    if (window)
      for (int i = gtid; i < a.Wc4 * a.Hc4; i += gstride) a.cells[i] = 0u;
    if (seed)
      for (long long o = gtid; o < (long long)a.Fi * a.Ki; o += gstride)
        if (!seed_row || o / a.Ki != a.slot) copy_row(a, o);
    did = true;
  }
  // stage: phase1
  // phase 2: the points into the cell table; the cells' maxima
  if (window || sel) {
    if (did) gridbar::grid_sync(a.bar, arrived);
    if (window)
      for (int p = gtid; p < a.P; p += gstride) project_point(a, p);
    if (sel) {
      float* th2 = reinterpret_cast<float*>(smem);
      const float th_out = threshold_table(a, th2);
      for (int c = gwarp; c < a.Hc * a.Wc; c += nwarps) cell_max(a, c, th2, th_out);
    }
    did = true;
  }
  // stage: phase2
  // phase 3: the z-buffer test and the levels' samples; the ranks
  if (ref || sel) {
    if (did) gridbar::grid_sync(a.bar, arrived);
    if (ref)
      for (int i = gtid; i < a.L * a.P; i += gstride) sample_point(a, i / a.P, i % a.P);
    if (sel) {
      float* best = reinterpret_cast<float*>(smem);
      for (int c = threadIdx.x; c < a.Hc * a.Wc; c += THREADS) best[c] = __ldcg(a.cell_best + c);
      __syncthreads();
      for (int c = gwarp; c < a.Hc * a.Wc; c += nwarps) rank_cell(a, c, best);
      for (int r = a.k + gtid; r < a.n_points; r += gstride) {
        a.sel_uv[2 * r] = 0.f;
        a.sel_uv[2 * r + 1] = 0.f;
        a.sel_valid[r] = 0;
        a.sel_score[r] = 0.f;
      }
    }
    did = true;
  }
  // stage: phase3
  // phase 4: the seeded row
  if (seed_row) {
    if (did) gridbar::grid_sync(a.bar, arrived);
    for (int i = gtid; i < a.Ki; i += gstride) seed_position(a, i);
  }
  // stage: phase4
  gridbar::finish_sync(a.bar);
}

// The co-resident grid on the current device: its SMs times the blocks an
// SM holds, at most BLOCKS_PER_SM (found once a device): 3 an SM on an H100,
// so that the range and the 300 regions of a 640 x 480 keyframe take one
// block each.
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
  e = cudaFuncSetAttribute(refresh_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           SMEM_BYTES);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, reinterpret_cast<const void*>(refresh_kernel), THREADS, SMEM_BYTES);
  if (e != cudaSuccess) return e;
  if (per_sm == 0) return cudaErrorLaunchOutOfResources;
  *blocks = sms * (per_sm < BLOCKS_PER_SM ? per_sm : BLOCKS_PER_SM);
  if (dev < 64) cached[dev] = *blocks;
  return cudaSuccess;
}

}  // namespace

// One cooperative launch on `stream` (the wrapper, ops/kf_programs.py,
// fills Args through a ctypes structure of the same fields). Returns the
// CUDA error of the launch.
extern "C" int kf_refresh_launch(const void* args, void* stream) {
  const Args& a = *static_cast<const Args*>(args);
  if (a.stages <= 0 || a.stages > 15 || a.L < 1 || a.L > MAX_LEVELS) return (int)cudaErrorInvalidValue;
  int sort_n = 1;
  while (sort_n < a.P) sort_n <<= 1;
  if (((a.stages & ST_RANGE) && sort_n > SMEM_WORDS) ||
      ((a.stages & ST_SELECT) && (a.Hr * a.Wr > SMEM_WORDS || a.Hc * a.Wc > SMEM_WORDS ||
                                  a.Hr < 1 || a.Wr < 1 || a.Hc < 1 || a.Wc < 1)))
    return (int)cudaErrorInvalidValue;
  int blocks = 0;
  const cudaError_t e = grid_blocks(&blocks);
  if (e != cudaSuccess) return (int)e;
  Args copy = a;
  void* params[] = {&copy};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(refresh_kernel), dim3(blocks), dim3(THREADS), params,
      SMEM_BYTES, static_cast<cudaStream_t>(stream));
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

// The blocks of the kernel's co-resident grid on the current device.
extern "C" int kf_refresh_grid_blocks(int* out) { return (int)grid_blocks(out); }

// sizeof(Args), for the wrapper's check of its structure.
extern "C" int kf_refresh_args_size() { return (int)sizeof(Args); }
