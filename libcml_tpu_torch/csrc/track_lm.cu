// Coarse-to-fine photometric LM of the direct tracker, one launch a solve
// and one thread block cluster a start, for Hopper (sm_90a).
//
// Replaces the JAX package's device program for the tracker's LM:
// `_track_level` (libcml_tpu/models/direct/tracker.py:118, its
// `lax.while_loop` at :189) chained over the pyramid levels by `track`
// (:272) and vmapped over the hypotheses by `track_multi` (:266). Its plain
// PyTorch form is `track_levels_plain` in
// libcml_tpu_torch/models/direct/tracker.py.
//
// One cluster of CS (lm::CLUSTER, 8) blocks of 256 threads a hypothesis
// (grid = B x CS) runs every listed level in turn, each the complete level
// loop of the plain form: E0 = mean capped Huber energy at (T0, ab0) over
// the valid, in-bounds points; then at most `iters` times the 8-dof normal
// equations at (T, ab) (36 H sums, 8 b sums; single-pixel residual, Huber x
// gradient weight with the hard cutoff, rel_pose_jacobian), the affine
// prior [0]*6 + [1e-1, 1e-3] about ab_center, the scaled damped 8x8 solve
// with partial pivoting, T_new = exp(-dx[:6]) o T, ab_new = ab - dx[6:],
// the energy at (T_new, ab_new), accept if E_new < E, lambda x0.5 (floor
// 1e-7) or x4 (cap 1e2), and the level ends on the device when an accepted
// step is below eps or lambda saturates. No value goes to the host inside
// the loop. Outputs: T, ab and E of every hypothesis, the iterations each
// level ran, and each step's decision values (E, E_new, |dx|; NaN past the
// last step), by which a test tells a decision that sits at its threshold.
// For `track` (stats != 0) the same launch then runs track's statistics
// sweep at the finest level (the covariance through the 8x8 inverse of H +
// 1e-6 I, flow, rotation-only flow, saturation, energy, num_valid:
// tracker.py's track_stats_plain).
//
// What bounds it on the H100: not bytes or operations (a level reads ~30 KB
// of point data and 4 bilinear texels a point a sweep, a few MFLOP in all)
// but latency: each LM step is a sweep over the points ending in a
// reduction, then a serial 8x8 solve, and the next step needs the pose this
// one chose. The design shortens that chain in three ways.
// - One sweep a step. The sweep at (T_new, ab_new) sums E_new and, from the
//   same per-point values, the normal equations there (44 sums and the
//   count). On accept they are the next step's system; on reject the block
//   keeps the system of T, which a sweep at the unchanged T would give bit
//   for bit (the per-point arithmetic is the same code). Each level's first
//   sweep, at T0, sums E0 and T0's system. A track at steps (10, 10, 5, 3)
//   makes 33 sweeps (the plain form's schedule: 61).
// - A cluster a start. Thread g = rank x 256 + tid owns points g, g + 2048,
//   ... (one a thread at P = 2048) and loads their constants (the
//   back-projected point, color, masked weight, validity) into registers
//   once a level; a sweep only projects and gathers the 2x2x3 texels. Each
//   block reduces in its fixed order, one cluster barrier a step, then
//   every block sums the CS partials in rank order from distributed shared
//   memory and runs the same solve and decision: all blocks hold the same
//   bits and leave the loop together, with no broadcast, atomic or grid
//   sync. A battery of 15 starts is 120 blocks on the 132 SMs.
// - The serial tail. The 8x8 solve is one warp's, a column a lane
//   (lm_common.cuh warp_solve): every lane finds each pivot from its own copy
//   of the pivot column, swaps and updates its own column, and scales the
//   multipliers by the pivot's reciprocal, so no row moves between lanes and
//   no lane takes a division's slow path alone (the earlier design kept a row
//   a lane and shuffled the pivot row and every swap); the pivot rule stays
//   torch.linalg.solve's (the first row of largest magnitude). A block's
//   reduction trades values between lanes by recursive halving (31 shuffles
//   for 32 sums instead of 160) with the same pairs as a shuffle tree.
//   se3_exp_compose is unchanged.
// The cluster's size is a compile-time constant (lm::CLUSTER, 8, the
// portable size) given to the launch as its cluster dimension. A card
// without cluster support (before sm_90) refuses the launch, and the
// wrapper raises.
//
// Arithmetic follows the plain version's formulas and clamps (ops/image.py
// bilinear, core/camera.py project/unproject, residuals.py proj_jacobian);
// the sums run in another order than PyTorch's einsum, and nvcc contracts
// products and sums into FMAs, so results agree to f32 rounding, not bits.

#include <cstdint>
#include <cuda_runtime.h>

#include "lm_common.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int CS = lm::CLUSTER;
constexpr int STRIDE = CS * THREADS;   // points apart that one thread owns
constexpr int KREG = 2;                // points a thread holds in registers
constexpr int MAX_LEVELS = 8;
constexpr int NH = 36;                 // the upper triangle of the 8x8 H
constexpr int NB = NH + 8;             // + b
constexpr int NS = NB + 2;             // + energy, count
constexpr int NSTAT = NH + 5;          // + count, energy, flow, rotation flow, saturated

struct Level {
  const float* grad;            // (H, W, 3): value, gx, gy
  const float* uv;              // (P, 2) host pixels at this level
  const float* color;           // (P,)
  const float* weight;          // (P,)
  const uint8_t* valid;         // (P,)
  float fx, fy, cx, cy;
  int W, H;
};

struct Args {
  Level lv[MAX_LEVELS];
  int n_levels, P, iters;
  const float* idepth;          // (P,)
  const float* R0;              // (B, 3, 3)
  const float* t0;              // (B, 3)
  const float* ab0;             // (B, 2)
  const float* ab_center;       // (2,)
  float huber_k, half_k, cutoff, cap, eps;
  float s[8];                   // state scaling
  float* R_out;
  float* t_out;
  float* ab_out;
  float* E_out;
  int32_t* it_out;              // (B, n_levels)
  float* trace;                 // (B, n_levels, iters, 3): E, E_new, |dx| a step
  // track's statistics at the last level (stats != 0): energy, flow,
  // flow_no_trans, saturated (B, 4); num_valid (B,); cov_pose (B, 6, 6)
  int stats;
  float sat_r;                  // 0.98 x the cutoff
  float* stat_out;
  long long* nvalid_out;
  float* cov_out;
};

struct Pose {
  float R[9], t[3], a, b, s_ji;
};

__device__ __forceinline__ Pose make_pose(const float* R, const float* t, const float* ab) {
  Pose T;
#pragma unroll
  for (int i = 0; i < 9; ++i) T.R[i] = R[i];
#pragma unroll
  for (int i = 0; i < 3; ++i) T.t[i] = t[i];
  T.a = ab[0];
  T.b = ab[1];
  T.s_ji = expf(T.a);
  return T;
}

// A point's constants over a level: its host pixel, the back-projected
// point (core/camera.py unproject), color, the weight masked by the
// reference's validity, and that validity.
struct PointConst {
  float u, v, Xi[3], color, wm;
  bool valid;
};

__device__ __forceinline__ PointConst load_point(const Level& L, const Args& a, int p) {
  PointConst c;
  c.u = __ldg(L.uv + 2 * p);
  c.v = __ldg(L.uv + 2 * p + 1);
  const float x = (c.u - L.cx) / L.fx;
  const float y = (c.v - L.cy) / L.fy;
  const float depth = 1.0f / lm::clamp_min(__ldg(a.idepth + p), 1e-12f);
  c.Xi[0] = x * depth;
  c.Xi[1] = y * depth;
  c.Xi[2] = 1.0f * depth;
  c.color = __ldg(L.color + p);
  c.valid = L.valid[p];
  c.wm = c.valid ? __ldg(L.weight + p) : 0.0f;
  return c;
}

// The bilinear sample of ops/image.py at (x, y): base pixel clamped to
// [0, W-2] x [0, H-2] (a NaN coordinate to pixel 0), fractions to [0, 1].
__device__ __forceinline__ void bilinear3(const float* img, int W, int H, float x, float y,
                                          float out[3]) {
  float x0f = lm::clamp_max(lm::clamp_min(floorf(x), 0.0f), (float)(W - 2));
  float y0f = lm::clamp_max(lm::clamp_min(floorf(y), 0.0f), (float)(H - 2));
  if (isnan(x0f)) x0f = 0.0f;
  if (isnan(y0f)) y0f = 0.0f;
  const float dx = lm::clamp_max(lm::clamp_min(x - x0f, 0.0f), 1.0f);
  const float dy = lm::clamp_max(lm::clamp_min(y - y0f, 0.0f), 1.0f);
  const float* p00 = img + ((size_t)(int)y0f * W + (int)x0f) * 3;
  const float* p10 = p00 + (size_t)W * 3;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float top = __ldg(p00 + c) * (1.0f - dx) + __ldg(p00 + 3 + c) * dx;
    const float bot = __ldg(p10 + c) * (1.0f - dx) + __ldg(p10 + 3 + c) * dx;
    out[c] = top * (1.0f - dy) + bot * dy;
  }
}

// One point of residuals.evaluate_residuals (PATTERN_CENTER) at `T`: the
// point in the target frame, its validity (in front, 2 px inside), the
// residual, robust weight and energy.
struct PointEval {
  float X[3], uj, vj, g[2], r, w, energy;
  bool valid;
};

__device__ __forceinline__ PointEval eval_point(const Level& L, const Args& a, const Pose& T,
                                                const PointConst& c) {
  PointEval e;
#pragma unroll
  for (int i = 0; i < 3; ++i)
    e.X[i] = (T.R[3 * i] * c.Xi[0] + T.R[3 * i + 1] * c.Xi[1] + T.R[3 * i + 2] * c.Xi[2])
             + T.t[i];
  const float z = e.X[2];
  const float iz = 1.0f / (fabsf(z) < 1e-12f ? 1e-12f : z);
  e.uj = L.fx * e.X[0] * iz + L.cx;
  e.vj = L.fy * e.X[1] * iz + L.cy;
  e.valid = (z > 1e-6f) && e.uj >= 2.0f && e.uj <= (float)L.W - 3.0f && e.vj >= 2.0f &&
            e.vj <= (float)L.H - 3.0f;
  float s[3];
  bilinear3(L.grad, L.W, L.H, e.uj, e.vj, s);
  e.g[0] = s[1];
  e.g[1] = s[2];
  e.r = (s[0] - T.b) - T.s_ji * c.color;
  const float ar = fabsf(e.r);
  float w = (ar <= a.huber_k ? 1.0f : a.huber_k / lm::clamp_min(ar, 1e-12f)) * c.wm;
  float en = ar <= a.huber_k ? 0.5f * e.r * e.r : a.huber_k * (ar - a.half_k);
  if (ar > a.cutoff) w = 0.0f;
  en = lm::clamp_max(en, a.cap);
  e.w = e.valid ? w : 0.0f;
  e.energy = e.valid ? c.wm * en : 0.0f;
  return e;
}

// rel_pose_jacobian of one point: (2x3 projection Jacobian) x [I | -skew(X)]
// against the sampled gradient, then d/da, d/db.
__device__ __forceinline__ void point_jacobian(const Level& L, const Pose& T, const PointEval& e,
                                               float color, float J[8]) {
  const float x = e.X[0], y = e.X[1], z = e.X[2];
  const float iz = 1.0f / lm::clamp_min(z, 1e-8f);
  const float iz2 = iz * iz;
  const float A[2][3] = {{L.fx * iz, 0.0f, -L.fx * x * iz2}, {0.0f, L.fy * iz, -L.fy * y * iz2}};
  const float Bm[3][6] = {{1.0f, 0.0f, 0.0f, -0.0f, z, -y},
                          {0.0f, 1.0f, 0.0f, -z, -0.0f, x},
                          {0.0f, 0.0f, 1.0f, y, -x, -0.0f}};
#pragma unroll
  for (int c = 0; c < 6; ++c) {
    const float ju = A[0][0] * Bm[0][c] + A[0][1] * Bm[1][c] + A[0][2] * Bm[2][c];
    const float jv = A[1][0] * Bm[0][c] + A[1][1] * Bm[1][c] + A[1][2] * Bm[2][c];
    J[c] = e.g[0] * ju + e.g[1] * jv;
  }
  J[6] = -T.s_ji * color;
  J[7] = -1.0f;
}

// The weighted Gauss-Newton sums of one point: H's upper triangle row by
// row into acc[0..35], and when `with_b` b into acc[36..43].
template <bool with_b, int N>
__device__ __forceinline__ void add_normal(float (&acc)[N], const float J[8], float w, float r) {
  int k = 0;
#pragma unroll
  for (int d = 0; d < 8; ++d) {
    const float jw = J[d] * w;
#pragma unroll
    for (int f = d; f < 8; ++f) acc[k++] += jw * J[f];
    if (with_b) acc[NH + d] += jw * r;
  }
}

// A point's share of a step's sweep: the normal equations (rel_pose_jacobian
// + gauss_newton_system), then over the points valid in the sweep and the
// reference the energy and their count (total_energy).
__device__ __forceinline__ void add_step(const Level& L, const Args& a, const Pose& T,
                                         const PointConst& c, float (&acc)[NS]) {
  const PointEval e = eval_point(L, a, T, c);
  float J[8];
  point_jacobian(L, T, e, c.color, J);
  add_normal<true>(acc, J, e.w, e.r);
  if (e.valid && c.valid) {
    acc[NB] += e.energy;
    acc[NB + 1] += 1.0f;
  }
}

// track's statistics of a point at the finest level: H without prior (36),
// then over the points valid in the sweep and the reference their count,
// energy, squared flow, squared rotation-only flow (the warp with t = 0)
// and the residuals at 0.98 x the cutoff.
__device__ __forceinline__ void add_stats(const Level& L, const Args& a, const Pose& T,
                                          const PointConst& c, float (&acc)[NSTAT]) {
  const PointEval e = eval_point(L, a, T, c);
  float J[8];
  point_jacobian(L, T, e, c.color, J);
  add_normal<false>(acc, J, e.w, e.r);
  if (e.valid && c.valid) {
    float Xr[3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
      Xr[i] = (T.R[3 * i] * c.Xi[0] + T.R[3 * i + 1] * c.Xi[1] + T.R[3 * i + 2] * c.Xi[2])
              + 0.0f;
    const float izr = 1.0f / (fabsf(Xr[2]) < 1e-12f ? 1e-12f : Xr[2]);
    const float du = e.uj - c.u, dv = e.vj - c.v;
    const float dur = (L.fx * Xr[0] * izr + L.cx) - c.u;
    const float dvr = (L.fy * Xr[1] * izr + L.cy) - c.v;
    acc[NH] += 1.0f;
    acc[NH + 1] += e.energy;
    acc[NH + 2] += du * du + dv * dv;
    acc[NH + 3] += dur * dur + dvr * dvr;
    acc[NH + 4] += fabsf(e.r) >= a.sat_r ? 1.0f : 0.0f;
  }
}

// A sweep of thread g over its points in index order: those held in
// registers, then (P > KREG x STRIDE only) the rest loaded from memory.
template <int N, typename F>
__device__ __forceinline__ void sweep(const Level& L, const Args& a, const PointConst (&pc)[KREG],
                                      int g, float (&acc)[N], F add) {
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] = 0.0f;
#pragma unroll
  for (int k = 0; k < KREG; ++k)
    if (g + k * STRIDE < a.P) add(pc[k], acc);
  for (int p = g + KREG * STRIDE; p < a.P; p += STRIDE) add(load_point(L, a, p), acc);
}

__global__ void __launch_bounds__(THREADS, 1) track_lm_kernel(const __grid_constant__ Args a) {
  __shared__ float red[WARPS * NS];
  __shared__ float part[2 * NS];
  __shared__ float sys[2][NS];      // sys[cur]: the system of the accepted state
  __shared__ Level L;
  __shared__ float R[9], t[3], ab[2], Rn[9], tn[3], abn[2];
  __shared__ float E, lam, step_norm;
  __shared__ float st[NSTAT];
  __shared__ int it, cur, run;
  const int rank = (int)cg::this_cluster().block_rank();
  const int h = blockIdx.x / CS, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = rank * THREADS + tid;
  const bool writer = rank == 0;    // every block holds the same state; one writes it
  const float ac0 = a.ab_center[0], ac1 = a.ab_center[1];
  const float sc = a.s[lane < 8 ? lane : 7];   // warp 0's solve: lane c's column scale
  int buf = 0;
  if (tid < 9) R[tid] = a.R0[h * 9 + tid];
  if (tid < 3) t[tid] = a.t0[h * 3 + tid];
  if (tid < 2) ab[tid] = a.ab0[h * 2 + tid];
  if (tid == 0) cur = 0;

  // warp 0: the damped scaled solve of sys[cur] at lambda (_solve_scaled on
  // H + diag(prior), b + prior * (0, ab - ab_center)), lane c < 8 building
  // column c, lane 8 the right-hand side; then T_new = exp(-dx[:6]) o T and
  // ab_new = ab - dx[6:] (lane 0 writes them)
  auto solve_step = [&]() {
    const float* S = sys[cur];
    const float lm_ = lam;
    const int c = lane < 8 ? lane : 7;   // lanes past 8 read column 7, unused
    float col[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const float prior = r == 6 ? 1e-1f : (r == 7 ? 1e-3f : 0.0f);
      const int i = r < c ? r : c, j = r < c ? c : r;
      float hv = S[i * 8 - i * (i - 1) / 2 + (j - i)];
      if (c == r) hv = hv + prior;
      const float v = (hv * a.s[r]) * sc;
      const float dab = r == 6 ? ab[0] - ac0 : (r == 7 ? ab[1] - ac1 : 0.0f);
      const float rhs = (S[NH + r] + prior * dab) * a.s[r];
      col[r] = lane >= 8 ? rhs : (c == r ? (v + lm_ * v) + 1e-8f : v);
    }
    float x[8];
    lm::warp_solve<8, 1>(col, x);
    if (lane == 0) {
      float dx[8], nrm = 0.0f;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        dx[i] = x[i] * a.s[i];
        nrm += dx[i] * dx[i];
      }
      step_norm = sqrtf(nrm);
      const float xi[6] = {-dx[0], -dx[1], -dx[2], -dx[3], -dx[4], -dx[5]};
      float Rl[9], tl[3];
#pragma unroll
      for (int i = 0; i < 9; ++i) Rl[i] = R[i];
#pragma unroll
      for (int i = 0; i < 3; ++i) tl[i] = t[i];
      lm::se3_exp_compose(xi, Rl, tl);
#pragma unroll
      for (int i = 0; i < 9; ++i) Rn[i] = Rl[i];
#pragma unroll
      for (int i = 0; i < 3; ++i) tn[i] = tl[i];
      abn[0] = ab[0] - dx[6];
      abn[1] = ab[1] - dx[7];
    }
  };

  PointConst pc[KREG];
  for (int li = 0; li < a.n_levels; ++li) {
    if (tid == 0) L = a.lv[li];
    __syncthreads();
#pragma unroll
    for (int k = 0; k < KREG; ++k)
      if (g + k * STRIDE < a.P) pc[k] = load_point(L, a, g + k * STRIDE);
    {
      // the level's first sweep at (T0, ab0): E0 and T0's system
      const Pose T = make_pose(R, t, ab);
      float acc[NS];
      sweep(L, a, pc, g, acc,
            [&](const PointConst& c, float (&ac)[NS]) { add_step(L, a, T, c, ac); });
      lm::cluster_sum<NS, WARPS>(acc, red, part, buf, sys[cur ^ 1]);
      buf ^= 1;
      if (warp == 0) {
        const int nxt = cur ^ 1;
        __syncwarp();   // every lane has read cur
        if (lane == 0) {
          cur = nxt;
          E = sys[nxt][NB] / lm::clamp_min(sys[nxt][NB + 1], 1.0f);
          lam = 1e-4f;
          it = 0;
          run = a.iters > 0;
        }
        __syncwarp();
        if (run) solve_step();
      }
    }
    __syncthreads();
    while (run) {
      // one sweep at (T_new, ab_new): E_new and the system there
      const Pose Tn = make_pose(Rn, tn, abn);
      float acc[NS];
      sweep(L, a, pc, g, acc,
            [&](const PointConst& c, float (&ac)[NS]) { add_step(L, a, Tn, c, ac); });
      lm::cluster_sum<NS, WARPS>(acc, red, part, buf, sys[cur ^ 1]);
      buf ^= 1;
      if (warp == 0) {
        const int nxt = cur ^ 1;
        const float E_new = sys[nxt][NB] / lm::clamp_min(sys[nxt][NB + 1], 1.0f);
        const bool accept = E_new < E;
        const float lam_new = accept ? lm::clamp_min(lam * 0.5f, 1e-7f)
                                     : lm::clamp_max(lam * 4.0f, 1e2f);
        // 1e2 - 1e-6 in f32 is 100
        const bool done = (accept && step_norm < a.eps) || (!accept && lam_new >= 100.0f);
        __syncwarp();
        if (lane == 0) {
          if (writer) {
            float* tr = a.trace + (((size_t)h * a.n_levels + li) * a.iters + it) * 3;
            tr[0] = E;
            tr[1] = E_new;
            tr[2] = step_norm;
          }
          if (accept) {
#pragma unroll
            for (int i = 0; i < 9; ++i) R[i] = Rn[i];
#pragma unroll
            for (int i = 0; i < 3; ++i) t[i] = tn[i];
            ab[0] = abn[0];
            ab[1] = abn[1];
            E = E_new;
            cur = nxt;
          }
          lam = lam_new;
          it += 1;
          run = !done && it < a.iters;
        }
        __syncwarp();
        if (run) solve_step();
      }
      __syncthreads();
    }
    if (writer && tid == 0) {
      a.it_out[h * a.n_levels + li] = it;
      float* tr = a.trace + ((size_t)h * a.n_levels + li) * a.iters * 3;
      for (int i = it * 3; i < a.iters * 3; ++i) tr[i] = __int_as_float(0x7fc00000);   // NaN
    }
  }
  if (writer) {
    if (tid < 9) a.R_out[h * 9 + tid] = R[tid];
    if (tid < 3) a.t_out[h * 3 + tid] = t[tid];
    if (tid < 2) a.ab_out[h * 2 + tid] = ab[tid];
    if (tid == 0) a.E_out[h] = E;
  }
  if (a.stats) {
    // track's statistics sweep at the last level (the finest), at the result
    const Pose T = make_pose(R, t, ab);
    float acc[NSTAT];
    sweep(L, a, pc, g, acc,
          [&](const PointConst& c, float (&ac)[NSTAT]) { add_stats(L, a, T, c, ac); });
    lm::cluster_sum<NSTAT, WARPS>(acc, red, part, buf, st);
    if (warp == 0 && writer) {
      // inv(H + 1e-6 I)[:6, :6]: lane 8 + j solves against the unit column j
      const int c = lane;
      float col[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        if (c < 8) {
          const int i = r < c ? r : c, j = r < c ? c : r;
          const float hv = st[i * 8 - i * (i - 1) / 2 + (j - i)];
          col[r] = c == r ? hv + 1e-6f : hv;
        } else {
          col[r] = r == c - 8 ? 1.0f : 0.0f;
        }
      }
      float x[8];
      lm::warp_solve<8, 6>(col, x);
      if (lane >= 8 && lane < 14) {
#pragma unroll
        for (int i = 0; i < 6; ++i) a.cov_out[h * 36 + i * 6 + lane - 8] = x[i];
      }
      if (lane == 0) {
        const float n = lm::clamp_min(st[NH], 1.0f);
        a.stat_out[h * 4 + 0] = st[NH + 1] / n;
        a.stat_out[h * 4 + 1] = sqrtf(st[NH + 2] / n);
        a.stat_out[h * 4 + 2] = sqrtf(st[NH + 3] / n);
        a.stat_out[h * 4 + 3] = st[NH + 4] / n;
        a.nvalid_out[h] = (long long)st[NH];
      }
    }
  }
  // no block leaves while another may still read its partials
  lm::cluster_barrier();
}

}  // namespace

// Host-side arrays (grad ... valid: one device pointer a level; hw: H, W a
// level; cam: fx, fy, cx, cy a level; cfg: huber_k, half_k, cutoff, cap,
// eps, the 8 state scales, 0.98 x cutoff); the rest are device pointers
// (the statistics outputs may be null when stats is 0). Returns the
// launch's cudaError_t.
extern "C" int track_lm_launch(int n_levels, const void* const* grad, const int* hw,
                               const float* cam, const void* const* uv,
                               const void* const* color, const void* const* weight,
                               const void* const* valid, const void* idepth, int P,
                               const void* R0, const void* t0, const void* ab0,
                               const void* ab_center, int B, const float* cfg, int iters,
                               void* R_out, void* t_out, void* ab_out, void* E_out,
                               void* it_out, void* trace, int stats, void* stat_out,
                               void* nvalid_out, void* cov_out, void* stream) {
  if (n_levels <= 0 || n_levels > MAX_LEVELS || P < 0 || B <= 0 || iters < 0)
    return (int)cudaErrorInvalidValue;
  Args a{};
  for (int l = 0; l < n_levels; ++l) {
    if (hw[2 * l] < 2 || hw[2 * l + 1] < 2) return (int)cudaErrorInvalidValue;
    a.lv[l] = Level{static_cast<const float*>(grad[l]), static_cast<const float*>(uv[l]),
                    static_cast<const float*>(color[l]), static_cast<const float*>(weight[l]),
                    static_cast<const uint8_t*>(valid[l]), cam[4 * l], cam[4 * l + 1],
                    cam[4 * l + 2], cam[4 * l + 3], hw[2 * l + 1], hw[2 * l]};
  }
  a.n_levels = n_levels;
  a.P = P;
  a.iters = iters;
  a.idepth = static_cast<const float*>(idepth);
  a.R0 = static_cast<const float*>(R0);
  a.t0 = static_cast<const float*>(t0);
  a.ab0 = static_cast<const float*>(ab0);
  a.ab_center = static_cast<const float*>(ab_center);
  a.huber_k = cfg[0];
  a.half_k = cfg[1];
  a.cutoff = cfg[2];
  a.cap = cfg[3];
  a.eps = cfg[4];
  for (int i = 0; i < 8; ++i) a.s[i] = cfg[5 + i];
  a.R_out = static_cast<float*>(R_out);
  a.t_out = static_cast<float*>(t_out);
  a.ab_out = static_cast<float*>(ab_out);
  a.E_out = static_cast<float*>(E_out);
  a.it_out = static_cast<int32_t*>(it_out);
  a.trace = static_cast<float*>(trace);
  a.stats = stats;
  a.sat_r = cfg[13];
  a.stat_out = static_cast<float*>(stat_out);
  a.nvalid_out = static_cast<long long*>(nvalid_out);
  a.cov_out = static_cast<float*>(cov_out);
  if (stats && (!stat_out || !nvalid_out || !cov_out)) return (int)cudaErrorInvalidValue;
  return (int)lm::launch_clusters(track_lm_kernel, B, THREADS,
                                  static_cast<cudaStream_t>(stream), nullptr, a);
}

// The cluster's size (blocks a solve) and how many such clusters the card
// holds at once (cudaOccupancyMaxActiveClusters). Returns the query's
// cudaError_t.
extern "C" int track_lm_cluster_info(int* cluster, int* max_active) {
  *cluster = CS;
  return (int)lm::launch_clusters(track_lm_kernel, 1, THREADS, nullptr, max_active, Args{});
}
