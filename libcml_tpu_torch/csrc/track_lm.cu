// Coarse-to-fine photometric LM of the direct tracker, one launch a solve,
// for Hopper (sm_90a).
//
// Replaces the JAX package's device program for the tracker's LM:
// `_track_level` (libcml_tpu/models/direct/tracker.py:118, its
// `lax.while_loop` at :189) chained over the pyramid levels by `track`
// (:272) and vmapped over the hypotheses by `track_multi` (:266). Its plain
// PyTorch form is `track_levels_plain` in
// libcml_tpu_torch/models/direct/tracker.py.
//
// One block a hypothesis (grid = B) runs every listed level in turn, each
// the complete level loop:
//   E0 = mean capped Huber energy at (T0, ab0) over the valid, in-bounds
//   points; then at most `iters` times: one sweep at (T, ab) giving the
//   8-dof normal equations (36 H sums, 8 b sums; single-pixel residual,
//   Huber x gradient weight with the hard cutoff, rel_pose_jacobian), the
//   affine prior [0]*6 + [1e-1, 1e-3] about ab_center, the scaled damped
//   8x8 solve with partial pivoting (one warp), T_new = exp(-dx[:6]) o T,
//   ab_new = ab - dx[6:], one energy sweep at (T_new, ab_new), accept if
//   E_new < E, lambda x0.5 (floor 1e-7) or x4 (cap 1e2), and the level ends
//   on the device when an accepted step is below eps or lambda saturates.
// No value goes to the host inside the loop. Outputs: T, ab and E of every
// hypothesis, the iterations each level ran, and each step's decision
// values (E, E_new, |dx|; NaN past the last step), by which a test tells a
// decision that sits at its threshold. For `track` (stats != 0) the same
// launch then runs track's statistics sweep at the finest level (the
// covariance through the 8x8 inverse of H + 1e-6 I, flow, rotation-only
// flow, saturation, energy, num_valid: tracker.py's track_stats_plain).
//
// What bounds it on the H100: not bytes or operations (a level sweep reads
// ~30 KB of point data and 4 bilinear texels a point, a few MFLOP in all)
// but latency: every LM step is two dependent sweeps, each ending in a block
// reduction, then a serial 8x8 solve, and the next step needs the last
// one's pose. One block a solve leaves most of the 132 SMs idle (one for
// `track`, 14-15 for `track_multi`'s battery), so it is latency-bound;
// spreading a solve over a thread block cluster is later work. The design
// keeps every step on chip: the pose, lambda and the flags live in shared
// memory, the reductions are warp shuffles then shared memory, and the
// solve runs in registers of one warp.
//
// Arithmetic follows the plain version's formulas and clamps (ops/image.py
// bilinear, core/camera.py project/unproject, residuals.py proj_jacobian);
// the sums run in another order than PyTorch's einsum, and nvcc contracts
// products and sums into FMAs, so results agree to f32 rounding, not bits.

#include <cstdint>
#include <cuda_runtime.h>

#include "lm_common.cuh"

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int MAX_LEVELS = 8;
constexpr int NH = 36;          // the upper triangle of the 8x8 H
constexpr int NLIN = NH + 8;    // + b
constexpr int NSTAT = NH + 5;   // + count, energy, flow, rotation flow, saturated

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
// residual, robust weight and energy. `wm` is the weight masked by the
// reference's validity.
struct PointEval {
  float Xi[3], X[3], u, v, uj, vj, g[2], r, w, energy;
  bool valid;
};

__device__ __forceinline__ PointEval eval_point(const Level& L, const Args& a, const Pose& T,
                                                int p, float wm) {
  PointEval e;
  e.u = __ldg(L.uv + 2 * p);
  e.v = __ldg(L.uv + 2 * p + 1);
  const float x = (e.u - L.cx) / L.fx;
  const float y = (e.v - L.cy) / L.fy;
  const float depth = 1.0f / lm::clamp_min(__ldg(a.idepth + p), 1e-12f);
  e.Xi[0] = x * depth;
  e.Xi[1] = y * depth;
  e.Xi[2] = 1.0f * depth;
#pragma unroll
  for (int i = 0; i < 3; ++i)
    e.X[i] = (T.R[3 * i] * e.Xi[0] + T.R[3 * i + 1] * e.Xi[1] + T.R[3 * i + 2] * e.Xi[2])
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
  e.r = (s[0] - T.b) - T.s_ji * __ldg(L.color + p);
  const float ar = fabsf(e.r);
  float w = (ar <= a.huber_k ? 1.0f : a.huber_k / lm::clamp_min(ar, 1e-12f)) * wm;
  float en = ar <= a.huber_k ? 0.5f * e.r * e.r : a.huber_k * (ar - a.half_k);
  if (ar > a.cutoff) w = 0.0f;
  en = lm::clamp_max(en, a.cap);
  e.w = e.valid ? w : 0.0f;
  e.energy = e.valid ? wm * en : 0.0f;
  return e;
}

__device__ __forceinline__ float masked_weight(const Level& L, int p) {
  return L.valid[p] ? __ldg(L.weight + p) : 0.0f;
}

// total_energy: the mean energy over the points valid in the sweep and in
// the reference (sum, count) -> out[0], out[1].
__device__ void energy_sweep(const Level& L, const Args& a, const Pose& T, float* red,
                             float* out) {
  float acc[2] = {0.0f, 0.0f};
  for (int p = threadIdx.x; p < a.P; p += THREADS) {
    const PointEval e = eval_point(L, a, T, p, masked_weight(L, p));
    if (e.valid && L.valid[p]) {
      acc[0] += e.energy;
      acc[1] += 1.0f;
    }
  }
  lm::block_sum<2, WARPS>(acc, red, out);
}

// rel_pose_jacobian of one point: (2x3 projection Jacobian) x [I | -skew(X)]
// against the sampled gradient, then d/da, d/db.
__device__ __forceinline__ void point_jacobian(const Level& L, const Pose& T, const PointEval& e,
                                               int p, float J[8]) {
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
  J[6] = -T.s_ji * __ldg(L.color + p);
  J[7] = -1.0f;
}

// The weighted Gauss-Newton sums of one point: H's upper triangle row by
// row into acc[0..35], and when `with_b` b into acc[36..43].
template <bool with_b>
__device__ __forceinline__ void add_normal(float* acc, const float J[8], float w, float r) {
  int k = 0;
#pragma unroll
  for (int d = 0; d < 8; ++d) {
    const float jw = J[d] * w;
#pragma unroll
    for (int f = d; f < 8; ++f) acc[k++] += jw * J[f];
    if (with_b) acc[NH + d] += jw * r;
  }
}

// The normal equations: rel_pose_jacobian + gauss_newton_system -> out[0..43].
__device__ void linear_sweep(const Level& L, const Args& a, const Pose& T, float* red,
                             float* out) {
  float acc[NLIN];
#pragma unroll
  for (int i = 0; i < NLIN; ++i) acc[i] = 0.0f;
  for (int p = threadIdx.x; p < a.P; p += THREADS) {
    const PointEval e = eval_point(L, a, T, p, masked_weight(L, p));
    float J[8];
    point_jacobian(L, T, e, p, J);
    add_normal<true>(acc, J, e.w, e.r);
  }
  lm::block_sum<NLIN, WARPS>(acc, red, out);
}

// track's statistics sweep at the finest level: H without prior (36), then
// over the points valid in the sweep and the reference their count, energy,
// squared flow, squared rotation-only flow (the warp with t = 0) and the
// residuals at 0.98 x the cutoff -> out[0..40].
__device__ void stats_sweep(const Level& L, const Args& a, const Pose& T, float* red,
                            float* out) {
  float acc[NSTAT];
#pragma unroll
  for (int i = 0; i < NSTAT; ++i) acc[i] = 0.0f;
  for (int p = threadIdx.x; p < a.P; p += THREADS) {
    const PointEval e = eval_point(L, a, T, p, masked_weight(L, p));
    float J[8];
    point_jacobian(L, T, e, p, J);
    add_normal<false>(acc, J, e.w, e.r);
    if (e.valid && L.valid[p]) {
      float Xr[3];
#pragma unroll
      for (int i = 0; i < 3; ++i)
        Xr[i] = (T.R[3 * i] * e.Xi[0] + T.R[3 * i + 1] * e.Xi[1] + T.R[3 * i + 2] * e.Xi[2])
                + 0.0f;
      const float izr = 1.0f / (fabsf(Xr[2]) < 1e-12f ? 1e-12f : Xr[2]);
      const float du = e.uj - e.u, dv = e.vj - e.v;
      const float dur = (L.fx * Xr[0] * izr + L.cx) - e.u;
      const float dvr = (L.fy * Xr[1] * izr + L.cy) - e.v;
      acc[NH] += 1.0f;
      acc[NH + 1] += e.energy;
      acc[NH + 2] += du * du + dv * dv;
      acc[NH + 3] += dur * dur + dvr * dvr;
      acc[NH + 4] += fabsf(e.r) >= a.sat_r ? 1.0f : 0.0f;
    }
  }
  lm::block_sum<NSTAT, WARPS>(acc, red, out);
}

__global__ void __launch_bounds__(THREADS) track_lm_kernel(const __grid_constant__ Args a) {
  __shared__ float red[WARPS * NLIN];
  __shared__ float sums[NLIN];
  __shared__ float tri[8 * 16], sol[64];
  __shared__ Level L;
  __shared__ float R[9], t[3], ab[2], Rn[9], tn[3], abn[2];
  __shared__ float E, lam, step_norm;
  __shared__ int it, done;
  const int h = blockIdx.x, tid = threadIdx.x, lane = tid & 31;
  if (tid < 9) R[tid] = a.R0[h * 9 + tid];
  if (tid < 3) t[tid] = a.t0[h * 3 + tid];
  if (tid < 2) ab[tid] = a.ab0[h * 2 + tid];
  const float ac0 = a.ab_center[0], ac1 = a.ab_center[1];

  for (int li = 0; li < a.n_levels; ++li) {
    if (tid == 0) L = a.lv[li];
    __syncthreads();
    Pose T;
#pragma unroll
    for (int i = 0; i < 9; ++i) T.R[i] = R[i];
#pragma unroll
    for (int i = 0; i < 3; ++i) T.t[i] = t[i];
    T.a = ab[0];
    T.b = ab[1];
    T.s_ji = expf(T.a);
    energy_sweep(L, a, T, red, sums);
    if (tid == 0) {
      E = sums[0] / lm::clamp_min(sums[1], 1.0f);
      lam = 1e-4f;
      it = 0;
      done = 0;
    }
    __syncthreads();
    while (it < a.iters && !done) {
      // T and ab are the accepted state (shared), read by every thread
#pragma unroll
      for (int i = 0; i < 9; ++i) T.R[i] = R[i];
#pragma unroll
      for (int i = 0; i < 3; ++i) T.t[i] = t[i];
      T.a = ab[0];
      T.b = ab[1];
      T.s_ji = expf(T.a);
      linear_sweep(L, a, T, red, sums);
      if (tid < 32) {
        // _solve_scaled on H + diag(prior), b + prior * (0, ab - ab_center);
        // lane r builds row r
        float row[9];
        const int r = lane < 8 ? lane : 0;
        float sr = 0.0f;
#pragma unroll
        for (int i = 0; i < 8; ++i) sr = i == r ? a.s[i] : sr;
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int i = r < c ? r : c, j = r < c ? c : r;
          float hv = sums[i * 8 - i * (i - 1) / 2 + (j - i)];
          if (c == r) hv = hv + (r == 6 ? 1e-1f : (r == 7 ? 1e-3f : 0.0f));
          const float v = (hv * sr) * a.s[c];
          row[c] = c == r ? (v + lam * v) + 1e-8f : v;
        }
        const float prior = r == 6 ? 1e-1f : (r == 7 ? 1e-3f : 0.0f);
        const float dab = r == 6 ? ab[0] - ac0 : (r == 7 ? ab[1] - ac1 : 0.0f);
        row[8] = (sums[NH + r] + prior * dab) * sr;
        if (lane >= 8) {
#pragma unroll
          for (int c = 0; c < 9; ++c) row[c] = 0.0f;
        }
        lm::warp_solve<8, 1>(row, tri, sol);
        if (lane == 0) {
          float dx[8], nrm = 0.0f;
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            dx[i] = sol[i] * a.s[i];
            nrm += dx[i] * dx[i];
          }
          step_norm = sqrtf(nrm);
          const float xi[6] = {-dx[0], -dx[1], -dx[2], -dx[3], -dx[4], -dx[5]};
#pragma unroll
          for (int i = 0; i < 9; ++i) Rn[i] = R[i];
#pragma unroll
          for (int i = 0; i < 3; ++i) tn[i] = t[i];
          lm::se3_exp_compose(xi, Rn, tn);
          abn[0] = ab[0] - dx[6];
          abn[1] = ab[1] - dx[7];
        }
      }
      __syncthreads();
      Pose Tn;
#pragma unroll
      for (int i = 0; i < 9; ++i) Tn.R[i] = Rn[i];
#pragma unroll
      for (int i = 0; i < 3; ++i) Tn.t[i] = tn[i];
      Tn.a = abn[0];
      Tn.b = abn[1];
      Tn.s_ji = expf(Tn.a);
      energy_sweep(L, a, Tn, red, sums);
      if (tid == 0) {
        const float E_new = sums[0] / lm::clamp_min(sums[1], 1.0f);
        const bool accept = E_new < E;
        float* tr = a.trace + (((size_t)h * a.n_levels + li) * a.iters + it) * 3;
        tr[0] = E;
        tr[1] = E_new;
        tr[2] = step_norm;
        if (accept) {
#pragma unroll
          for (int i = 0; i < 9; ++i) R[i] = Rn[i];
#pragma unroll
          for (int i = 0; i < 3; ++i) t[i] = tn[i];
          ab[0] = abn[0];
          ab[1] = abn[1];
          E = E_new;
        }
        const float lam_new = accept ? lm::clamp_min(lam * 0.5f, 1e-7f)
                                     : lm::clamp_max(lam * 4.0f, 1e2f);
        lam = lam_new;
        // 1e2 - 1e-6 in f32 is 100
        done = (accept && step_norm < a.eps) || (!accept && lam_new >= 100.0f);
        it += 1;
      }
      __syncthreads();
    }
    if (tid == 0) {
      a.it_out[h * a.n_levels + li] = it;
      float* tr = a.trace + ((size_t)h * a.n_levels + li) * a.iters * 3;
      for (int i = it * 3; i < a.iters * 3; ++i) tr[i] = __int_as_float(0x7fc00000);   // NaN
    }
    __syncthreads();
  }
  if (tid < 9) a.R_out[h * 9 + tid] = R[tid];
  if (tid < 3) a.t_out[h * 3 + tid] = t[tid];
  if (tid < 2) a.ab_out[h * 2 + tid] = ab[tid];
  if (tid == 0) a.E_out[h] = E;
  if (!a.stats) return;

  // track's statistics sweep at the last level (the finest), at the result
  Pose T;
#pragma unroll
  for (int i = 0; i < 9; ++i) T.R[i] = R[i];
#pragma unroll
  for (int i = 0; i < 3; ++i) T.t[i] = t[i];
  T.a = ab[0];
  T.b = ab[1];
  T.s_ji = expf(T.a);
  stats_sweep(L, a, T, red, sums);
  if (tid < 32) {
    // inv(H + 1e-6 I): the warp solves against the identity
    float row[16];
    const int r = lane < 8 ? lane : 0;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int i = r < c ? r : c, j = r < c ? c : r;
      const float hv = sums[i * 8 - i * (i - 1) / 2 + (j - i)];
      row[c] = c == r ? hv + 1e-6f : hv;
      row[8 + c] = c == r ? 1.0f : 0.0f;
    }
    if (lane >= 8) {
#pragma unroll
      for (int c = 0; c < 16; ++c) row[c] = 0.0f;
    }
    lm::warp_solve<8, 8>(row, tri, sol);
    if (lane < 6) {
#pragma unroll
      for (int c = 0; c < 6; ++c) a.cov_out[h * 36 + lane * 6 + c] = sol[lane * 8 + c];
    }
    if (lane == 0) {
      const float n = lm::clamp_min(sums[NH], 1.0f);
      a.stat_out[h * 4 + 0] = sums[NH + 1] / n;
      a.stat_out[h * 4 + 1] = sqrtf(sums[NH + 2] / n);
      a.stat_out[h * 4 + 2] = sqrtf(sums[NH + 3] / n);
      a.stat_out[h * 4 + 3] = sums[NH + 4] / n;
      a.nvalid_out[h] = (long long)sums[NH];
    }
  }
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
  track_lm_kernel<<<B, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
