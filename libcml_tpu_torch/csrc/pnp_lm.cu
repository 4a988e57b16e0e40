// Motion-only PnP (Huber LM with chi2 re-classification and the pose
// covariance), one launch a solve, for Hopper (sm_90a).
//
// Replaces the JAX package's device program `solve_pnp`
// (libcml_tpu/models/indirect/pnp.py:64: `lm_step` :78 scanned 10 times
// inside `round_body` :102, scanned 4 times at :115, then the covariance
// :119-128). Its plain PyTorch form is `pnp_lm_plain` in
// libcml_tpu_torch/models/indirect/pnp.py.
//
// One block runs the whole solve: `rounds` rounds, each starting at
// lambda 1e-4 and taking `iters` LM steps on the round's inliers: one sweep
// at T giving the chi2-Huber weighted 6-dof normal equations (21 H sums, 6 b
// sums) and the robust energy E, the damped 6x6 solve with partial pivoting
// (one warp), T_new = exp(-dx) o T, one sweep for E_new at T_new over the
// same points, accept if E_new < E, lambda x0.5 (floor 1e-9) or x4 (cap 1e3).
// After each round the matches are re-classified on the plain chi2
// (valid & z > 1e-6 & chi2 < 5.991). Last, one sweep over the inliers gives
// inv(H + 1e-6 I) (the warp solves against the identity), the inlier chi2
// and their count. No value goes to the host inside the solve. Each step's
// (E, E_new) is kept, by which a test tells a decision at its threshold.
//
// What bounds it on the H100: latency, not bytes or operations. The map
// arena is 4096 matches x 36 bytes, read from L2 by 81 sweeps, and the
// sweeps are a few MFLOP; every step is two dependent sweeps ending in
// block reductions, then a serial solve. One block a solve uses one of the
// 132 SMs: latency-bound; spreading a solve over a cluster is later work.
// The inlier mask lives in the output buffer, each entry written and read
// only by the thread that owns the match, so no round needs a grid sync.
//
// Sums run in another order than PyTorch's einsum, and nvcc contracts into
// FMAs: results agree to f32 rounding, not bits. _jacobian clamps z at 1e-9
// here, not the photometric tracker's 1e-8.

#include <cstdint>
#include <cuda_runtime.h>

#include "lm_common.cuh"

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int NH = 21;          // the upper triangle of the 6x6 H
constexpr float CHI2_2D = 5.991f;

struct Args {
  const float* Xw;              // (N, 3)
  const float* uv;              // (N, 2)
  const uint8_t* valid;         // (N,)
  const float* sigma2;          // (N,)
  const float* R0;              // (3, 3)
  const float* t0;              // (3,)
  int N, rounds, iters;
  float fx, fy, cx, cy;
  float* R_out;
  float* t_out;
  uint8_t* inlier;              // (N,): the state between rounds, then the output
  long long* num_inliers;
  float* cov;                   // (6, 6)
  float* chi2_out;
  float* trace;                 // (rounds, iters, 2): E, E_new a step
};

// _residuals at (R, t): the camera point, the residual and z > 1e-6.
__device__ __forceinline__ bool residual(const Args& a, const float* R, const float* t, int n,
                                         float X[3], float r[2]) {
  const float x = __ldg(a.Xw + 3 * n), y = __ldg(a.Xw + 3 * n + 1), z = __ldg(a.Xw + 3 * n + 2);
#pragma unroll
  for (int i = 0; i < 3; ++i) X[i] = (x * R[3 * i] + y * R[3 * i + 1] + z * R[3 * i + 2]) + t[i];
  const float iz = 1.0f / (fabsf(X[2]) < 1e-12f ? 1e-12f : X[2]);
  r[0] = (a.fx * X[0] * iz + a.cx) - __ldg(a.uv + 2 * n);
  r[1] = (a.fy * X[1] * iz + a.cy) - __ldg(a.uv + 2 * n + 1);
  return X[2] > 1e-6f;
}

// min(chi2, 5.991 sqrt(max(chi2 / 5.991, 1))); a NaN stays NaN, as under
// torch.minimum
__device__ __forceinline__ float robust(float chi2) {
  const float cap = CHI2_2D * sqrtf(lm::clamp_min(chi2 / CHI2_2D, 1.0f));
  return (chi2 < cap || isnan(chi2)) ? chi2 : cap;
}

// _jacobian: (2, 6) d(reproj)/d(xi) at the camera point X.
__device__ __forceinline__ void jacobian(const Args& a, const float X[3], float J[2][6]) {
  const float x = X[0], y = X[1], z = X[2];
  const float iz = 1.0f / lm::clamp_min(z, 1e-9f);
  const float iz2 = iz * iz;
  const float A[2][3] = {{a.fx * iz, 0.0f, -a.fx * x * iz2}, {0.0f, a.fy * iz, -a.fy * y * iz2}};
  const float Bm[3][6] = {{1.0f, 0.0f, 0.0f, -0.0f, z, -y},
                          {0.0f, 1.0f, 0.0f, -z, -0.0f, x},
                          {0.0f, 0.0f, 1.0f, y, -x, -0.0f}};
#pragma unroll
  for (int u = 0; u < 2; ++u)
#pragma unroll
    for (int c = 0; c < 6; ++c)
      J[u][c] = A[u][0] * Bm[0][c] + A[u][1] * Bm[1][c] + A[u][2] * Bm[2][c];
}

// A point's share of the weighted normal equations: H's upper triangle,
// then b.
__device__ __forceinline__ void add_normal(float* acc, const float J[2][6], float w,
                                           const float r[2]) {
  int k = 0;
#pragma unroll
  for (int d = 0; d < 6; ++d) {
    const float jw0 = J[0][d] * w, jw1 = J[1][d] * w;
#pragma unroll
    for (int e = d; e < 6; ++e) acc[k++] += jw0 * J[0][e] + jw1 * J[1][e];
    acc[NH + d] += jw0 * r[0] + jw1 * r[1];
  }
}

__global__ void __launch_bounds__(THREADS) pnp_lm_kernel(const __grid_constant__ Args a) {
  constexpr int NLIN = NH + 6 + 1;           // H, b, E
  __shared__ float red[WARPS * (NLIN + 1)];
  __shared__ float sums[NLIN + 1];
  __shared__ float tri[6 * 12], sol[36], e_new_sum[1];
  __shared__ float R[9], t[3], Rn[9], tn[3], lam;
  const int tid = threadIdx.x, lane = tid & 31;
  if (tid < 9) R[tid] = a.R0[tid];
  if (tid < 3) t[tid] = a.t0[tid];
  for (int n = tid; n < a.N; n += THREADS) a.inlier[n] = a.valid[n];
  __syncthreads();

  for (int round = 0; round < a.rounds; ++round) {
    if (tid == 0) lam = 1e-4f;
    for (int step = 0; step < a.iters; ++step) {
      float Rc[9], tc[3];
#pragma unroll
      for (int i = 0; i < 9; ++i) Rc[i] = R[i];
#pragma unroll
      for (int i = 0; i < 3; ++i) tc[i] = t[i];
      float acc[NLIN];
#pragma unroll
      for (int i = 0; i < NLIN; ++i) acc[i] = 0.0f;
      for (int n = tid; n < a.N; n += THREADS) {
        float X[3], r[2], J[2][6];
        const bool ok = residual(a, Rc, tc, n, X, r) && a.inlier[n];
        const float w_meas = 1.0f / __ldg(a.sigma2 + n);
        const float chi2 = (r[0] * r[0] + r[1] * r[1]) * w_meas;
        const float hub =
            chi2 > CHI2_2D ? sqrtf(CHI2_2D / lm::clamp_min(chi2, 1e-12f)) : 1.0f;
        const float w = ok ? w_meas * hub : 0.0f;
        jacobian(a, X, J);
        add_normal(acc, J, w, r);
        if (ok) acc[NH + 6] += robust(chi2);
      }
      lm::block_sum<NLIN, WARPS>(acc, red, sums);
      if (tid < 32) {
        float row[7];
        const int rr = lane < 6 ? lane : 0;
#pragma unroll
        for (int c = 0; c < 6; ++c) {
          const int i = rr < c ? rr : c, j = rr < c ? c : rr;
          const float h = sums[i * 6 - i * (i - 1) / 2 + (j - i)];
          row[c] = c == rr ? (h + lam * h) + 1e-8f : h;
        }
        row[6] = sums[NH + rr];
        if (lane >= 6) {
#pragma unroll
          for (int c = 0; c < 7; ++c) row[c] = 0.0f;
        }
        lm::warp_solve<6, 1>(row, tri, sol);
        if (lane == 0) {
          const float xi[6] = {-sol[0], -sol[1], -sol[2], -sol[3], -sol[4], -sol[5]};
#pragma unroll
          for (int i = 0; i < 9; ++i) Rn[i] = R[i];
#pragma unroll
          for (int i = 0; i < 3; ++i) tn[i] = t[i];
          lm::se3_exp_compose(xi, Rn, tn);
        }
      }
      __syncthreads();
      float Rm[9], tm[3];
#pragma unroll
      for (int i = 0; i < 9; ++i) Rm[i] = Rn[i];
#pragma unroll
      for (int i = 0; i < 3; ++i) tm[i] = tn[i];
      float e_new[1] = {0.0f};
      for (int n = tid; n < a.N; n += THREADS) {
        float X[3], r[2];
        // ok at T (the step's points), the residual at T_new
        const bool ok = residual(a, Rc, tc, n, X, r) && a.inlier[n];
        residual(a, Rm, tm, n, X, r);
        if (ok) {
          const float w_meas = 1.0f / __ldg(a.sigma2 + n);
          e_new[0] += robust((r[0] * r[0] + r[1] * r[1]) * w_meas);
        }
      }
      const float E = sums[NH + 6];
      lm::block_sum<1, WARPS>(e_new, red, e_new_sum);
      if (tid == 0) {
        const bool accept = e_new_sum[0] < E;
        float* tr = a.trace + ((size_t)round * a.iters + step) * 2;
        tr[0] = E;
        tr[1] = e_new_sum[0];
        if (accept) {
#pragma unroll
          for (int i = 0; i < 9; ++i) R[i] = Rn[i];
#pragma unroll
          for (int i = 0; i < 3; ++i) t[i] = tn[i];
        }
        lam = accept ? lm::clamp_min(lam * 0.5f, 1e-9f) : lm::clamp_max(lam * 4.0f, 1e3f);
      }
      __syncthreads();
    }
    // re-classify on the plain chi2 at the round's pose
    float Rc[9], tc[3];
#pragma unroll
    for (int i = 0; i < 9; ++i) Rc[i] = R[i];
#pragma unroll
    for (int i = 0; i < 3; ++i) tc[i] = t[i];
    for (int n = tid; n < a.N; n += THREADS) {
      float X[3], r[2];
      const bool z_ok = residual(a, Rc, tc, n, X, r);
      const float chi2 = (r[0] * r[0] + r[1] * r[1]) * (1.0f / __ldg(a.sigma2 + n));
      a.inlier[n] = a.valid[n] && z_ok && chi2 < CHI2_2D;
    }
    __syncthreads();
  }

  // the covariance and statistics over the final inliers
  float Rc[9], tc[3];
#pragma unroll
  for (int i = 0; i < 9; ++i) Rc[i] = R[i];
#pragma unroll
  for (int i = 0; i < 3; ++i) tc[i] = t[i];
  float acc[NLIN + 1];
#pragma unroll
  for (int i = 0; i < NLIN + 1; ++i) acc[i] = 0.0f;
  for (int n = tid; n < a.N; n += THREADS) {
    float X[3], r[2], J[2][6];
    residual(a, Rc, tc, n, X, r);
    const bool in = a.inlier[n];
    const float w_meas = 1.0f / __ldg(a.sigma2 + n);
    jacobian(a, X, J);
    add_normal(acc, J, in ? w_meas : 0.0f, r);
    if (in) {
      acc[NH + 6] += (r[0] * r[0] + r[1] * r[1]) * w_meas;
      acc[NH + 7] += 1.0f;
    }
  }
  // sums: H, b, the inlier chi2, the inlier count
  lm::block_sum<NLIN + 1, WARPS>(acc, red, sums);
  if (tid < 32) {
    float row[12];
    const int rr = lane < 6 ? lane : 0;
#pragma unroll
    for (int c = 0; c < 6; ++c) {
      const int i = rr < c ? rr : c, j = rr < c ? c : rr;
      row[c] = sums[i * 6 - i * (i - 1) / 2 + (j - i)] + (c == rr ? 1e-6f : 0.0f);
      row[6 + c] = c == rr ? 1.0f : 0.0f;
    }
    if (lane >= 6) {
#pragma unroll
      for (int c = 0; c < 12; ++c) row[c] = 0.0f;
    }
    lm::warp_solve<6, 6>(row, tri, sol);
    if (lane < 6) {
#pragma unroll
      for (int c = 0; c < 6; ++c) a.cov[lane * 6 + c] = sol[lane * 6 + c];
    }
  }
  if (tid < 9) a.R_out[tid] = R[tid];
  if (tid < 3) a.t_out[tid] = t[tid];
  if (tid == 0) {
    a.chi2_out[0] = sums[NH + 6];
    a.num_inliers[0] = (long long)sums[NH + 7];
  }
}

}  // namespace

// All pointers are device pointers; `cam` is fx, fy, cx, cy (host). Returns
// the launch's cudaError_t.
extern "C" int pnp_lm_launch(const void* Xw, const void* uv, const void* valid,
                             const void* sigma2, const void* R0, const void* t0, int N,
                             const float* cam, int rounds, int iters, void* R_out, void* t_out,
                             void* inlier, void* num_inliers, void* cov, void* chi2,
                             void* trace, void* stream) {
  if (N < 0 || rounds < 0 || iters < 0) return (int)cudaErrorInvalidValue;
  Args a{static_cast<const float*>(Xw), static_cast<const float*>(uv),
         static_cast<const uint8_t*>(valid), static_cast<const float*>(sigma2),
         static_cast<const float*>(R0), static_cast<const float*>(t0), N, rounds, iters,
         cam[0], cam[1], cam[2], cam[3], static_cast<float*>(R_out),
         static_cast<float*>(t_out), static_cast<uint8_t*>(inlier),
         static_cast<long long*>(num_inliers), static_cast<float*>(cov),
         static_cast<float*>(chi2), static_cast<float*>(trace)};
  pnp_lm_kernel<<<1, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
