// Pieces shared by the LM kernels (track_lm.cu, pnp_lm.cu): torch's clamp
// semantics, the fixed-order block reduction, the warp's dense solve with
// partial pivoting, and the SE(3) exponential of core/lie.py.
//
// Every reduction here runs in one fixed order (a thread's points in index
// order, a shuffle tree inside each warp, then the warps' partials in warp
// order) and none uses atomics, so a kernel gives the same bits on the same
// inputs: repeated runs, a resumed run and a sharded world of one stay
// bit-identical.

#pragma once

#include <cuda_runtime.h>

namespace lm {

constexpr unsigned FULL = 0xffffffffu;

// torch.clamp(x, min=m) / clamp(x, max=m): a NaN stays NaN (fmaxf would
// drop it)
__device__ __forceinline__ float clamp_min(float x, float m) { return x < m ? m : x; }
__device__ __forceinline__ float clamp_max(float x, float m) { return x > m ? m : x; }

// Sum N values over the block. `red` holds WARPS * N floats, `out` N; both
// in shared memory. Ends with the block synchronized and `out` complete.
template <int N, int WARPS>
__device__ __forceinline__ void block_sum(const float (&v)[N], float* red, float* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float x = v[i];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) x += __shfl_down_sync(FULL, x, off);
    if (lane == 0) red[warp * N + i] = x;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < N; i += WARPS * 32) {
    float s = red[i];
    for (int w = 1; w < WARPS; ++w) s += red[w * N + i];
    out[i] = s;
  }
  __syncthreads();
}

// Gaussian elimination with partial pivoting (the pivot is the first row of
// largest magnitude, as LAPACK's isamax picks it) on the N x (N + R)
// augmented system held one row a lane in `row` (lanes >= N carry nothing),
// by the whole warp. Then the R right-hand sides are solved by back
// substitution, lane c for column c, from the triangular rows staged in
// `tri` (shared, N * (N + R) floats), into x (shared, N * R, row-major).
// A zero pivot gives inf/NaN, as torch.linalg.solve_ex and inv_ex do.
template <int N, int R>
__device__ __forceinline__ void warp_solve(float (&row)[N + R], float* tri, float* x) {
  constexpr int C = N + R;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    float v = (lane >= k && lane < N) ? fabsf(row[k]) : -1.0f;
    int p = lane;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float vo = __shfl_down_sync(FULL, v, off);
      const int po = __shfl_down_sync(FULL, p, off);
      if (vo > v || (vo == v && po < p)) {
        v = vo;
        p = po;
      }
    }
    p = __shfl_sync(FULL, p, 0);
    if (p < k || p >= N) p = k;   // every candidate NaN: keep the row in place
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float rk = __shfl_sync(FULL, row[c], k);
      const float rp = __shfl_sync(FULL, row[c], p);
      if (lane == k) row[c] = rp;
      else if (lane == p) row[c] = rk;
    }
    float piv[C];
#pragma unroll
    for (int c = 0; c < C; ++c) piv[c] = __shfl_sync(FULL, row[c], k);
    if (lane > k && lane < N) {
      const float l = row[k] / piv[k];
      row[k] = l;
#pragma unroll
      for (int c = k + 1; c < C; ++c) row[c] -= l * piv[c];
    }
  }
  if (lane < N) {
#pragma unroll
    for (int c = 0; c < C; ++c) tri[lane * C + c] = row[c];
  }
  __syncwarp();
  if (lane < R) {
    for (int k = N - 1; k >= 0; --k) {
      float s = tri[k * C + N + lane];
      for (int j = k + 1; j < N; ++j) s -= tri[k * C + j] * x[j * R + lane];
      x[k * R + lane] = s / tri[k * C + k];
    }
  }
  __syncwarp();
}

// core/lie.py: _sinc_coeffs, so3_exp, so3_V, se3_exp(xi) and compose:
// (R, t) <- exp(xi) o (R, t), with xi = (v, w); R row-major.
__device__ __forceinline__ void se3_exp_compose(const float* xi, float* R, float* t) {
  const float w0 = xi[3], w1 = xi[4], w2 = xi[5];
  const float theta2 = (w0 * w0 + w1 * w1) + w2 * w2;
  const float theta = sqrtf(clamp_min(theta2, 1e-16f));
  const bool small = theta2 < 1e-8f;
  const float A = small ? 1.0f - theta2 / 6.0f : sinf(theta) / theta;
  const float B = small ? 0.5f - theta2 / 24.0f : (1.0f - cosf(theta)) / theta2;
  const float Cc = small ? 1.0f / 6.0f - theta2 / 120.0f : (1.0f - A) / theta2;
  const float w[3] = {w0, w1, w2};
  const float K[9] = {0.0f, -w2, w1, w2, 0.0f, -w0, -w1, w0, 0.0f};
  float Re[9], V[9];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float eye = i == j ? 1.0f : 0.0f;
      const float ss = w[i] * w[j] - theta2 * eye;
      Re[3 * i + j] = (eye + A * K[3 * i + j]) + B * ss;
      V[3 * i + j] = (eye + B * K[3 * i + j]) + Cc * ss;
    }
  }
  float Rn[9], tn[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j)
      Rn[3 * i + j] = Re[3 * i] * R[j] + Re[3 * i + 1] * R[3 + j] + Re[3 * i + 2] * R[6 + j];
    const float te = V[3 * i] * xi[0] + V[3 * i + 1] * xi[1] + V[3 * i + 2] * xi[2];
    tn[i] = (Re[3 * i] * t[0] + Re[3 * i + 1] * t[1] + Re[3 * i + 2] * t[2]) + te;
  }
#pragma unroll
  for (int i = 0; i < 9; ++i) R[i] = Rn[i];
#pragma unroll
  for (int i = 0; i < 3; ++i) t[i] = tn[i];
}

}  // namespace lm
