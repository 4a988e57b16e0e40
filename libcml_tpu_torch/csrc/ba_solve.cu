// The rest of the window BA's LM step for Hopper (sm_90a): from the reduced
// system of csrc/ba_sweep.cu to the candidate state, in one launch of one
// block.
//
// Replaces the solve of the JAX package's `ba_step`
// (libcml_tpu/models/direct/ba.py:532): the marginalization prior's terms,
// `_gauge_priors` (:490), the subtraction of the Schur terms (`_schur_reduce`
// :481), the damping, the dense (8F)^2 solve, the scale-gauge projection
// (`_nullspaces` :795, its column 6), the pose / affine / delta update and the
// inverse-depth back-substitution. Its plain PyTorch form is `_solve_plain`
// with the state update of `ba_step_plain` in
// libcml_tpu_torch/models/direct/ba.py.
//
// The block builds A = H [+ Hi] + H_m + diag(prior) - H_corr [- Hi_corr],
// damped as A + lambda diag(A) + 1e-6 I, and g = b [+ bi] + b_m + H_m delta +
// b_prior - b_corr [- bi_corr] in shared memory (A's last column), then
// eliminates with partial pivoting: at column k one warp finds the pivot, the
// first row of largest magnitude (as LAPACK's isamax picks it for getrf; a NaN
// never displaces the first row), the block swaps the two rows and subtracts
// (a_ik * rcp_k) a_kj from every entry below and right of the pivot, rcp_k =
// 1 / a_kk kept in one lane (LAPACK's sgetf2 scales the multipliers by it);
// one warp back-substitutes, multiplying by the reciprocals. The scale-gauge
// direction (each valid slot's translation) is projected out of dx; then
// T = exp(-dx[:6]) o T on valid slots (lm_common.cuh se3_exp_compose, the
// map of core/lie.py), ab - dx[6:], delta - dx, and for every point row
// d_rho = (b_rho - H_xr dx) / H_rho_d (0 where invalid) and idepth =
// clamp(idepth - d_rho). With a mesh the rows are this rank's, and d_rho is
// written for the all-gather instead.
//
// What bounds it on the H100: not bytes (~0.5 MB of H_xr) or operations
// (~60 k FMA for the LU, ~115 k for the back-substitution at P 2048) but the
// elimination's 56 dependent steps, each a pivot search and two block
// barriers: latency. A simple design first; the rows' back-substitution
// spreads over the block.

#include <cstdint>
#include <cuda_runtime.h>

#include "lm_common.cuh"

namespace {

constexpr int MAX_F = 8;
constexpr int MAX_D = MAX_F * 8;
constexpr int THREADS = 512;

// The launch's arguments (mirrored field for field by ops/ba_sweep.py
// SolveArgs); pointers may be null where noted.
struct Args {
  int F, P, mesh;
  float prior_a, prior_b, idepth_min, idepth_max;
  const float* H; const float* b; const float* H_corr; const float* b_corr;   // reduced sweep
  const float* Hi; const float* bi; const float* Hi_corr; const float* bi_corr;   // or null
  const float* H_m; const float* b_m;
  const float* R; const float* t; const float* ab; const float* delta;   // the state
  const uint8_t* frame_valid;
  const float* lam;                 // device scalar
  const float* H_rho_d; const float* b_rho; const float* H_xr;   // (P,), (P,), (P, D)
  const uint8_t* point_valid;       // (P,)
  const float* idepth;              // (P,) (not read with a mesh)
  float* R_out; float* t_out; float* ab_out; float* delta_out;
  float* idepth_out;                // (P,) without a mesh
  float* d_rho_out;                 // (P,) with a mesh
  float* dx_out;                    // (D,) or null
};

struct Shared {
  float A[MAX_D][MAX_D + 1];   // the system, right-hand side in column D
  float rcp[MAX_D];
  float x[MAX_D];
  float hd[MAX_D];
  int piv;
};

__global__ void __launch_bounds__(THREADS, 1) ba_solve_kernel(const __grid_constant__ Args a) {
  __shared__ Shared s;
  const int D = 8 * a.F, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float lam = *a.lam;

  // (H_m delta)_i, then the damped system
  if (tid < D) {
    float acc = 0.0f;
    for (int j = 0; j < D; ++j) acc += a.H_m[(size_t)tid * D + j] * a.delta[j];
    s.hd[tid] = acc;
  }
  for (int i = tid; i < D * D; i += THREADS) {
    const int r = i / D, c = i % D;
    float h = a.H[i];
    if (a.Hi) h = h + a.Hi[i];
    h = h + a.H_m[i];
    const int f = r >> 3, k = r & 7;
    const bool fv = a.frame_valid[f] != 0;
    if (r == c) h = h + (fv ? (k == 6 ? a.prior_a : (k == 7 ? a.prior_b : 0.0f)) : 1.0f);
    h = h - a.H_corr[i];
    if (a.Hi_corr) h = h - a.Hi_corr[i];
    if (r == c) h = (h + lam * h) + 1e-6f;
    s.A[r][c] = h;
  }
  __syncthreads();
  if (tid < D) {
    const int f = tid >> 3, k = tid & 7;
    const bool fv = a.frame_valid[f] != 0;
    float g = a.b[tid];
    if (a.bi) g = g + a.bi[tid];
    g = (g + a.b_m[tid]) + s.hd[tid];
    const float pw = k == 6 ? a.prior_a : (k == 7 ? a.prior_b : 0.0f);
    const float abv = k == 6 ? a.ab[2 * f] : (k == 7 ? a.ab[2 * f + 1] : 0.0f);
    g = g + (fv ? pw * abv : 0.0f);
    g = g - a.b_corr[tid];
    if (a.bi_corr) g = g - a.bi_corr[tid];
    s.A[tid][D] = g;
  }
  __syncthreads();

  // elimination with partial pivoting
  for (int k = 0; k < D; ++k) {
    if (warp == 0) {
      // the first row of largest |a_ik|, i >= k; a NaN never wins unless it
      // is row k itself
      const float first = fabsf(s.A[k][k]);
      float best = -1.0f;
      int bi = D;
      for (int i = k + lane; i < D; i += 32) {
        const float v = fabsf(s.A[i][k]);
        if (v > best) {   // NaN compares false: skipped
          best = v;
          bi = i;
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        const float ob = __shfl_xor_sync(lm::FULL, best, o);
        const int oi = __shfl_xor_sync(lm::FULL, bi, o);
        if (ob > best || (ob == best && oi < bi)) {
          best = ob;
          bi = oi;
        }
      }
      if (lane == 0) s.piv = (isnan(first) || bi >= D || !(best > first)) ? k : bi;
    }
    __syncthreads();
    const int p = s.piv;
    if (p != k)
      for (int j = k + tid; j <= D; j += THREADS) {
        const float tk = s.A[k][j];
        s.A[k][j] = s.A[p][j];
        s.A[p][j] = tk;
      }
    __syncthreads();
    const float rk = 1.0f / s.A[k][k];
    if (tid == 0) s.rcp[k] = rk;
    const int rows = D - 1 - k, cols = D - k;   // columns k+1 .. D (right-hand side)
    for (int i = tid; i < rows * cols; i += THREADS) {
      const int r = k + 1 + i / cols, c = k + 1 + i % cols;
      s.A[r][c] -= (s.A[r][k] * rk) * s.A[k][c];
    }
    __syncthreads();
  }

  // back-substitution by warp 0, x_k = (y_k - sum_j>k u_kj x_j) * rcp_k
  if (warp == 0) {
    for (int k = D - 1; k >= 0; --k) {
      float acc = 0.0f;
      for (int j = k + 1 + lane; j < D; j += 32) acc += s.A[k][j] * s.x[j];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(lm::FULL, acc, o);
      if (lane == 0) s.x[k] = (s.A[k][D] - acc) * s.rcp[k];
      __syncwarp();
    }
    // project the scale gauge out: N_i = t_f[c] for c < 3 on valid slots
    float nn = 0.0f, nd = 0.0f;
    for (int i = lane; i < D; i += 32) {
      const int f = i >> 3, c = i & 7;
      const float n = c < 3 ? a.t[3 * f + c] * (a.frame_valid[f] ? 1.0f : 0.0f) : 0.0f;
      nn += n * n;
      nd += n * s.x[i];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      nn += __shfl_xor_sync(lm::FULL, nn, o);
      nd += __shfl_xor_sync(lm::FULL, nd, o);
    }
    const float coeff = nd / (nn + 1e-6f);
    for (int i = lane; i < D; i += 32) {
      const int f = i >> 3, c = i & 7;
      const float n = c < 3 ? a.t[3 * f + c] * (a.frame_valid[f] ? 1.0f : 0.0f) : 0.0f;
      s.x[i] = s.x[i] - n * coeff;
    }
  }
  __syncthreads();
  if (a.dx_out && tid < D) a.dx_out[tid] = s.x[tid];

  // the frames: exp(-dx) o T, ab - dx[6:], delta - dx on valid slots
  if (tid < a.F) {
    const int f = tid;
    const bool fv = a.frame_valid[f] != 0;
    float dxf[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) dxf[c] = fv ? s.x[8 * f + c] : 0.0f;
    float R[9], t[3];
#pragma unroll
    for (int i = 0; i < 9; ++i) R[i] = a.R[9 * f + i];
#pragma unroll
    for (int i = 0; i < 3; ++i) t[i] = a.t[3 * f + i];
    if (fv) {
      const float xi[6] = {-dxf[0], -dxf[1], -dxf[2], -dxf[3], -dxf[4], -dxf[5]};
      lm::se3_exp_compose(xi, R, t);
    }
#pragma unroll
    for (int i = 0; i < 9; ++i) a.R_out[9 * f + i] = R[i];
#pragma unroll
    for (int i = 0; i < 3; ++i) a.t_out[3 * f + i] = t[i];
    a.ab_out[2 * f] = a.ab[2 * f] - dxf[6];
    a.ab_out[2 * f + 1] = a.ab[2 * f + 1] - dxf[7];
#pragma unroll
    for (int c = 0; c < 8; ++c) a.delta_out[8 * f + c] = a.delta[8 * f + c] - dxf[c];
  }

  // the points: d_rho = (b_rho - H_xr dx) / H_rho_d
  for (int p = tid; p < a.P; p += THREADS) {
    const float* row = a.H_xr + (size_t)p * D;
    float acc = 0.0f;
    for (int j = 0; j < D; ++j) acc += row[j] * s.x[j];
    float d = (a.b_rho[p] - acc) / a.H_rho_d[p];
    d = a.point_valid[p] ? d : 0.0f;
    if (a.mesh) {
      a.d_rho_out[p] = d;
    } else {
      a.idepth_out[p] = lm::clamp_max(lm::clamp_min(a.idepth[p] - d, a.idepth_min), a.idepth_max);
    }
  }
}

}  // namespace

// Launches the solve on `stream` with the arguments in `a` (a host struct,
// copied into the launch). Returns the launch's cudaError_t.
extern "C" int ba_solve_launch(const void* args, void* stream) {
  const Args* a = static_cast<const Args*>(args);
  if (a->F < 1 || a->F > MAX_F || a->P < 0) return (int)cudaErrorInvalidValue;
  if (a->mesh ? !a->d_rho_out : (!a->idepth_out || !a->idepth)) return (int)cudaErrorInvalidValue;
  ba_solve_kernel<<<1, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(*a);
  return (int)cudaGetLastError();
}

// sizeof(Args), for the wrapper's check of its mirror of the struct.
extern "C" int ba_solve_args_size() { return (int)sizeof(Args); }
