// Motion-only PnP (Huber LM with chi2 re-classification and the pose
// covariance), one launch a solve and one thread block cluster a solve,
// for Hopper (sm_90a).
//
// Replaces the JAX package's device program `solve_pnp`
// (libcml_tpu/models/indirect/pnp.py:64: `lm_step` :78 scanned 10 times
// inside `round_body` :102, scanned 4 times at :115, then the covariance
// :119-128). Its plain PyTorch form is `pnp_lm_plain` in
// libcml_tpu_torch/models/indirect/pnp.py.
//
// One cluster of CS (lm::CLUSTER, 8) blocks of 256 threads runs the whole
// solve of the plain form: `rounds` rounds, each starting at lambda 1e-4
// and taking `iters` LM steps on the round's inliers: at T the chi2-Huber
// weighted 6-dof normal equations (21 H sums, 6 b sums) and the robust
// energy E over ok(T) = inlier & z_ok(T), the damped 6x6 solve with partial
// pivoting, T_new = exp(-dx) o T, E_new at T_new over the same ok(T),
// accept if E_new < E, lambda x0.5 (floor 1e-9) or x4 (cap 1e3). After each
// round the matches are re-classified on the plain chi2 (valid & z > 1e-6 &
// chi2 < 5.991). Last, over the final inliers, inv(H + 1e-6 I), the inlier
// chi2 and their count. No value goes to the host inside the solve. Each
// step's (E, E_new) is kept, by which a test tells a decision at its
// threshold.
//
// What bounds it on the H100: latency, not bytes or operations (4096
// matches x 36 bytes, a few MFLOP a sweep): every step is a sweep ending in
// a reduction, then a serial solve. The design shortens that chain in three
// ways.
// - One sweep a step. The sweep at T_new sums E_new over the step's mask
//   ok(T), which each thread keeps for its matches in registers, and from
//   the same per-match values E, H and b at T_new over ok(T_new): on accept
//   the next step's system, on reject the block keeps T's (what a sweep at
//   the unchanged T gives bit for bit). A round's re-classification runs at
//   the pose of the next round's first step and merges into that sweep
//   (each match's work is local); the last one merges into the covariance
//   sweep. A solve of 4 rounds x 10 steps makes 45 sweeps (the plain form's
//   schedule: 85).
// - A cluster a solve. Thread g = rank x 256 + tid owns matches g, g +
//   2048, ... (two a thread at N 4096) and holds their constants (the world
//   point, the pixel, 1 / sigma2, validity) and their inlier and ok(T) bits
//   in registers for the whole solve. Each block reduces in its fixed order,
//   one cluster barrier a step, then every block sums the CS partials in
//   rank order from distributed shared memory and runs the same solve and
//   decision: no broadcast, atomic or grid sync.
// - The serial tail: the 6x6 solve by one warp, a column a lane, with the
//   pivot rule of torch.linalg.solve, and the block's reduction by recursive
//   halving (lm_common.cuh); se3_exp_compose unchanged.
// Matches past KREG x 2048 a thread (N > 8192) are read from memory each
// sweep, their inlier bit kept in the output buffer (each entry written and
// read only by the thread that owns the match) and ok(T) recomputed at the
// accepted pose. A card without cluster support refuses the launch, and
// the wrapper raises.
//
// Sums run in another order than PyTorch's einsum, and nvcc contracts into
// FMAs: results agree to f32 rounding, not bits. _jacobian clamps z at 1e-9
// here, not the photometric tracker's 1e-8.

#include <cstdint>
#include <cuda_runtime.h>

#include "lm_common.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int CS = lm::CLUSTER;
constexpr int STRIDE = CS * THREADS;   // matches apart that one thread owns
constexpr int KREG = 4;                // matches a thread holds in registers
constexpr int NH = 21;                 // the upper triangle of the 6x6 H
constexpr int NE = NH + 6;             // + b; then E at the sweep's pose, E_new
constexpr int NS = NE + 2;
constexpr int NF = NH + 2;             // the covariance sweep: H, inlier chi2, count
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
  uint8_t* inlier;              // (N,): the output (and the state past KREG a thread)
  long long* num_inliers;
  float* cov;                   // (6, 6)
  float* chi2_out;
  float* trace;                 // (rounds, iters, 2): E, E_new a step
};

// A match's constants over the solve.
struct Match {
  float X[3], u, v, w_meas;
  bool valid;
};

__device__ __forceinline__ Match load_match(const Args& a, int n) {
  Match m;
#pragma unroll
  for (int i = 0; i < 3; ++i) m.X[i] = __ldg(a.Xw + 3 * n + i);
  m.u = __ldg(a.uv + 2 * n);
  m.v = __ldg(a.uv + 2 * n + 1);
  m.w_meas = 1.0f / __ldg(a.sigma2 + n);
  m.valid = a.valid[n];
  return m;
}

// _residuals at (R, t): the camera point, the residual and z > 1e-6.
__device__ __forceinline__ bool residual(const Args& a, const float* R, const float* t,
                                         const Match& m, float X[3], float r[2]) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
    X[i] = (m.X[0] * R[3 * i] + m.X[1] * R[3 * i + 1] + m.X[2] * R[3 * i + 2]) + t[i];
  const float iz = 1.0f / (fabsf(X[2]) < 1e-12f ? 1e-12f : X[2]);
  r[0] = (a.fx * X[0] * iz + a.cx) - m.u;
  r[1] = (a.fy * X[1] * iz + a.cy) - m.v;
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

// A match's share of the weighted normal equations: H's upper triangle,
// then (with_b) b.
template <bool with_b, int N>
__device__ __forceinline__ void add_normal(float (&acc)[N], const float J[2][6], float w,
                                           const float r[2]) {
  int k = 0;
#pragma unroll
  for (int d = 0; d < 6; ++d) {
    const float jw0 = J[0][d] * w, jw1 = J[1][d] * w;
#pragma unroll
    for (int e = d; e < 6; ++e) acc[k++] += jw0 * J[0][e] + jw1 * J[1][e];
    if (with_b) acc[NH + d] += jw0 * r[0] + jw1 * r[1];
  }
}

// The step system of a match at the sweep's pose over ok (its chi2 given):
// the chi2-Huber weight, J, H and b, and E.
__device__ __forceinline__ void add_system(const Args& a, const float X[3], const float r[2],
                                           float chi2, float w_meas, bool ok,
                                           float (&acc)[NS]) {
  const float hub = chi2 > CHI2_2D ? sqrtf(CHI2_2D / lm::clamp_min(chi2, 1e-12f)) : 1.0f;
  float J[2][6];
  jacobian(a, X, J);
  add_normal<true>(acc, J, ok ? w_meas * hub : 0.0f, r);
  if (ok) acc[NE] += robust(chi2);
}

// The sweep that opens a round, at the accepted pose T: with `classify`
// (every round after the first) the previous round's re-classification,
// then the system over ok(T). Sets the match's inlier and ok(T) bits.
__device__ __forceinline__ void first_match(const Args& a, const float* R, const float* t,
                                            const Match& m, bool classify, bool& inl, bool& okT,
                                            float (&acc)[NS]) {
  float X[3], r[2];
  const bool z_ok = residual(a, R, t, m, X, r);
  const float chi2 = (r[0] * r[0] + r[1] * r[1]) * m.w_meas;
  if (classify) inl = m.valid && z_ok && chi2 < CHI2_2D;
  okT = inl && z_ok;
  add_system(a, X, r, chi2, m.w_meas, okT, acc);
}

// A step's sweep at T_new: E_new over the step's ok(T), then the system at
// T_new over ok(T_new) (returned in okN).
__device__ __forceinline__ void step_match(const Args& a, const float* Rn, const float* tn,
                                           const Match& m, bool inl, bool okT, bool& okN,
                                           float (&acc)[NS]) {
  float X[3], r[2];
  const bool z_ok = residual(a, Rn, tn, m, X, r);
  const float chi2 = (r[0] * r[0] + r[1] * r[1]) * m.w_meas;
  if (okT) acc[NE + 1] += robust(chi2);
  okN = inl && z_ok;
  add_system(a, X, r, chi2, m.w_meas, okN, acc);
}

// The covariance sweep at the final pose: with `classify` the last round's
// re-classification, then H over the inliers with the plain weight, their
// chi2 and their count.
__device__ __forceinline__ void final_match(const Args& a, const float* R, const float* t,
                                            const Match& m, bool classify, bool& inl,
                                            float (&acc)[NF]) {
  float X[3], r[2], J[2][6];
  const bool z_ok = residual(a, R, t, m, X, r);
  const float chi2 = (r[0] * r[0] + r[1] * r[1]) * m.w_meas;
  if (classify) inl = m.valid && z_ok && chi2 < CHI2_2D;
  jacobian(a, X, J);
  add_normal<false>(acc, J, inl ? m.w_meas : 0.0f, r);
  if (inl) {
    acc[NH] += chi2;
    acc[NH + 1] += 1.0f;
  }
}

__global__ void __launch_bounds__(THREADS, 1) pnp_lm_kernel(const __grid_constant__ Args a) {
  __shared__ float red[WARPS * NS];
  __shared__ float part[2 * NS];
  __shared__ float sys[2][NS];      // sys[cur]: the system of the accepted pose
  __shared__ float fin[NF];
  __shared__ float R[9], t[3], Rn[9], tn[3], lam;
  __shared__ int cur, accepted;
  const int rank = (int)cg::this_cluster().block_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = rank * THREADS + tid;
  const bool writer = rank == 0;    // every block holds the same state; one writes it
  int buf = 0;
  if (tid < 9) R[tid] = a.R0[tid];
  if (tid < 3) t[tid] = a.t0[tid];
  if (tid == 0) cur = 0;
  Match m[KREG];
  bool inl[KREG], okT[KREG], okN[KREG];
#pragma unroll
  for (int k = 0; k < KREG; ++k) {
    const int n = g + k * STRIDE;
    if (n < a.N) m[k] = load_match(a, n);
    inl[k] = n < a.N && m[k].valid;
    okT[k] = okN[k] = false;
  }
  for (int n = g + KREG * STRIDE; n < a.N; n += STRIDE) a.inlier[n] = a.valid[n];
  __syncthreads();

  // warp 0: the damped solve of sys[cur] at lambda, lane c < 6 building
  // column c, lane 6 the right-hand side; then T_new = exp(-dx) o T (lane 0
  // writes it)
  auto solve_step = [&]() {
    const float* S = sys[cur];
    const float lm_ = lam;
    const int c = lane < 6 ? lane : 5;   // lanes past 6 read column 5, unused
    float col[6];
#pragma unroll
    for (int r = 0; r < 6; ++r) {
      const int i = r < c ? r : c, j = r < c ? c : r;
      const float h = S[i * 6 - i * (i - 1) / 2 + (j - i)];
      col[r] = lane >= 6 ? S[NH + r] : (c == r ? (h + lm_ * h) + 1e-8f : h);
    }
    float x[6];
    lm::warp_solve<6, 1>(col, x);
    if (lane == 0) {
      const float xi[6] = {-x[0], -x[1], -x[2], -x[3], -x[4], -x[5]};
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
    }
  };

  for (int round = 0; round < a.rounds && a.iters > 0; ++round) {
    {
      // the round's first sweep at T (merging the last round's
      // re-classification): E, H and b over ok(T)
      float Rc[9], tc[3], acc[NS];
#pragma unroll
      for (int i = 0; i < 9; ++i) Rc[i] = R[i];
#pragma unroll
      for (int i = 0; i < 3; ++i) tc[i] = t[i];
#pragma unroll
      for (int i = 0; i < NS; ++i) acc[i] = 0.0f;
      const bool classify = round > 0;
#pragma unroll
      for (int k = 0; k < KREG; ++k)
        if (g + k * STRIDE < a.N) first_match(a, Rc, tc, m[k], classify, inl[k], okT[k], acc);
      for (int n = g + KREG * STRIDE; n < a.N; n += STRIDE) {
        bool in = a.inlier[n], ok;
        first_match(a, Rc, tc, load_match(a, n), classify, in, ok, acc);
        a.inlier[n] = in;
      }
      lm::cluster_sum<NS, WARPS>(acc, red, part, buf, sys[cur ^ 1]);
      buf ^= 1;
      if (warp == 0) {
        const int nxt = cur ^ 1;
        __syncwarp();   // every lane has read cur
        if (lane == 0) {
          cur = nxt;
          lam = 1e-4f;
        }
        __syncwarp();
        solve_step();
      }
      __syncthreads();
    }
    for (int step = 0; step < a.iters; ++step) {
      float Rm[9], tm[3], Rc[9], tc[3], acc[NS];
#pragma unroll
      for (int i = 0; i < 9; ++i) Rm[i] = Rn[i];
#pragma unroll
      for (int i = 0; i < 3; ++i) tm[i] = tn[i];
#pragma unroll
      for (int i = 0; i < NS; ++i) acc[i] = 0.0f;
#pragma unroll
      for (int k = 0; k < KREG; ++k)
        if (g + k * STRIDE < a.N) step_match(a, Rm, tm, m[k], inl[k], okT[k], okN[k], acc);
      if (g + KREG * STRIDE < a.N) {
        // matches read from memory: ok(T) again at the accepted pose
#pragma unroll
        for (int i = 0; i < 9; ++i) Rc[i] = R[i];
#pragma unroll
        for (int i = 0; i < 3; ++i) tc[i] = t[i];
        for (int n = g + KREG * STRIDE; n < a.N; n += STRIDE) {
          const Match mn = load_match(a, n);
          const bool in = a.inlier[n];
          float X[3], r[2];
          const bool ok = in && residual(a, Rc, tc, mn, X, r);
          bool ok_new;
          step_match(a, Rm, tm, mn, in, ok, ok_new, acc);
        }
      }
      lm::cluster_sum<NS, WARPS>(acc, red, part, buf, sys[cur ^ 1]);
      buf ^= 1;
      if (warp == 0) {
        const int nxt = cur ^ 1;
        const float E = sys[cur][NE], E_new = sys[nxt][NE + 1];
        const bool accept = E_new < E;
        __syncwarp();
        if (lane == 0) {
          if (writer) {
            float* tr = a.trace + ((size_t)round * a.iters + step) * 2;
            tr[0] = E;
            tr[1] = E_new;
          }
          if (accept) {
#pragma unroll
            for (int i = 0; i < 9; ++i) R[i] = Rn[i];
#pragma unroll
            for (int i = 0; i < 3; ++i) t[i] = tn[i];
            cur = nxt;
          }
          lam = accept ? lm::clamp_min(lam * 0.5f, 1e-9f) : lm::clamp_max(lam * 4.0f, 1e3f);
          accepted = accept;
        }
        __syncwarp();
        if (step + 1 < a.iters) solve_step();
      }
      __syncthreads();
      if (accepted) {
#pragma unroll
        for (int k = 0; k < KREG; ++k) okT[k] = okN[k];
      }
    }
  }

  // the covariance sweep at the final pose (merging the last round's
  // re-classification): H over the inliers, their chi2 and count
  float Rc[9], tc[3], acc[NF];
#pragma unroll
  for (int i = 0; i < 9; ++i) Rc[i] = R[i];
#pragma unroll
  for (int i = 0; i < 3; ++i) tc[i] = t[i];
#pragma unroll
  for (int i = 0; i < NF; ++i) acc[i] = 0.0f;
  const bool classify = a.rounds > 0;
#pragma unroll
  for (int k = 0; k < KREG; ++k) {
    const int n = g + k * STRIDE;
    if (n < a.N) {
      final_match(a, Rc, tc, m[k], classify, inl[k], acc);
      a.inlier[n] = inl[k];
    }
  }
  for (int n = g + KREG * STRIDE; n < a.N; n += STRIDE) {
    bool in = a.inlier[n];
    final_match(a, Rc, tc, load_match(a, n), classify, in, acc);
    a.inlier[n] = in;
  }
  lm::cluster_sum<NF, WARPS>(acc, red, part, buf, fin);
  if (warp == 0 && writer) {
    // inv(H + 1e-6 I): lane 6 + j solves against the unit column j
    const int c = lane;
    float col[6];
#pragma unroll
    for (int r = 0; r < 6; ++r) {
      if (c < 6) {
        const int i = r < c ? r : c, j = r < c ? c : r;
        col[r] = fin[i * 6 - i * (i - 1) / 2 + (j - i)] + (c == r ? 1e-6f : 0.0f);
      } else {
        col[r] = r == c - 6 ? 1.0f : 0.0f;
      }
    }
    float x[6];
    lm::warp_solve<6, 6>(col, x);
    if (lane >= 6 && lane < 12) {
#pragma unroll
      for (int i = 0; i < 6; ++i) a.cov[i * 6 + lane - 6] = x[i];
    }
    if (lane < 9) a.R_out[lane] = R[lane];
    if (lane < 3) a.t_out[lane] = t[lane];
    if (lane == 0) {
      a.chi2_out[0] = fin[NH];
      a.num_inliers[0] = (long long)fin[NH + 1];
    }
  }
  // no block leaves while another may still read its partials
  lm::cluster_barrier();
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
  return (int)lm::launch_clusters(pnp_lm_kernel, 1, THREADS, static_cast<cudaStream_t>(stream),
                                  nullptr, a);
}

// The cluster's size (blocks a solve) and how many such clusters the card
// holds at once (cudaOccupancyMaxActiveClusters). Returns the query's
// cudaError_t.
extern "C" int pnp_lm_cluster_info(int* cluster, int* max_active) {
  *cluster = CS;
  return (int)lm::launch_clusters(pnp_lm_kernel, 1, THREADS, nullptr, max_active, Args{});
}
