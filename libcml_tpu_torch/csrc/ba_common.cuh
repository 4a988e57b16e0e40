// Device code shared by the window BA's kernels for Hopper (sm_90a):
// csrc/ba_sweep.cu (a sweep, or FINISH), csrc/ba_solve.cu (the rest of an
// LM step) and csrc/ba_run.cu (a whole run_ba or run_ba_mixed in one
// launch). Each of them runs the same functions in the same orders, so a
// run split into launches (with a mesh) gives the bits of the one-launch
// run.
//
// The sweep. The residual of point p (host slot h) in target slot f at
// pattern pixel k has Jacobians that factor through z_k = (gx_k, gy_k, c_k,
// 1) (the sampled gradient, the host color less the host's FEJ offset, and
// 1): J_t[k] = L_t z_k, J_h[k] = L_h z_k, J_rho[k] = (a, 0, 0) . z_k, with
// L_t, L_h (8 x 4) made of the pair's FEJ projection Jacobians A_t, A_h (2 x
// 6) and its brightness scale s0, and a = d(pixel)/d(idepth). Every
// normal-equation term of the pair is a form in Z = sum_k w_k z_k z_k^T (10
// sums) and zr = sum_k w_k z_k r_k (4 sums); the (P, F, 8, 8) Jacobians are
// never formed.
//
// A point group is NPB (16) points, 128 (point, target slot) pairs; the
// block that owns it takes it through:
//   A  a thread a pair: the current-state warp and bilinear sample of the 8
//      pixels, residuals, Huber weights and energy, the masks, the FEJ
//      geometry, Z and zr (kept in shared memory; MARG takes this phase in
//      double, marg_pair);
//   F  two threads a pair: its forms L Z L^T (L_t Z L_t^T, L_t Z L_h^T, L_h Z
//      L_h^T), L zr, the target block of its H_xr row and its share of the
//      point's H_rho, b_rho, H_xr host block;
//   B  nine threads a point: H_rho and b_rho (then the damped Schur scale),
//      and the eight entries of the host block of the H_xr row, each summed
//      over the point's pairs in slot order;
//   C  each thread owns entries of the group's partial sums (H's slot blocks
//      on and above the block diagonal, H_corr on and above the diagonal, b,
//      b_corr) and adds the group's points into
//      each, in double (H - H_corr along the scale direction is ~1e6 of
//      ~1e10: PERF.md): a quarter's 4 points in point order, then the
//      quarters in order; the energy is a tree over each warp's lanes, then
//      the warps in order.
// The partials go to device memory; after a grid barrier every block sums
// its slice of the entries over all groups, acc = 0 and then groups 0..G-1
// (phase D, spread over the card): the bits do not depend on the grid's
// size, and no floating-point atomic is used anywhere.
//
// A system sweep hands the solve the Schur complement S = H - H_corr and s =
// b - b_corr, each difference of two double sums rounded once.
//
// The mixed BA's reprojection factors (_linearize_indirect, _assemble_indirect,
// the second _schur_reduce of ba_step, indirect_energy) are point groups too:
// NPB factor points, a pair a (point, target slot), swept by the same
// phases (sweep_group's IND_SYSTEM and IND_ENERGY modes) after the
// photometric groups. Phase A (ind_pair) linearizes a pair at the current
// state (no FEJ): the 2-d residual, J_t, J_h, J_rho and the Huber weight
// mixed_weight / sigma2 at chi2 5.991; phase F writes its 2 x 6 products into
// a pair's forms (affine rows and columns zero), so phases B and C are the
// photometric ones: the point's H_rho, b_rho and H_xr row, the damped Schur
// scale, and the group's partials in point order. Phase D keeps their four
// sums apart (H, b, H_corr, b_corr, each rounded once), and the solve adds
// them to the photometric system in _solve_plain's order; the energy is
// mixed_weight x the groups' sum, added last in the finish. The factors'
// sums are never part of the photometric partials, so with a mesh, whose
// ranks each hold them whole, they join after the all-reduce, once.
//
// The solve: one warp takes the damped (8F)^2 system through LU with
// partial pivoting, two rows a lane held in registers and __syncwarp only
// (the pivot is the first row of largest magnitude, as LAPACK's isamax
// picks it; a NaN never displaces the first row; the multipliers are scaled
// by the pivot's reciprocal, as sgetf2 does), then back-substitutes. Each
// point's inverse-depth update d_rho = (b_rho - H_xr dx) / H_rho_d is then a
// dot in column order, by the block that owns the point's row (ba_run.cu,
// from shared memory) or by the block that loaded it in a coalesced tile
// (ba_solve.cu).
//
// Arithmetic follows the plain forms' formulas and clamps (ops/image.py
// bilinear, core/camera.py project/unproject/in_bounds, residuals.py
// proj_jacobian and the Huber pair); sums run in other orders than PyTorch's
// and nvcc contracts products into FMAs, so results agree with the plain
// forms to f32 rounding, not bits.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "lm_common.cuh"

namespace ba {

constexpr int MAX_F = 8;                  // frame slots
constexpr int MAX_D = MAX_F * 8;          // camera-state dimension
constexpr int NPB = 16;                   // points a group
constexpr int NPAIR = NPB * MAX_F;        // (point, target slot) pairs a group
constexpr int THREADS = 256;              // a block: two threads a pair in phase F
constexpr int WARPS = THREADS / 32;
constexpr int NPAT = 8;                   // residual pattern pixels
constexpr int XS = MAX_D + 1;             // row stride of H_xr rows in shared memory
// row stride of the solve's system (the right-hand side in column D), then of
// its factors U (the right-hand side in column MAX_D): rows 16-byte aligned,
// and U[i][k - i] down the rows in distinct banks
constexpr int AS = MAX_D + 4;
// a pair's forms, 8 x 8 each, row by row: L_t Z L_t^T, L_t Z L_h^T, L_h Z
// L_h^T; then L_t zr (8), L_h zr (8)
constexpr int F_TT = 0, F_TH = 64, F_HH = 128, F_BT = 192, F_BH = 200, NFORM = 208;
constexpr int NPB_VALS = 10;              // a pair's share of H_rho, b_rho, H_xr host block

// residuals.py PATTERN (DSO's pattern #8)
__constant__ float PAT_U[NPAT] = {0.0f, -1.0f, 1.0f, -2.0f, 0.0f, 2.0f, -1.0f, 0.0f};
__constant__ float PAT_V[NPAT] = {-2.0f, -1.0f, -1.0f, 0.0f, 0.0f, 0.0f, 1.0f, 2.0f};

enum Mode { SYSTEM = 0, ENERGY = 1, STATUS = 2, MARG = 3, FINISH = 4 };
// sweep_group's modes for the reprojection groups of a SYSTEM or ENERGY sweep
enum IndMode { IND_SYSTEM = 5, IND_ENERGY = 6 };
// the reprojection residuals' Huber threshold: chi2 with 2 dof at 95 %
constexpr float CHI2_2D = 5.991f;

// The mixed BA's reprojection factors (ba.py IndirectFactors; Q = 0: none)
// and what a SYSTEM or ENERGY sweep makes of them (ops/ba_sweep.py IndArgs
// mirrors it).
struct Ind {
  int Q;
  float mixed_weight;
  const float* uv;             // (Q, 2) anchor pixel in the host slot
  const int32_t* host;         // (Q,) host slot
  const float* idepth;         // (Q,) inverse depth in the host slot
  const uint8_t* point_valid;  // (Q,)
  const float* obs_uv;         // (Q, F, 2) observed corner in each target slot
  const uint8_t* obs_valid;    // (Q, F)
  const float* sigma2;         // (Q, F) measurement variance
  float* H;                    // SYSTEM: (D, D) the additive system
  float* b;                    // SYSTEM: (D,)
  float* H_corr;               // SYSTEM: (D, D) the damped Schur pair
  float* b_corr;               // SYSTEM: (D,)
  float* H_rho_d;              // SYSTEM: (Q,) the damped inverse-depth block
  float* b_rho;                // SYSTEM: (Q,)
  float* H_xr;                 // SYSTEM: (Q, D)
  float* e;                    // ENERGY: () mixed_weight x the robust energy
  void* partials;              // scratch: the reprojection groups' partial sums (double)
};
enum Fin { FIN_NONE = 0, FIN_ENERGY = 1, FIN_ACCEPT = 2 };

// A sweep's arguments (ops/ba_sweep.py SweepArgs mirrors them field for
// field); pointers may be null where a mode does not use them. Data that a
// kernel of this family writes while another block may read it (the state's
// frames and inverse depths, lambda, the reduced system) is read with
// __ldcg, past the SM's L1.
struct Args {
  int mode, fin, P, F, img_h, img_w, slot_host, init_lam;
  float fx, fy, cx, cy, huber_k, half_k, outlier, rho_eps;
  float prior_a, prior_b, lam_init;
  int P_total, Q;
  // points (the P rows this launch sweeps)
  const float* uv;             // (P, 2)
  const int32_t* host;         // (P,)
  const float* idepth;         // (P,)
  const float* idepth_fej;     // (P,)
  const float* color;          // (P, 8)
  const float* weight;         // (P, 8)
  const uint8_t* point_valid;  // (P,)
  const uint8_t* res_active;   // (P, F)
  // frames
  const float* R;              // (F, 3, 3) current poses
  const float* t;              // (F, 3)
  const float* R_fej;          // (F, 3, 3) linearization point
  const float* t_fej;          // (F, 3)
  const float* ab;             // (F, 2)
  const float* ab_fej;         // (F, 2)
  const float* delta;          // (F, 8)
  const uint8_t* frame_valid;  // (F,)
  const float* images;         // (F, H, W, 3): value, gx, gy
  const float* lam;            // SYSTEM: the damping (device scalar)
  const int64_t* slot;         // MARG: the slot (device scalar), or null: slot_host
  // outputs
  float* H;                    // (D, D)
  float* b;                    // (D,)
  float* H_corr;               // (D, D)
  float* b_corr;               // (D,)
  float* H_rho_d;              // (P,)
  float* b_rho;                // (P,)
  float* H_xr;                 // (P, D)
  float* e_photo;              // () this launch's photometric energy
  uint8_t* res_active_out;     // STATUS: (P, F)
  uint8_t* point_valid_out;    // STATUS: (P,)
  void* partials;              // scratch: the groups' partial sums (double)
  unsigned* bar;               // scratch: the grid barrier (count, generation; 0, any between launches)
  // finish: total_energy's prior and affine terms at the evaluated state
  const float* H_m;            // (D, D)
  const float* b_m;            // (D,)
  const float* e_in;           // FINISH: the photometric energy (device scalar)
  const float* e_extra;        // added last (the mixed BA's reprojection energy), or null
  float* E;                    // FIN_ENERGY: out; FIN_ACCEPT: the held energy, in and out
  float* lam_io;               // FIN_ENERGY with init_lam: out; FIN_ACCEPT: in and out
  // FIN_ACCEPT: dst = accept ? cand : src (cand = the evaluated state: R, t, ab, delta)
  const float* src_R; const float* src_t; const float* src_ab; const float* src_delta;
  const float* src_idepth; const float* cand_idepth;
  float* dst_R; float* dst_t; float* dst_ab; float* dst_delta; float* dst_idepth;
  const float* src_extra; const float* cand_extra; float* dst_extra;   // (Q,) or null
  float* trace;                // FIN_ACCEPT: (E, E_new) of the step, or null
  Ind ind;                     // SYSTEM, ENERGY: the reprojection factors
};

// The solve's arguments (ops/ba_sweep.py SolveArgs mirrors them).
struct SolveArgs {
  int F, P, mesh;
  float prior_a, prior_b, idepth_min, idepth_max;
  int Q;                            // reprojection factor points (0: none)
  const float* H; const float* b;   // the reduced sweep: H - H_corr, b - b_corr
  // the reprojection terms (the sweep's Ind sums), or null
  const float* Hi; const float* bi; const float* Hi_corr; const float* bi_corr;
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
  float* dx;                        // (D,) the step (written, then read back by every block)
  unsigned* bar;                    // the grid barrier
  // the factor points' rows (Q > 0): (Q,), (Q,), (Q, D); their inverse depths
  // in, and the candidate's out (every rank's whole, with a mesh too)
  const float* Hi_rho_d; const float* bi_rho; const float* Hi_xr;
  const uint8_t* ind_valid; const float* ind_idepth; float* ind_idepth_out;
};

// A (point, target) pair's sums and FEJ geometry.
struct Pair {
  float At[12];   // FEJ d(pixel)/d(target state), rows u then v
  float Ah[12];   // FEJ d(pixel)/d(host state)
  float a[2];     // FEJ d(pixel)/d(idepth)
  float s0;       // FEJ brightness scale exp(a_f - a_h)
  float Z[10];    // sum w z z^T, upper triangle row by row
  float zr[4];    // sum w z r
};

// A reprojection pair's linearization at the current state (phase A of a
// reprojection group; it takes a Pair's place).
struct IndPair {
  float Jt[12];   // d(pixel)/d(target pose), rows u then v
  float Jh[12];   // d(pixel)/d(host pose)
  float Jr[2];    // d(pixel)/d(idepth)
  float r[2];     // proj(T_f T_h^-1 X_h) - obs
  float w;        // mixed_weight x Huber weight / sigma2; 0 when inactive
};

// A block's shared memory during a sweep, a solve or a finish (a union: the
// phases of a launch never overlap); the rows a block keeps across the
// phases of a one-launch run_ba lie past it (ba_run.cu).
struct SweepShared {
  float relR[2][MAX_F * MAX_F][9];   // [cur, fej][h * MAX_F + f]: T_f o T_h^-1
  float relt[2][MAX_F * MAX_F][3];
  // the swept state's frames, read once a block (rel_poses): R, t current
  // then FEJ, ab, ab_fej, delta, frame_valid
  float fR[2][MAX_F][9], ft[2][MAX_F][3], fab[MAX_F][2], fabf[MAX_F][2], fdelta[MAX_F][8];
  int fvalid[MAX_F];
  union {
    Pair pair[NPAIR];
    IndPair ipair[NPAIR];
  };
  float form[NPAIR][NFORM];
  float pv[NPAIR][NPB_VALS];         // hr, br, hx[8] of each pair
  float e[NPAIR];
  int act[NPAIR];
  float scale[NPB], bs[NPB];         // Schur scale, b_rho x scale
  int host[NPB];
  double wsum[WARPS];
  double egroup;
  float fin[2 * MAX_D];              // finish: H_m delta, delta
  float e_photo;
  int flag;
};

struct SolveShared {
  __align__(16) float A[MAX_D][AS];  // the system, right-hand side in column D; then U
  float rcp[MAX_D];
  float x[MAX_D];
  float hd[MAX_D];
  float tile[128][XS];               // ba_solve.cu: a tile of H_xr rows
};

union Shared {
  SweepShared w;
  SolveShared v;
};

// A group's rows that a sweep keeps for the back-substitution: its H_xr rows,
// H_rho_d and b_rho (past the union; the run kernel keeps one set a group it
// owns).
constexpr int ROW_FLOATS = NPB * XS + 2 * NPB;
constexpr int ROW_BYTES = ROW_FLOATS * (int)sizeof(float);

// The block's dynamic shared memory, one symbol for every function here: a
// function that is not inlined still addresses it as shared memory.
extern __shared__ __align__(16) unsigned char ba_smem[];

__device__ __forceinline__ SweepShared& sweep_smem() {
  return reinterpret_cast<Shared*>(ba_smem)->w;
}
__device__ __forceinline__ SolveShared& solve_smem() {
  return reinterpret_cast<Shared*>(ba_smem)->v;
}
__device__ __forceinline__ float* smem_floats(int byte_offset) {
  return reinterpret_cast<float*>(ba_smem + byte_offset);
}

// A copy of the launch's arguments in shared memory, for every thread of the
// block: the functions below take them by reference, and a field read there
// is a shared-memory load, not one from the parameter space.
template <class T>
__device__ __forceinline__ const T& shared_args(T& dst, const T& src) {
  static_assert(sizeof(T) % sizeof(int) == 0, "copied as ints");
  for (int i = threadIdx.x; i < (int)(sizeof(T) / sizeof(int)); i += blockDim.x)
    reinterpret_cast<int*>(&dst)[i] = reinterpret_cast<const int*>(&src)[i];
  __syncthreads();
  return dst;
}

struct Rows {
  float (*X)[XS];
  float* hrd;
  float* brho;
};

__device__ __forceinline__ Rows rows_at(int byte_offset) {
  float* p = smem_floats(byte_offset);
  return {reinterpret_cast<float(*)[XS]>(p), p + NPB * XS, p + NPB * XS + NPB};
}

__device__ __forceinline__ float ldcg(const float* p) { return __ldcg(p); }

__device__ __forceinline__ float huber_w(float r, float k) {
  const float ar = fabsf(r);
  return ar <= k ? 1.0f : k / lm::clamp_min(ar, 1e-12f);
}

__device__ __forceinline__ float huber_e(float r, float k, float half_k) {
  const float ar = fabsf(r);
  return ar <= k ? 0.5f * r * r : k * (ar - half_k);
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

// Row d of L_t (host == false) or L_h (true): the 4-vector that maps z to
// J[k][d].
__device__ __forceinline__ void lrow(const Pair& q, bool host_side, int d, float L[4]) {
  const float* A = host_side ? q.Ah : q.At;
  const bool g = d < 6;
  const int c = g ? d : 0;
  L[0] = g ? A[c] : 0.0f;
  L[1] = g ? A[6 + c] : 0.0f;
  L[2] = d == 6 ? (host_side ? q.s0 : -q.s0) : 0.0f;
  L[3] = d == 7 ? (host_side ? q.s0 : -1.0f) : 0.0f;
}

// u = Z v for the packed symmetric 4x4 Z.
__device__ __forceinline__ void zmul(const float* Z, const float v[4], float u[4]) {
  u[0] = Z[0] * v[0] + Z[1] * v[1] + Z[2] * v[2] + Z[3] * v[3];
  u[1] = Z[1] * v[0] + Z[4] * v[1] + Z[5] * v[2] + Z[6] * v[3];
  u[2] = Z[2] * v[0] + Z[5] * v[1] + Z[7] * v[2] + Z[8] * v[3];
  u[3] = Z[3] * v[0] + Z[6] * v[1] + Z[8] * v[2] + Z[9] * v[3];
}

__device__ __forceinline__ float dot4(const float L[4], const float u[4]) {
  return ((L[0] * u[0] + L[1] * u[1]) + L[2] * u[2]) + L[3] * u[3];
}

// Row and column of entry t of a D x D upper triangle stored row by row.
__device__ __forceinline__ void upper_index(int t, int D, int& i, int& j) {
  const float b = 2.0f * D + 1.0f;
  int r = (int)((b - sqrtf(b * b - 8.0f * t)) * 0.5f);
  r = max(0, min(r, D - 1));
  while (r > 0 && t < r * D - r * (r - 1) / 2) --r;
  while (r + 1 < D && t >= (r + 1) * D - (r + 1) * r / 2) ++r;
  i = r;
  j = r + (t - (r * D - r * (r - 1) / 2));
}

// The partial-sum layout of SYSTEM / MARG: H's 8 x 8 slot blocks on and above
// the block diagonal, whole (nH entries: the plain form, too, sums both
// triangles of a diagonal block), H_corr on and above the diagonal, b,
// b_corr, the energy (last).
struct Layout {
  int D, nH, nc, total;
  __host__ __device__ explicit Layout(int F) {
    D = 8 * F;
    nH = F * (F + 1) / 2 * 64;
    nc = D * (D + 1) / 2;
    total = nH + nc + 2 * D + 1;
  }
};

// The slot block (fi <= fj) of block index bi on and above the block
// diagonal, row by row.
__device__ __forceinline__ void block_pair(int bi, int F, int& fi, int& fj) {
  fi = 0;
  while (bi >= F - fi) {
    bi -= F - fi;
    ++fi;
  }
  fj = fi + bi;
}

__host__ __device__ __forceinline__ int groups(int P) { return (P + NPB - 1) / NPB; }

// Every block of the grid arrives, then waits until all have: an integer
// ticket and a generation number, no floating-point atomic. The grid must be
// co-resident (a cooperative launch); a wait that never ends traps instead
// of hanging the card. Data written before the barrier by another block is
// read after it with __ldcg.
__device__ __forceinline__ void grid_barrier(unsigned* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned* vb = bar;
    const unsigned gen = vb[1];
    __threadfence();
    if (atomicAdd(bar, 1u) == gridDim.x - 1) {
      atomicExch(bar, 0u);
      __threadfence();
      atomicAdd(bar + 1, 1u);
    } else {
      unsigned spins = 0;
      while (vb[1] == gen) {
        __nanosleep(32);
        if (++spins == (1u << 30)) __trap();
      }
    }
    __threadfence();
  }
  __syncthreads();
}

// The swept state's frames into shared memory, and the relative poses of
// every (host h, target f): T_f o T_h^-1 (core/lie.py compose of inverse),
// current and FEJ (every thread of the block; the caller then waits at a
// block barrier).
// Inlined into each kernel, so its products and sums are written out as
// rounded intrinsics: nvcc may not contract them differently in different
// callers.
__device__ __forceinline__ float dot3(float a0, float b0, float a1, float b1, float a2,
                                      float b2) {
  return __fmaf_rn(a2, b2, __fmaf_rn(a1, b1, __fmul_rn(a0, b0)));
}

__device__ __forceinline__ void rel_poses(const Args& a) {
  SweepShared& s = sweep_smem();
  // the frames to shared memory first: every block reads the same few lines,
  // once a value (not once a thread)
  const int F = a.F, tid = threadIdx.x;
  for (int i = tid; i < F * 56; i += blockDim.x) {
    const int f = i / 56, k = i % 56;
    if (k < 9) s.fR[0][f][k] = ldcg(a.R + 9 * f + k);
    else if (k < 18) s.fR[1][f][k - 9] = ldcg(a.R_fej + 9 * f + k - 9);
    else if (k < 21) s.ft[0][f][k - 18] = ldcg(a.t + 3 * f + k - 18);
    else if (k < 24) s.ft[1][f][k - 21] = ldcg(a.t_fej + 3 * f + k - 21);
    else if (k < 26) s.fab[f][k - 24] = ldcg(a.ab + 2 * f + k - 24);
    else if (k < 28) s.fabf[f][k - 26] = a.ab_fej[2 * f + k - 26];
    else if (k < 36) s.fdelta[f][k - 28] = a.delta ? ldcg(a.delta + 8 * f + k - 28) : 0.0f;
    else if (k == 36) s.fvalid[f] = a.frame_valid[f];
  }
  __syncthreads();
  for (int i = tid; i < 2 * MAX_F * MAX_F; i += blockDim.x) {
    const int which = i / (MAX_F * MAX_F), hf = i % (MAX_F * MAX_F);
    const int h = hf / MAX_F, f = hf % MAX_F;
    if (h >= F || f >= F) continue;
    const float* Ri = s.fR[which][h];
    const float* Rj = s.fR[which][f];
    const float* ti = s.ft[which][h];
    const float* tj = s.ft[which][f];
    float ninv[3];   // -(R_i^T t_i)
#pragma unroll
    for (int r = 0; r < 3; ++r) ninv[r] = -dot3(Ri[r], ti[0], Ri[3 + r], ti[1], Ri[6 + r], ti[2]);
#pragma unroll
    for (int r = 0; r < 3; ++r) {
#pragma unroll
      for (int c = 0; c < 3; ++c)
        s.relR[which][hf][3 * r + c] = dot3(Rj[3 * r], Ri[3 * c], Rj[3 * r + 1], Ri[3 * c + 1],
                                            Rj[3 * r + 2], Ri[3 * c + 2]);
      s.relt[which][hf][r] =
          __fadd_rn(dot3(Rj[3 * r], ninv[0], Rj[3 * r + 1], ninv[1], Rj[3 * r + 2], ninv[2]),
                    tj[r]);
    }
  }
}

// Phase A: one (point, target) pair (thread t < NPAIR of the block; pair
// t = pl * MAX_F + f), in SYSTEM, ENERGY and STATUS (MARG: marg_pair).
__device__ __forceinline__ void sweep_pair(const Args& a, int mode, SweepShared& s, int t,
                                           int p) {
  const int f = t % MAX_F;
  Pair& q = s.pair[t];
  const bool sys = mode == SYSTEM;
  float e = 0.0f, Z[10], zr[4];
#pragma unroll
  for (int i = 0; i < 10; ++i) Z[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < 4; ++i) zr[i] = 0.0f;
  bool active = false;
  if (p < a.P && f < a.F) {
    const int h = a.host[p];
    const int F = a.F;
    const bool pv = a.point_valid[p] != 0;
    active = a.res_active[(size_t)p * F + f] && pv && s.fvalid[f] && s.fvalid[h] &&
             h != f;
    const float u = a.uv[2 * p], v = a.uv[2 * p + 1];
    const float rho = ldcg(a.idepth + p);
    const float ah = s.fab[h][0], bh = s.fab[h][1];
    const float s_ji = expf(s.fab[f][0] - ah);
    const float bj = s.fab[f][1];
    const float* Rc = s.relR[0][h * MAX_F + f];
    const float* tc = s.relt[0][h * MAX_F + f];

    // FEJ geometry at the point's centre
    float s0 = 0.0f, b0h = 0.0f, At[12], Ah[12], ar[2];
    if (sys) {
      const float* Rf = s.relR[1][h * MAX_F + f];
      const float* tf = s.relt[1][h * MAX_F + f];
      const float rho0 = a.idepth_fej[p];
      const float d0 = 1.0f / lm::clamp_min(rho0, 1e-12f);
      const float Xi[3] = {((u - a.cx) / a.fx) * d0, ((v - a.cy) / a.fy) * d0, 1.0f * d0};
      float Xj[3];
#pragma unroll
      for (int r = 0; r < 3; ++r)
        Xj[r] = ((Rf[3 * r] * Xi[0] + Rf[3 * r + 1] * Xi[1]) + Rf[3 * r + 2] * Xi[2]) + tf[r];
      const float iz = 1.0f / lm::clamp_min(Xj[2], 1e-8f);
      const float iz2 = iz * iz;
      const float Ju[3] = {a.fx * iz, 0.0f, (-a.fx * Xj[0]) * iz2};
      const float Jv[3] = {0.0f, a.fy * iz, (-a.fy * Xj[1]) * iz2};
      // [I | -skew(Xj)] and -R_fej [I | -skew(Xi)]
      const float Sj[3][3] = {{0.0f, Xj[2], -Xj[1]}, {-Xj[2], 0.0f, Xj[0]}, {Xj[1], -Xj[0], 0.0f}};
      const float Si[3][3] = {{0.0f, Xi[2], -Xi[1]}, {-Xi[2], 0.0f, Xi[0]}, {Xi[1], -Xi[0], 0.0f}};
      float Mh[3][6];
#pragma unroll
      for (int r = 0; r < 3; ++r) {
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          Mh[r][c] = -Rf[3 * r + c];
          Mh[r][3 + c] =
              -((Rf[3 * r] * Si[0][c] + Rf[3 * r + 1] * Si[1][c]) + Rf[3 * r + 2] * Si[2][c]);
        }
      }
#pragma unroll
      for (int c = 0; c < 6; ++c) {
        float tu, tv;
        if (c < 3) {
          tu = Ju[c];
          tv = Jv[c];
        } else {
          tu = (Ju[0] * Sj[0][c - 3] + Ju[1] * Sj[1][c - 3]) + Ju[2] * Sj[2][c - 3];
          tv = (Jv[0] * Sj[0][c - 3] + Jv[1] * Sj[1][c - 3]) + Jv[2] * Sj[2][c - 3];
        }
        At[c] = tu;
        At[6 + c] = tv;
        Ah[c] = (Ju[0] * Mh[0][c] + Ju[1] * Mh[1][c]) + Ju[2] * Mh[2][c];
        Ah[6 + c] = (Jv[0] * Mh[0][c] + Jv[1] * Mh[1][c]) + Jv[2] * Mh[2][c];
      }
      const float rc = lm::clamp_min(rho0, 1e-8f);
      const float dX[3] = {-(Xj[0] - tf[0]) / rc, -(Xj[1] - tf[1]) / rc, -(Xj[2] - tf[2]) / rc};
      ar[0] = (Ju[0] * dX[0] + Ju[1] * dX[1]) + Ju[2] * dX[2];
      ar[1] = (Jv[0] * dX[0] + Jv[1] * dX[1]) + Jv[2] * dX[2];
      s0 = expf(s.fabf[f][0] - s.fabf[h][0]);
      b0h = s.fabf[h][1];
    }

    // the current-state warp of the 8 pattern pixels
    const float depth = 1.0f / lm::clamp_min(rho, 1e-12f);
    const float* img = a.images + (size_t)f * a.img_h * a.img_w * 3;
    bool geo_ok = true;
#pragma unroll
    for (int k = 0; k < NPAT; ++k) {
      const float pu = u + PAT_U[k], pv_ = v + PAT_V[k];
      const float X[3] = {((pu - a.cx) / a.fx) * depth, ((pv_ - a.cy) / a.fy) * depth,
                          1.0f * depth};
      float Y[3];
#pragma unroll
      for (int r = 0; r < 3; ++r)
        Y[r] = ((Rc[3 * r] * X[0] + Rc[3 * r + 1] * X[1]) + Rc[3 * r + 2] * X[2]) + tc[r];
      const float z = Y[2];
      const float iz = 1.0f / (fabsf(z) < 1e-12f ? 1e-12f : z);
      const float uj = a.fx * Y[0] * iz + a.cx;
      const float vj = a.fy * Y[1] * iz + a.cy;
      geo_ok = geo_ok && z > 1e-6f && uj >= 2.0f && uj <= (float)a.img_w - 3.0f && vj >= 2.0f &&
               vj <= (float)a.img_h - 3.0f;
      float smp[3];
      bilinear3(img, a.img_w, a.img_h, uj, vj, smp);
      const float col = a.color[(size_t)p * NPAT + k];
      const float wk = a.weight[(size_t)p * NPAT + k];
      const float r = (smp[0] - bj) - s_ji * (col - bh);
      e += wk * huber_e(r, a.huber_k, a.half_k);
      if (sys) {
        const float w = huber_w(r, a.huber_k) * wk;
        const float c0 = col - b0h;
        const float zk[4] = {smp[1], smp[2], c0, 1.0f};
        int i = 0;
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const float wz = w * zk[m];
#pragma unroll
          for (int n = m; n < 4; ++n) Z[i++] += wz * zk[n];
          zr[m] += wz * r;
        }
      }
    }
    active = active && geo_ok;
    if (sys) {
#pragma unroll
      for (int i = 0; i < 12; ++i) {
        q.At[i] = At[i];
        q.Ah[i] = Ah[i];
      }
      q.a[0] = ar[0];
      q.a[1] = ar[1];
      q.s0 = s0;
    }
  }
  if (!active) {
    e = 0.0f;
#pragma unroll
    for (int i = 0; i < 10; ++i) Z[i] = 0.0f;
#pragma unroll
    for (int i = 0; i < 4; ++i) zr[i] = 0.0f;
  }
  if (sys) {
    if (!(p < a.P && f < a.F)) {
#pragma unroll
      for (int i = 0; i < 12; ++i) q.At[i] = q.Ah[i] = 0.0f;
      q.a[0] = q.a[1] = q.s0 = 0.0f;
    }
#pragma unroll
    for (int i = 0; i < 10; ++i) q.Z[i] = Z[i];
#pragma unroll
    for (int i = 0; i < 4; ++i) q.zr[i] = zr[i];
  }
  s.e[t] = e;
  s.act[t] = active;
}

// Phase A of MARG (_marg_pieces: the points hosted in `slot`), in double.
// The marginalization's sums go to the host's float64 Schur, where b_pts and
// b_corr are sums whose terms cancel: a residual rounded in float32 (a
// sample at a pixel projected in float32, less the host colour's affine
// image; ~1e-4 of the residual) reaches them at up to ~1e-2 of their
// largest entry on a real window, in the plain form as in a float32 sweep
// (PERF.md). So the pair's relative poses, the current-state warp and
// bilinear samples of the 8 pixels, the residuals, the Huber weights, the
// FEJ shift r - J_t d_t - J_h d_h - J_rho d_rho, the FEJ geometry and the
// sums Z and zr are taken here in double from the float32 inputs, in the
// plain form's formulas, and rounded once into the Pair; phases F to D are
// those of SYSTEM. The plain form's float64 run (_marg_pieces_plain on a
// float64 state) is then matched to float32 rounding of Z and zr.
__device__ __forceinline__ double dclamp_min(double x, double m) { return x < m ? m : x; }
__device__ __forceinline__ double dclamp_max(double x, double m) { return x > m ? m : x; }

// T_f o T_h^-1 in double from the frames' float32 poses (core/lie.py).
__device__ __forceinline__ void rel_pose_f64(const float* Rh, const float* th, const float* Rf,
                                             const float* tf, double R[9], double t[3]) {
  double ninv[3];
#pragma unroll
  for (int r = 0; r < 3; ++r)
    ninv[r] = -((double)Rh[r] * th[0] + (double)Rh[3 + r] * th[1] + (double)Rh[6 + r] * th[2]);
#pragma unroll
  for (int r = 0; r < 3; ++r) {
#pragma unroll
    for (int c = 0; c < 3; ++c)
      R[3 * r + c] = (double)Rf[3 * r] * Rh[3 * c] + (double)Rf[3 * r + 1] * Rh[3 * c + 1] +
                     (double)Rf[3 * r + 2] * Rh[3 * c + 2];
    t[r] = (double)Rf[3 * r] * ninv[0] + (double)Rf[3 * r + 1] * ninv[1] +
           (double)Rf[3 * r + 2] * ninv[2] + (double)tf[r];
  }
}

__device__ __forceinline__ void marg_pair(const Args& a, SweepShared& s, int t, int p, int slot) {
  const int f = t % MAX_F;
  Pair& q = s.pair[t];
  double e = 0.0, Z[10], zr[4], At[12], Ah[12], ar[2] = {0.0, 0.0}, s0 = 0.0;
#pragma unroll
  for (int i = 0; i < 10; ++i) Z[i] = 0.0;
#pragma unroll
  for (int i = 0; i < 4; ++i) zr[i] = 0.0;
#pragma unroll
  for (int i = 0; i < 12; ++i) At[i] = Ah[i] = 0.0;
  bool active = false;
  if (p < a.P && f < a.F) {
    const int h = a.host[p];
    const int F = a.F;
    const bool pv = a.point_valid[p] != 0 && h == slot;
    active = a.res_active[(size_t)p * F + f] && pv && s.fvalid[f] && s.fvalid[h] && h != f;
    const double fx = a.fx, fy = a.fy, cx = a.cx, cy = a.cy;
    const double u = a.uv[2 * p], v = a.uv[2 * p + 1];
    const double rho = ldcg(a.idepth + p);
    const double rho0 = a.idepth_fej[p];
    const double ah = s.fab[h][0], bh = s.fab[h][1];
    const double s_ji = exp((double)s.fab[f][0] - ah);
    const double bj = s.fab[f][1];
    double Rc[9], tc[3], Rf[9], tf[3];
    rel_pose_f64(s.fR[0][h], s.ft[0][h], s.fR[0][f], s.ft[0][f], Rc, tc);
    rel_pose_f64(s.fR[1][h], s.ft[1][h], s.fR[1][f], s.ft[1][f], Rf, tf);

    // FEJ geometry at the point's centre (linearize, proj_jacobian)
    const double d0 = 1.0 / dclamp_min(rho0, 1e-12);
    const double Xi[3] = {((u - cx) / fx) * d0, ((v - cy) / fy) * d0, d0};
    double Xj[3];
#pragma unroll
    for (int r = 0; r < 3; ++r)
      Xj[r] = Rf[3 * r] * Xi[0] + Rf[3 * r + 1] * Xi[1] + Rf[3 * r + 2] * Xi[2] + tf[r];
    const double iz = 1.0 / dclamp_min(Xj[2], 1e-8);
    const double iz2 = iz * iz;
    const double Ju[3] = {fx * iz, 0.0, -fx * Xj[0] * iz2};
    const double Jv[3] = {0.0, fy * iz, -fy * Xj[1] * iz2};
    const double Sj[3][3] = {{0.0, Xj[2], -Xj[1]}, {-Xj[2], 0.0, Xj[0]}, {Xj[1], -Xj[0], 0.0}};
    const double Si[3][3] = {{0.0, Xi[2], -Xi[1]}, {-Xi[2], 0.0, Xi[0]}, {Xi[1], -Xi[0], 0.0}};
    double Mh[3][6];
#pragma unroll
    for (int r = 0; r < 3; ++r) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        Mh[r][c] = -Rf[3 * r + c];
        Mh[r][3 + c] =
            -(Rf[3 * r] * Si[0][c] + Rf[3 * r + 1] * Si[1][c] + Rf[3 * r + 2] * Si[2][c]);
      }
    }
#pragma unroll
    for (int c = 0; c < 6; ++c) {
      if (c < 3) {
        At[c] = Ju[c];
        At[6 + c] = Jv[c];
      } else {
        At[c] = Ju[0] * Sj[0][c - 3] + Ju[1] * Sj[1][c - 3] + Ju[2] * Sj[2][c - 3];
        At[6 + c] = Jv[0] * Sj[0][c - 3] + Jv[1] * Sj[1][c - 3] + Jv[2] * Sj[2][c - 3];
      }
      Ah[c] = Ju[0] * Mh[0][c] + Ju[1] * Mh[1][c] + Ju[2] * Mh[2][c];
      Ah[6 + c] = Jv[0] * Mh[0][c] + Jv[1] * Mh[1][c] + Jv[2] * Mh[2][c];
    }
    const double rc = dclamp_min(rho0, 1e-8);
    const double dX[3] = {-(Xj[0] - tf[0]) / rc, -(Xj[1] - tf[1]) / rc, -(Xj[2] - tf[2]) / rc};
    ar[0] = Ju[0] * dX[0] + Ju[1] * dX[1] + Ju[2] * dX[2];
    ar[1] = Jv[0] * dX[0] + Jv[1] * dX[1] + Jv[2] * dX[2];
    s0 = exp((double)s.fabf[f][0] - (double)s.fabf[h][0]);
    const double b0h = s.fabf[h][1];
    const float* dt = s.fdelta[f];
    const float* dh = s.fdelta[h];
    const double drho = rho - rho0;

    // the current-state warp of the 8 pattern pixels (camera.project,
    // ops/image.py bilinear_stack)
    const double depth = 1.0 / dclamp_min(rho, 1e-12);
    const float* img = a.images + (size_t)f * a.img_h * a.img_w * 3;
    const double u_max = a.img_w - 3.0, v_max = a.img_h - 3.0;
    bool geo_ok = true;
#pragma unroll 1
    for (int k = 0; k < NPAT; ++k) {
      const double X[3] = {((u + PAT_U[k] - cx) / fx) * depth, ((v + PAT_V[k] - cy) / fy) * depth,
                           depth};
      double Y[3];
#pragma unroll
      for (int r = 0; r < 3; ++r)
        Y[r] = Rc[3 * r] * X[0] + Rc[3 * r + 1] * X[1] + Rc[3 * r + 2] * X[2] + tc[r];
      const double izk = 1.0 / (fabs(Y[2]) < 1e-12 ? 1e-12 : Y[2]);
      const double uj = fx * Y[0] * izk + cx;
      const double vj = fy * Y[1] * izk + cy;
      geo_ok = geo_ok && Y[2] > 1e-6 && uj >= 2.0 && uj <= u_max && vj >= 2.0 && vj <= v_max;
      double x0f = dclamp_max(dclamp_min(floor(uj), 0.0), a.img_w - 2.0);
      double y0f = dclamp_max(dclamp_min(floor(vj), 0.0), a.img_h - 2.0);
      if (isnan(x0f)) x0f = 0.0;
      if (isnan(y0f)) y0f = 0.0;
      const double dx = dclamp_max(dclamp_min(uj - x0f, 0.0), 1.0);
      const double dy = dclamp_max(dclamp_min(vj - y0f, 0.0), 1.0);
      const float* p00 = img + ((size_t)(int)y0f * a.img_w + (int)x0f) * 3;
      const float* p10 = p00 + (size_t)a.img_w * 3;
      double smp[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const double top = (double)__ldg(p00 + c) * (1.0 - dx) + (double)__ldg(p00 + 3 + c) * dx;
        const double bot = (double)__ldg(p10 + c) * (1.0 - dx) + (double)__ldg(p10 + 3 + c) * dx;
        smp[c] = top * (1.0 - dy) + bot * dy;
      }
      const double col = a.color[(size_t)p * NPAT + k];
      const double wk = a.weight[(size_t)p * NPAT + k];
      const double r = (smp[0] - bj) - s_ji * (col - bh);
      const double ar_ = fabs(r);
      const double k_ = a.huber_k;
      e += wk * (ar_ <= k_ ? 0.5 * r * r : k_ * (ar_ - 0.5 * k_));
      const double w = (ar_ <= k_ ? 1.0 : k_ / dclamp_min(ar_, 1e-12)) * wk;
      const double c0 = col - b0h;
      // res_toZeroF: r - J_t d_t - J_h d_h - J_rho d_rho
      double jt = 0.0, jh = 0.0;
#pragma unroll
      for (int c = 0; c < 6; ++c) {
        jt += (smp[1] * At[c] + smp[2] * At[6 + c]) * dt[c];
        jh += (smp[1] * Ah[c] + smp[2] * Ah[6 + c]) * dh[c];
      }
      jt += -s0 * c0 * dt[6] - dt[7];
      jh += s0 * c0 * dh[6] + s0 * dh[7];
      const double rr = ((r - jt) - jh) - (smp[1] * ar[0] + smp[2] * ar[1]) * drho;
      const double zk[4] = {smp[1], smp[2], c0, 1.0};
      int i = 0;
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const double wz = w * zk[m];
#pragma unroll
        for (int n = m; n < 4; ++n) Z[i++] += wz * zk[n];
        zr[m] += wz * rr;
      }
    }
    active = active && geo_ok;
  }
  if (!active) {
    e = 0.0;
#pragma unroll
    for (int i = 0; i < 10; ++i) Z[i] = 0.0;
#pragma unroll
    for (int i = 0; i < 4; ++i) zr[i] = 0.0;
  }
#pragma unroll
  for (int i = 0; i < 12; ++i) {
    q.At[i] = (float)At[i];
    q.Ah[i] = (float)Ah[i];
  }
  q.a[0] = (float)ar[0];
  q.a[1] = (float)ar[1];
  q.s0 = (float)s0;
#pragma unroll
  for (int i = 0; i < 10; ++i) q.Z[i] = (float)Z[i];
#pragma unroll
  for (int i = 0; i < 4; ++i) q.zr[i] = (float)zr[i];
  s.e[t] = (float)e;
  s.act[t] = active;
}

// Phase F, the target side of pair t (thread t): L_t Z L_t^T and L_t zr when
// active (zeros when not); za = Z (a, 0, 0), the pair's H_rho and
// b_rho terms, the host block's terms L_h za, and the target block of the
// point's H_xr row, L_t za (X: the group's rows).
__device__ __forceinline__ void pair_target_forms(const Args& a, SweepShared& s, int t,
                                                  float (*X)[XS]) {
  const int pl = t / MAX_F, f = t % MAX_F;
  const Pair& q = s.pair[t];
  float* F = s.form[t];
  if (!s.act[t]) {
#pragma unroll
    for (int i = F_TT; i < F_TH; ++i) F[i] = 0.0f;
#pragma unroll
    for (int i = F_BT; i < F_BH; ++i) F[i] = 0.0f;
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      float Le[4], u[4];
      lrow(q, false, e, Le);
      zmul(q.Z, Le, u);
#pragma unroll
      for (int d = 0; d < 8; ++d) {
        float Ld[4];
        lrow(q, false, d, Ld);
        F[F_TT + d * 8 + e] = dot4(Ld, u);
      }
    }
#pragma unroll
    for (int d = 0; d < 8; ++d) {
      float Ld[4];
      lrow(q, false, d, Ld);
      F[F_BT + d] = dot4(Ld, q.zr);
    }
  }
  const float a4[4] = {q.a[0], q.a[1], 0.0f, 0.0f};
  float za[4];
  zmul(q.Z, a4, za);
  float* pv = s.pv[t];
  pv[0] = q.a[0] * za[0] + q.a[1] * za[1];
  pv[1] = q.a[0] * q.zr[0] + q.a[1] * q.zr[1];
#pragma unroll
  for (int d = 0; d < 8; ++d) {
    float L[4];
    lrow(q, true, d, L);
    pv[2 + d] = dot4(L, za);
  }
  if (f < a.F) {
#pragma unroll
    for (int d = 0; d < 8; ++d) {
      float L[4];
      lrow(q, false, d, L);
      X[pl][f * 8 + d] = dot4(L, za);
    }
  }
}

// Phase F, the host side of pair t (thread t + NPAIR): L_t Z L_h^T, L_h Z
// L_h^T and L_h zr, when active (zeros when not, so that phase C adds every
// pair without a test: x + 0 is x).
__device__ __forceinline__ void pair_host_forms(SweepShared& s, int t) {
  float* F = s.form[t];
  if (!s.act[t]) {
#pragma unroll
    for (int i = F_TH; i < F_BT; ++i) F[i] = 0.0f;
#pragma unroll
    for (int i = F_BH; i < NFORM; ++i) F[i] = 0.0f;
    return;
  }
  const Pair& q = s.pair[t];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    float Le[4], u[4];
    lrow(q, true, e, Le);
    zmul(q.Z, Le, u);
#pragma unroll
    for (int d = 0; d < 8; ++d) {
      float Ld[4];
      lrow(q, false, d, Ld);
      F[F_TH + d * 8 + e] = dot4(Ld, u);
    }
#pragma unroll
    for (int d = 0; d < 8; ++d) {
      float Ld[4];
      lrow(q, true, d, Ld);
      F[F_HH + d * 8 + e] = dot4(Ld, u);
    }
  }
#pragma unroll
  for (int d = 0; d < 8; ++d) {
    float Ld[4];
    lrow(q, true, d, Ld);
    F[F_BH + d] = dot4(Ld, q.zr);
  }
}

// Phase A of a reprojection group (_linearize_indirect): pair t = pl * MAX_F
// + f (thread t < NPAIR) of factor point q, at the current poses and inverse
// depth (no FEJ): X_t = T_f T_h^-1 X_h, the residual proj(X_t) - obs, J_t =
// J_uv [I | -skew(X_t)], J_h = -J_uv R [I | -skew(X_h)], J_rho = -J_uv (X_t -
// t) / rho, the mask (the observation, the point, both slots valid, not the
// host slot, z > 1e-6 and z > 1e-4) and the Huber weight and energy at
// chi2 = |r|^2 / sigma2 against CHI2_2D, in the plain form's formulas (the
// energy before mixed_weight). `sys`: the linearization kept for phase F.
__device__ __forceinline__ void ind_pair(const Args& a, SweepShared& s, int t, int q, bool sys) {
  const Ind& d = a.ind;
  const int f = t % MAX_F, F = a.F;
  float e = 0.0f, w = 0.0f, Jt[12], Jh[12], Jr[2] = {0.0f, 0.0f}, r[2] = {0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < 12; ++i) Jt[i] = Jh[i] = 0.0f;
  bool active = false;
  if (q < d.Q && f < F) {
    const int h = d.host[q];
    const float rho = ldcg(d.idepth + q);
    const float depth = 1.0f / lm::clamp_min(rho, 1e-12f);
    const float u = d.uv[2 * q], v = d.uv[2 * q + 1];
    const float Xh[3] = {((u - a.cx) / a.fx) * depth, ((v - a.cy) / a.fy) * depth, 1.0f * depth};
    const float* R = s.relR[0][h * MAX_F + f];
    const float* tt = s.relt[0][h * MAX_F + f];
    float Xt[3];
#pragma unroll
    for (int k = 0; k < 3; ++k)
      Xt[k] = ((R[3 * k] * Xh[0] + R[3 * k + 1] * Xh[1]) + R[3 * k + 2] * Xh[2]) + tt[k];
    const float z = Xt[2];
    const float inv_z = 1.0f / (fabsf(z) < 1e-12f ? 1e-12f : z);
    const size_t o = (size_t)q * F + f;
    r[0] = (a.fx * Xt[0] * inv_z + a.cx) - d.obs_uv[2 * o];
    r[1] = (a.fy * Xt[1] * inv_z + a.cy) - d.obs_uv[2 * o + 1];
    const float iz = 1.0f / lm::clamp_min(z, 1e-8f);
    const float iz2 = iz * iz;
    const float Ju[3] = {a.fx * iz, 0.0f, (-a.fx * Xt[0]) * iz2};
    const float Jv[3] = {0.0f, a.fy * iz, (-a.fy * Xt[1]) * iz2};
    // -skew(X_t), -skew(X_h), and -R [I | -skew(X_h)]
    const float St[3][3] = {{0.0f, Xt[2], -Xt[1]}, {-Xt[2], 0.0f, Xt[0]}, {Xt[1], -Xt[0], 0.0f}};
    const float Sh[3][3] = {{0.0f, Xh[2], -Xh[1]}, {-Xh[2], 0.0f, Xh[0]}, {Xh[1], -Xh[0], 0.0f}};
    float Mh[3][6];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        Mh[k][c] = -R[3 * k + c];
        Mh[k][3 + c] =
            -((R[3 * k] * Sh[0][c] + R[3 * k + 1] * Sh[1][c]) + R[3 * k + 2] * Sh[2][c]);
      }
    }
#pragma unroll
    for (int c = 0; c < 6; ++c) {
      if (c < 3) {
        Jt[c] = Ju[c];
        Jt[6 + c] = Jv[c];
      } else {
        Jt[c] = (Ju[0] * St[0][c - 3] + Ju[1] * St[1][c - 3]) + Ju[2] * St[2][c - 3];
        Jt[6 + c] = (Jv[0] * St[0][c - 3] + Jv[1] * St[1][c - 3]) + Jv[2] * St[2][c - 3];
      }
      Jh[c] = (Ju[0] * Mh[0][c] + Ju[1] * Mh[1][c]) + Ju[2] * Mh[2][c];
      Jh[6 + c] = (Jv[0] * Mh[0][c] + Jv[1] * Mh[1][c]) + Jv[2] * Mh[2][c];
    }
    const float rc = lm::clamp_min(rho, 1e-8f);
    const float dX[3] = {-(Xt[0] - tt[0]) / rc, -(Xt[1] - tt[1]) / rc, -(Xt[2] - tt[2]) / rc};
    Jr[0] = (Ju[0] * dX[0] + Ju[1] * dX[1]) + Ju[2] * dX[2];
    Jr[1] = (Jv[0] * dX[0] + Jv[1] * dX[1]) + Jv[2] * dX[2];
    active = d.obs_valid[o] && d.point_valid[q] && s.fvalid[f] && s.fvalid[h] && h != f &&
             z > 1e-6f && z > 1e-4f;
    const float sg = d.sigma2[o];
    const float chi2 = (r[0] * r[0] + r[1] * r[1]) / sg;
    const float hub = chi2 > CHI2_2D ? sqrtf(CHI2_2D / lm::clamp_min(chi2, 1e-12f)) : 1.0f;
    if (active) {
      w = (d.mixed_weight * hub) / sg;
      e = chi2 <= CHI2_2D ? chi2 : 2.0f * sqrtf(CHI2_2D * lm::clamp_min(chi2, 1e-12f)) - CHI2_2D;
    }
  }
  if (sys) {
    IndPair& p = s.ipair[t];
#pragma unroll
    for (int i = 0; i < 12; ++i) {
      p.Jt[i] = Jt[i];
      p.Jh[i] = Jh[i];
    }
    p.Jr[0] = Jr[0];
    p.Jr[1] = Jr[1];
    p.r[0] = r[0];
    p.r[1] = r[1];
    p.w = w;
  }
  s.e[t] = e;
  s.act[t] = active;
}

// Phase F of a reprojection pair, its target side (thread t): J_t^T W J_t
// and J_t^T W r into the pair's forms, the pair's shares of H_rho (J_rho^T
// W J_rho), b_rho (J_rho^T W r) and the host block of the H_xr row (J_h^T W
// J_rho), and the target block of the point's H_xr row (J_t^T W J_rho);
// the affine rows and columns zero, and every value zero when inactive
// (_assemble_indirect's pose-only terms, a form each as the photometric
// pairs' in pair_target_forms).
__device__ __forceinline__ void ind_target_forms(const Args& a, SweepShared& s, int t,
                                                 float (*X)[XS]) {
  const int pl = t / MAX_F, f = t % MAX_F;
  const IndPair& q = s.ipair[t];
  float* F = s.form[t];
  float* pv = s.pv[t];
  const bool on = s.act[t] != 0;
  float wJr[2], wJ[12];
#pragma unroll
  for (int u = 0; u < 2; ++u) wJr[u] = q.w * q.Jr[u];
#pragma unroll
  for (int i = 0; i < 12; ++i) wJ[i] = q.w * q.Jt[i];
#pragma unroll
  for (int d = 0; d < 8; ++d) {
#pragma unroll
    for (int e = 0; e < 8; ++e)
      F[F_TT + d * 8 + e] = on && d < 6 && e < 6 ? wJ[d] * q.Jt[e] + wJ[6 + d] * q.Jt[6 + e] : 0.0f;
    F[F_BT + d] = on && d < 6 ? wJ[d] * q.r[0] + wJ[6 + d] * q.r[1] : 0.0f;
    pv[2 + d] = on && d < 6 ? q.Jh[d] * wJr[0] + q.Jh[6 + d] * wJr[1] : 0.0f;
    if (f < a.F) X[pl][f * 8 + d] = on && d < 6 ? q.Jt[d] * wJr[0] + q.Jt[6 + d] * wJr[1] : 0.0f;
  }
  pv[0] = on ? wJr[0] * q.Jr[0] + wJr[1] * q.Jr[1] : 0.0f;
  pv[1] = on ? wJr[0] * q.r[0] + wJr[1] * q.r[1] : 0.0f;
}

// Phase F of a reprojection pair, its host side (thread t + NPAIR): J_t^T W
// J_h, J_h^T W J_h and J_h^T W r (zeros when inactive).
__device__ __forceinline__ void ind_host_forms(SweepShared& s, int t) {
  const IndPair& q = s.ipair[t];
  float* F = s.form[t];
  const bool on = s.act[t] != 0;
  float wJt[12], wJh[12];
#pragma unroll
  for (int i = 0; i < 12; ++i) {
    wJt[i] = q.w * q.Jt[i];
    wJh[i] = q.w * q.Jh[i];
  }
#pragma unroll
  for (int d = 0; d < 8; ++d) {
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const bool in = on && d < 6 && e < 6;
      F[F_TH + d * 8 + e] = in ? wJt[d] * q.Jh[e] + wJt[6 + d] * q.Jh[6 + e] : 0.0f;
      F[F_HH + d * 8 + e] = in ? wJh[d] * q.Jh[e] + wJh[6 + d] * q.Jh[6 + e] : 0.0f;
    }
    F[F_BH + d] = on && d < 6 ? wJh[d] * q.r[0] + wJh[6 + d] * q.r[1] : 0.0f;
  }
}

// One entry of a group's partial sums (SYSTEM / MARG layout, not the energy):
// each quarter of the group's points (4 points) summed in point order, each
// term added in double, then the quarters in order, ((q0 + q1) + q2) + q3. An
// inactive pair's forms, and a missing point's row and scale, are zeros (x +
// 0 is x), so the loops run over all NPB points without a test and unroll: a
// thread's loads and conversions issue ahead of its adds.
__device__ __forceinline__ double group_entry(const SweepShared& s, const float (*X)[XS],
                                              const Layout& L, int task) {
  double acc[4] = {0.0, 0.0, 0.0, 0.0};
  if (task < L.nH) {   // H's slot blocks on and above the block diagonal
    int fi, fj;
    block_pair(task >> 6, L.D >> 3, fi, fj);
    const int d = (task >> 3) & 7, e = task & 7;
    if (fi == fj) {
      const int k = d * 8 + e;
#pragma unroll
      for (int pl = 0; pl < NPB; ++pl) {
        const int t = pl * MAX_F;
        acc[pl >> 2] += (double)s.form[t + fi][F_TT + k];
        if (s.host[pl] == fi) {
#pragma unroll
          for (int g = 0; g < MAX_F; ++g) acc[pl >> 2] += (double)s.form[t + g][F_HH + k];
        }
      }
    } else {
      const int o1 = F_TH + d * 8 + e, o2 = F_TH + e * 8 + d;
#pragma unroll
      for (int pl = 0; pl < NPB; ++pl) {
        const int t = pl * MAX_F, h = s.host[pl];
        if (h == fj) acc[pl >> 2] += (double)s.form[t + fi][o1];
        if (h == fi) acc[pl >> 2] += (double)s.form[t + fj][o2];
      }
    }
  } else if (task < L.nH + L.nc) {   // H_corr, on and above the diagonal
    int i, j;
    upper_index(task - L.nH, L.D, i, j);
#pragma unroll
    for (int pl = 0; pl < NPB; ++pl)
      acc[pl >> 2] += (double)((X[pl][i] * s.scale[pl]) * X[pl][j]);
  } else if (task < L.nH + L.nc + L.D) {   // b
    const int f = (task - L.nH - L.nc) >> 3, d = (task - L.nH - L.nc) & 7;
#pragma unroll
    for (int pl = 0; pl < NPB; ++pl) {
      const int t = pl * MAX_F;
      acc[pl >> 2] += (double)s.form[t + f][F_BT + d];
      if (s.host[pl] == f) {
#pragma unroll
        for (int g = 0; g < MAX_F; ++g) acc[pl >> 2] += (double)s.form[t + g][F_BH + d];
      }
    }
  } else {   // b_corr
    const int c = task - L.nH - L.nc - L.D;
#pragma unroll
    for (int pl = 0; pl < NPB; ++pl) acc[pl >> 2] += (double)(X[pl][c] * s.bs[pl]);
  }
  return ((acc[0] + acc[1]) + acc[2]) + acc[3];
}

// The group's energy: a tree over each warp's lanes (pair order), then the
// pair warps in order; ends with s.egroup set for every thread.
__device__ __forceinline__ void group_energy(SweepShared& s) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (warp < NPAIR / 32) {
    double e = (double)s.e[tid];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const double other = __shfl_down_sync(lm::FULL, e, o);
      if (lane % (2 * o) == 0) e += other;
    }
    if (lane == 0) s.wsum[warp] = e;
  }
  __syncthreads();
  if (tid == 0) {
    double acc = s.wsum[0];
    for (int w = 1; w < NPAIR / 32; ++w) acc += s.wsum[w];
    s.egroup = acc;
  }
  __syncthreads();
}

// Phases A-C of point group g in `mode` (every thread of the block): the
// group's partial sums to part (Layout(F).total entries in SYSTEM / MARG /
// IND_SYSTEM, the energy alone otherwise); its H_xr rows, H_rho_d and b_rho
// to the rows at byte `rows` of shared memory (SYSTEM / MARG / IND_SYSTEM);
// STATUS writes the residual status of its points. IND_SYSTEM and
// IND_ENERGY sweep group g of the reprojection factors a.ind instead of the
// state's points (phases A and F their own, B and C the photometric ones).
// Expects rel_poses of the swept state.
//
// This and the other functions that both the split kernels and the run
// kernel call are __noinline__ (and the mode a template argument): compiled
// apart from their callers, nvcc contracts the same products into the same
// FMAs in every kernel, so the routes give the same bits.
template <int mode>
__device__ __noinline__ void sweep_group(const Args& a, int slot, float lam, int g, double* part,
                                         int rows) {
  // stage: enter
  SweepShared& s = sweep_smem();
  const Rows R = rows_at(rows);
  float(*X)[XS] = R.X;
  const int tid = threadIdx.x;
  constexpr bool ind = mode == IND_SYSTEM || mode == IND_ENERGY;
  constexpr bool sys = mode == SYSTEM || mode == MARG || mode == IND_SYSTEM;
  const int n = ind ? a.ind.Q : a.P;
  const int32_t* host = ind ? a.ind.host : a.host;
  const uint8_t* pvalid = ind ? a.ind.point_valid : a.point_valid;
  const int base = g * NPB;
  const int np = min(NPB, n - base);
  if (sys)
    for (int i = tid; i < NPB * XS; i += THREADS) (&X[0][0])[i] = 0.0f;
  if (tid < NPB) s.host[tid] = base + tid < n ? host[base + tid] : -1;
  // stage: A0
  if (tid < NPAIR) {
    if (ind)
      ind_pair(a, s, tid, base + tid / MAX_F, sys);
    else if (mode == MARG)
      marg_pair(a, s, tid, base + tid / MAX_F, slot);
    else
      sweep_pair(a, mode, s, tid, base + tid / MAX_F);
  }
  __syncthreads();
  // stage: A
  group_energy(s);
  if (mode == STATUS && tid < np) {
    // update_residual_status: drop active residuals at or above the outlier
    // energy, and points left with no good residual
    const int p = base + tid;
    int n_good = 0;
    for (int f = 0; f < a.F; ++f) {
      const int t = tid * MAX_F + f;
      const bool good = s.act[t] && s.e[t] < a.outlier;
      n_good += good;
      a.res_active_out[(size_t)p * a.F + f] = a.res_active[(size_t)p * a.F + f] && (good || !s.act[t]);
    }
    a.point_valid_out[p] = a.point_valid[p] && n_good >= 1;
  }
  if (!sys) {
    if (tid == 0) part[0] = s.egroup;
    return;
  }

  // phase F: two threads a pair
  if (ind) {
    if (tid < NPAIR) ind_target_forms(a, s, tid, X);
    else ind_host_forms(s, tid - NPAIR);
  } else {
    if (tid < NPAIR) pair_target_forms(a, s, tid, X);
    else pair_host_forms(s, tid - NPAIR);
  }
  __syncthreads();
  // stage: F

  // phase B: nine threads a point
  if (tid < NPB * 9) {
    const int pl = tid / 9, c = tid % 9, p = base + pl;
    if (c == 0) {
      float hr = 0.0f, br = 0.0f;
      for (int f = 0; f < a.F; ++f) {
        hr += s.pv[pl * MAX_F + f][0];
        br += s.pv[pl * MAX_F + f][1];
      }
      float hd = 1.0f, sc = 0.0f;
      if (p < n) {
        bool valid = pvalid[p] != 0;
        if (mode == MARG) valid = valid && s.host[pl] == slot;
        if (valid) {
          hd = hr * (1.0f + lam) + a.rho_eps;
          sc = 1.0f / hd;
        }
      }
      R.hrd[pl] = hd;
      R.brho[pl] = br;
      s.scale[pl] = sc;
      s.bs[pl] = br * sc;
    } else if (p < n) {
      const int d = c - 1;
      float hx = 0.0f;
      for (int f = 0; f < a.F; ++f) hx += s.pv[pl * MAX_F + f][2 + d];
      X[pl][s.host[pl] * 8 + d] += hx;
    }
  }
  __syncthreads();
  // stage: B

  // phase C: the group's partial sums, each in point order
  const Layout L(a.F);
  for (int task = tid; task < L.total - 1; task += THREADS)
    part[task] = group_entry(s, X, L, task);
  if (tid == 0) part[L.total - 1] = s.egroup;
  // stage: C
}

// Phase D, spread over the card: a warp of the grid a chunk of 32 entries
// (chunk c to block c mod gridDim.x), each of the first `count` entries
// summed over the G groups' partials (`stride` doubles a group) in group
// order, acc = 0 and then groups 0..G-1; `store(task, value)` writes it.
template <class Store>
__device__ void reduce_entries(const double* part, int stride, int count, int G, Store store) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int c = blockIdx.x + gridDim.x * warp; c * 32 < count; c += gridDim.x * WARPS) {
    const int task = c * 32 + lane;
    if (task >= count) continue;
    double acc = 0.0;
    int g = 0;
    for (; g + 16 <= G; g += 16) {
      double v[16];
#pragma unroll
      for (int u = 0; u < 16; ++u) v[u] = __ldcg(part + (size_t)(g + u) * stride + task);
#pragma unroll
      for (int u = 0; u < 16; ++u) acc += v[u];
    }
    for (; g < G; ++g) acc += __ldcg(part + (size_t)g * stride + task);
    store(task, acc);
  }
}

// Phase D of a SYSTEM sweep: the Schur-complemented system, each entry's two
// sums (H's and H_corr's, b's and b_corr's) over the groups in group order,
// then their difference in double, rounded once: H - H_corr along the scale
// direction is ~1e6 of ~1e10 (PERF.md), so the two sums are not rounded to
// float32 apart. H takes S = H - H_corr, b takes b - b_corr; with `energy`,
// the last entry goes to estore. Chunks of 32 tasks over the grid as
// reduce_entries.
__device__ __forceinline__ double sum_groups(const double* part, int stride, int G, int task) {
  double acc = 0.0;
  int g = 0;
  for (; g + 16 <= G; g += 16) {
    double v[16];
#pragma unroll
    for (int u = 0; u < 16; ++u) v[u] = __ldcg(part + (size_t)(g + u) * stride + task);
#pragma unroll
    for (int u = 0; u < 16; ++u) acc += v[u];
  }
  for (; g < G; ++g) acc += __ldcg(part + (size_t)g * stride + task);
  return acc;
}

template <class EStore>
__device__ void reduce_system(const double* part, const Layout& L, int G, float* H, float* b,
                              bool energy, EStore estore) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, D = L.D;
  const int count = L.nH + D + (energy ? 1 : 0);
  for (int c = blockIdx.x + gridDim.x * warp; c * 32 < count; c += gridDim.x * WARPS) {
    const int task = c * 32 + lane;
    if (task >= count) continue;
    if (task < L.nH) {
      int fi, fj;
      block_pair(task >> 6, D >> 3, fi, fj);
      const int i = fi * 8 + ((task >> 3) & 7), j = fj * 8 + (task & 7);
      const int lo = min(i, j), hi = max(i, j);
      const int corr = L.nH + lo * D - lo * (lo - 1) / 2 + (hi - lo);
      const float v = (float)(sum_groups(part, L.total, G, task) -
                              sum_groups(part, L.total, G, corr));
      H[(size_t)i * D + j] = v;
      if (fi != fj) H[(size_t)j * D + i] = v;
    } else if (task < L.nH + D) {
      const int r = task - L.nH, main = L.nH + L.nc + r;
      b[r] = (float)(sum_groups(part, L.total, G, main) - sum_groups(part, L.total, G, main + D));
    } else {
      estore(sum_groups(part, L.total, G, L.total - 1));
    }
  }
}

// Phase D of a lone entry (the energy, `stride` doubles a group) by warp 0
// of the calling block: the warp loads the G partials into shared memory
// (`buf`, 256 doubles), lane 0 adds them in group order (acc = 0, then
// groups 0..G-1). Returns the sum to lane 0.
__device__ __forceinline__ double reduce_one(const double* part, int stride, int G, double* buf) {
  const int lane = threadIdx.x & 31;
  double acc = 0.0;
  for (int g0 = 0; g0 < G; g0 += 256) {
    const int n = min(256, G - g0);
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int g = u * 32 + lane;
      if (g < n) buf[g] = __ldcg(part + (size_t)(g0 + g) * stride);
    }
    __syncwarp();
    if (lane == 0)
      for (int g = 0; g < n; ++g) acc += buf[g];
    __syncwarp();
  }
  return acc;
}

// The block that phase D gives the last entry (the energy) to.
__device__ __forceinline__ int energy_block(int total) {
  return ((total - 1) / 32) % gridDim.x;
}

// Writes a reduced SYSTEM / MARG entry to the system's outputs (the
// energy to e_photo).
__device__ __forceinline__ void store_system(float* H, float* b, float* H_corr, float* b_corr,
                                             float* e_photo, const Layout& L, int task, float v) {
  const int D = L.D;
  if (task < L.nH) {
    int fi, fj;
    block_pair(task >> 6, D >> 3, fi, fj);
    const int d = (task >> 3) & 7, e = task & 7;
    H[(size_t)(fi * 8 + d) * D + fj * 8 + e] = v;
    if (fi != fj) H[(size_t)(fj * 8 + e) * D + fi * 8 + d] = v;
    return;
  }
  task -= L.nH;
  if (task < L.nc) {
    int i, j;
    upper_index(task, D, i, j);
    H_corr[(size_t)i * D + j] = v;
    H_corr[(size_t)j * D + i] = v;
    return;
  }
  task -= L.nc;
  if (task < D) {
    b[task] = v;
    return;
  }
  task -= D;
  if (task < D) {
    b_corr[task] = v;
    return;
  }
  if (e_photo) *e_photo = v;
}

// Phase D of a SYSTEM sweep's reprojection groups (a.ind.Q > 0): their four
// sums apart, each entry over the groups in group order and rounded once,
// to a.ind.H, b, H_corr, b_corr. Chunks over the grid as reduce_entries.
__device__ __forceinline__ void reduce_ind_system(const Args& a, const Layout& L) {
  if (a.ind.Q == 0) return;
  reduce_entries(static_cast<const double*>(a.ind.partials), L.total, L.total - 1,
                 groups(a.ind.Q), [&](int task, double v) {
                   store_system(a.ind.H, a.ind.b, a.ind.H_corr, a.ind.b_corr, nullptr, L, task,
                                (float)v);
                 });
}

// Phase D of the reprojection energy by warp 0 of the calling block
// (a.ind.Q > 0): the groups' partials in group order, rounded, times
// mixed_weight (indirect_energy), to *a.ind.e by thread 0. `buf`: 256
// doubles of shared memory.
__device__ __forceinline__ void reduce_ind_energy(const Args& a, double* buf) {
  if (a.ind.Q == 0 || threadIdx.x >= 32) return;
  const double e = reduce_one(static_cast<const double*>(a.ind.partials), 1, groups(a.ind.Q), buf);
  if (threadIdx.x == 0) *a.ind.e = a.ind.mixed_weight * (float)e;
}

// out[r] = sum_j M[r][j] v[j] for r < D (M row-major D x D in device memory,
// v in shared memory): a warp a row, lanes j and j + 32, then a tree over the
// lanes. Every thread of the block calls it.
__device__ __forceinline__ void matvec_rows(const float* M, const float* v, float* out, int D) {
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < D; r += WARPS) {
    float acc = 0.0f;
    for (int j = lane; j < D; j += 32) acc += M[(size_t)r * D + j] * v[j];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(lm::FULL, acc, o);
    if (lane == 0) out[r] = acc;
  }
}

// The finish of total_energy at the evaluated state (cand, or the state
// itself): E = (e_photo + e_prior) + 0.5 e_ab [+ extra], e_prior = b_m .
// delta + 0.5 delta . (H_m delta); then FIN_ENERGY stores it (and lambda's
// initial value), FIN_ACCEPT takes run_ba's accept test, lambda's update and
// the select of the frames (and with `points`, of every point's inverse
// depth and the extra values). One block; every sum in a fixed order.
// Returns the accept decision (FIN_ACCEPT) to every thread.
__device__ __noinline__ bool finish(const Args& a, float e_photo, int fin, float* trace,
                                    bool points) {
  SweepShared& s = sweep_smem();
  const int D = 8 * a.F, tid = threadIdx.x;
  float* hd = s.fin;            // (H_m delta)_i
  float* dl = s.fin + MAX_D;    // delta
  if (tid < D) dl[tid] = ldcg(a.delta + tid);
  __syncthreads();
  matvec_rows(a.H_m, dl, hd, D);
  __syncthreads();
  if (tid < 32) {
    float x = 0.0f, y = 0.0f;
    for (int i = tid; i < D; i += 32) {
      x += a.b_m[i] * dl[i];
      y += dl[i] * hd[i];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      x += __shfl_xor_sync(lm::FULL, x, o);
      y += __shfl_xor_sync(lm::FULL, y, o);
    }
    float eab = 0.0f;
    for (int f = 0; f < a.F; ++f) {
      const float av = ldcg(a.ab + 2 * f), bv = ldcg(a.ab + 2 * f + 1);
      eab += a.frame_valid[f] ? a.prior_a * (av * av) + a.prior_b * (bv * bv) : 0.0f;
    }
    if (tid == 0) {
      float E = (e_photo + (x + 0.5f * y)) + 0.5f * eab;
      if (a.e_extra) E = E + *a.e_extra;
      int accept = 0;
      if (fin == FIN_ENERGY) {
        *a.E = E;
        if (a.init_lam) *a.lam_io = a.lam_init;
      } else {
        const float E_old = ldcg(a.E);
        accept = E < E_old;
        if (trace) {
          trace[0] = E_old;
          trace[1] = E;
        }
        const float lam = ldcg(a.lam_io);
        *a.E = accept ? E : E_old;
        *a.lam_io = accept ? lm::clamp_min(lam * 0.4f, 1e-7f) : lm::clamp_max(lam * 5.0f, 1e2f);
      }
      s.flag = accept;
    }
  }
  __syncthreads();
  const bool accept = s.flag != 0;
  if (fin != FIN_ACCEPT) return false;
  for (int i = tid; i < a.F * 9; i += blockDim.x)
    a.dst_R[i] = accept ? ldcg(a.R + i) : ldcg(a.src_R + i);
  for (int i = tid; i < a.F * 3; i += blockDim.x)
    a.dst_t[i] = accept ? ldcg(a.t + i) : ldcg(a.src_t + i);
  for (int i = tid; i < a.F * 2; i += blockDim.x)
    a.dst_ab[i] = accept ? ldcg(a.ab + i) : ldcg(a.src_ab + i);
  for (int i = tid; i < a.F * 8; i += blockDim.x)
    a.dst_delta[i] = accept ? dl[i] : ldcg(a.src_delta + i);
  if (points) {
    for (int i = tid; i < a.P_total; i += blockDim.x)
      a.dst_idepth[i] = accept ? ldcg(a.cand_idepth + i) : ldcg(a.src_idepth + i);
    if (a.dst_extra)
      for (int i = tid; i < a.Q; i += blockDim.x)
        a.dst_extra[i] = accept ? ldcg(a.cand_extra + i) : ldcg(a.src_extra + i);
  }
  return accept;
}

// The damped system of an LM step in shared memory (every thread of the
// block): A = S [+ Hi] + H_m + diag(prior) [- Hi_corr] (S = H - H_corr, the
// system sweep's), damped as A + lambda diag(A) + 1e-6 I, and g = s [+ bi] +
// b_m + H_m delta + b_prior [- bi_corr] (s = b - b_corr) in A's column D.
__device__ __noinline__ void build_system(const SolveArgs& a) {
  SolveShared& s = solve_smem();
  const int D = 8 * a.F, tid = threadIdx.x;
  const float lam = ldcg(a.lam);
  if (tid < D) s.x[tid] = ldcg(a.delta + tid);
  __syncthreads();
  matvec_rows(a.H_m, s.x, s.hd, D);
  for (int i0 = tid; i0 < D * D; i0 += 4 * THREADS) {
    float hv[4], mv[4];   // the loads first, four entries a thread
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = min(i0 + u * THREADS, D * D - 1);
      hv[u] = ldcg(a.H + i);
      mv[u] = a.H_m[i];
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + u * THREADS;
      if (i >= D * D) break;
      const int r = i / D, c = i % D;
      float h = hv[u];
      if (a.Hi) h = h + ldcg(a.Hi + i);
      h = h + mv[u];
      const int f = r >> 3, k = r & 7;
      const bool fv = a.frame_valid[f] != 0;
      if (r == c) h = h + (fv ? (k == 6 ? a.prior_a : (k == 7 ? a.prior_b : 0.0f)) : 1.0f);
      if (a.Hi_corr) h = h - ldcg(a.Hi_corr + i);
      if (r == c) h = (h + lam * h) + 1e-6f;
      s.A[r][c] = h;
    }
  }
  __syncthreads();
  if (tid < D) {
    const int f = tid >> 3, k = tid & 7;
    const bool fv = a.frame_valid[f] != 0;
    float g = ldcg(a.b + tid);
    if (a.bi) g = g + ldcg(a.bi + tid);
    g = (g + a.b_m[tid]) + s.hd[tid];
    const float pw = k == 6 ? a.prior_a : (k == 7 ? a.prior_b : 0.0f);
    const float abv = k == 6 ? ldcg(a.ab + 2 * f) : (k == 7 ? ldcg(a.ab + 2 * f + 1) : 0.0f);
    g = g + (fv ? pw * abv : 0.0f);
    if (a.bi_corr) g = g - ldcg(a.bi_corr + tid);
    s.A[tid][D] = g;
  }
  __syncthreads();
}

// The pivot of column k (the lane's candidates' entries v0, v1 at positions
// pos0, pos1): the first row, in LAPACK's row order, of largest magnitude
// among positions k..D-1, a NaN never displacing the row at position k. The
// magnitudes as ordered integers (+1; 0 for none or a NaN) reduce over the
// warp in integer reductions (REDUX). Returns the pivot's position in p and
// its lane (+ 32 for a lane's second row) in owner.
__device__ __forceinline__ void lu_pivot(float v0, float v1, int pos0, int pos1, int k, int D,
                                         int& p, int& owner) {
  const int lane = threadIdx.x & 31;
  const float a0 = fabsf(v0), a1 = fabsf(v1);
  const unsigned k0 = pos0 >= k && pos0 < D && !isnan(a0) ? __float_as_uint(a0) + 1u : 0u;
  const unsigned k1 = pos1 >= k && pos1 < D && !isnan(a1) ? __float_as_uint(a1) + 1u : 0u;
  const unsigned m = __reduce_max_sync(lm::FULL, max(k0, k1));
  const unsigned first_bits = __reduce_or_sync(
      lm::FULL, pos0 == k ? __float_as_uint(v0) : (pos1 == k ? __float_as_uint(v1) : 0u));
  const unsigned row_k = __reduce_min_sync(
      lm::FULL, pos0 == k ? (unsigned)lane : (pos1 == k ? (unsigned)lane + 32u : 64u));
  const unsigned q = __reduce_min_sync(
      lm::FULL, min(m && k0 == m ? ((unsigned)pos0 << 6) | (unsigned)lane : ~0u,
                    m && k1 == m ? ((unsigned)pos1 << 6) | ((unsigned)lane + 32u) : ~0u));
  const float first = fabsf(__uint_as_float(first_bits));
  const bool swap = !(isnan(first) || m == 0u || !(__uint_as_float(m - 1u) > first));
  p = swap ? (int)(q >> 6) : k;
  owner = swap ? (int)(q & 63u) : (int)row_k;
}

// The LM step dx by warp 0 of the block (the other warps return at once).
// Lane l holds rows l and l + 32 of [A | g] in registers, __syncwarp only.
// Elimination with partial pivoting (lu_pivot). Rows never move: each lane
// tracks its rows' positions, which an interchange swaps as LAPACK's row
// interchange would, so every entry takes the same operations, a_ic -=
// (a_ik rcp_k) a_kc with rcp_k = 1 / a_kk (sgetf2's scaling; a row already
// eliminated takes m = 0). The lanes' columns shift left one a step (r[c]
// holds column k + c at step k), so the pivot column is always r[0]: the
// pivot row's lane writes it to U's row k in shared memory (the factors, by
// position), every lane reads it back as broadcasts, and the next column's
// pivot reduces while the rest of the step's columns update. Then
// back-substitution in position order from U, each row's sum a tree over
// the lanes' strided partial sums (a tree adds fewer roundings in a row
// than a chain); then the scale gauge (each valid slot's translation)
// projected out. Ends with s.x set (warp 0).
__device__ __noinline__ void warp_solve(const SolveArgs& a) {
  if (threadIdx.x >= 32) return;
  SolveShared& s = solve_smem();
  const int D = 8 * a.F, lane = threadIdx.x;
  float r0[MAX_D], r1[MAX_D];
#pragma unroll
  for (int c = 0; c < MAX_D; ++c) {
    r0[c] = (lane < D && c < D) ? s.A[min(lane, D - 1)][c] : 0.0f;
    r1[c] = (lane + 32 < D && c < D) ? s.A[min(lane + 32, D - 1)][c] : 0.0f;
  }
  float y0 = lane < D ? s.A[min(lane, D - 1)][D] : 0.0f;
  float y1 = lane + 32 < D ? s.A[min(lane + 32, D - 1)][D] : 0.0f;
  __syncwarp();   // A's rows read: U takes their place
  float(*U)[AS] = s.A;
  int pos0 = lane, pos1 = lane + 32;   // the rows' positions in LAPACK's order
  int p, owner;
  lu_pivot(r0[0], r1[0], pos0, pos1, 0, D, p, owner);
  for (int k = 0; k < D; ++k) {
    if (p != k) {   // the interchange of rows k and p: their positions
      pos0 = pos0 == k ? p : (pos0 == p ? k : pos0);
      pos1 = pos1 == k ? p : (pos1 == p ? k : pos1);
    }
    if (lane == (owner & 31)) {   // the pivot row: U's row k
      if (owner >= 32) {
#pragma unroll
        for (int c = 0; c < MAX_D; ++c) U[k][c] = r1[c];
        U[k][MAX_D] = y1;
      } else {
#pragma unroll
        for (int c = 0; c < MAX_D; ++c) U[k][c] = r0[c];
        U[k][MAX_D] = y0;
      }
    }
    __syncwarp();
    const float rk = __frcp_rn(U[k][0]);   // 1 / a_kk, rounded as the division
    if (lane == 0) s.rcp[k] = rk;
    const float m0 = pos0 > k && pos0 < D ? r0[0] * rk : 0.0f;
    const float m1 = pos1 > k && pos1 < D ? r1[0] * rk : 0.0f;
    // column k + 1 first, and its pivot; then the other columns, shifted
    r0[0] = r0[1] - m0 * U[k][1];
    r1[0] = r1[1] - m1 * U[k][1];
    if (k + 1 < D) lu_pivot(r0[0], r1[0], pos0, pos1, k + 1, D, p, owner);
#pragma unroll
    for (int c = 1; c < MAX_D - 1; ++c) {
      const float akc = U[k][c + 1];
      r0[c] = r0[c + 1] - m0 * akc;
      r1[c] = r1[c + 1] - m1 * akc;
    }
    r0[MAX_D - 1] = 0.0f;
    r1[MAX_D - 1] = 0.0f;
    y0 = y0 - m0 * U[k][MAX_D];
    y1 = y1 - m1 * U[k][MAX_D];
    __syncwarp();
  }
  // stage: eliminate
  // back-substitution in position order (U[i][j - i] is u_ij): x_k = (y_k -
  // sum_j>k u_kj x_j) rcp_k, the lanes' strided partial sums added by a tree
  // over the lanes
  for (int k = D - 1; k >= 0; --k) {
    float acc = 0.0f;
    for (int j = k + 1 + lane; j < D; j += 32) acc += U[k][j - k] * s.x[j];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(lm::FULL, acc, o);
    if (lane == 0) s.x[k] = (U[k][MAX_D] - acc) * s.rcp[k];
    __syncwarp();
  }
  // project the scale gauge out: N_i = t_f[c] for c < 3 on valid slots
  float nn = 0.0f, nd = 0.0f;
  for (int i = lane; i < D; i += 32) {
    const int f = i >> 3, c = i & 7;
    const float n = c < 3 ? ldcg(a.t + 3 * f + c) * (a.frame_valid[f] ? 1.0f : 0.0f) : 0.0f;
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
    const float n = c < 3 ? ldcg(a.t + 3 * f + c) * (a.frame_valid[f] ? 1.0f : 0.0f) : 0.0f;
    s.x[i] = s.x[i] - n * coeff;
  }
  __syncwarp();
}

// The candidate frames (threads < F): exp(-dx) o T, ab - dx[6:], delta - dx on
// valid slots; and dx to a.dx (threads < D).
__device__ __noinline__ void update_frames(const SolveArgs& a) {
  const SolveShared& s = solve_smem();
  const int tid = threadIdx.x, D = 8 * a.F;
  if (tid < D) a.dx[tid] = s.x[tid];
  if (tid >= a.F) return;
  const int f = tid;
  const bool fv = a.frame_valid[f] != 0;
  float dxf[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) dxf[c] = fv ? s.x[8 * f + c] : 0.0f;
  float R[9], t[3];
#pragma unroll
  for (int i = 0; i < 9; ++i) R[i] = ldcg(a.R + 9 * f + i);
#pragma unroll
  for (int i = 0; i < 3; ++i) t[i] = ldcg(a.t + 3 * f + i);
  if (fv) {
    const float xi[6] = {-dxf[0], -dxf[1], -dxf[2], -dxf[3], -dxf[4], -dxf[5]};
    lm::se3_exp_compose(xi, R, t);
  }
#pragma unroll
  for (int i = 0; i < 9; ++i) a.R_out[9 * f + i] = R[i];
#pragma unroll
  for (int i = 0; i < 3; ++i) a.t_out[3 * f + i] = t[i];
  a.ab_out[2 * f] = ldcg(a.ab + 2 * f) - dxf[6];
  a.ab_out[2 * f + 1] = ldcg(a.ab + 2 * f + 1) - dxf[7];
#pragma unroll
  for (int c = 0; c < 8; ++c) a.delta_out[8 * f + c] = ldcg(a.delta + 8 * f + c) - dxf[c];
}

// A point's inverse-depth step d_rho = (b_rho - H_xr dx) / H_rho_d (0 where
// the point is invalid): the dot of the H_xr row at byte `row` of shared
// memory with dx at byte `x`, in column order.
__device__ __noinline__ float point_step(int row, int x, int D, float b_rho, float hrd,
                                         bool valid) {
  const float* r = smem_floats(row);
  const float* v = smem_floats(x);
  float acc = 0.0f;
  for (int j = 0; j < D; ++j) acc += r[j] * v[j];
  const float d = (b_rho - acc) / hrd;
  return valid ? d : 0.0f;
}

// The byte offset of p in the block's dynamic shared memory.
__device__ __forceinline__ int smem_offset(const void* p) {
  return (int)(static_cast<const unsigned char*>(p) - ba_smem);
}

__device__ __forceinline__ float clamp_idepth(float x, float lo, float hi) {
  return lm::clamp_max(lm::clamp_min(x, lo), hi);
}

// The blocks of THREADS threads that a cooperative launch of `kernel` with
// `smem` bytes of dynamic shared memory can keep resident on the current
// card (0 on an error), cached per device: each library launches one kernel
// through it.
inline int capacity(const void* kernel, size_t smem) {
  static int cached[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (cached[dev] == 0) {
    int sms = 0, per_sm = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem) !=
        cudaSuccess)
      return 0;
    cached[dev] = sms * per_sm;
  }
  return cached[dev];
}

}  // namespace ba
