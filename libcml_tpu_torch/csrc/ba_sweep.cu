// The windowed photometric BA's residual sweep for Hopper (sm_90a): one
// launch computes what the plain forms' linearize + _assemble +
// _schur_terms (or total_energy's photometric sum, or
// update_residual_status, or _marg_pieces' contraction) compute, without
// writing a Jacobian.
//
// Replaces the sweep of the JAX package's device program for the window BA:
// `linearize` (libcml_tpu/models/direct/ba.py:317), `_assemble` (:424) and
// `_schur_reduce` (:481) inside `run_ba`'s `lax.scan` (:619, :644), and the
// same sweep inside `total_energy` (:508), `update_residual_status` (:653)
// and `_marg_pieces` (:804). Its plain PyTorch forms are `_sweep_plain`,
// `total_energy_plain`, `update_residual_status_plain` and
// `_marg_pieces_plain` in libcml_tpu_torch/models/direct/ba.py.
//
// The residual of point p (host slot h) in target slot f at pattern pixel k
// has Jacobians that factor through z_k = (gx_k, gy_k, c_k, 1) (the sampled
// gradient, the host color less the host's FEJ offset, and 1):
//   J_t[k] = L_t z_k,  J_h[k] = L_h z_k,  J_rho[k] = (a, 0, 0) . z_k,
// with L_t, L_h (8 x 4) made of the pair's FEJ projection Jacobians A_t, A_h
// (2 x 6) and its brightness scale s0, and a = d(pixel)/d(idepth). So every
// normal-equation term of the pair is a form in Z = sum_k w_k z_k z_k^T (10
// sums) and zr = sum_k w_k z_k r_k (4 sums): L_t Z L_h^T, L_t zr, ... A
// thread sums Z and zr over its pair's 8 pixels and keeps 43 numbers; the
// (P, F, 8, 8) J_t and J_h (7.3 MB at P 2048, F 7) are never formed.
//
// Layout: a block of 256 threads owns 32 points (NPB), a thread a (point,
// target slot) pair (8 slots a point, MAX_F). Phase A: each thread sweeps its
// pair (the current-state warp and bilinear sample of 8 pixels, residuals,
// Huber weights and energy, the masks, FEJ geometry, Z, zr) into shared
// memory. Phase B: a thread a point sums its pairs into H_rho, b_rho and the
// host block of its H_xr row, and the damped Schur scale. Phase C: each thread
// owns entries of the block's partial sums (H by 8x8 slot blocks on and above
// the diagonal, H_corr's upper triangle, b, b_corr, the energy) and adds the
// block's pairs or points into each in index order, in double; a warp's lanes
// share one 8x8 block, so they branch alike. Phase D: the partials go to
// global scratch; the block that arrives last (an integer ticket, no
// floating-point atomic) sums every block's partials in block order and
// writes H, b, H_corr, b_corr and the energy. Every sum runs in a fixed
// order, so a sweep gives the same bits on the same inputs.
//
// Modes: SYSTEM (the LM system with the lambda-damped Schur corrections, per
// point H_rho_d, b_rho and the H_xr row for the back-substitution, and the
// energy); ENERGY (the photometric energy only); STATUS (update_residual_status:
// the new res_active and point_valid, and the energy); MARG (_marg_pieces:
// the points hosted in a slot, the gradient from the FEJ-shifted residual
// r - J_t d_t - J_h d_h - J_rho d_rho, the Schur scale 1/(H_rho + 1e-12));
// FINISH (no sweep: one block completes an energy reduced elsewhere, e.g. by
// an all-reduce). With `fin`, the last block (or FINISH's block) also adds
// the prior and affine terms of total_energy and, for FIN_ACCEPT, takes run_ba's
// accept test, lambda's update and the state select on the device.
//
// What bounds it on the H100: with every (point, slot) pair active at P
// 2048, F 7 a sweep gathers ~5.5 MB of texels and does ~26 M FMA
// (linearize/assemble and the Schur term), about 2 us at the card's rates;
// the launch of 64 blocks is latency-bound instead (a dependent chain of
// phases, and the last block's serial sum of 64 partials; PERF.md).
//
// Arithmetic follows the plain forms' formulas and clamps (ops/image.py
// bilinear, core/camera.py project/unproject/in_bounds, residuals.py
// proj_jacobian and the Huber pair); sums run in another order than
// PyTorch's einsum and nvcc contracts products into FMAs, so results agree
// to f32 rounding, not bits.

#include <cstdint>
#include <cuda_runtime.h>

#include "lm_common.cuh"

namespace {

constexpr int MAX_F = 8;                 // frame slots
constexpr int MAX_D = MAX_F * 8;         // camera-state dimension
constexpr int NPB = 32;                  // points a block
constexpr int THREADS = NPB * MAX_F;     // a thread a (point, target slot) pair
constexpr int NPAT = 8;                  // residual pattern pixels

// residuals.py PATTERN (DSO's pattern #8)
__constant__ float PAT_U[NPAT] = {0.0f, -1.0f, 1.0f, -2.0f, 0.0f, 2.0f, -1.0f, 0.0f};
__constant__ float PAT_V[NPAT] = {-2.0f, -1.0f, -1.0f, 0.0f, 0.0f, 0.0f, 1.0f, 2.0f};

enum Mode { SYSTEM = 0, ENERGY = 1, STATUS = 2, MARG = 3, FINISH = 4 };
enum Fin { FIN_NONE = 0, FIN_ENERGY = 1, FIN_ACCEPT = 2 };

// The launch's arguments (mirrored field for field by ops/ba_sweep.py
// SweepArgs); pointers may be null where a mode does not use them.
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
  void* partials;              // scratch: a block's partial sums
  unsigned* counter;           // scratch: the arrival ticket (0 between launches)
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
};

// A (point, target) pair's sums and geometry.
struct Pair {
  float At[12];   // FEJ d(pixel)/d(target state), rows u then v
  float Ah[12];   // FEJ d(pixel)/d(host state)
  float a[2];     // FEJ d(pixel)/d(idepth)
  float s0;       // FEJ brightness scale exp(a_f - a_h)
  float Z[10];    // sum w z z^T, upper triangle row by row
  float zr[4];    // sum w z r
  float e;        // energy
  int act;        // active
};

struct Shared {
  float relR[2][MAX_F * MAX_F][9];   // [cur, fej][h * MAX_F + f]: T_f o T_h^-1
  float relt[2][MAX_F * MAX_F][3];
  Pair pair[THREADS];
  float X[NPB][MAX_D];               // H_xr rows
  float scale[NPB], bs[NPB];         // Schur scale, b_rho x scale
  int host[NPB];
  int last;
  float fin[2 * MAX_D + 2];
};

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

// L_?[d] Z L_?[e]^T of one pair.
__device__ __forceinline__ float zform(const Pair& q, bool dh, int d, bool eh, int e) {
  float Ld[4], Le[4], u[4];
  lrow(q, dh, d, Ld);
  lrow(q, eh, e, Le);
  zmul(q.Z, Le, u);
  return ((Ld[0] * u[0] + Ld[1] * u[1]) + Ld[2] * u[2]) + Ld[3] * u[3];
}

__device__ __forceinline__ float zrdot(const Pair& q, bool dh, int d) {
  float Ld[4];
  lrow(q, dh, d, Ld);
  return ((Ld[0] * q.zr[0] + Ld[1] * q.zr[1]) + Ld[2] * q.zr[2]) + Ld[3] * q.zr[3];
}

// Relative poses of every (host h, target f): T_f o T_h^-1 (core/lie.py
// compose of inverse), current and FEJ.
__device__ void rel_poses(const Args& a, Shared& s) {
  for (int i = threadIdx.x; i < 2 * MAX_F * MAX_F; i += blockDim.x) {
    const int which = i / (MAX_F * MAX_F), hf = i % (MAX_F * MAX_F);
    const int h = hf / MAX_F, f = hf % MAX_F;
    if (h >= a.F || f >= a.F) continue;
    const float* Rs = which ? a.R_fej : a.R;
    const float* ts = which ? a.t_fej : a.t;
    const float* Ri = Rs + 9 * h;
    const float* Rj = Rs + 9 * f;
    const float* ti = ts + 3 * h;
    const float* tj = ts + 3 * f;
    float ninv[3];   // -(R_i^T t_i)
#pragma unroll
    for (int r = 0; r < 3; ++r) ninv[r] = -((Ri[r] * ti[0] + Ri[3 + r] * ti[1]) + Ri[6 + r] * ti[2]);
#pragma unroll
    for (int r = 0; r < 3; ++r) {
#pragma unroll
      for (int c = 0; c < 3; ++c)
        s.relR[which][hf][3 * r + c] =
            (Rj[3 * r] * Ri[3 * c] + Rj[3 * r + 1] * Ri[3 * c + 1]) + Rj[3 * r + 2] * Ri[3 * c + 2];
      s.relt[which][hf][r] =
          ((Rj[3 * r] * ninv[0] + Rj[3 * r + 1] * ninv[1]) + Rj[3 * r + 2] * ninv[2]) + tj[r];
    }
  }
}

// Phase A: one (point, target) pair.
__device__ void sweep_pair(const Args& a, Shared& s, int pl, int f, int p, int slot) {
  Pair& q = s.pair[threadIdx.x];
  const bool sys = a.mode == SYSTEM || a.mode == MARG;
  float e = 0.0f, Z[10], zr[4];
#pragma unroll
  for (int i = 0; i < 10; ++i) Z[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < 4; ++i) zr[i] = 0.0f;
  bool active = false;
  if (p < a.P && f < a.F) {
    const int h = a.host[p];
    const int F = a.F;
    bool pv = a.point_valid[p] != 0;
    if (a.mode == MARG) pv = pv && h == slot;
    active = a.res_active[(size_t)p * F + f] && pv && a.frame_valid[f] && a.frame_valid[h] &&
             h != f;
    const float u = a.uv[2 * p], v = a.uv[2 * p + 1];
    const float rho = a.idepth[p];
    const float ah = a.ab[2 * h], bh = a.ab[2 * h + 1];
    const float s_ji = expf(a.ab[2 * f] - ah);
    const float bj = a.ab[2 * f + 1];
    const float* Rc = s.relR[0][h * MAX_F + f];
    const float* tc = s.relt[0][h * MAX_F + f];

    // FEJ geometry at the point's centre
    float s0 = 0.0f, b0h = 0.0f, At[12], Ah[12], ar[2], dt[8], dh[8], drho = 0.0f;
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
      s0 = expf(a.ab_fej[2 * f] - a.ab_fej[2 * h]);
      b0h = a.ab_fej[2 * h + 1];
      if (a.mode == MARG) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          dt[i] = a.delta[8 * f + i];
          dh[i] = a.delta[8 * h + i];
        }
        drho = rho - rho0;
      }
    }

    // the current-state warp of the 8 pattern pixels
    const float depth = 1.0f / lm::clamp_min(rho, 1e-12f);
    const float* img = a.images + (size_t)f * a.img_h * a.img_w * 3;
    bool geo_ok = true;
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
        float rr = r;
        if (a.mode == MARG) {
          // res_toZeroF: r - J_t d_t - J_h d_h - J_rho d_rho
          float jt = 0.0f, jh = 0.0f;
#pragma unroll
          for (int c = 0; c < 6; ++c) {
            jt += (smp[1] * At[c] + smp[2] * At[6 + c]) * dt[c];
            jh += (smp[1] * Ah[c] + smp[2] * Ah[6 + c]) * dh[c];
          }
          jt += (-s0 * c0) * dt[6] + (-1.0f) * dt[7];
          jh += (s0 * c0) * dh[6] + s0 * dh[7];
          const float jr = smp[1] * ar[0] + smp[2] * ar[1];
          rr = ((r - jt) - jh) - jr * drho;
        }
        int i = 0;
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const float wz = w * zk[m];
#pragma unroll
          for (int n = m; n < 4; ++n) Z[i++] += wz * zk[n];
          zr[m] += wz * rr;
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
  q.e = e;
  q.act = active;
}

// The finish of total_energy at the evaluated state (cand, or the state
// itself): E = (e_photo + e_prior) + e_ab [+ extra], e_prior = b_m . delta +
// 0.5 delta . (H_m delta); then FIN_ENERGY stores it (and lambda's initial
// value), FIN_ACCEPT takes run_ba's accept test, lambda's update and the
// select. One block; every sum in a fixed order.
__device__ void finish(const Args& a, Shared& s, float e_photo) {
  const int D = 8 * a.F, tid = threadIdx.x;
  float* hd = s.fin;            // (H_m delta)_i
  float* pr = s.fin + MAX_D;    // per warp-lane partials
  if (tid < D) {
    float acc = 0.0f;
    for (int j = 0; j < D; ++j) acc += a.H_m[(size_t)tid * D + j] * a.delta[j];
    hd[tid] = acc;
  }
  __syncthreads();
  if (tid < 32) {
    float x = 0.0f, y = 0.0f;
    for (int i = tid; i < D; i += 32) {
      x += a.b_m[i] * a.delta[i];
      y += a.delta[i] * hd[i];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      x += __shfl_xor_sync(lm::FULL, x, o);
      y += __shfl_xor_sync(lm::FULL, y, o);
    }
    float eab = 0.0f;
    for (int f = 0; f < a.F; ++f) {
      const float av = a.ab[2 * f], bv = a.ab[2 * f + 1];
      eab += a.frame_valid[f] ? a.prior_a * (av * av) + a.prior_b * (bv * bv) : 0.0f;
    }
    if (tid == 0) {
      float E = (e_photo + (x + 0.5f * y)) + 0.5f * eab;
      if (a.e_extra) E = E + *a.e_extra;
      if (a.fin == FIN_ENERGY) {
        *a.E = E;
        if (a.init_lam) *a.lam_io = a.lam_init;
        pr[0] = 0.0f;
      } else {
        const float E_old = *a.E;
        const bool accept = E < E_old;
        if (a.trace) {
          a.trace[0] = E_old;
          a.trace[1] = E;
        }
        const float lam = *a.lam_io;
        *a.E = accept ? E : E_old;
        *a.lam_io = accept ? lm::clamp_min(lam * 0.4f, 1e-7f) : lm::clamp_max(lam * 5.0f, 1e2f);
        pr[0] = accept ? 1.0f : 0.0f;
      }
    }
  }
  __syncthreads();
  if (a.fin != FIN_ACCEPT) return;
  const bool accept = pr[0] != 0.0f;
  for (int i = tid; i < a.F * 9; i += blockDim.x) a.dst_R[i] = accept ? a.R[i] : a.src_R[i];
  for (int i = tid; i < a.F * 3; i += blockDim.x) a.dst_t[i] = accept ? a.t[i] : a.src_t[i];
  for (int i = tid; i < a.F * 2; i += blockDim.x) a.dst_ab[i] = accept ? a.ab[i] : a.src_ab[i];
  for (int i = tid; i < a.F * 8; i += blockDim.x)
    a.dst_delta[i] = accept ? a.delta[i] : a.src_delta[i];
  for (int i = tid; i < a.P_total; i += blockDim.x)
    a.dst_idepth[i] = accept ? a.cand_idepth[i] : a.src_idepth[i];
  if (a.dst_extra)
    for (int i = tid; i < a.Q; i += blockDim.x)
      a.dst_extra[i] = accept ? a.cand_extra[i] : a.src_extra[i];
}

// The partial-sum layout of SYSTEM / MARG: H's 8x8 blocks (fi <= fj), H_corr's
// upper triangle, b, b_corr, the energy.
struct Layout {
  int nhb, nc, D, total;
  __device__ explicit Layout(int F) {
    D = 8 * F;
    nhb = F * (F + 1) / 2;
    nc = D * (D + 1) / 2;
    total = nhb * 64 + nc + 2 * D + 1;
  }
};

__device__ __forceinline__ void block_pair(int bi, int F, int& fi, int& fj) {
  fi = 0;
  while (bi >= F - fi) {
    bi -= F - fi;
    ++fi;
  }
  fj = fi + bi;
}

__device__ __forceinline__ void upper_index(int t, int D, int& i, int& j) {
  i = 0;
  while (t >= D - i) {
    t -= D - i;
    ++i;
  }
  j = i + t;
}

__device__ double system_partial(const Args& a, const Shared& s, const Layout& L, int task, int np) {
  const int F = a.F;
  double acc = 0;
  if (task < L.nhb * 64) {
    int fi, fj;
    block_pair(task >> 6, F, fi, fj);
    const int d = (task >> 3) & 7, e = task & 7;
    for (int pl = 0; pl < np; ++pl) {
      const int h = s.host[pl];
      if (fi == fj) {
        const Pair& q = s.pair[pl * MAX_F + fi];
        if (q.act) acc += (double)zform(q, false, d, false, e);
        if (h == fi)
          for (int g = 0; g < F; ++g) {
            const Pair& qg = s.pair[pl * MAX_F + g];
            if (qg.act) acc += (double)zform(qg, true, d, true, e);
          }
      } else {
        if (h == fj) {
          const Pair& q = s.pair[pl * MAX_F + fi];
          if (q.act) acc += (double)zform(q, false, d, true, e);
        }
        if (h == fi) {
          const Pair& q = s.pair[pl * MAX_F + fj];
          if (q.act) acc += (double)zform(q, false, e, true, d);
        }
      }
    }
    return acc;
  }
  task -= L.nhb * 64;
  if (task < L.nc) {
    int i, j;
    upper_index(task, L.D, i, j);
    for (int pl = 0; pl < np; ++pl) acc += (double)((s.X[pl][i] * s.scale[pl]) * s.X[pl][j]);
    return acc;
  }
  task -= L.nc;
  if (task < L.D) {
    const int f = task >> 3, d = task & 7;
    for (int pl = 0; pl < np; ++pl) {
      const Pair& q = s.pair[pl * MAX_F + f];
      if (q.act) acc += (double)zrdot(q, false, d);
      if (s.host[pl] == f)
        for (int g = 0; g < F; ++g) {
          const Pair& qg = s.pair[pl * MAX_F + g];
          if (qg.act) acc += (double)zrdot(qg, true, d);
        }
    }
    return acc;
  }
  task -= L.D;
  if (task < L.D) {
    for (int pl = 0; pl < np; ++pl) acc += (double)(s.X[pl][task] * s.bs[pl]);
    return acc;
  }
  for (int q = 0; q < np * MAX_F; ++q) acc += (double)s.pair[q].e;
  return acc;
}

// Writes the reduced sum of partial `task` to the outputs.
__device__ void store_system(const Args& a, const Layout& L, int task, float v) {
  const int D = L.D;
  if (task < L.nhb * 64) {
    int fi, fj;
    block_pair(task >> 6, a.F, fi, fj);
    const int d = (task >> 3) & 7, e = task & 7;
    a.H[(size_t)(fi * 8 + d) * D + fj * 8 + e] = v;
    if (fi != fj) a.H[(size_t)(fj * 8 + e) * D + fi * 8 + d] = v;
    return;
  }
  task -= L.nhb * 64;
  if (task < L.nc) {
    int i, j;
    upper_index(task, D, i, j);
    a.H_corr[(size_t)i * D + j] = v;
    a.H_corr[(size_t)j * D + i] = v;
    return;
  }
  task -= L.nc;
  if (task < D) {
    a.b[task] = v;
    return;
  }
  task -= D;
  if (task < D) {
    a.b_corr[task] = v;
    return;
  }
  *a.e_photo = v;
}

__global__ void __launch_bounds__(THREADS, 1) ba_sweep_kernel(const __grid_constant__ Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  Shared& s = *reinterpret_cast<Shared*>(smem);
  const int tid = threadIdx.x;
  if (a.mode == FINISH) {
    finish(a, s, *a.e_in);
    return;
  }
  const bool sys = a.mode == SYSTEM || a.mode == MARG;
  const int D = 8 * a.F;
  const int base = blockIdx.x * NPB;
  const int np = min(NPB, a.P - base);
  const int slot = a.mode == MARG ? (a.slot ? (int)*a.slot : a.slot_host) : -1;
  rel_poses(a, s);
  for (int i = tid; i < NPB * MAX_D; i += THREADS) (&s.X[0][0])[i] = 0.0f;
  if (tid < NPB) s.host[tid] = base + tid < a.P ? a.host[base + tid] : -1;
  __syncthreads();

  // phase A: a thread a (point, target) pair
  const int pl = tid / MAX_F, f = tid % MAX_F;
  sweep_pair(a, s, pl, f, base + pl, slot);
  const Pair& q = s.pair[tid];
  float za[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (sys) {
    const float a4[4] = {q.a[0], q.a[1], 0.0f, 0.0f};
    zmul(q.Z, a4, za);
    if (f < a.F) {
      // H_xr's target block: L_t Z a
#pragma unroll
      for (int d = 0; d < 8; ++d) {
        float L[4];
        lrow(q, false, d, L);
        s.X[pl][f * 8 + d] = ((L[0] * za[0] + L[1] * za[1]) + L[2] * za[2]) + L[3] * za[3];
      }
    }
  }
  __syncthreads();

  if (a.mode == STATUS && tid < NPB && base + tid < a.P) {
    // update_residual_status: drop active residuals at or above the outlier
    // energy, and points left with no good residual
    const int p = base + tid;
    int n_good = 0;
    for (int g = 0; g < a.F; ++g) {
      const Pair& qg = s.pair[tid * MAX_F + g];
      const bool good = qg.act && qg.e < a.outlier;
      n_good += good;
      a.res_active_out[(size_t)p * a.F + g] = a.res_active[(size_t)p * a.F + g] && (good || !qg.act);
    }
    a.point_valid_out[p] = a.point_valid[p] && n_good >= 1;
  }

  // phase B: a thread a point: H_rho, b_rho, H_xr's host block, the scale
  if (sys && tid < NPB) {
    const int p = base + tid;
    float hr = 0.0f, br = 0.0f, hx[8];
#pragma unroll
    for (int d = 0; d < 8; ++d) hx[d] = 0.0f;
    for (int g = 0; g < a.F; ++g) {
      const Pair& qg = s.pair[tid * MAX_F + g];
      const float a4[4] = {qg.a[0], qg.a[1], 0.0f, 0.0f};
      float zg[4];
      zmul(qg.Z, a4, zg);
      hr += qg.a[0] * zg[0] + qg.a[1] * zg[1];
      br += qg.a[0] * qg.zr[0] + qg.a[1] * qg.zr[1];
#pragma unroll
      for (int d = 0; d < 8; ++d) {
        float L[4];
        lrow(qg, true, d, L);
        hx[d] += ((L[0] * zg[0] + L[1] * zg[1]) + L[2] * zg[2]) + L[3] * zg[3];
      }
    }
    bool valid = false;
    float hrd = 1.0f, sc = 0.0f;
    if (p < a.P) {
      const int h = s.host[tid];
#pragma unroll
      for (int d = 0; d < 8; ++d) s.X[tid][h * 8 + d] += hx[d];
      valid = a.point_valid[p] != 0;
      if (a.mode == MARG) valid = valid && h == slot;
      const float lam = a.mode == SYSTEM ? *a.lam : 0.0f;
      if (valid) {
        hrd = hr * (1.0f + lam) + a.rho_eps;
        sc = 1.0f / hrd;
      }
      if (a.H_rho_d) {
        a.H_rho_d[p] = hrd;
        a.b_rho[p] = br;
      }
    }
    s.scale[tid] = sc;
    s.bs[tid] = br * sc;
  }
  __syncthreads();
  if (sys && a.H_xr)
    for (int i = tid; i < np * D; i += THREADS)
      a.H_xr[(size_t)(base + i / D) * D + i % D] = s.X[i / D][i % D];

  // phase C: the block's partial sums, each in index order
  double* part = static_cast<double*>(a.partials);
  int total;
  if (sys) {
    const Layout L(a.F);
    total = L.total;
    for (int task = tid; task < total; task += THREADS)
      part[(size_t)blockIdx.x * total + task] = system_partial(a, s, L, task, np);
  } else {
    total = 1;
    // the pairs' energies in index order: a warp's lanes, then the warps
    double e = (double)q.e;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const double other = __shfl_down_sync(lm::FULL, e, o);
      if ((tid & 31) % (2 * o) == 0) e += other;
    }
    __shared__ double wsum[THREADS / 32];
    if ((tid & 31) == 0) wsum[tid >> 5] = e;
    __syncthreads();
    if (tid == 0) {
      double acc = wsum[0];
      for (int w = 1; w < THREADS / 32; ++w) acc += wsum[w];
      part[blockIdx.x] = acc;
    }
  }

  // phase D: the last block to arrive sums the partials in block order
  __threadfence();
  __syncthreads();
  if (tid == 0) s.last = atomicAdd(a.counter, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!s.last) return;
  __threadfence();
  float e_photo = 0.0f;
  if (sys) {
    const Layout L(a.F);
    for (int task = tid; task < total; task += THREADS) {
      double acc = 0;
      for (int bk = 0; bk < (int)gridDim.x; ++bk) acc += __ldcg(part + (size_t)bk * total + task);
      store_system(a, L, task, (float)acc);
      if (task == total - 1) s.fin[0] = (float)acc;
    }
  } else if (tid == 0) {
    double acc = 0;
    for (int bk = 0; bk < (int)gridDim.x; ++bk) acc += __ldcg(part + bk);
    *a.e_photo = (float)acc;
    s.fin[0] = (float)acc;
  }
  if (tid == 0) *a.counter = 0u;
  __syncthreads();
  e_photo = s.fin[0];
  __syncthreads();
  if (a.fin != FIN_NONE) finish(a, s, e_photo);
}

cudaError_t launch(const Args& a, cudaStream_t stream) {
  const size_t smem = sizeof(Shared);
  cudaError_t e = cudaFuncSetAttribute(ba_sweep_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const int blocks = a.mode == FINISH ? 1 : (a.P + NPB - 1) / NPB;
  ba_sweep_kernel<<<blocks, THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// The block count a sweep of P points launches, and the scratch bytes a
// block's partial sums take.
extern "C" int ba_sweep_plan(int P, int F, int* blocks, long long* partial_bytes) {
  if (F < 1 || F > MAX_F || P < 0) return (int)cudaErrorInvalidValue;
  const int D = 8 * F;
  const int total = F * (F + 1) / 2 * 64 + D * (D + 1) / 2 + 2 * D + 1;
  *blocks = (P + NPB - 1) / NPB;
  *partial_bytes = (long long)total * (long long)sizeof(double);
  return 0;
}

// Launches one sweep (or FINISH) on `stream` with the arguments in `a` (a
// host struct, copied into the launch). Returns the launch's cudaError_t.
extern "C" int ba_sweep_launch(const void* args, void* stream) {
  const Args* a = static_cast<const Args*>(args);
  if (a->F < 1 || a->F > MAX_F || a->P < 0 || (a->mode != FINISH && a->P == 0))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)launch(*a, st);
}

// sizeof(Args), for the wrapper's check of its mirror of the struct.
extern "C" int ba_sweep_args_size() { return (int)sizeof(Args); }
