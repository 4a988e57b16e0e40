// The windowed photometric BA's residual sweep for Hopper (sm_90a): one
// cooperative launch computes what the plain forms' linearize + _assemble +
// _schur_terms (or total_energy's photometric sum, or
// update_residual_status, or _marg_pieces' contraction) compute, without
// writing a Jacobian.
//
// Replaces the sweep of the JAX package's device program for the window BA:
// `linearize` (libcml_tpu/models/direct/ba.py:317), `_assemble` (:424) and
// `_schur_reduce` (:481) inside `run_ba`'s `lax.scan` (:619, :644), and the
// same sweep inside `total_energy` (:508), `update_residual_status` (:740)
// and `_marg_pieces` (:928). Its plain PyTorch forms are `_sweep_plain`,
// `total_energy_plain`, `update_residual_status_plain` and
// `_marg_pieces_plain` in libcml_tpu_torch/models/direct/ba.py.
//
// A block takes point groups of 16 points (csrc/ba_common.cuh: phases A, F,
// B, C) into their partial sums; after a grid barrier every block sums its
// slice of the entries over all groups in group order (phase D), and the
// block given the energy takes the finish. A SYSTEM sweep returns the
// Schur-complemented system S = H - H_corr and s = b - b_corr, each
// difference taken in double and rounded once; MARG keeps the four sums
// apart for the host's float64 Schur. With P 2048 the grid is 128
// blocks, one group each, on 128 of the card's 132 SMs (the one-block
// reduction it replaces: 64 blocks, and the last to arrive summed all 64
// partials of ~3,500 doubles).
//
// Modes: SYSTEM (the LM system less its lambda-damped Schur corrections, per
// point H_rho_d, b_rho and the H_xr row for the back-substitution, and the
// energy); ENERGY (the photometric energy only); in both, with the mixed BA's
// reprojection factors (a.ind.Q > 0), their groups after the photometric
// ones and their own outputs (SYSTEM: the additive system, the Schur pair
// and each factor point's rows; ENERGY: the reprojection energy, which the
// finish adds last), kept apart from the photometric sums so that with a
// mesh they join after the all-reduce (`_linearize_indirect` :175,
// `_assemble_indirect` :231, the second `_schur_reduce` of `ba_step` :568,
// `indirect_energy` :281); STATUS (update_residual_status:
// the new res_active and point_valid, and the energy); MARG (_marg_pieces:
// the points hosted in a slot, the gradient from the FEJ-shifted residual
// r - J_t d_t - J_h d_h - J_rho d_rho, the Schur scale 1/(H_rho + 1e-12);
// its pairs' residuals and sums in double, ba_common.cuh marg_pair, since
// the host's float64 Schur takes sums whose terms cancel);
// FINISH (no sweep: one block completes an energy reduced elsewhere, e.g. by
// an all-reduce). With `fin`, the energy's block also adds the prior and
// affine terms of total_energy and, for FIN_ACCEPT, takes run_ba's accept
// test, lambda's update and the state select on the device.
//
// What bounds it on the H100: with every (point, slot) pair active at P
// 2048, F 7 a sweep gathers ~5.5 MB of texels and does ~26 M FMA, about 2 us
// at the card's rates; the launch is latency-bound instead (the pixels'
// dependent loads, the phases' barriers, the grid barrier and phase D's
// 128-deep sums; PERF.md).

#include <cstdint>
#include <cuda_runtime.h>

#include "ba_common.cuh"

namespace {

using namespace ba;

// A system sweep's group rows (the H_xr rows, H_rho_d and b_rho of the np
// points from `base`) from the block's shared memory to device memory, for
// the solve's back-substitution.
__device__ __forceinline__ void write_rows(const Rows& R, int base, int np, int D, float* H_xr,
                                           float* H_rho_d, float* b_rho) {
  for (int i = threadIdx.x; i < np * D; i += THREADS)
    H_xr[(size_t)base * D + i] = R.X[i / D][i % D];
  if (threadIdx.x < np) {
    H_rho_d[base + threadIdx.x] = R.hrd[threadIdx.x];
    b_rho[base + threadIdx.x] = R.brho[threadIdx.x];
  }
}

__global__ void __launch_bounds__(THREADS, 1) ba_sweep_kernel(const __grid_constant__ Args args) {
  __shared__ Args args_s;
  const Args& a = shared_args(args_s, args);
  // stage: start
  if (a.mode == FINISH) {
    finish(a, ldcg(a.e_in), a.fin, a.trace, true);
    return;
  }
  SweepShared& s = sweep_smem();
  const bool sys = a.mode == SYSTEM || a.mode == MARG;
  const int D = 8 * a.F, G = groups(a.P), NG = G + groups(a.ind.Q);
  const int slot = a.mode == MARG ? (a.slot ? (int)*a.slot : a.slot_host) : -1;
  const float lam = a.mode == SYSTEM ? ldcg(a.lam) : 0.0f;
  const Layout L(a.F);
  const int total = sys ? L.total : 1;
  const int rows = (int)sizeof(Shared);
  const Rows R = rows_at(rows);
  double* part = static_cast<double*>(a.partials);
  double* ipart = static_cast<double*>(a.ind.partials);
  rel_poses(a);
  __syncthreads();
  // stage: poses
  for (int g = blockIdx.x; g < NG; g += gridDim.x) {
    if (g >= G) {   // a reprojection group (SYSTEM or ENERGY)
      const int gi = g - G;
      if (a.mode == SYSTEM) {
        sweep_group<IND_SYSTEM>(a, slot, lam, gi, ipart + (size_t)gi * total, rows);
        __syncthreads();
        write_rows(R, gi * NPB, min(NPB, a.ind.Q - gi * NPB), D, a.ind.H_xr, a.ind.H_rho_d,
                   a.ind.b_rho);
      } else {
        sweep_group<IND_ENERGY>(a, slot, lam, gi, ipart + gi, rows);
      }
      __syncthreads();
      continue;
    }
    double* pg = part + (size_t)g * total;
    switch (a.mode) {
      case SYSTEM: sweep_group<SYSTEM>(a, slot, lam, g, pg, rows); break;
      case ENERGY: sweep_group<ENERGY>(a, slot, lam, g, pg, rows); break;
      case STATUS: sweep_group<STATUS>(a, slot, lam, g, pg, rows); break;
      default: sweep_group<MARG>(a, slot, lam, g, pg, rows); break;
    }
    __syncthreads();
    if (sys && a.H_xr)
      write_rows(R, g * NPB, min(NPB, a.P - g * NPB), D, a.H_xr, a.H_rho_d, a.b_rho);
  }
  grid_barrier(a.bar);
  // stage: partials

  // phase D
  if (!sys) {
    if (blockIdx.x == 0 && threadIdx.x < 32) {
      const double e = reduce_one(part, 1, G, reinterpret_cast<double*>(s.form));
      if (threadIdx.x == 0) *a.e_photo = s.e_photo = (float)e;
      reduce_ind_energy(a, reinterpret_cast<double*>(s.form));
    }
  } else if (a.mode == SYSTEM) {
    float* e_photo = &s.e_photo;
    reduce_system(part, L, G, a.H, a.b, true, [&](double v) {
      *a.e_photo = (float)v;
      *e_photo = (float)v;
    });
    reduce_ind_system(a, L);
  } else {
    float* e_photo = &s.e_photo;
    reduce_entries(part, total, total, G, [&](int task, double v) {
      if (task == total - 1) {
        *a.e_photo = (float)v;
        *e_photo = (float)v;
      } else {
        store_system(a.H, a.b, a.H_corr, a.b_corr, nullptr, L, task, (float)v);
      }
    });
  }
  // stage: D
  const int fb = a.mode == SYSTEM ? ((L.nH + D) / 32) % (int)gridDim.x : energy_block(total);
  if (a.fin == FIN_NONE || (int)blockIdx.x != fb) return;
  __syncthreads();
  finish(a, s.e_photo, a.fin, a.trace, true);
  // stage: finish
}

cudaError_t launch(const Args& a, cudaStream_t stream) {
  const size_t smem = sizeof(Shared) + ROW_BYTES;
  const void* kernel = reinterpret_cast<const void*>(ba_sweep_kernel);
  cudaError_t e = cudaFuncSetAttribute(ba_sweep_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const int cap = capacity(kernel, smem);
  if (cap < 1) return cudaErrorLaunchOutOfResources;
  const int blocks = a.mode == FINISH ? 1 : min(groups(a.P) + groups(a.ind.Q), cap);
  void* params[] = {const_cast<Args*>(&a)};
  e = cudaLaunchCooperativeKernel(kernel, dim3(blocks), dim3(THREADS), params, smem, stream);
  return e != cudaSuccess ? e : cudaGetLastError();
}

}  // namespace

// The group count a sweep of P points reduces, and the scratch bytes a
// group's partial sums take in a system or marg sweep.
extern "C" int ba_sweep_plan(int P, int F, int* n_groups, long long* partial_bytes) {
  if (F < 1 || F > MAX_F || P < 0) return (int)cudaErrorInvalidValue;
  *n_groups = (P + NPB - 1) / NPB;
  *partial_bytes = (long long)Layout(F).total * (long long)sizeof(double);
  return 0;
}

// Launches one sweep (or FINISH) on `stream` with the arguments in `a` (a
// host struct, copied into the launch). Returns the launch's cudaError_t.
extern "C" int ba_sweep_launch(const void* args, void* stream) {
  const Args* a = static_cast<const Args*>(args);
  if (a->F < 1 || a->F > MAX_F || a->P < 0 || (a->mode != FINISH && a->P == 0))
    return (int)cudaErrorInvalidValue;
  if (a->ind.Q < 0 ||
      (a->ind.Q > 0 && ((a->mode != SYSTEM && a->mode != ENERGY) || !a->ind.partials)))
    return (int)cudaErrorInvalidValue;
  return (int)launch(*a, static_cast<cudaStream_t>(stream));
}

// sizeof(Args), for the wrapper's check of its mirror of the struct.
extern "C" int ba_sweep_args_size() { return (int)sizeof(Args); }
