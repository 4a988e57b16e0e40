// The window BA's whole LM loop (run_ba without a mesh or the mixed BA's
// reprojection terms) for Hopper (sm_90a), in one persistent cooperative
// launch.
//
// Replaces the JAX package's device program for the window BA, `run_ba`'s
// `lax.scan` (libcml_tpu/models/direct/ba.py:619): the energy at the start
// and lambda's first value, then each LM step's system sweep (`linearize`
// :317, `_assemble` :424, `_schur_reduce` :481), `ba_step`'s solve (:532)
// and the candidate's `total_energy` (:508), the accept test, lambda's update
// and the select. Its plain PyTorch form is `run_ba_plain` in
// libcml_tpu_torch/models/direct/ba.py; the split launches of
// csrc/ba_sweep.cu and csrc/ba_solve.cu run the same device functions
// (csrc/ba_common.cuh) in the same orders, so both give the same bits.
//
// A block owns point groups g = blockIdx.x + k gridDim.x (at P 2048, 128
// groups on 128 blocks, one each) and keeps their H_xr rows, H_rho_d and
// b_rho in its shared memory from the system sweep to the back-substitution,
// so no row goes through device memory. Phases, each ended by a grid barrier
// (integer tickets; the grid is co-resident by the cooperative launch):
//   start: the energy sweep of the input state, its copy into the held
//          state | block 0: the energy's sum over groups, total_energy's
//          finish, lambda's first value;
//   a step: the system sweep (phases A, F, B, C per group) | phase D, every
//          block its slice of the entries | block 0: the damped system and
//          warp 0's LU, the candidate frames and dx | the owners: d_rho and
//          the candidate inverse depths, then the candidate's energy sweep |
//          block 0: the energy's sum, the finish, the accept test, lambda's
//          update, the frames' select | the owners: the inverse depths'
//          select.
// No host read and no other launch inside: 5 grid barriers a step.
//
// What bounds it on the H100: the LU's 56 dependent steps in one warp and
// the chain of the phases' barriers; bytes (the sweeps' texels and the
// state, a few MB) and operations (~26 M FMA a system sweep) take a few us
// (PERF.md).

#include <cstdint>
#include <cuda_runtime.h>

#include "ba_common.cuh"

namespace {

using namespace ba;

// The launch's arguments (ops/ba_sweep.py RunArgs mirrors them). init: the
// input state (energy mode, FIN_ENERGY with init_lam); cur: the held state,
// its frames and inverse depths in the output buffers (system mode; lambda
// and E in scratch); cand: the candidate, its frames and inverse depths in
// scratch (energy mode, FIN_ACCEPT with src = dst = cur's buffers); solve:
// cur's reduced system (scratch) to the candidate's frames and dx. The
// partials and the barrier are init's.
struct RunArgs {
  Args init, cur, cand;
  SolveArgs solve;
  int iters;
  float* trace;   // (iters, 2): each step's (E, E_new), or null
  int* flag;      // scratch: the step's accept decision
};

// Phase D of the energy by block 0: s.e_photo for every thread.
__device__ __forceinline__ void energy_sum(const double* part, int G, SweepShared& s) {
  if (threadIdx.x < 32) {
    const double e = reduce_one(part, 1, G, reinterpret_cast<double*>(s.form));
    if (threadIdx.x == 0) s.e_photo = (float)e;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(THREADS, 1) ba_run_kernel(const __grid_constant__ RunArgs args) {
  __shared__ RunArgs args_s;
  const RunArgs& r = shared_args(args_s, args);
  SweepShared& s = sweep_smem();
  const int tid = threadIdx.x;
  const int P = r.cur.P, F = r.cur.F, D = 8 * F, G = groups(P);
  const int per = (G + gridDim.x - 1) / gridDim.x;   // groups a block owns
  const Layout L(F);
  double* part = static_cast<double*>(r.init.partials);
  unsigned* bar = r.init.bar;
  const int rows = (int)sizeof(Shared);               // group k's rows at rows + k ROW_BYTES
  const int xk = rows + per * ROW_BYTES;              // dx
  float* x = smem_floats(xk);
  // stage: start

  // the energy at the start; the input state copied into the held state
  rel_poses(r.init);
  __syncthreads();
  for (int g = blockIdx.x; g < G; g += gridDim.x) {
    sweep_group<ENERGY>(r.init, -1, 0.0f, g, part + g, rows);
    const int p = g * NPB + tid;
    if (tid < NPB && p < P) r.cand.dst_idepth[p] = r.init.idepth[p];
    __syncthreads();
  }
  if (blockIdx.x == 0) {
    for (int i = tid; i < F * 9; i += THREADS) r.cand.dst_R[i] = r.init.R[i];
    for (int i = tid; i < F * 3; i += THREADS) r.cand.dst_t[i] = r.init.t[i];
    for (int i = tid; i < F * 2; i += THREADS) r.cand.dst_ab[i] = r.init.ab[i];
    for (int i = tid; i < F * 8; i += THREADS) r.cand.dst_delta[i] = r.init.delta[i];
  }
  grid_barrier(bar);
  if (blockIdx.x == 0) {
    energy_sum(part, G, s);
    finish(r.init, s.e_photo, FIN_ENERGY, nullptr, false);
  }
  grid_barrier(bar);
  // stage: E0

  for (int it = 0; it < r.iters; ++it) {
    // the system sweep of the held state
    rel_poses(r.cur);
    const float lam = ldcg(r.cur.lam);
    __syncthreads();
    for (int k = 0, g = blockIdx.x; g < G; ++k, g += gridDim.x) {
      sweep_group<SYSTEM>(r.cur, -1, lam, g, part + (size_t)g * L.total, rows + k * ROW_BYTES);
      __syncthreads();
    }
    grid_barrier(bar);
    // stage: system
    reduce_system(part, L, G, r.cur.H, r.cur.b, false, [](double) {});
    grid_barrier(bar);
    // stage: reduce
    if (blockIdx.x == 0) {
      build_system(r.solve);
      warp_solve(r.solve);
      __syncthreads();
      update_frames(r.solve);
    }
    grid_barrier(bar);
    // stage: solve

    // the owners' back-substitution, then the candidate's energy
    if (tid < D) x[tid] = ldcg(r.solve.dx + tid);
    __syncthreads();
    for (int k = 0, g = blockIdx.x; g < G; ++k, g += gridDim.x) {
      const int p = g * NPB + tid;
      if (tid < NPB && p < P) {
        const Rows R = rows_at(rows + k * ROW_BYTES);
        const float d = point_step(smem_offset(R.X[tid]), xk, D, R.brho[tid], R.hrd[tid],
                                   r.cur.point_valid[p] != 0);
        r.solve.idepth_out[p] =
            clamp_idepth(ldcg(r.solve.idepth + p) - d, r.solve.idepth_min, r.solve.idepth_max);
      }
    }
    __syncthreads();
    rel_poses(r.cand);
    __syncthreads();
    for (int g = blockIdx.x; g < G; g += gridDim.x) {
      sweep_group<ENERGY>(r.cand, -1, 0.0f, g, part + g, rows);
      __syncthreads();
    }
    grid_barrier(bar);
    // stage: energy
    if (blockIdx.x == 0) {
      energy_sum(part, G, s);
      const bool accept = finish(r.cand, s.e_photo, FIN_ACCEPT,
                                 r.trace ? r.trace + 2 * it : nullptr, false);
      if (tid == 0) *r.flag = accept;
    }
    grid_barrier(bar);
    // stage: accept
    const bool accept = __ldcg(r.flag) != 0;
    for (int g = blockIdx.x; g < G; g += gridDim.x) {
      const int p = g * NPB + tid;
      if (tid < NPB && p < P)
        r.cand.dst_idepth[p] = accept ? ldcg(r.cand.cand_idepth + p) : ldcg(r.cand.src_idepth + p);
    }
    __syncthreads();
  }
}

}  // namespace

// Launches run_ba on `stream` with the arguments in `a` (a host struct,
// copied into the launch): one cooperative grid of co-resident blocks, each
// owning the fewest point groups (and their rows in shared memory) that let
// the grid fit on the card. Returns the launch's cudaError_t.
extern "C" int ba_run_launch(const void* args, void* stream) {
  const RunArgs* a = static_cast<const RunArgs*>(args);
  if (a->cur.F < 1 || a->cur.F > MAX_F || a->cur.P < 1 || a->iters < 0)
    return (int)cudaErrorInvalidValue;
  const void* kernel = reinterpret_cast<const void*>(ba_run_kernel);
  int dev = 0, sms = 0, max_smem = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return (int)e;
  const int G = groups(a->cur.P);
  // the fewest groups a block that fit: each block keeps its groups' rows
  for (int per = 1; per <= G; ++per) {
    const size_t smem = sizeof(Shared) + (size_t)per * ROW_BYTES + sizeof(float) * MAX_D;
    if (smem > (size_t)max_smem) break;
    e = cudaFuncSetAttribute(ba_run_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
    int per_sm = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem);
    if (e != cudaSuccess) return (int)e;
    const int blocks = (G + per - 1) / per;
    if (blocks > sms * per_sm) continue;
    void* params[] = {const_cast<RunArgs*>(a)};
    e = cudaLaunchCooperativeKernel(kernel, dim3(blocks), dim3(THREADS), params, smem,
                                    static_cast<cudaStream_t>(stream));
    return (int)(e != cudaSuccess ? e : cudaGetLastError());
  }
  return (int)cudaErrorLaunchOutOfResources;
}

// sizeof(RunArgs), for the wrapper's check of its mirror of the struct.
extern "C" int ba_run_args_size() { return (int)sizeof(RunArgs); }
