// The window BA's whole LM loop (run_ba, or run_ba_mixed with its
// reprojection factors, without a mesh) for Hopper (sm_90a), in one
// persistent cooperative launch.
//
// Replaces the JAX package's device programs for the window BA, `run_ba`'s
// `lax.scan` (libcml_tpu/models/direct/ba.py:619) and `run_ba_mixed`'s
// (:651, the scan at :684): the energy at the start and lambda's first
// value, then each LM step's system sweep (`linearize` :317, `_assemble`
// :424, `_schur_reduce` :481; with factors `_linearize_indirect` :175,
// `_assemble_indirect` :231 and the second `_schur_reduce` :568),
// `ba_step`'s solve (:532) with the factors' back-substitution (:609), and
// the candidate's `total_energy` (:508, with `indirect_energy` :281), the
// accept test, lambda's update and the select. Its plain PyTorch forms are
// `run_ba_plain` and `run_ba_mixed_plain` in
// libcml_tpu_torch/models/direct/ba.py; the split launches of
// csrc/ba_sweep.cu and csrc/ba_solve.cu run the same device functions
// (csrc/ba_common.cuh) in the same orders, so both give the same bits.
//
// A block owns point groups g = blockIdx.x + k gridDim.x, the state's G
// groups first and then the factors' (at P 2048, 128 groups on 128 blocks,
// one each; with 256 factor points 16 more, on 132 blocks, two for 12 of
// them), and keeps their H_xr rows, H_rho_d and b_rho in its shared memory
// from the system sweep to the back-substitution, so no row goes through
// device memory. Phases, each ended by a grid barrier (integer tickets; the
// grid is co-resident by the cooperative launch):
//   start: the energy sweep of the input state, its copy into the held
//          state | block 0: the energy's sum over groups (and the
//          factors'), total_energy's finish, lambda's first value;
//   a step: the system sweep (phases A, F, B, C per group) | phase D, every
//          block its slice of the entries (the factors' four sums apart) |
//          block 0: the damped system and warp 0's LU, the candidate frames
//          and dx | the owners: d_rho and the candidate inverse depths
//          (the factors' too), then the candidate's energy sweep | block 0:
//          the energy's sums, the finish, the accept test, lambda's update,
//          the frames' select | the owners: the inverse depths' select.
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
// partials and the barrier are init's. With factors (ind.Q > 0, the same in
// all three): init's inverse depths are the input's, cur's the held ones in
// the output buffer (cand.src_extra = cand.dst_extra), cand's the
// candidate's (solve.ind_idepth_out = cand.cand_extra); each Args' e_extra
// is its ind.e, and the partials are init's.
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
  const int P = r.cur.P, F = r.cur.F, D = 8 * F, G = groups(P), Q = r.cur.ind.Q;
  const int NG = G + groups(Q);
  const int per = (NG + gridDim.x - 1) / gridDim.x;  // groups a block owns
  const Layout L(F);
  double* part = static_cast<double*>(r.init.partials);
  double* ipart = static_cast<double*>(r.init.ind.partials);
  unsigned* bar = r.init.bar;
  const int rows = (int)sizeof(Shared);               // group k's rows at rows + k ROW_BYTES
  const int xk = rows + per * ROW_BYTES;              // dx
  float* x = smem_floats(xk);
  // stage: start

  // the energy at the start; the input state copied into the held state
  rel_poses(r.init);
  __syncthreads();
  for (int g = blockIdx.x; g < NG; g += gridDim.x) {
    if (g < G) {
      sweep_group<ENERGY>(r.init, -1, 0.0f, g, part + g, rows);
      const int p = g * NPB + tid;
      if (tid < NPB && p < P) r.cand.dst_idepth[p] = r.init.idepth[p];
    } else {
      sweep_group<IND_ENERGY>(r.init, -1, 0.0f, g - G, ipart + (g - G), rows);
      const int q = (g - G) * NPB + tid;
      if (tid < NPB && q < Q) r.cand.dst_extra[q] = r.init.ind.idepth[q];
    }
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
    reduce_ind_energy(r.init, reinterpret_cast<double*>(s.form));
    finish(r.init, s.e_photo, FIN_ENERGY, nullptr, false);
  }
  grid_barrier(bar);
  // stage: E0

  for (int it = 0; it < r.iters; ++it) {
    // the system sweep of the held state
    rel_poses(r.cur);
    const float lam = ldcg(r.cur.lam);
    __syncthreads();
    for (int k = 0, g = blockIdx.x; g < NG; ++k, g += gridDim.x) {
      if (g < G)
        sweep_group<SYSTEM>(r.cur, -1, lam, g, part + (size_t)g * L.total, rows + k * ROW_BYTES);
      else
        sweep_group<IND_SYSTEM>(r.cur, -1, lam, g - G, ipart + (size_t)(g - G) * L.total,
                                rows + k * ROW_BYTES);
      __syncthreads();
    }
    grid_barrier(bar);
    // stage: system
    reduce_system(part, L, G, r.cur.H, r.cur.b, false, [](double) {});
    reduce_ind_system(r.cur, L);
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
    for (int k = 0, g = blockIdx.x; g < NG; ++k, g += gridDim.x) {
      const Rows R = rows_at(rows + k * ROW_BYTES);
      if (g < G) {
        const int p = g * NPB + tid;
        if (tid < NPB && p < P) {
          const float d = point_step(smem_offset(R.X[tid]), xk, D, R.brho[tid], R.hrd[tid],
                                     r.cur.point_valid[p] != 0);
          r.solve.idepth_out[p] =
              clamp_idepth(ldcg(r.solve.idepth + p) - d, r.solve.idepth_min, r.solve.idepth_max);
        }
      } else {
        const int q = (g - G) * NPB + tid;
        if (tid < NPB && q < Q) {
          const float d = point_step(smem_offset(R.X[tid]), xk, D, R.brho[tid], R.hrd[tid],
                                     r.cur.ind.point_valid[q] != 0);
          r.solve.ind_idepth_out[q] = clamp_idepth(ldcg(r.solve.ind_idepth + q) - d,
                                                   r.solve.idepth_min, r.solve.idepth_max);
        }
      }
    }
    __syncthreads();
    rel_poses(r.cand);
    __syncthreads();
    for (int g = blockIdx.x; g < NG; g += gridDim.x) {
      if (g < G) sweep_group<ENERGY>(r.cand, -1, 0.0f, g, part + g, rows);
      else sweep_group<IND_ENERGY>(r.cand, -1, 0.0f, g - G, ipart + (g - G), rows);
      __syncthreads();
    }
    grid_barrier(bar);
    // stage: energy
    if (blockIdx.x == 0) {
      energy_sum(part, G, s);
      reduce_ind_energy(r.cand, reinterpret_cast<double*>(s.form));
      const bool accept = finish(r.cand, s.e_photo, FIN_ACCEPT,
                                 r.trace ? r.trace + 2 * it : nullptr, false);
      if (tid == 0) *r.flag = accept;
    }
    grid_barrier(bar);
    // stage: accept
    const bool accept = __ldcg(r.flag) != 0;
    for (int g = blockIdx.x; g < NG; g += gridDim.x) {
      if (g < G) {
        const int p = g * NPB + tid;
        if (tid < NPB && p < P)
          r.cand.dst_idepth[p] =
              accept ? ldcg(r.cand.cand_idepth + p) : ldcg(r.cand.src_idepth + p);
      } else {
        const int q = (g - G) * NPB + tid;
        if (tid < NPB && q < Q)
          r.cand.dst_extra[q] = accept ? ldcg(r.cand.cand_extra + q) : ldcg(r.cand.src_extra + q);
      }
    }
    __syncthreads();
  }
}

// The card's SM count and the shared memory a block may opt into.
cudaError_t device_limits(int* sms, int* max_smem) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return e;
}

// A block that owns `per` groups: its dynamic shared memory (the sweep's,
// the groups' rows, dx) into *smem and the blocks of it an SM holds into
// *per_sm (0 where it and the kernel's static shared memory, the launch's
// arguments, do not fit in what a block may opt into).
cudaError_t blocks_per_sm(int per, int max_smem, size_t* smem, int* per_sm) {
  *smem = sizeof(Shared) + (size_t)per * ROW_BYTES + sizeof(float) * MAX_D;
  *per_sm = 0;
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, ba_run_kernel);
  if (e != cudaSuccess) return e;
  if (*smem + attr.sharedSizeBytes > (size_t)max_smem) return cudaSuccess;
  e = cudaFuncSetAttribute(ba_run_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, reinterpret_cast<const void*>(ba_run_kernel), THREADS, *smem);
}

}  // namespace

// Launches run_ba (run_ba_mixed) on `stream` with the arguments in `a` (a
// host struct, copied into the launch): one cooperative grid of co-resident
// blocks, a block a group where the card holds that many, else each owning
// at most the fewest groups (and their rows in shared memory) that let the
// grid fit. Returns the launch's cudaError_t (cudaErrorLaunchOutOfResources
// above ba_run_max_groups).
extern "C" int ba_run_launch(const void* args, void* stream) {
  const RunArgs* a = static_cast<const RunArgs*>(args);
  if (a->cur.F < 1 || a->cur.F > MAX_F || a->cur.P < 1 || a->iters < 0)
    return (int)cudaErrorInvalidValue;
  const int Q = a->cur.ind.Q;
  if (Q < 0 || a->init.ind.Q != Q || a->cand.ind.Q != Q || a->solve.Q != Q ||
      (Q > 0 && (!a->init.ind.partials || !a->cand.dst_extra)))
    return (int)cudaErrorInvalidValue;
  int sms = 0, max_smem = 0;
  cudaError_t e = device_limits(&sms, &max_smem);
  if (e != cudaSuccess) return (int)e;
  const int NG = groups(a->cur.P) + groups(Q);
  // the fewest groups a block that fit: each block keeps its groups' rows
  for (int per = 1; per <= NG; ++per) {
    size_t smem = 0;
    int per_sm = 0;
    e = blocks_per_sm(per, max_smem, &smem, &per_sm);
    if (e != cudaSuccess) return (int)e;
    if (per_sm == 0) break;
    const int cap = sms * per_sm;
    if ((long long)cap * per < NG) continue;
    const int blocks = min(NG, cap);
    void* params[] = {const_cast<RunArgs*>(a)};
    e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(ba_run_kernel), dim3(blocks),
                                    dim3(THREADS), params, smem,
                                    static_cast<cudaStream_t>(stream));
    return (int)(e != cudaSuccess ? e : cudaGetLastError());
  }
  return (int)cudaErrorLaunchOutOfResources;
}

// The most point groups (the state's and the factors', NPB points each)
// ba_run_launch takes on the current device, into *out: the most that any
// groups-a-block count fits in one co-resident grid. Returns a cudaError_t.
extern "C" int ba_run_max_groups(int* out) {
  int sms = 0, max_smem = 0;
  cudaError_t e = device_limits(&sms, &max_smem);
  if (e != cudaSuccess) return (int)e;
  long long best = 0;
  for (int per = 1;; ++per) {
    size_t smem = 0;
    int per_sm = 0;
    e = blocks_per_sm(per, max_smem, &smem, &per_sm);
    if (e != cudaSuccess) return (int)e;
    if (per_sm == 0) break;
    const long long n = (long long)per * sms * per_sm;
    if (n > best) best = n;
  }
  *out = (int)(best < (1LL << 30) ? best : (1LL << 30));
  return (int)cudaSuccess;
}

// sizeof(RunArgs), for the wrapper's check of its mirror of the struct.
extern "C" int ba_run_args_size() { return (int)sizeof(RunArgs); }
