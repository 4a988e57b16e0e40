// The rest of the window BA's LM step for Hopper (sm_90a): from the reduced
// system of csrc/ba_sweep.cu to the candidate state, in one cooperative
// launch. The split routes use it (a mesh, whose all-reduce lies between
// sweep and solve; the mixed BA, whose reprojection terms do; a lone
// ba_step); csrc/ba_run.cu runs the same device functions inside its loop.
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
// Block 0 builds the damped system in shared memory; its warp 0 solves it
// (csrc/ba_common.cuh warp_solve: LU with partial pivoting, two rows a lane,
// __syncwarp only) and block 0 writes the candidate frames and dx.
// After a grid barrier every block takes tiles of 128 point rows: the tile's
// H_xr rows are read coalesced into shared memory, then a thread a row
// forms d_rho = (b_rho - H_xr dx) / H_rho_d (0 where invalid) and idepth =
// clamp(idepth - d_rho), or, with a mesh, writes d_rho for the all-gather.
// The mixed BA's factor points (Q > 0) take tiles after the state's: their
// rows from the system sweep's Ind outputs, their candidate inverse depths
// written whole (every rank holds the factors whole). The sweep's
// reprojection sums enter build_system as its additive system and second
// Schur pair.
//
// What bounds it on the H100: not bytes (~0.5 MB of H_xr) or operations
// (~60 k FMA for the LU, ~115 k for the rows at P 2048) but the
// elimination's 56 dependent steps in one warp, ~800 cycles each (the pivot's
// reductions, the pivot row's trip through shared memory): latency
// (PERF.md).

#include <cstdint>
#include <cuda_runtime.h>

#include "ba_common.cuh"

namespace {

using namespace ba;

constexpr int ROWS = 128;   // point rows a tile

__global__ void __launch_bounds__(THREADS, 1) ba_solve_kernel(
    const __grid_constant__ SolveArgs args) {
  __shared__ SolveArgs args_s;
  const SolveArgs& a = shared_args(args_s, args);
  SolveShared& s = solve_smem();
  const int D = 8 * a.F, tid = threadIdx.x;
  // stage: start
  if (blockIdx.x == 0) {
    build_system(a);
    // stage: build
    warp_solve(a);
    __syncthreads();
    // stage: triangular
    update_frames(a);
    // stage: frames
  }
  grid_barrier(a.bar);
  if (tid < D) s.x[tid] = ldcg(a.dx + tid);
  const int tiles = (a.P + ROWS - 1) / ROWS;
  for (int k = blockIdx.x; k < tiles + (a.Q + ROWS - 1) / ROWS; k += gridDim.x) {
    const bool ind = k >= tiles;   // a tile of the factor points
    const int base = (ind ? k - tiles : k) * ROWS;
    const int n = min(ROWS, (ind ? a.Q : a.P) - base);
    const float* H_xr = ind ? a.Hi_xr : a.H_xr;
    __syncthreads();
    for (int i = tid; i < n * D; i += THREADS) s.tile[i / D][i % D] = H_xr[(size_t)base * D + i];
    __syncthreads();
    if (tid < n) {
      const int p = base + tid;
      if (ind) {
        const float d = point_step(smem_offset(s.tile[tid]), smem_offset(s.x), D, a.bi_rho[p],
                                   a.Hi_rho_d[p], a.ind_valid[p] != 0);
        a.ind_idepth_out[p] = clamp_idepth(a.ind_idepth[p] - d, a.idepth_min, a.idepth_max);
      } else {
        const float d = point_step(smem_offset(s.tile[tid]), smem_offset(s.x), D, a.b_rho[p],
                                   a.H_rho_d[p], a.point_valid[p] != 0);
        if (a.mesh) a.d_rho_out[p] = d;
        else a.idepth_out[p] = clamp_idepth(a.idepth[p] - d, a.idepth_min, a.idepth_max);
      }
    }
  }
  // stage: rows
}

}  // namespace

// Launches the solve on `stream` with the arguments in `a` (a host struct,
// copied into the launch). Returns the launch's cudaError_t.
extern "C" int ba_solve_launch(const void* args, void* stream) {
  const SolveArgs* a = static_cast<const SolveArgs*>(args);
  if (a->F < 1 || a->F > MAX_F || a->P < 0 || !a->dx || !a->bar) return (int)cudaErrorInvalidValue;
  if (a->mesh ? !a->d_rho_out : (!a->idepth_out || !a->idepth)) return (int)cudaErrorInvalidValue;
  if (a->Q < 0 ||
      (a->Q > 0 && (!a->Hi || !a->Hi_xr || !a->ind_idepth || !a->ind_idepth_out)))
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(SolveShared);
  const void* kernel = reinterpret_cast<const void*>(ba_solve_kernel);
  cudaError_t e = cudaFuncSetAttribute(ba_solve_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int cap = capacity(kernel, smem);
  if (cap < 1) return (int)cudaErrorLaunchOutOfResources;
  const int blocks = max(1, min((a->P + ROWS - 1) / ROWS + (a->Q + ROWS - 1) / ROWS, cap));
  void* params[] = {const_cast<SolveArgs*>(a)};
  e = cudaLaunchCooperativeKernel(kernel, dim3(blocks), dim3(THREADS), params, smem,
                                  static_cast<cudaStream_t>(stream));
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

// sizeof(SolveArgs), for the wrapper's check of its mirror of the struct.
extern "C" int ba_solve_args_size() { return (int)sizeof(SolveArgs); }
