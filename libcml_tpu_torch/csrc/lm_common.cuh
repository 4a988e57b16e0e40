// Pieces shared by the LM kernels (track_lm.cu, pnp_lm.cu): torch's clamp
// semantics, the thread block cluster a solve runs on (its size, its
// launch, its fixed-order reduction), the warp's dense solve with partial
// pivoting, and the SE(3) exponential of core/lie.py.
//
// Every reduction here runs in one fixed order (a thread's points in index
// order, a tree over each warp's lanes, the warps' partials in warp order,
// then the blocks' partials in rank order) and none uses atomics, so a
// kernel gives the same bits on the same inputs: repeated runs, a resumed
// run and a sharded world of one stay bit-identical. Every block of a
// cluster sums the partials itself, in the same order, so all of them hold
// the same bits and take the same decisions without a broadcast.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace lm {

namespace cg = cooperative_groups;

constexpr unsigned FULL = 0xffffffffu;
// Blocks a solve: 8, the portable cluster size (16, the non-portable one,
// was no faster for a track and slower for a battery; PERF.md)
constexpr int CLUSTER = 8;

// torch.clamp(x, min=m) / clamp(x, max=m): a NaN stays NaN (fmaxf would
// drop it)
__device__ __forceinline__ float clamp_min(float x, float m) { return x < m ? m : x; }
__device__ __forceinline__ float clamp_max(float x, float m) { return x > m ? m : x; }

// p ? a : b as one select instruction. Written as a ternary, the choice
// between v[j] and v[j + H] below compiles to an index into v, which moves
// v to local memory.
__device__ __forceinline__ float select(bool p, float a, float b) {
  float r;
  asm("{\n .reg .pred q;\n setp.ne.s32 q, %3, 0;\n selp.f32 %0, %1, %2, q;\n}"
      : "=f"(r) : "f"(a), "f"(b), "r"((int)p));
  return r;
}

// One round of warp_reduce_scatter: a lane keeps H of its 2H values (the
// upper half where bit H of its lane is set) and adds the partner's copy of
// them, trading the other half with the lane H apart.
template <int H>
__device__ __forceinline__ void reduce_round(float (&v)[32], bool upper) {
#pragma unroll
  for (int j = 0; j < H; ++j) {
    const float send = select(upper, v[j], v[j + H]);
    const float keep = select(upper, v[j + H], v[j]);
    v[j] = keep + __shfl_xor_sync(FULL, send, H);
  }
}

// Sum each of 32 values over the warp's lanes: lane l ends with the total of
// v[l] in v[0]. Recursive halving: each round a lane keeps half of its values
// and trades the other half with the lane H apart, 31 shuffles in all
// (a shuffle-down tree a value would take 160). Each total has the bits of
// that tree's: the same pairs at each round, and a sum of two is the same
// either way round.
__device__ __forceinline__ float warp_reduce_scatter(float (&v)[32]) {
  const int lane = threadIdx.x & 31;
  reduce_round<16>(v, lane & 16);
  reduce_round<8>(v, lane & 8);
  reduce_round<4>(v, lane & 4);
  reduce_round<2>(v, lane & 2);
  reduce_round<1>(v, lane & 1);
  return v[0];
}

// Every thread of the cluster arrives and waits: the arrival releases this
// block's shared-memory writes to the cluster, the wait acquires the other
// blocks' (cooperative_groups' cluster.sync() compiles with a device-wide
// memory fence besides).
__device__ __forceinline__ void cluster_barrier() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Sum N values over the cluster. Each block reduces its threads' values (a
// tree over each warp's lanes, lane l keeping value l of a group of 32, into
// `red`, WARPS * N floats, then the warps in order) into its half `buf` of
// `part` (2 * N, double-buffered so that a block already writing the next
// sum never overwrites a partial another block still reads); one cluster
// barrier; then warp 0 of every block sums the CLUSTER partials in rank order
// (distributed shared memory) into `out` (N). Ends with `out` complete for
// warp 0; the other warps read it only after a block barrier.
template <int N, int WARPS>
__device__ __forceinline__ void cluster_sum(const float (&v)[N], float* red, float* part,
                                            int buf, float* out) {
  cg::cluster_group cluster = cg::this_cluster();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int g = 0; g < N; g += 32) {
    float w[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) w[j] = g + j < N ? v[g + j < N ? g + j : 0] : 0.0f;
    const float x = warp_reduce_scatter(w);
    if (g + lane < N) red[warp * N + g + lane] = x;
  }
  __syncthreads();
  float* mine = part + buf * N;
  for (int i = threadIdx.x; i < N; i += WARPS * 32) {
    float s = red[i];
    for (int w = 1; w < WARPS; ++w) s += red[w * N + i];
    mine[i] = s;
  }
  cluster_barrier();
  if (warp == 0) {
    for (int i = lane; i < N; i += 32) {
      float p[CLUSTER];
#pragma unroll
      for (int r = 0; r < CLUSTER; ++r) p[r] = *cluster.map_shared_rank(mine + i, r);
      float s = p[0];
#pragma unroll
      for (int r = 1; r < CLUSTER; ++r) s += p[r];
      out[i] = s;
    }
    __syncwarp();
  }
}

// Gaussian elimination with partial pivoting of an N x N system with R
// right-hand sides (N + R <= 32) by one warp, a column a lane: lane c < N
// holds column c of the matrix in col, lane N + j right-hand side j; other
// lanes' values are ignored. At column k every lane finds the pivot of lane
// k's column from its own copy (the first row of largest magnitude, as
// LAPACK's isamax picks it: a NaN never displaces the diagonal, so decisions
// follow torch.linalg.solve), swaps its own column's two rows, and updates
// it with the multipliers of lane k's column scaled by the reciprocal of the
// pivot, as LAPACK's sgetf2 scales them; no row moves between lanes. Then
// every lane gathers U and back-substitutes, multiplying by the pivots'
// reciprocals, right-hand side j on lane N + j and side 0 on any other lane,
// into x. Every lane runs the same instructions on the same values as its
// neighbours (no divergent division: an IEEE division takes a slow path for
// special operands). A zero pivot gives inf/NaN, as torch.linalg.solve_ex
// and inv_ex do.
template <int N, int R>
__device__ __forceinline__ void warp_solve(float (&col)[N], float (&x)[N]) {
  static_assert(N + R <= 32, "a column a lane");
  const int lane = threadIdx.x & 31;
  float rcp[N];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    float pc[N];   // lane k's column
#pragma unroll
    for (int i = k; i < N; ++i) pc[i] = __shfl_sync(FULL, col[i], k);
    float best = fabsf(pc[k]);
    int p = k;
#pragma unroll
    for (int i = k + 1; i < N; ++i) {
      const float v = fabsf(pc[i]);
      if (v > best) {
        best = v;
        p = i;
      }
    }
#pragma unroll
    for (int i = k + 1; i < N; ++i) {
      const bool sw = p == i;
      const float ck = col[k], ci = col[i], pk = pc[k], pi = pc[i];
      col[k] = sw ? ci : ck;
      col[i] = sw ? ck : ci;
      pc[k] = sw ? pi : pk;
      pc[i] = sw ? pk : pi;
    }
    rcp[k] = 1.0f / pc[k];
    // every lane (no branch): rows below k of the lanes up to k are never
    // read again
#pragma unroll
    for (int i = k + 1; i < N; ++i) col[i] -= (pc[i] * rcp[k]) * col[k];
  }
  float U[N][N], y[N];
  const int side = (lane >= N && lane < N + R) ? lane : N;
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int c = i + 1; c < N; ++c) U[i][c] = __shfl_sync(FULL, col[i], c);
    y[i] = __shfl_sync(FULL, col[i], side);
  }
#pragma unroll
  for (int k = N - 1; k >= 0; --k) {
    float s = y[k];
#pragma unroll
    for (int j = k + 1; j < N; ++j) s -= U[k][j] * x[j];
    x[k] = s * rcp[k];
  }
}

// Launch `kernel` as `clusters` thread block clusters of CLUSTER blocks of
// `threads` threads on `stream`; with `occupancy`, only report in it how
// many such clusters the card holds at once (cudaOccupancyMaxActiveClusters)
// and launch nothing.
template <typename... P, typename... A>
inline cudaError_t launch_clusters(void (*kernel)(P...), int clusters, int threads,
                                   cudaStream_t stream, int* occupancy, A&&... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters * CLUSTER);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (occupancy) return cudaOccupancyMaxActiveClusters(occupancy, kernel, &cfg);
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, static_cast<A&&>(args)...);
  return e != cudaSuccess ? e : cudaGetLastError();
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
