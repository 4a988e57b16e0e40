// The grid barrier of the cooperative kernels local_ba.cu and orb_extract.cu.
//
// Every block arrives, then waits until all have. Arrivals are counted on
// BAR_LINES counters, each on its own 128-byte line (block b adds to
// counter b mod BAR_LINES, so that fewer atomics queue on one address),
// that only grow during the launch: block b waits until their sum reaches
// gridDim.x times the barriers passed (`arrived`, a value the caller keeps
// in shared memory, 0 at the launch's start), lanes 0..BAR_LINES-1 of warp
// 0 each polling one counter (an arrival a release, a poll an acquire, at
// the GPU's scope), so the last arrival releases every waiter at once and
// nothing is reset between barriers; a wait that never ends traps instead
// of hanging the card. The last block to finish the launch (finish_sync
// counts them on the line after the counters) sets every count back to 0.
// Data written before the barrier by another block is read after it with
// __ldcg. The buffer: BAR_WORDS unsigned, all 0 before the launch
// (ops/kernel_build.py grid_barrier).
#pragma once

#include <cuda_runtime.h>

namespace gridbar {

constexpr int BAR_LINES = 8, BAR_STRIDE = 32;   // unsigned
constexpr int BAR_WORDS = (BAR_LINES + 1) * BAR_STRIDE;

__device__ __forceinline__ void grid_sync(unsigned* bar, unsigned& arrived) {
  __syncthreads();
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const unsigned target = arrived + gridDim.x;
    if (lane == 0)   // release: the block's writes (ordered by the barrier above) before it
      asm volatile("red.release.gpu.global.add.u32 [%0], 1;"
                   :: "l"(bar + (blockIdx.x % BAR_LINES) * BAR_STRIDE) : "memory");
    const long long t0 = clock64();
    unsigned total;
    do {
      unsigned v = 0u;
      if (lane < BAR_LINES)
        asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
                     : "=r"(v) : "l"(bar + lane * BAR_STRIDE) : "memory");
      total = __reduce_add_sync(0xFFFFFFFFu, v);
      if (clock64() - t0 > (1ll << 36)) __trap();
    } while ((int)(total - target) < 0);
    if (lane == 0) arrived = target;
  }
  __syncthreads();
}

__device__ __forceinline__ void finish_sync(unsigned* bar) {
  unsigned* gone = bar + BAR_LINES * BAR_STRIDE;
  if (threadIdx.x == 0 && atomicAdd(gone, 1u) == gridDim.x - 1) {
    for (int l = 0; l < BAR_LINES; ++l) atomicExch(bar + l * BAR_STRIDE, 0u);
    atomicExch(gone, 0u);
  }
}

}  // namespace gridbar
