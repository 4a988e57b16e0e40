// Point activation into the window BA's arena, one launch a call, for Hopper
// (sm_90a).
//
// Replaces no Pallas kernel: the JAX package runs `_activate_and_clear`
// (libcml_tpu/runtime/odometry.py:444) as one jitted program, XLA fusing
// `mature_mask` (models/direct/tracer.py:312) and `add_points`
// (models/direct/window.py:86) unrolled over the F frame slots. The port's
// plain PyTorch forms are `_activate_and_clear_plain` (runtime/odometry.py)
// and `add_points_plain` (models/direct/window.py), ~536 launches a call of
// the first; `_activate_and_clear` and `add_points` dispatch between the
// forms by the tensors' device (ops/kf_programs.py is the wrapper).
//
// What a call computes. R rows of K candidates (the immature arena's F rows,
// or one row of given points): a candidate is ready when it has matured
// (arena: traced at least `min_traces` times, its interval's relative width
// under `max_relwidth`; points: its flag), its inverse depth is
// max(sqrt(lo hi), idepth_min) (points: max(idepth, idepth_min)). Row r is
// hosted in frame slot r (points: the given slot). Position i of row r goes
// to the i-th lowest free point slot as the free set stands after rows
// 0..r-1 were written, whether or not the candidate is ready (a candidate
// that is not ready uses up its position); a position at or past the
// number of free slots is not written. A written slot takes the candidate's
// pixel, host, inverse depth (twice: the estimate and its FEJ point), the
// 8 pattern colours and gradient weights sampled in its host image, validity,
// and residuals to every other valid frame. The arena's rows lose their
// ready candidates.
//
// Design. The colours and weights do not depend on where a point lands:
// every block computes them for the ready candidates of its grid-stride
// share (a thread a candidate, 8 bilinear taps of 3 channels) into a
// scratch buffer, and copies its share of the arena's P rows into the new
// tensors. The last block to finish (a ticket, with fences on both sides,
// as hamming_match.cu's finish) runs the R dependent free-slot scans over
// the P validity flags in shared memory (a thread a contiguous run of slots,
// a block scan of the runs' free counts, each free slot of rank under K
// listed for its position, the ready positions' slots marked taken before
// the next row's scan), then writes every ready candidate's row at once. It
// then sets the ticket back to 0. No host read, one launch.
//
// Bound: bytes. The arena's rows are read once and written once, the
// candidates' state read once and each ready candidate's 32 texels read;
// the arithmetic is a few hundred operations a candidate. The latency of
// the R scans in one block (a few hundred cycles each) and of the launch
// are what it costs.
//
// Numerics: every product, sum and quotient is rounded on its own
// (__fmul_rn, __fadd_rn, __fdiv_rn, __fsqrt_rn) as the plain form's
// separate PyTorch operations round them on the card: ops/image.py
// bilinear's interpolation, the gradient weight sqrt((1 / (c2 + g^2)) c2)
// (`c2 / x` is x.reciprocal() * c2 in PyTorch), the interval's midpoint
// and relative width. Every output is the plain form's bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int MAX_BLOCKS = 264;
// models/direct/residuals.PATTERN
__constant__ float PAT_U[8] = {0.f, -1.f, 1.f, -2.f, 0.f, 2.f, -1.f, 0.f};
__constant__ float PAT_V[8] = {-2.f, -1.f, -1.f, 0.f, 0.f, 0.f, 1.f, 2.f};

struct Args {
  int mode;                      // 0: the immature arena's rows, 1: one row of given points
  int P, F, K, R, H, W;
  // mode 0: the arena (R = F rows of K)
  const float* imm_uv;           // (R, K, 2)
  const float* imm_lo;           // (R, K)
  const float* imm_hi;
  const int* imm_nok;
  const unsigned char* imm_valid;
  int min_traces;
  float max_relwidth;
  // mode 1: K points hosted in one slot
  const float* pt_uv;            // (K, 2)
  const float* pt_idepth;        // (K,)
  const unsigned char* pt_valid;
  const long long* slot_ptr;     // the slot as a device int64 scalar, or nullptr
  int slot_val;                  // else this slot
  // the window
  const float* images;           // (F, H, W, 3)
  const unsigned char* frame_valid;
  const float* uv;               // (P, 2)
  const int* host;
  const float* idepth;
  const float* idepth_fej;
  const float* color;            // (P, 8)
  const float* weight;
  const unsigned char* point_valid;
  const unsigned char* res_active;   // (P, F)
  float idepth_min, c2;
  // outputs: the arena's new tensors and the arena rows' new validity
  float* o_uv;
  int* o_host;
  float* o_idepth;
  float* o_idepth_fej;
  float* o_color;
  float* o_weight;
  unsigned char* o_point_valid;
  unsigned char* o_res_active;
  unsigned char* o_imm_valid;    // mode 0
  // scratch: per candidate 8 colours then 8 weights, the inverse depth, readiness
  float* s_cw;
  float* s_rho;
  unsigned char* s_ready;
  unsigned* ticket;              // 0 between launches
};

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

// torch.clamp: NaN stays NaN
__device__ __forceinline__ float clamp_nan(float x, float lo, float hi) {
  return isnan(x) ? x : fminf(fmaxf(x, lo), hi);
}
__device__ __forceinline__ float max_nan(float x, float lo) { return isnan(x) ? x : fmaxf(x, lo); }

__host__ __device__ __forceinline__ int pad16(int n) { return (n + 15) & ~15; }

__device__ __forceinline__ int row_slot(const Args& a, int r) {
  return a.mode == 0 ? r : (a.slot_ptr ? (int)*a.slot_ptr : a.slot_val);
}

// ops/image.py bilinear on an (H, W, 3) image: the base pixel clamped to
// [0, W-2] x [0, H-2] (a NaN coordinate reads pixel 0), the fractions to
// [0, 1] (NaN stays NaN), each channel interpolated with its own roundings.
__device__ __forceinline__ void bilinear3(const float* img, int H, int W, float x, float y,
                                          float out[3]) {
  const float x0f = isnan(x) ? 0.f : fminf(fmaxf(floorf(x), 0.f), (float)(W - 2));
  const float y0f = isnan(y) ? 0.f : fminf(fmaxf(floorf(y), 0.f), (float)(H - 2));
  const long long x0 = (long long)x0f, y0 = (long long)y0f;
  const float dx = clamp_nan(sub(x, x0f), 0.f, 1.f), dy = clamp_nan(sub(y, y0f), 0.f, 1.f);
  const float ex = sub(1.f, dx), ey = sub(1.f, dy);
  const float* p = img + (y0 * W + x0) * 3;
  const float* q = p + (long long)W * 3;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float top = add(mul(__ldg(p + c), ex), mul(__ldg(p + 3 + c), dx));
    const float bot = add(mul(__ldg(q + c), ex), mul(__ldg(q + 3 + c), dx));
    out[c] = add(mul(top, ey), mul(bot, dy));
  }
}

// A candidate's readiness and inverse depth (tracer.mature_mask, then
// add_points' clamp).
__device__ __forceinline__ bool candidate(const Args& a, int r, int i, float& rho) {
  const int j = r * a.K + i;
  if (a.mode == 1) {
    rho = max_nan(a.pt_idepth[i], a.idepth_min);
    return a.pt_valid[i] != 0;
  }
  const float lo = a.imm_lo[j], hi = a.imm_hi[j];
  const float mid = __fsqrt_rn(mul(lo, hi));
  const float relwidth = __fdiv_rn(sub(hi, lo), max_nan(mid, 1e-6f));
  rho = max_nan(mid, a.idepth_min);
  return a.imm_valid[j] != 0 && a.imm_nok[j] >= a.min_traces && relwidth < a.max_relwidth;
}

// Exclusive sum of v over the block's threads, and the total.
__device__ __forceinline__ int block_exclusive(int v, int& total, int* warp_sums) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < WARPS ? warp_sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(FULL, w, o);
      if (lane >= o) w += y;
    }
    if (lane < WARPS) warp_sums[lane] = w;   // inclusive sums of the warps
  }
  __syncthreads();
  total = warp_sums[WARPS - 1];
  const int before = warp == 0 ? 0 : warp_sums[warp - 1];
  __syncthreads();                            // warp_sums free for the next scan
  return before + x - v;
}

__global__ void __launch_bounds__(THREADS) activate_kernel(const Args a) {
  extern __shared__ unsigned char smem[];
  __shared__ int warp_sums[WARPS];
  __shared__ int s_last;
  const int gtid = blockIdx.x * THREADS + threadIdx.x, gstride = gridDim.x * THREADS;

  // every block: its share of the P rows copied into the new tensors, each
  // row's loads issued before its stores (a store may alias a later load,
  // so the compiler keeps a load after an earlier store: interleaved, each
  // pair would wait a memory round trip)
  for (int p = gtid; p < a.P; p += gstride) {
    const float2 uv = reinterpret_cast<const float2*>(a.uv)[p];
    const int host = a.host[p];
    const float rho = a.idepth[p], fej = a.idepth_fej[p];
    const unsigned char pv = a.point_valid[p];
    float4 c[2], w[2];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      c[k] = reinterpret_cast<const float4*>(a.color)[2 * p + k];
      w[k] = reinterpret_cast<const float4*>(a.weight)[2 * p + k];
    }
    reinterpret_cast<float2*>(a.o_uv)[p] = uv;
    a.o_host[p] = host;
    a.o_idepth[p] = rho;
    a.o_idepth_fej[p] = fej;
    a.o_point_valid[p] = pv;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      reinterpret_cast<float4*>(a.o_color)[2 * p + k] = c[k];
      reinterpret_cast<float4*>(a.o_weight)[2 * p + k] = w[k];
    }
  }
  for (int b = gtid; b < a.P * a.F; b += gstride) a.o_res_active[b] = a.res_active[b];
  // and its share of the candidates: readiness, inverse depth, and the
  // ready ones' colours and weights in their host image (every tap's loads
  // before the stores)
  for (int j = gtid; j < a.R * a.K; j += gstride) {
    const int r = j / a.K, i = j - r * a.K;
    float rho;
    const bool ready = candidate(a, r, i, rho);
    const int slot = row_slot(a, r);
    const bool ok = ready && slot >= 0 && slot < a.F;
    float cw[16];
    if (ok) {
      const float* uvp = a.mode == 0 ? a.imm_uv + 2 * j : a.pt_uv + 2 * i;
      const float u = uvp[0], v = uvp[1];
      const float* img = a.images + (long long)slot * a.H * a.W * 3;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        float s[3];
        bilinear3(img, a.H, a.W, add(u, PAT_U[k]), add(v, PAT_V[k]), s);
        const float gsq = add(mul(s[1], s[1]), mul(s[2], s[2]));
        cw[k] = s[0];
        cw[8 + k] = __fsqrt_rn(mul(__frcp_rn(add(gsq, a.c2)), a.c2));
      }
    }
    a.s_ready[j] = ok ? 1 : 0;
    a.s_rho[j] = rho;
    if (a.mode == 0) a.o_imm_valid[j] = (a.imm_valid[j] != 0 && !ready) ? 1 : 0;
    if (ok) {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        reinterpret_cast<float4*>(a.s_cw)[4 * j + k] =
            make_float4(cw[4 * k], cw[4 * k + 1], cw[4 * k + 2], cw[4 * k + 3]);
    }
  }

  // the last block out scans and scatters
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    const bool last = atomicAdd(a.ticket, 1u) == gridDim.x - 1u;
    if (last) __threadfence();
    s_last = last;
  }
  __syncthreads();
  if (!s_last) return;

  // shared memory: the P validity flags, the candidates' readiness, each
  // row's free slots by position, and every candidate's destination
  const int RK = a.R * a.K;
  unsigned char* pv = smem;
  unsigned char* rdy = smem + pad16(a.P);
  int* slots = reinterpret_cast<int*>(smem + pad16(a.P) + pad16(RK));
  int* dest = slots + a.K;
  for (int p = threadIdx.x; p < a.P; p += THREADS) pv[p] = a.point_valid[p];
  for (int j = threadIdx.x; j < RK; j += THREADS) {
    rdy[j] = __ldcg(a.s_ready + j);
    dest[j] = -1;
  }
  __syncthreads();
  // the R dependent scans, in shared memory only
  const int run = (a.P + THREADS - 1) / THREADS;
  const int s0 = min(threadIdx.x * run, a.P), s1 = min(s0 + run, a.P);
  for (int r = 0; r < a.R; ++r) {
    int n_free = 0;
    for (int s = s0; s < s1; ++s) n_free += pv[s] == 0;
    int total;
    int pos = block_exclusive(n_free, total, warp_sums);
    for (int s = s0; s < s1 && pos < a.K; ++s)
      if (pv[s] == 0) slots[pos++] = s;
    __syncthreads();
    const int m = min(a.K, total);
    for (int i = threadIdx.x; i < m; i += THREADS) {
      if (!rdy[r * a.K + i]) continue;
      const int s = slots[i];
      dest[r * a.K + i] = s;
      pv[s] = 1;
    }
    __syncthreads();
  }
  // stage: scans
  // every ready candidate's row written, all at once (its loads first)
  for (int j = threadIdx.x; j < RK; j += THREADS) {
    const int s = dest[j];
    if (s < 0) continue;
    const int r = j / a.K, i = j - r * a.K;
    const int slot = row_slot(a, r);
    const float2 uv = reinterpret_cast<const float2*>(a.mode == 0 ? a.imm_uv + 2 * j
                                                                  : a.pt_uv + 2 * i)[0];
    const float rho = __ldcg(a.s_rho + j);
    float4 cw[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) cw[k] = __ldcg(reinterpret_cast<const float4*>(a.s_cw) + 4 * j + k);
    reinterpret_cast<float2*>(a.o_uv)[s] = uv;
    a.o_host[s] = slot;
    a.o_idepth[s] = rho;
    a.o_idepth_fej[s] = rho;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      reinterpret_cast<float4*>(a.o_color)[2 * s + k] = cw[k];
      reinterpret_cast<float4*>(a.o_weight)[2 * s + k] = cw[2 + k];
    }
    a.o_point_valid[s] = 1;
    for (int f = 0; f < a.F; ++f)
      a.o_res_active[s * a.F + f] = (a.frame_valid[f] != 0 && f != slot) ? 1 : 0;
  }
  // stage: scatter
  if (threadIdx.x == 0) *a.ticket = 0u;
}

int shared_bytes(int P, int K, int R) { return pad16(P) + pad16(R * K) + 4 * K + 4 * R * K; }

}  // namespace

// One launch of the kernel on `stream` (a is filled by the wrapper,
// ops/kf_programs.py, whose ctypes structure mirrors Args field by field).
// Returns the CUDA error of the launch.
extern "C" int kf_activate_launch(const void* args, void* stream) {
  const Args& a = *static_cast<const Args*>(args);
  if (a.P <= 0 || a.F <= 0 || a.F > 32 || a.K < 0 || a.K > a.P || a.R < 0 || a.H < 2 ||
      a.W < 2 || (a.mode != 0 && a.mode != 1))
    return (int)cudaErrorInvalidValue;
  const int smem = shared_bytes(a.P, a.K, a.R);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        activate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int work = a.R * a.K > a.P ? a.R * a.K : a.P;
  int blocks = (work + THREADS - 1) / THREADS;
  blocks = blocks < 1 ? 1 : (blocks > MAX_BLOCKS ? MAX_BLOCKS : blocks);
  activate_kernel<<<blocks, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

// sizeof(Args), for the wrapper's check of its structure.
extern "C" int kf_activate_args_size() { return (int)sizeof(Args); }
