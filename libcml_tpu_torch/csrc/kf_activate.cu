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
// Design. Every block computes the readiness of all R K candidates itself
// (4 loads and a few operations each) as ballot bits in shared memory, and
// runs the R dependent free-slot scans itself: a thread holds a run of at
// most 32 point slots as a bit mask of free slots, a row's scan is the
// block's exclusive sum of the runs' free counts (ballots on the counts'
// bits in a warp, one __syncthreads for the warps' totals), and each run's
// free slots under position K take the row's ready bits at their positions,
// marking those slots taken before the next row (and each landed
// candidate's slot in shared memory). No block waits for another: a block
// then writes its own candidates' rows. A candidate is 4
// threads (2 of its 8 taps each, loaded before the scans), and candidate j
// lives in block j mod G, so the ready ones, which come in runs, spread
// over the grid's SMs (the ticket design of commit cb7cc16 gathered them by
// contiguous share and scattered them from one block: one SM serving a
// warp's 32 scattered lines one at a time took 7.6 us and 3.5 us of its
// 20.7). The arena's valid rows
// are copied before the scans, its free rows after them unless a candidate
// took them. No host read, one launch, no ticket.
//
// Bound: bytes. The arena's rows are read once and written once, the
// candidates' state read once and each ready candidate's 32 texels read;
// the arithmetic is a few hundred operations a candidate. What it costs is
// latency: the candidates' two dependent loads, the R scans (a few hundred
// cycles each) and the launch.
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
constexpr int GROUP = 4;                   // threads a candidate: 2 taps each
constexpr int CANDS = THREADS / GROUP;     // candidates a block
constexpr int MAX_RUN = 32;                // slots a thread's scan mask holds
constexpr int READY_CHUNK = 16;            // candidates' loads a thread issues at once
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
};

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

// torch.clamp: NaN stays NaN
__device__ __forceinline__ float clamp_nan(float x, float lo, float hi) {
  return isnan(x) ? x : fminf(fmaxf(x, lo), hi);
}
__device__ __forceinline__ float max_nan(float x, float lo) { return isnan(x) ? x : fmaxf(x, lo); }

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

// An arena candidate's maturity (tracer.mature_mask) from its loaded
// fields, and then its interval's midpoint
__device__ __forceinline__ bool matured(const Args& a, float lo, float hi, int nok, bool valid,
                                        float& mid) {
  if (!valid || nok < a.min_traces) return false;   // mid is read only when matured
  mid = __fsqrt_rn(mul(lo, hi));
  const float relwidth = __fdiv_rn(sub(hi, lo), max_nan(mid, 1e-6f));
  return relwidth < a.max_relwidth;
}

// A warp's chunk of candidates j = base + 32 u + lane (u < READY_CHUNK): their
// fields, loaded together before any is tested
struct Chunk {
  float lo[READY_CHUNK], hi[READY_CHUNK];
  int nok[READY_CHUNK];
  bool valid[READY_CHUNK];
};
__device__ __forceinline__ void load_chunk(const Args& a, int base, int RK, Chunk& x) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int u = 0; u < READY_CHUNK; ++u) {
    const int j = min(base + 32 * u + lane, RK - 1);
    if (a.mode == 0) {
      x.lo[u] = a.imm_lo[j];
      x.hi[u] = a.imm_hi[j];
      x.nok[u] = a.imm_nok[j];
      x.valid[u] = a.imm_valid[j] != 0;
    } else {
      x.valid[u] = a.pt_valid[j % a.K] != 0;
    }
  }
}
// ... and their part in the scans (ready, and the row's slot a frame slot),
// one ballot word each into `bits`
__device__ __forceinline__ void chunk_bits(const Args& a, int base, int slot1, int RK,
                                           const Chunk& x, unsigned* bits) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int u = 0; u < READY_CHUNK; ++u) {
    bool ok = base + 32 * u + lane < RK;
    float mid;
    if (a.mode == 0) ok = ok && matured(a, x.lo[u], x.hi[u], x.nok[u], x.valid[u], mid);
    else ok = ok && x.valid[u] && slot1 >= 0 && slot1 < a.F;
    const unsigned w = __ballot_sync(FULL, ok);
    if (lane == 0 && base + 32 * u < RK) bits[(base >> 5) + u] = w;
  }
}

// Point row p of the window, its residual flags apart, loaded and stored
// whole (every load before the stores: a store may alias a later load, so
// interleaved each pair would wait a memory round trip)
struct Row {
  float2 uv;
  int host;
  float rho, fej;
  unsigned char pv;
  float4 c[2], w[2];
};
__device__ __forceinline__ Row load_row(const Args& a, int p) {
  Row x;
  x.uv = reinterpret_cast<const float2*>(a.uv)[p];
  x.host = a.host[p];
  x.rho = a.idepth[p];
  x.fej = a.idepth_fej[p];
  x.pv = a.point_valid[p];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    x.c[k] = reinterpret_cast<const float4*>(a.color)[2 * p + k];
    x.w[k] = reinterpret_cast<const float4*>(a.weight)[2 * p + k];
  }
  return x;
}
__device__ __forceinline__ void store_row(const Args& a, int p, const Row& x) {
  reinterpret_cast<float2*>(a.o_uv)[p] = x.uv;
  a.o_host[p] = x.host;
  a.o_idepth[p] = x.rho;
  a.o_idepth_fej[p] = x.fej;
  a.o_point_valid[p] = x.pv;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    reinterpret_cast<float4*>(a.o_color)[2 * p + k] = x.c[k];
    reinterpret_cast<float4*>(a.o_weight)[2 * p + k] = x.w[k];
  }
}

// One block an SM at the smoke's shapes (56 blocks): the registers a thread
// may take are not cut to fit two, so the chunk's and the row's loads stay
// in registers (at the compiler's default of 128 they spilled).
__global__ void __launch_bounds__(THREADS, 1) activate_kernel(const Args a) {
  // bit j of the first ceil(R K / 32) words: candidate j takes part; of the
  // next as many: candidate j landed, in the slot dest[j] of the short array after
  extern __shared__ unsigned smem[];
  __shared__ int s_free[2][WARPS];           // the warps' free counts, by row parity
  __shared__ unsigned s_taken[THREADS];      // each run's slots taken
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int G = gridDim.x, RK = a.R * a.K;
  const int slot1 = a.mode == 1 ? (a.slot_ptr ? (int)*a.slot_ptr : a.slot_val) : 0;
  // stage: activate_start

  // every load that needs nothing loaded first is issued before the first
  // use: this block's candidate j = c G + blockIdx.x (its taps 2q, 2q + 1
  // follow its readiness), this thread's run of point slots [s0, s1), its
  // first point row, every candidate's readiness
  const int c = threadIdx.x / GROUP, q = threadIdx.x % GROUP;
  const int j = c * G + blockIdx.x;
  const int r = j / max(a.K, 1), i = j - r * a.K;
  const int slot = a.mode == 0 ? r : slot1;
  float lo = 0.f, hi = 0.f;   // mode 1: hi is the point's inverse depth
  int nok = 0;
  bool imm_valid = false;
  float2 uv = make_float2(0.f, 0.f);
  if (j < RK) {
    if (a.mode == 0) {
      lo = a.imm_lo[j];
      hi = a.imm_hi[j];
      nok = a.imm_nok[j];
      imm_valid = a.imm_valid[j] != 0;
    } else {
      hi = a.pt_idepth[i];
      imm_valid = a.pt_valid[i] != 0;
    }
    uv = reinterpret_cast<const float2*>(a.mode == 0 ? a.imm_uv + 2 * j : a.pt_uv + 2 * i)[0];
  }
  const int run = (a.P + THREADS - 1) / THREADS;
  const int s0 = min((int)threadIdx.x * run, a.P), s1 = min(s0 + run, a.P);
  unsigned valid = 0u;
  for (int s = s0; s < s1; ++s) valid |= (unsigned)(a.point_valid[s] != 0) << (s - s0);
  const unsigned run_mask = s1 - s0 >= 32 ? FULL : (1u << (s1 - s0)) - 1u;
  const int gtid = blockIdx.x * THREADS + threadIdx.x, gstride = G * THREADS;
  Row held;
  if (gtid < a.P) held = load_row(a, gtid);
  const int words = (RK + 31) >> 5;
  unsigned* ready_bits = smem;
  unsigned* landed = smem + words;
  short* dest = reinterpret_cast<short*>(smem + 2 * words);
  for (int w = threadIdx.x; w < words; w += THREADS) landed[w] = 0u;
  const int first_base = warp * 32 * READY_CHUNK;
  Chunk chunk;
  if (first_base < RK) load_chunk(a, first_base, RK, chunk);
  const int b0 = gtid;   // this thread's first residual flag, and its row's validity
  const bool flag_held = b0 < a.P * a.F;
  unsigned char flag = 0, flag_row_valid = 0;
  if (flag_held) {
    flag = a.res_active[b0];
    flag_row_valid = a.point_valid[b0 / a.F];
  }
  // the candidate's readiness, inverse depth (add_points' clamp), colours
  // and weights in its host image
  float rho = hi;
  bool ready = imm_valid;
  if (a.mode == 0) ready = matured(a, lo, hi, nok, imm_valid, rho);
  rho = max_nan(rho, a.idepth_min);
  ready = ready && j < RK;
  const bool ok = ready && slot >= 0 && slot < a.F;
  if (j < RK && a.mode == 0 && q == 0) a.o_imm_valid[j] = (imm_valid && !ready) ? 1 : 0;
  float2 col = make_float2(0.f, 0.f), wgt = col;
  if (ok) {
    const float* img = a.images + (long long)slot * a.H * a.W * 3;
    float s[2][3];
#pragma unroll
    for (int t = 0; t < 2; ++t)
      bilinear3(img, a.H, a.W, add(uv.x, PAT_U[2 * q + t]), add(uv.y, PAT_V[2 * q + t]), s[t]);
    float cw[4];
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const float gsq = add(mul(s[t][1], s[t][1]), mul(s[t][2], s[t][2]));
      cw[t] = s[t][0];
      cw[2 + t] = __fsqrt_rn(mul(__frcp_rn(add(gsq, a.c2)), a.c2));
    }
    col = make_float2(cw[0], cw[1]);
    wgt = make_float2(cw[2], cw[3]);
  }
  // every candidate's part in the scans: a warp's chunks of 32 READY_CHUNK
  if (first_base < RK) chunk_bits(a, first_base, slot1, RK, chunk, ready_bits);
  for (int base = first_base + THREADS * READY_CHUNK; base < RK; base += THREADS * READY_CHUNK) {
    load_chunk(a, base, RK, chunk);
    chunk_bits(a, base, slot1, RK, chunk, ready_bits);
  }
  // the valid rows copied now (no candidate lands on them)
  if (gtid < a.P && held.pv) store_row(a, gtid, held);
  for (int p = gtid + gstride; p < a.P; p += gstride)
    if (a.point_valid[p]) store_row(a, p, load_row(a, p));
  if (flag_held && flag_row_valid) a.o_res_active[b0] = flag;
  for (int b = b0 + gstride; b < a.P * a.F; b += gstride) {   // both loads before the test
    const unsigned char pv = a.point_valid[b / a.F], act = a.res_active[b];
    if (pv) a.o_res_active[b] = act;
  }
  // stage: candidates
  __syncthreads();

  // the R dependent scans: position pos of row r takes the pos-th free slot
  // as rows 0..r-1 left them, ready or not
  const unsigned lanes_below = (1u << lane) - 1u;
  unsigned taken = 0u;
  for (int row = 0; row < a.R; ++row) {
    const unsigned free = ~(valid | taken) & run_mask;
    const int n = __popc(free);
    int before = 0, total = 0;   // the warp's exclusive sum and total of n (n <= 32)
#pragma unroll
    for (int b = 0; b < 6; ++b) {
      const unsigned m = __ballot_sync(FULL, (n >> b) & 1);
      before += __popc(m & lanes_below) << b;
      total += __popc(m) << b;
    }
    if (lane == 0) s_free[row & 1][warp] = total;
    __syncthreads();
    before += __reduce_add_sync(FULL, lane < warp ? s_free[row & 1][lane] : 0);
    if (n > 0 && before < a.K) {
      // the ready bits of positions before .. before + m - 1 of this row
      const int g = row * a.K + before, wd = g >> 5, m = min(n, a.K - before);
      const unsigned long long pair =
          ((unsigned long long)(wd + 1 < words ? ready_bits[wd + 1] : 0u) << 32) | ready_bits[wd];
      unsigned ready = (unsigned)(pair >> (g & 31)) & (m == 32 ? FULL : (1u << m) - 1u);
      unsigned f = free;
      for (int k = 0; ready; ++k, ready >>= 1) {   // position k takes the k-th free slot
        const int b = __ffs(f) - 1;
        f &= f - 1u;
        if (ready & 1u) {
          taken |= 1u << b;
          atomicOr(landed + ((g + k) >> 5), 1u << ((g + k) & 31));
          dest[g + k] = (short)(s0 + b);
        }
      }
    }
  }
  s_taken[threadIdx.x] = taken;
  // stage: scans
  __syncthreads();

  // this block's landed candidates' rows, and its free rows that none took
  if (ok && ((landed[j >> 5] >> (j & 31)) & 1u)) {
    const int s = dest[j];
    reinterpret_cast<float2*>(a.o_color + 8 * (long long)s)[q] = col;
    reinterpret_cast<float2*>(a.o_weight + 8 * (long long)s)[q] = wgt;
    if (q == 0) {
      reinterpret_cast<float2*>(a.o_uv)[s] = uv;
      a.o_host[s] = slot;
      a.o_idepth[s] = rho;
      a.o_idepth_fej[s] = rho;
      a.o_point_valid[s] = 1;
    }
    for (int f = q; f < a.F; f += GROUP)
      a.o_res_active[(long long)s * a.F + f] = (a.frame_valid[f] != 0 && f != slot) ? 1 : 0;
  }
  auto untaken_free = [&](int p) {
    const int owner = p / run;
    return !a.point_valid[p] && !((s_taken[owner] >> (p - owner * run)) & 1u);
  };
  if (gtid < a.P && untaken_free(gtid)) store_row(a, gtid, held);
  for (int p = gtid + gstride; p < a.P; p += gstride)
    if (untaken_free(p)) store_row(a, p, load_row(a, p));
  if (flag_held && !flag_row_valid && untaken_free(b0 / a.F)) a.o_res_active[b0] = flag;
  for (int b = b0 + gstride; b < a.P * a.F; b += gstride) {
    const unsigned char act = a.res_active[b];
    if (untaken_free(b / a.F)) a.o_res_active[b] = act;
  }
  // stage: scatter
}

}  // namespace

// One launch of the kernel on `stream` (a is filled by the wrapper,
// ops/kf_programs.py, whose ctypes structure mirrors Args field by field):
// ceil(R K / 64) blocks of 256. Returns the CUDA error of the launch.
extern "C" int kf_activate_launch(const void* args, void* stream) {
  const Args& a = *static_cast<const Args*>(args);
  if (a.P <= 0 || a.P > THREADS * MAX_RUN || a.F <= 0 || a.F > 32 || a.K < 0 || a.K > a.P ||
      a.R < 0 || a.H < 2 || a.W < 2 || (a.mode != 0 && a.mode != 1))
    return (int)cudaErrorInvalidValue;
  const long long rk = (long long)a.R * a.K;
  const long long smem = 8 * ((rk + 31) / 32) + 2 * rk;   // two bit sets, the slots
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const long long blocks = rk > 0 ? (rk + CANDS - 1) / CANDS : 1;
  activate_kernel<<<(unsigned)blocks, THREADS, (size_t)smem, static_cast<cudaStream_t>(stream)>>>(
      a);
  return (int)cudaGetLastError();
}

// sizeof(Args), for the wrapper's check of its structure.
extern "C" int kf_activate_args_size() { return (int)sizeof(Args); }
