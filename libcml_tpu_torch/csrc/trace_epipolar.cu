// The direct frame's epipolar tracer, one launch a call, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package leaves this sweep to XLA, which
// fuses `trace_immatures_rows` (libcml_tpu/models/direct/tracer.py:185)
// and the `trace_immatures` it calls (:224) into a few device programs.
// Its plain PyTorch form is `trace_immatures_rows_plain` in
// libcml_tpu_torch/models/direct/tracer.py (same arguments and results).
//
// For the R most recently seeded arena rows (`rows`, -1 as padding) every
// immature point of a live host slot searches S = 16 log-spaced inverse
// depths inside its [rho_lo, rho_hi]: the 8-pixel pattern unprojected from
// the host, moved by T_oh = T_obs o T_host^-1 and projected into the
// observer, channel 0 of the observer's level-0 gradient image sampled
// bilinearly, the SSD against the stored colours (1e12 where a hypothesis
// fails z > 1e-6 or the 2-pixel border), the first-occurrence argmin, the
// second best outside a +-2-step window, the parabolic refine, the pixel
// span from the first hypothesis to the last, the gates, and the interval
// narrowed to best +- 1.2 steps. One launch writes the whole new arena:
// rows that are not traced (and the -1 padding) are copied through. The
// kernel is functional: it reads the old arena and writes new tensors,
// since the pipelined retrack and a checkpoint may hold the old one.
//
// What bounds it on the H100: neither bytes (the arena in and out and the
// texels, ~0.6 MB at the main path's 7 x 512 arena) nor operations (~3.5
// MFLOP) but latency: a point's result needs a chain of dependent steps
// (its entry and poses from memory, the relative pose, 16 x 8 projections,
// 4 texel loads each, an 8-term sum, an argmin over 16, the refine), above
// a launch floor of ~4.7 us that an empty kernel takes through the same
// route. The first design, stamped (tools/trace_stages.py, PERF.md): 3.9 us
// above the floor, of which a trip for the traced rows' indices, a second
// for the poses behind the ballot, 1.6 us of samples (~0.9 us of a lane's
// arithmetic, each pixel's quotient ending its chain before the next
// pixel's began, then the texel trip) and ~0.4 us of shuffle butterflies.
// This design keeps the chain in one warp and off memory, and shortens it
// (~3.2 us above the floor, PERF.md):
// - One warp an arena entry (F x K warps, 8 a block). Every load an entry
//   needs is issued at the start, before any is used: the traced rows and
//   the slots' flags (a lane each), the entry (its pixel as a float2, its
//   colours as two float4, its interval and statuses) and both poses, so
//   one trip to memory brings them all. A warp whose row is not traced
//   copies the entry; a traced point whose slot is dead or which is invalid
//   takes the plain form's status update without a sweep (its results do
//   not depend on the sweep).
// - Two lanes a hypothesis, four pattern pixels each (the even ones and the
//   odd ones), taken in phases: the four projections, the four quotients,
//   the four pixels and their sixteen texel loads, the interpolations; one
//   shuffle adds the halves. 1 / fx and 1 / fy come from the host, rounded
//   as the kernel would round them.
// - The argmin is two redux.sync minima, exact: over each SSD's bits (a
//   non-negative float orders as its bits; a NaN takes the least key, as
//   torch.argmin counts it the smallest), then over the hypotheses that
//   hold the least (the first occurrence). The second best is one more
//   over bits (a NaN wins, as torch.amin); f0, f1, f2 and the grid at the
//   refine's centre are read from their lanes by shuffles. Lane 0 writes.
//   No shared memory, no atomics: every output has one writer, so repeated
//   runs give the same bits. The runner-up and the border margin are probes
//   alone: computed only when a probe buffer is given, under a branch every
//   lane of the grid takes alike.
// - A lane of the warp holds a traced row index (R <= 32) and one host
//   slot's validity bit (F <= 32): two ballots find an entry's source trace
//   (the first listed, as the plain form's scatter) and its slot's flag.
// Measured and dropped (PERF.md): sweep blocks over the traced rows only,
// with the other rows copied by blocks of 16-byte chunks (one more trip:
// rows, then the entry; slower cold); one T_oh a block in shared memory
// behind a barrier; the entry and poses loaded a word a lane and handed
// out by shuffles (within the runs' spread).
// Rounding: the plain form's arithmetic as the card rounds it, so that the
// two agree bit for bit where the card's libraries round as measured
// (PERF.md). No FMA contraction and no fast math: every elementwise
// product, sum and quotient is rounded on its own (__fmul_rn, __fadd_rn,
// __fdiv_rn) in the plain form's order; a division by a Python number is a
// product with its float reciprocal, as PyTorch computes it on the card;
// expf and logf are the accurate library functions. The 3x3 products take
// the card's matrix-product rounding (dot3, mv3), and the 8-term SSD the
// order of its sum reduction. Where a library rounds otherwise, near-tied
// hypotheses may resolve otherwise: ops/trace_epipolar.py's `parity` holds
// the results, and the optional probe buffer gives, for every swept point,
// the values that decide them.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int S = 16;                 // hypotheses (cfg.trace_steps)
constexpr int NP = 8;                 // pattern pixels (residuals.PATTERN)
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int MAX_ROWS = 32;          // a lane each: traced rows and host slots
constexpr int PROBES = 7;             // best, best_ssd, runner_up, second, span, edge, dlog
constexpr unsigned FULL = 0xffffffffu;
constexpr float BIG = 1e12f;


struct Args {
  const float* uv;          // (F, K, 2)
  const float* color;       // (F, K, 8)
  const float* rho_lo;      // (F, K)
  const float* rho_hi;
  const int32_t* n_ok;
  const int32_t* n_fail;
  const uint8_t* valid;
  const int32_t* rows;      // (R,)
  const float* R_host;      // (F, 3, 3)
  const float* t_host;      // (F, 3)
  const uint8_t* host_valid;  // (F,)
  const float* grad;        // (H, W, 3), channel 0 sampled
  const float* R_obs;       // (3, 3)
  const float* t_obs;       // (3,)
  float* uv_out;
  float* color_out;
  float* lo_out;
  float* hi_out;
  int32_t* n_ok_out;
  int32_t* n_fail_out;
  uint8_t* valid_out;
  float* probes;            // (R, K, PROBES) or null
  int F, K, R, H, W;
  float fx, fy, cx, cy;
  float step;               // float32(1 / (S - 1)): the grid's fractions and step
  float min_quality;
  float ifx, ify;           // float32(1 / fx), float32(1 / fy), as quo(1, fx) rounds them
};

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float quo(float a, float b) { return __fdiv_rn(a, b); }

// torch.clamp: NaN stays NaN
__device__ __forceinline__ float clamp_nan(float x, float lo, float hi) {
  return isnan(x) ? x : fminf(fmaxf(x, lo), hi);
}
__device__ __forceinline__ float max_nan(float x, float lo) { return isnan(x) ? x : fmaxf(x, lo); }

// A 3-term dot product as the card's matrix products round it: a product of
// two 3x3 matrices (and einsum's batched product) as a fused multiply-add
// chain in index order from the first product; a matrix times a vector as
// the first two terms' chain plus the third product.
__device__ __forceinline__ float dot3(float a0, float a1, float a2, float b0, float b1,
                                      float b2) {
  return __fmaf_rn(a2, b2, __fmaf_rn(a1, b1, mul(a0, b0)));
}
__device__ __forceinline__ float mv3(float a0, float a1, float a2, float b0, float b1,
                                     float b2) {
  return add(__fmaf_rn(a1, b1, mul(a0, b0)), mul(a2, b2));
}

// residuals.PATTERN's pixel p of this lane's parity for step j of a lane's
// four, p = h, h+4, h+2, h+6 (h = 0 or 1): (0,-2) (-1,-1) (1,-1) (-2,0)
// (0,0) (2,0) (-1,1) (0,2), selected by constants (j is unrolled)
__device__ __forceinline__ void pattern(int j, int half, float& pu, float& pv) {
  switch (j) {
    case 0: pu = half ? -1.f : 0.f; pv = half ? -1.f : -2.f; break;   // 1 : 0
    case 1: pu = half ? 2.f : 0.f; pv = 0.f; break;                    // 5 : 4
    case 2: pu = half ? -2.f : 1.f; pv = half ? 0.f : -1.f; break;     // 3 : 2
    default: pu = half ? 0.f : -1.f; pv = half ? 2.f : 1.f; break;     // 7 : 6
  }
}

// ops/image.py bilinear on channel 0 of an (H, W, 3) image, in two halves so
// that a lane's four gathers issue together: the base pixel clamped to
// [0, W-2] x [0, H-2] (a NaN coordinate reads pixel 0) and its four texels
// (32-bit offsets: H W 3 < 2^31, ops/trace_epipolar.py checks it), the
// fractions clamped to [0, 1] (NaN stays NaN); then the interpolation.
struct Taps {
  float v00, v01, v10, v11, dx, dy;
};

__device__ __forceinline__ Taps gather0(const float* img, int H, int W, float x, float y) {
  const float x0f = isnan(x) ? 0.f : fminf(fmaxf(floorf(x), 0.f), (float)(W - 2));
  const float y0f = isnan(y) ? 0.f : fminf(fmaxf(floorf(y), 0.f), (float)(H - 2));
  const int x0 = (int)x0f, y0 = (int)y0f;
  const float* p = img + (y0 * W + x0) * 3;
  return {__ldg(p), __ldg(p + 3), __ldg(p + W * 3), __ldg(p + W * 3 + 3),
          clamp_nan(sub(x, x0f), 0.f, 1.f), clamp_nan(sub(y, y0f), 0.f, 1.f)};
}

__device__ __forceinline__ float interp(const Taps& t) {
  const float ex = sub(1.f, t.dx), ey = sub(1.f, t.dy);
  const float top = add(mul(t.v00, ex), mul(t.v01, t.dx));
  const float bot = add(mul(t.v10, ex), mul(t.v11, t.dx));
  return add(mul(top, ey), mul(bot, t.dy));
}

// The first-occurrence argmin of torch.argmin over the 16 hypotheses (two
// lanes each, holding the same SSD), a NaN the smallest: a non-negative
// float orders as its bits, so the least key (0 for a NaN, else the bits
// plus one) is the least SSD, and the least hypothesis among the lanes that
// hold it the first occurrence. Two redux.sync, exact.
__device__ __forceinline__ int argmin_first(float ssd, int s) {
  const unsigned key = isnan(ssd) ? 0u : __float_as_uint(ssd) + 1u;
  const unsigned kmin = __reduce_min_sync(FULL, key);
  return (int)__reduce_min_sync(FULL, key == kmin ? (unsigned)s : (unsigned)S);
}

// The least of x over the warp as min_nan takes it (a NaN wins), for x >= 0.
__device__ __forceinline__ float warp_min_nan(float x) {
  const unsigned kmin = __reduce_min_sync(FULL, isnan(x) ? 0u : __float_as_uint(x) + 1u);
  return kmin == 0u ? __int_as_float(0x7fffffff) : __uint_as_float(kmin - 1u);
}

// The least of x over the warp as fminf takes it (a NaN loses), for x >= 0.
__device__ __forceinline__ float warp_fmin(float x) {
  const unsigned kmin = __reduce_min_sync(FULL, isnan(x) ? 0xffffffffu : __float_as_uint(x));
  return kmin == 0xffffffffu ? __int_as_float(0x7fffffff) : __uint_as_float(kmin);
}

__global__ void __launch_bounds__(THREADS) trace_epipolar_kernel(const Args a) {
  // stage: start
  const int lane = threadIdx.x & 31;
  const long long e = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (e >= (long long)a.F * a.K) return;         // a whole warp leaves together
  const int f = (int)(e / a.K), k = (int)(e % a.K);

  // every load the entry needs, issued before any is used: the traced rows
  // and the slots' flags (a lane each), the entry (its pixel and colours as
  // vectors, its interval and statuses) and both poses, so that one trip to
  // memory brings them all
  const int my_row = lane < a.R ? __ldg(a.rows + lane) : -1;
  const bool my_live = lane < a.F && __ldg(a.host_valid + lane) != 0;
  const float2 uv = __ldg(reinterpret_cast<const float2*>(a.uv) + e);
  const float4 c_lo = __ldg(reinterpret_cast<const float4*>(a.color + e * NP));
  const float4 c_hi = __ldg(reinterpret_cast<const float4*>(a.color + e * NP) + 1);
  const float lo_in = __ldg(a.rho_lo + e), hi_in = __ldg(a.rho_hi + e);
  const int n_ok = __ldg(a.n_ok + e), n_fail = __ldg(a.n_fail + e);
  const bool valid = __ldg(a.valid + e) != 0;
  const float* Rh = a.R_host + (size_t)f * 9;
  const float* th = a.t_host + (size_t)f * 3;
  float Rt[3][3], Ro[3][3], t_h[3], t_o[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      Rt[i][j] = __ldg(Rh + j * 3 + i);
      Ro[i][j] = __ldg(a.R_obs + i * 3 + j);
    }
    t_h[i] = __ldg(th + i);
    t_o[i] = __ldg(a.t_obs + i);
  }

  const unsigned hit = __ballot_sync(FULL, my_row == f);
  const unsigned live = __ballot_sync(FULL, my_live);
  // stage: index

  // the entry's pixel and colours never change: copied by lanes 0-2
  if (lane == 0)
    reinterpret_cast<float4*>(a.color_out + e * NP)[0] = c_lo;
  else if (lane == 1)
    reinterpret_cast<float4*>(a.color_out + e * NP)[1] = c_hi;
  else if (lane == 2)
    reinterpret_cast<float2*>(a.uv_out)[e] = uv;

  if (hit == 0) {                                 // not traced: copied through
    if (lane == 0) {
      a.lo_out[e] = lo_in;
      a.hi_out[e] = hi_in;
      a.n_ok_out[e] = n_ok;
      a.n_fail_out[e] = n_fail;
      a.valid_out[e] = valid;
    }
    // stage: copied
    return;
  }
  const int r = __ffs(hit) - 1;                  // the first listed trace of row f
  if (!valid || !((live >> f) & 1u)) {
    // ok is false whatever the sweep gives: the interval and n_ok stay,
    // a valid point on a dead slot counts a failure
    if (lane == 0) {
      const int nf = n_fail + (valid ? 1 : 0);
      a.lo_out[e] = lo_in;
      a.hi_out[e] = hi_in;
      a.n_ok_out[e] = n_ok;
      a.n_fail_out[e] = nf;
      a.valid_out[e] = valid && nf < 4;
    }
    return;
  }

  // T_oh = T_obs o T_host^-1 (SE3.inverse, SE3.compose)
  float ti[3], Roh[3][3], toh[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) ti[i] = -mv3(Rt[i][0], Rt[i][1], Rt[i][2], t_h[0], t_h[1], t_h[2]);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j)
      Roh[i][j] = dot3(Ro[i][0], Ro[i][1], Ro[i][2], Rt[0][j], Rt[1][j], Rt[2][j]);
    toh[i] = add(mv3(Ro[i][0], Ro[i][1], Ro[i][2], ti[0], ti[1], ti[2]), t_o[i]);
  }
  // stage: pose

  // the hypothesis grid: log of the clamped interval, XLA's linspace
  // fractions (the last exactly 1)
  const int s = lane >> 1, half = lane & 1;
  const float lo = logf(max_nan(lo_in, 1e-6f));
  const float hi = logf(max_nan(hi_in, 2e-6f));
  const float width = sub(hi, lo);
  const float frac = s == S - 1 ? 1.f : mul((float)s, a.step);
  const float lg = add(lo, mul(width, frac));
  const float depth = quo(1.f, max_nan(expf(lg), 1e-12f));

  // this lane's pattern pixels h, h+4, h+2, h+6 and their colours
  const float col[4] = {half ? c_lo.y : c_lo.x, half ? c_hi.y : c_hi.x,
                        half ? c_lo.w : c_lo.z, half ? c_hi.w : c_hi.z};
  const float u_max = (float)(a.W - 3), v_max = (float)(a.H - 3);
  const bool probe = a.probes != nullptr;       // the same for every lane
  // the four pixels in phases, each op of a pixel in the plain form's
  // order: the projections, then the four quotients (each one's slow-path
  // branch would otherwise end a pixel's chain before the next starts),
  // then the pixels and the sixteen gathers, then the interpolations
  float Y0[4], Y1[4], z[4], iz[4], uo[4], vo[4], sq[4], edge = INFINITY;
  Taps tap[4];
  bool ok = true;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float pu, pv;
    pattern(j, half, pu, pv);
    const float x = mul(sub(add(uv.x, pu), a.cx), a.ifx);
    const float y = mul(sub(add(uv.y, pv), a.cy), a.ify);
    const float X0 = mul(x, depth), X1 = mul(y, depth);
    Y0[j] = add(dot3(Roh[0][0], Roh[0][1], Roh[0][2], X0, X1, depth), toh[0]);
    Y1[j] = add(dot3(Roh[1][0], Roh[1][1], Roh[1][2], X0, X1, depth), toh[1]);
    z[j] = add(dot3(Roh[2][0], Roh[2][1], Roh[2][2], X0, X1, depth), toh[2]);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) iz[j] = quo(1.f, fabsf(z[j]) < 1e-12f ? 1e-12f : z[j]);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    uo[j] = add(mul(mul(a.fx, Y0[j]), iz[j]), a.cx);
    vo[j] = add(mul(mul(a.fy, Y1[j]), iz[j]), a.cy);
    ok = ok && z[j] > 1e-6f && uo[j] >= 2.f && uo[j] <= u_max && vo[j] >= 2.f &&
         vo[j] <= v_max;
    tap[j] = gather0(a.grad, a.H, a.W, uo[j], vo[j]);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float d = sub(interp(tap[j]), col[j]);
    sq[j] = mul(d, d);
    if (probe)
      edge = fminf(edge, fminf(fminf(fabsf(uo[j] - 2.f), fabsf(uo[j] - u_max)),
                               fminf(fabsf(vo[j] - 2.f), fabsf(vo[j] - v_max))));
  }
  const float u_p0 = uo[0], v_p0 = vo[0];
  // stage: samples
  // the hypothesis's SSD in the card's sum reduction's order over the 8
  // pattern pixels, ((0+4)+(2+6)) + ((1+5)+(3+7)): a lane holds the even
  // or the odd pixels; every lane takes every shuffle and every reduction
  // (a lane that skipped one would trade the wrong values in all those
  // after it)
  const float part = add(add(sq[0], sq[1]), add(sq[2], sq[3]));
  const float other = __shfl_xor_sync(FULL, part, 1);
  const int other_ok = __shfl_xor_sync(FULL, (int)ok, 1);
  const bool pair_ok = ok && other_ok != 0;
  const float ssd = pair_ok ? (half ? add(other, part) : add(part, other)) : BIG;

  const int best = argmin_first(ssd, s);
  const float best_ssd = __shfl_sync(FULL, ssd, 2 * best);
  // the second best outside the +-2-step window
  const float second = warp_min_nan(abs(s - best) <= 2 ? BIG : ssd);
  float runner = INFINITY;                         // any other hypothesis
  if (probe) {                                     // every lane takes these reductions
    runner = warp_fmin(s == best ? INFINITY : ssd);
    edge = warp_fmin(edge);
  }
  const float quality = quo(second, max_nan(best_ssd, 1e-6f));
  // stage: argmin

  // the parabolic refine about clamp(best, 1, S - 2), in log inverse depth
  const int bm = min(max(best, 1), S - 2);
  const float f0 = __shfl_sync(FULL, ssd, 2 * (bm - 1));
  const float f1 = __shfl_sync(FULL, ssd, 2 * bm);
  const float f2 = __shfl_sync(FULL, ssd, 2 * (bm + 1));
  const float lg_bm = __shfl_sync(FULL, lg, 2 * bm);
  const float denom = add(sub(f0, mul(2.f, f1)), f2);
  const float delta =
      clamp_nan(fabsf(denom) > 1e-9f ? quo(mul(0.5f, sub(f0, f2)), denom) : 0.f, -1.f, 1.f);
  const float dlog = mul(width, a.step);            // step: quo(1, S - 1) exactly
  const float log_best = add(lg_bm, mul(delta, dlog));
  const float reach = mul(1.2f, dlog);

  // the span: pattern pixel 0 of the first hypothesis (lane 0) to the last (lane 30)
  const float du = sub(__shfl_sync(FULL, u_p0, 2 * (S - 1)), __shfl_sync(FULL, u_p0, 0));
  const float dv = sub(__shfl_sync(FULL, v_p0, 2 * (S - 1)), __shfl_sync(FULL, v_p0, 0));
  const float span = __fsqrt_rn(add(mul(du, du), mul(dv, dv)));
  // stage: refine

  if (lane == 0) {
    const bool good = best_ssd < BIG && best_ssd < 8.f * 12.f * 12.f && quality > a.min_quality;
    const bool informative = good && span > 1.f;
    a.lo_out[e] = informative ? max_nan(expf(sub(log_best, reach)), 1e-5f) : lo_in;
    a.hi_out[e] = informative ? expf(add(log_best, reach)) : hi_in;
    a.n_ok_out[e] = n_ok + (informative ? 1 : 0);
    const int nf = good ? n_fail : n_fail + 1;
    a.n_fail_out[e] = nf;
    a.valid_out[e] = nf < 4;
    if (probe) {
      float* pr = a.probes + ((size_t)r * a.K + k) * PROBES;
      pr[0] = (float)best;
      pr[1] = best_ssd;
      pr[2] = runner;
      pr[3] = second;
      pr[4] = span;
      pr[5] = edge;
      pr[6] = dlog;
    }
  }
  // stage: stored
}

}  // namespace

// in: uv, color, rho_lo, rho_hi, n_ok, n_fail, valid, rows, R_host, t_host,
//     host_valid, grad, R_obs, t_obs; out: uv, color, rho_lo, rho_hi, n_ok,
//     n_fail, valid; dims: F, K, R, H, W; conf: fx, fy, cx, cy, step,
//     min_quality, 1 / fx, 1 / fy (float32 quotients). Returns the launch's
//     cudaError_t.
extern "C" int trace_epipolar_launch(const void* const* in, void* const* out, const int* dims,
                                     const float* conf, void* probes, void* stream) {
  Args a{static_cast<const float*>(in[0]), static_cast<const float*>(in[1]),
         static_cast<const float*>(in[2]), static_cast<const float*>(in[3]),
         static_cast<const int32_t*>(in[4]), static_cast<const int32_t*>(in[5]),
         static_cast<const uint8_t*>(in[6]), static_cast<const int32_t*>(in[7]),
         static_cast<const float*>(in[8]), static_cast<const float*>(in[9]),
         static_cast<const uint8_t*>(in[10]), static_cast<const float*>(in[11]),
         static_cast<const float*>(in[12]), static_cast<const float*>(in[13]),
         static_cast<float*>(out[0]), static_cast<float*>(out[1]), static_cast<float*>(out[2]),
         static_cast<float*>(out[3]), static_cast<int32_t*>(out[4]),
         static_cast<int32_t*>(out[5]), static_cast<uint8_t*>(out[6]),
         static_cast<float*>(probes), dims[0], dims[1], dims[2], dims[3], dims[4],
         conf[0], conf[1], conf[2], conf[3], conf[4], conf[5], conf[6], conf[7]};
  if (a.F <= 0 || a.F > MAX_ROWS || a.K <= 0 || a.R < 0 || a.R > MAX_ROWS || a.H < 2 || a.W < 2 ||
      3LL * a.H * a.W >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const long long warps = (long long)a.F * a.K;
  const unsigned int blocks = (unsigned int)((warps + WARPS - 1) / WARPS);
  trace_epipolar_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
