// The keyframe triangulation after the epipolar match, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: it is the rest of the XLA program
// `_epipolar_triangulate` (libcml_tpu/runtime/hybrid.py:195) after its
// `match_epipolar`, which the port ran as ~2,100 PyTorch launches a call
// (the 40 golden-section steps of `_min_cost_t` a Python loop of ~40
// launches each). One launch computes, for each query row i of the match:
//   - orientation_check (libcml_tpu/models/indirect/matching.py:123): the
//     angle difference angle0[i] - angle1[idx[i]] in float32, its remainder
//     in [0, 2 pi) as torch.remainder (fmodf, then + 2 pi for a negative
//     value, which can round to 2 pi and land in the clamped bin 29), the
//     bin by int32 truncation of x 30 / (2 pi), the 30-bin histogram of the
//     valid rows, its top 3 by a stable sort of -hist (ties to the lower
//     bin), a top bin kept when it holds at least max(hist[top0] / 10, 1);
//   - optimal_correct (libcml_tpu/models/indirect/triangulation.py:72):
//     Hartley-Sturm's translation to the points, the epipoles of the
//     translated F' as cross products (the right null vector from two rows,
//     the left from two columns, the pair with the largest cross product;
//     the reference's SVD vector differs in sign and scale, which the
//     normalisation and the rotations undo), the pencil cost minimised by
//     _min_cost_t (:33): 129 tan-spaced angles as torch.linspace makes
//     them (start + i step below the middle, end - (128 - i) step from it),
//     the first index on ties, then (where the reference takes 40
//     golden-section steps) a section search over the warp's lanes, then
//     the t -> inf asymptote when it costs less; the corrected pixels
//     transferred back;
//   - triangulate_linear (libcml_tpu/models/indirect/pnp.py:131): the DLT's
//     3x3 normal equations + 1e-9 I, solved by Cramer's rule, positive
//     depth (> 1e-4) in both views, and the depth test (1e-3, 1e4).
// T_10 and F come from the match's launch (csrc/hamming_match.cu
// epi_geometry, `geom`), so the two launches need no host wait.
// Arithmetic: the bins in float32 exactly as the plain form (they must
// agree bit for bit); the correction and the DLT in double from the
// float32 inputs (the plain form's float32 SVD and solve sit ~1e-4 px from
// float64 at a short baseline; this kernel sits on float64's side).
// What bounds it on this card: neither bytes (~60 kB a call) nor operations
// (~4e5 flops) but latency: a row is a chain of ~210 dependent cost
// evaluations, each a double tan and two divisions (~0.34 us each when a
// thread takes a row), and the histogram of N rows is a chain of dependent
// loads. So a warp takes a row: its lanes evaluate the 129 grid points
// (i = lane + 32 k, at most five a lane; their tangents, the same for every
// row, made once a block) and find the first minimum by shuffles under the
// sequential loop's rule (`takes`); then, in place of the 40 golden-section
// steps (two dependent costs each), 7 rounds of a section search over the
// lanes (32 costs at once, the bracket kept around the smallest), so the
// chain is ~13 evaluations; the DLT's three Cramer quotients go to three
// lanes. The corrected pixels differ from the golden section's by what the
// bracket's last widths allow (~1e-10 rad; the card's verdict holds them
// within MODEL_TOL of the golden model and of float64). Each block of ROWS
// warps builds the whole histogram itself (no second launch, no grid
// barrier), its loads issued together, and reads it only after its rows
// are corrected, so the histogram's latency hides behind theirs.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int ROWS = 8;                          // rows (warps) a block
constexpr int TPB = 32 * ROWS;
constexpr int HIST_ROWS = 8;                     // histogram rows a thread loads at once
constexpr int NBINS = 30;
constexpr int KEEP = 3;
constexpr int GRID = 129;
constexpr int SECTIONS = 7;                      // the section search's rounds
constexpr float TWO_PI_F = 6.28318548f;          // float32(2 pi)
constexpr float BIN_SCALE_F = 4.77464819f;       // float32(30 / (2 pi))

struct TriArgs {
  const float* uv0;       // (N, 2)
  const float* uv1;       // (M, 2)
  const float* angle0;    // (N,)
  const float* angle1;    // (M,)
  const int64_t* idx;     // (N,) the match's column
  const uint8_t* valid;   // (N,) the match's validity
  const double* geom;     // F (9), R_10 (9), t_10 (3), |t_10|
  double fx, fy, cx, cy;
  int N, M, optimal;
  float* X0;              // (N, 3)
  uint8_t* ok;            // (N,)
  float* probe;           // (N, 4) corrected uv0, uv1, or nullptr
};

__device__ __forceinline__ int bin_of(float angle0, float angle1) {
  const float d = __fsub_rn(angle0, angle1);
  float r = fmodf(d, TWO_PI_F);
  if (r != 0.f && r < 0.f) r = __fadd_rn(r, TWO_PI_F);
  const int b = (int)__fmul_rn(r, BIN_SCALE_F);
  return min(max(b, 0), NBINS - 1);
}

struct Pencil {
  double a, b, c, d, f0, f1;
};

// s(t) = t^2 / (1 + (f0 t)^2) + (ct + d)^2 / ((at + b)^2 + (f1 (ct + d))^2 + 1e-30)
__device__ __forceinline__ double pencil_cost(const Pencil& p, double t) {
  const double At = p.a * t + p.b, Ct = p.c * t + p.d;
  const double f0t = p.f0 * t, f1c = p.f1 * Ct;
  return t * t / (1.0 + f0t * f0t) + Ct * Ct / (At * At + f1c * f1c + 1e-30);
}

// the grid angle i, as torch.linspace(-half, half, 129) forms it, every
// product and sum rounded (no contraction, so the grid is symmetric)
__device__ __forceinline__ double grid_angle(int i) {
  const double half = 1.5707963267948966 - 1e-3;
  const double step = __ddiv_rn(__dsub_rn(half, -half), (double)(GRID - 1));
  return i < GRID / 2 ? __dadd_rn(-half, __dmul_rn(step, (double)i))
                      : __dsub_rn(half, __dmul_rn(step, (double)(GRID - 1 - i)));
}

__device__ __forceinline__ void cross3(const double* x, const double* y, double* o) {
  o[0] = x[1] * y[2] - x[2] * y[1];
  o[1] = x[2] * y[0] - x[0] * y[2];
  o[2] = x[0] * y[1] - x[1] * y[0];
}

// the null vector of three 3-vectors spanning a plane: the largest of their
// pairwise cross products, made unit (the SVD's vector has unit length, and
// the cross product of F's small entries ~1e-14, under _norm_epi's 1e-12
// floor), then normalised so that e0^2 + e1^2 = 1
__device__ void null_of(const double* r0, const double* r1, const double* r2, double* e) {
  double c[3][3];
  cross3(r0, r1, c[0]);
  cross3(r0, r2, c[1]);
  cross3(r1, r2, c[2]);
  int k = 0;
  double best = -1.0;
  for (int j = 0; j < 3; ++j) {
    const double n = c[j][0] * c[j][0] + c[j][1] * c[j][1] + c[j][2] * c[j][2];
    if (n > best) {
      best = n;
      k = j;
    }
  }
  const double n = sqrt(best);
  double u[3];
  for (int j = 0; j < 3; ++j) u[j] = n > 0.0 ? c[k][j] / n : 0.0;
  const double s = fmax(sqrt(u[0] * u[0] + u[1] * u[1]), 1e-12);
  for (int j = 0; j < 3; ++j) e[j] = u[j] / s;
}

// whether grid candidate (c, i) beats (bc, bi) under the sequential loop's
// rule (index 0 first, a later index only on a strictly smaller cost): a
// NaN at index 0 wins, any other NaN loses, then the smaller cost, then
// the smaller index. A total order, so the lanes' order of merging cannot
// change the winner.
__device__ __forceinline__ bool takes(double c, int i, double bc, int bi) {
  if (bi == 0 && isnan(bc)) return false;
  if (i == 0 && isnan(c)) return true;
  if (isnan(c)) return false;
  if (isnan(bc)) return true;
  return c < bc || (c == bc && i < bi);   // fault point: the first index on ties
}

// optimal_correct for one pair, by a whole warp (every lane gets the same
// result): (x0, y0), (x1, y1) in, corrected out; `tan_grid` the grid
// angles' tangents
__device__ void correct(const double* F, double x0, double y0, double x1, double y1,
                        const double* tan_grid, double* out) {
  const int lane = threadIdx.x & 31;
  // F' = T1inv^T F T0inv with T_inv = [[1, 0, x], [0, 1, y], [0, 0, 1]]
  double G[9], Fp[9];
  for (int j = 0; j < 3; ++j) {
    G[3 * j] = F[3 * j];
    G[3 * j + 1] = F[3 * j + 1];
    G[3 * j + 2] = F[3 * j] * x0 + F[3 * j + 1] * y0 + F[3 * j + 2];
  }
  for (int l = 0; l < 3; ++l) {
    Fp[l] = G[l];
    Fp[3 + l] = G[3 + l];
    Fp[6 + l] = x1 * G[l] + y1 * G[3 + l] + G[6 + l];
  }
  // e0: F' e0 = 0 (rows); e1: e1^T F' = 0 (columns)
  double e0[3], e1[3];
  null_of(Fp, Fp + 3, Fp + 6, e0);
  const double c0[3] = {Fp[0], Fp[3], Fp[6]}, c1[3] = {Fp[1], Fp[4], Fp[7]},
               c2[3] = {Fp[2], Fp[5], Fp[8]};
  null_of(c0, c1, c2, e1);
  // R = [[e0, e1, 0], [-e1, e0, 0], [0, 0, 1]]; F'' = R1 F' R0^T
  const double R0[9] = {e0[0], e0[1], 0.0, -e0[1], e0[0], 0.0, 0.0, 0.0, 1.0};
  const double R1[9] = {e1[0], e1[1], 0.0, -e1[1], e1[0], 0.0, 0.0, 0.0, 1.0};
  double H[9], Fpp[9];
  for (int i = 0; i < 3; ++i)
    for (int k = 0; k < 3; ++k)
      H[3 * i + k] = R1[3 * i] * Fp[k] + R1[3 * i + 1] * Fp[3 + k] + R1[3 * i + 2] * Fp[6 + k];
  for (int i = 0; i < 3; ++i)
    for (int l = 0; l < 3; ++l)
      Fpp[3 * i + l] = H[3 * i] * R0[3 * l] + H[3 * i + 1] * R0[3 * l + 1] +
                       H[3 * i + 2] * R0[3 * l + 2];
  const Pencil p{Fpp[4], Fpp[5], Fpp[7], Fpp[8], e0[2], e1[2]};
  // stage: tri_epipoles

  // _min_cost_t: the grid's first minimum, lane i of every 32, all in
  // flight; then the lanes' minima merged by shuffles
  constexpr int PER = (GRID + 31) / 32;
  double gc[PER];
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int i = lane + 32 * k;
    if (i < GRID) gc[k] = pencil_cost(p, tan_grid[i]);
  }
  double best_c = gc[0];
  int best = lane;
#pragma unroll
  for (int k = 1; k < PER; ++k) {
    const int i = lane + 32 * k;
    if (i < GRID && takes(gc[k], i, best_c, best)) {
      best_c = gc[k];
      best = i;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const double oc = __shfl_xor_sync(0xffffffffu, best_c, off);
    const int oi = __shfl_xor_sync(0xffffffffu, best, off);
    if (takes(oc, oi, best_c, best)) {
      best_c = oc;
      best = oi;
    }
  }
  // stage: tri_grid
  // the section search around it (in place of _min_cost_t's 40
  // golden-section steps): a round puts lane k at lo + (k + 1) h, h = (hi -
  // lo) / 33, and keeps the two neighbours of the first smallest cost (NaN
  // as +inf), shrinking the bracket 16.5x; SECTIONS rounds leave it
  // 2 step / 16.5^7 ~ 1.5e-10 rad wide, under the 40 steps' 2.1e-10. The
  // last round's smallest point is the bracket's middle: t_best and its
  // cost come from its lane.
  const double step = __dsub_rn(grid_angle(1), grid_angle(0));
  double lo = grid_angle(best) - step, hi = grid_angle(best) + step;
  double t = 0.0, cost_best = 0.0;
  for (int r = 0; r < SECTIONS; ++r) {
    const double h = (hi - lo) * (1.0 / 33.0);
    const double tk = tan(lo + (lane + 1) * h);
    const double v = pencil_cost(p, tk);
    // the first smallest by three reductions of the cost's bits: a cost is
    // never negative (nor -0), so its bits order as its value
    const unsigned long long bits =
        isnan(v) ? 0x7ff0000000000000ull : (unsigned long long)__double_as_longlong(v);
    const unsigned b_hi = (unsigned)(bits >> 32), b_lo = (unsigned)bits;
    const unsigned m_hi = __reduce_min_sync(0xffffffffu, b_hi);
    const unsigned m_lo = __reduce_min_sync(0xffffffffu, b_hi == m_hi ? b_lo : 0xffffffffu);
    const int bk = (int)__reduce_min_sync(0xffffffffu,
                                          b_hi == m_hi && b_lo == m_lo ? (unsigned)lane : 32u);
    const double nlo = lo + bk * h, nhi = lo + (bk + 2) * h;
    lo = nlo;
    hi = nhi;
    if (r == SECTIONS - 1) {
      t = __shfl_sync(0xffffffffu, tk, bk);
      cost_best = __shfl_sync(0xffffffffu, v, bk);
    }
  }
  // stage: tri_section
  const double cost_inf = 1.0 / fmax(p.f0 * p.f0, 1e-30) +
                          p.c * p.c / (p.a * p.a + p.f1 * p.f1 * p.c * p.c + 1e-30);
  const bool use_inf = cost_inf < cost_best;   // fault point: the asymptote
  double l0[3], l1[3];
  if (use_inf) {
    l0[0] = p.f0; l0[1] = 0.0; l0[2] = -1.0;
    l1[0] = -p.f1 * p.c; l1[1] = p.a; l1[2] = p.c;
  } else {
    l0[0] = t * p.f0; l0[1] = 1.0; l0[2] = -t;
    const double ct = p.c * t + p.d;
    l1[0] = -p.f1 * ct; l1[1] = p.a * t + p.b; l1[2] = ct;
  }
  // the point of each line closest to the origin, then x = T_inv R^T x_hat
  const double* ls[2] = {l0, l1};
  const double* es[2] = {e0, e1};
  const double xs[2][2] = {{x0, y0}, {x1, y1}};
  for (int v = 0; v < 2; ++v) {
    const double* l = ls[v];
    const double* e = es[v];
    const double h0 = -l[0] * l[2], h1 = -l[1] * l[2], h2 = l[0] * l[0] + l[1] * l[1];
    const double r0 = e[0] * h0 - e[1] * h1, r1 = e[1] * h0 + e[0] * h1;
    const double X = r0 + xs[v][0] * h2, Y = r1 + xs[v][1] * h2;
    const double w = fabs(h2) < 1e-12 ? 1e-12 : h2;
    out[2 * v] = X / w;
    out[2 * v + 1] = Y / w;
  }
}

// the histogram's share of one thread: every valid row's bin, HIST_ROWS
// rows' loads at once (valid, angle0 and idx, then angle1 at idx);
// `between()` runs once, between the first rows' two rounds of loads
template <typename Between>
__device__ void hist_rows(const TriArgs& a, int* hist, Between between) {
  for (int i0 = threadIdx.x; i0 < a.N; i0 += TPB * HIST_ROWS) {
    uint8_t v[HIST_ROWS];
    float a0[HIST_ROWS], a1[HIST_ROWS];
    int64_t j[HIST_ROWS];
#pragma unroll
    for (int k = 0; k < HIST_ROWS; ++k) {
      const int i = i0 + k * TPB;
      v[k] = i < a.N ? a.valid[i] : 0;
      a0[k] = i < a.N ? a.angle0[i] : 0.f;
      j[k] = i < a.N ? a.idx[i] : 0;
    }
    if (i0 == (int)threadIdx.x) between();
#pragma unroll
    for (int k = 0; k < HIST_ROWS; ++k) a1[k] = v[k] ? a.angle1[j[k]] : 0.f;
#pragma unroll
    for (int k = 0; k < HIST_ROWS; ++k)
      if (v[k]) atomicAdd(&hist[bin_of(a0[k], a1[k])], 1);
  }
}

__global__ void __launch_bounds__(TPB) triangulate_kernel(const TriArgs a) {
  // stage: tri_start
  __shared__ int hist[NBINS];
  __shared__ int keep[KEEP];          // the strong top bins, -1 where not strong
  __shared__ double tan_grid[GRID];   // the same for every row: a thread each
  const int lane = threadIdx.x & 31;
  if (threadIdx.x < NBINS) hist[threadIdx.x] = 0;
  // a warp a row: every lane computes the row (the correction's points
  // spread over the lanes), lane 0 writes it; the row's loads in flight
  // with the histogram's
  const int i = blockIdx.x * ROWS + (threadIdx.x >> 5);
  const bool row = i < a.N;
  int64_t j = 0;
  float2 u0 = make_float2(0.f, 0.f), u1 = make_float2(0.f, 0.f);
  float an0 = 0.f, an1 = 0.f;
  if (row) {
    j = a.idx[i];
    u0 = make_float2(a.uv0[2 * i], a.uv0[2 * i + 1]);
    an0 = a.angle0[i];
  }
  __syncthreads();
  // while the histogram's first loads fly: the row's second loads (at its
  // match) and the grid's tangents (a thread past the last row has no
  // histogram rows)
  auto second = [&]() {
    if (row) {
      u1 = make_float2(a.uv1[2 * j], a.uv1[2 * j + 1]);
      an1 = a.angle1[j];
    }
    for (int g = threadIdx.x; g < GRID; g += TPB) tan_grid[g] = tan(grid_angle(g));
  };
  hist_rows(a, hist, second);
  if ((int)threadIdx.x >= a.N) second();
  __syncthreads();
  // stage: tri_histogram
  double X[3] = {0.0, 0.0, 0.0};
  double c[4] = {0.0, 0.0, 0.0, 0.0};
  bool tri_ok = false, depth_ok = false;
  int bin = -1;
  if (row) {
    bin = bin_of(an0, an1);
    const double x0 = u0.x, y0 = u0.y;
    const double x1 = u1.x, y1 = u1.y;
    c[0] = x0; c[1] = y0; c[2] = x1; c[3] = y1;
    const double* F = a.geom;
    if (a.optimal) correct(F, x0, y0, x1, y1, tan_grid, c);

    // the DLT: rows x R[2] - R[0], y R[2] - R[1] and x t[2] - ..., in the
    // normalised coordinates of both views (view 0: R = I, t = 0)
    const double* R = a.geom + 9;
    const double* tt = a.geom + 18;
    const double n0x = (c[0] - a.cx) / a.fx, n0y = (c[1] - a.cy) / a.fy;
    const double n1x = (c[2] - a.cx) / a.fx, n1y = (c[3] - a.cy) / a.fy;
    double A[4][3], b[4];
    A[0][0] = -1.0; A[0][1] = 0.0; A[0][2] = n0x; b[0] = 0.0;
    A[1][0] = 0.0; A[1][1] = -1.0; A[1][2] = n0y; b[1] = 0.0;
    for (int k = 0; k < 3; ++k) {
      A[2][k] = n1x * R[6 + k] - R[k];
      A[3][k] = n1y * R[6 + k] - R[3 + k];
    }
    b[2] = tt[0] - n1x * tt[2];
    b[3] = tt[1] - n1y * tt[2];
    double M[3][3], v[3];
    for (int r = 0; r < 3; ++r) {
      for (int s = 0; s < 3; ++s) {
        double acc = r == s ? 1e-9 : 0.0;
        for (int k = 0; k < 4; ++k) acc += A[k][r] * A[k][s];
        M[r][s] = acc;
      }
      double acc = 0.0;
      for (int k = 0; k < 4; ++k) acc += A[k][r] * b[k];
      v[r] = acc;
    }
    const double det = M[0][0] * (M[1][1] * M[2][2] - M[1][2] * M[2][1]) -
                       M[0][1] * (M[1][0] * M[2][2] - M[1][2] * M[2][0]) +
                       M[0][2] * (M[1][0] * M[2][1] - M[1][1] * M[2][0]);
    // Cramer, column k replaced by v: quotient k on lane k, then shared
    const int k = min(lane, 2);
    double C[3][3];
    for (int r = 0; r < 3; ++r)
      for (int s = 0; s < 3; ++s) C[r][s] = s == k ? v[r] : M[r][s];
    const double Xk = (C[0][0] * (C[1][1] * C[2][2] - C[1][2] * C[2][1]) -
                       C[0][1] * (C[1][0] * C[2][2] - C[1][2] * C[2][0]) +
                       C[0][2] * (C[1][0] * C[2][1] - C[1][1] * C[2][0])) / det;
    for (int q = 0; q < 3; ++q) X[q] = __shfl_sync(0xffffffffu, Xk, q);
    const double z1 = R[6] * X[0] + R[7] * X[1] + R[8] * X[2] + tt[2];
    tri_ok = X[2] > 1e-4 && z1 > 1e-4;
    depth_ok = X[2] > 1e-3 && X[2] < 1e4;
  }
  // stage: tri_dlt
  // the histogram's top 3 (argsort(-hist), stable: the larger count first,
  // the lower bin on ties) by warp 0, a lane a bin
  __syncthreads();
  if (threadIdx.x < 32) {
    const int h = lane < NBINS ? hist[lane] : -1;
    int top[KEEP];
    unsigned taken = 0;
    for (int k = 0; k < KEEP; ++k) {
      const int key = lane < NBINS && !((taken >> lane) & 1u) ? (h << 5) | (31 - lane) : -1;
      const int m = __reduce_max_sync(0xffffffffu, key);
      top[k] = 31 - (m & 31);
      taken |= 1u << top[k];
    }
    const int floor10 = max(hist[top[0]] / 10, 1);
    if (lane < KEEP) keep[lane] = hist[top[lane]] >= floor10 ? top[lane] : -1;
  }
  __syncthreads();
  // stage: tri_keep
  if (!row || lane != 0) return;
  const bool in_top = bin == keep[0] || bin == keep[1] || bin == keep[2];
  if (a.probe)
    for (int k = 0; k < 4; ++k) a.probe[4 * i + k] = (float)c[k];
  for (int k = 0; k < 3; ++k) a.X0[3 * i + k] = (float)X[k];
  a.ok[i] = a.valid[i] && in_top && tri_ok && depth_ok;
}

}  // namespace

// C entry point (bound with ctypes): one launch on `stream`; returns the
// CUDA error code. `f` = (fx, fy, cx, cy); `probe` may be null.
extern "C" int triangulate_launch(const void* uv0, const void* uv1, const void* angle0,
                                  const void* angle1, const void* idx, const void* valid,
                                  const void* geom, const double* f, int N, int M, int optimal,
                                  void* X0, void* ok, void* probe, void* stream) {
  if (N <= 0 || M <= 0) return (int)cudaErrorInvalidValue;
  TriArgs a{static_cast<const float*>(uv0), static_cast<const float*>(uv1),
            static_cast<const float*>(angle0), static_cast<const float*>(angle1),
            static_cast<const int64_t*>(idx), static_cast<const uint8_t*>(valid),
            static_cast<const double*>(geom), f[0], f[1], f[2], f[3], N, M, optimal,
            static_cast<float*>(X0), static_cast<uint8_t*>(ok), static_cast<float*>(probe)};
  const unsigned int blocks = (unsigned int)((N + ROWS - 1) / ROWS);
  triangulate_kernel<<<blocks, TPB, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
