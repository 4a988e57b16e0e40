"""The keyframe triangulation after the epipolar match: the CUDA kernel, the
whole `_epipolar_triangulate` on the card, a numpy model and the verdict.

  triangulate_cuda            hand-written sm_90a kernel (csrc/triangulate.cu):
                              orientation_check, optimal_correct and
                              triangulate_linear with the depth test, one
                              launch, from the match's `geom` (F, T_10).
  epipolar_triangulate_cuda   runtime/hybrid._epipolar_triangulate on CUDA
                              tensors: the epipolar match with T_10 and F made
                              in its launch (ops/hamming_match.py), then this
                              kernel. Two launches, no host wait.
  model_triangulate           the kernel's arithmetic in numpy: the bins in
                              float32, the correction (cross-product epipoles,
                              torch.linspace's grid, first index on ties by
                              the kernel's warp argmin, 40 golden-section
                              steps as the reference, or with
                              search="lanes" the kernel's section search
                              over 32 lanes, the asymptote) and the DLT in
                              float64. `faults` plants the smoke's faults
                              in it.
  tri_parity                  the verdict on one call: the kernel against the
                              model and float64 (MODEL_TOL) and against the
                              plain float32 form (PLAIN_TOL, or the plain form
                              the one further from float64), rows where the
                              model's two best basins cost within BASIN_REL
                              of each other (or of the asymptote) or a depth
                              test sits within DEPTH_REL of its limit
                              counted, not held.

The plain forms are matching.orientation_check, triangulation.optimal_correct
and pnp.triangulate_linear (runtime/hybrid._epipolar_triangulate_plain). The
kernel is compiled with nvcc on first use (ops/kernel_build.py).
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from libcml_tpu_torch.core.camera import PinholeCamera
from libcml_tpu_torch.core.lie import SE3
from libcml_tpu_torch.ops import hamming_match as hm
from libcml_tpu_torch.ops import kernel_build as kb
from libcml_tpu_torch.ops.kernel_build import KernelLaunchError

SOURCE = kb.CSRC / "triangulate.cu"
N_BINS, KEEP_BINS = 30, 3
# the grid, the reference's golden-section steps, the kernel's section
# search: its rounds and points a round (a warp's lanes)
GRID, REFINE = 129, 40
SECTIONS, SECTION_POINTS = 7, 32
# the kernel against its numpy model and the plain form run in float64 (the
# kernel computes in double; X0 is written in float32): corrected and
# keyframe-0 pixels, and inverse depth relative
MODEL_TOL = {"px": 1e-4, "idepth_rel": 1e-5}
# the kernel against the plain float32 form (tests/test_torch_hybrid.py's
# measures of the port against the JAX package): corrected and keyframe-0
# pixels, inverse depth absolute
PLAIN_TOL = {"px": 2e-3, "idepth": 1e-3}
# a basin decision that float32 may take otherwise: the grid's two lowest
# local minima (or the best and the asymptote) within this relative distance
BASIN_REL = 1e-4
# a depth test that float32 may decide otherwise: the float64 depth within
# this relative distance of 1e-4, 1e-3 or 1e4
DEPTH_REL = 1e-2
FAULTS = ("grid_ties_to_the_last_index", "asymptote_left_out")
# pencils where each fault shows (both points at the pixel origin, F in its
# Hartley-Sturm form [[f1 f0 d, -f1 c, -f1 d], [-f0 b, a, b], [-f0 d, c, d]]):
# "tie", a = 10, d = 1, f1 = 1, the rest 0, whose cost is even in t with two
# minima at t = -0.3 and 0.3 that tie exactly on the symmetric grid; and
# "asymptote", f0 = 10, a = 1e-4, b = 5, d = 1, whose cost at |t| = 1000 (the
# grid's end) is ~0.048 against 0.01 as t -> inf, so only the asymptote
# finds the minimum
FAULT_PENCILS = {"tie": [[0.0, 0.0, -1.0], [0.0, 10.0, 0.0], [0.0, 0.0, 1.0]],
                 "asymptote": [[0.0, 0.0, 0.0], [-50.0, 1e-4, 5.0], [-10.0, 0.0, 1.0]]}


def fault_case(name: str) -> dict:
    """triangulate_cuda's inputs for one FAULT_PENCILS pencil: one match
    of the pixel origin to itself, valid, its angles equal, `geom` with that
    F and a sideways unit baseline."""
    geom = np.r_[np.ravel(FAULT_PENCILS[name]), np.eye(3).ravel(), [1.0, 0.0, 0.0], 1.0]
    return {"uv0": np.zeros((1, 2), np.float32), "uv1": np.zeros((1, 2), np.float32),
            "angle0": np.zeros(1, np.float32), "angle1": np.zeros(1, np.float32),
            "idx": np.zeros(1, np.int64), "valid": np.ones(1, bool), "geom": geom}


def _library() -> ctypes.CDLL:
    return kb.load(SOURCE, "triangulate_launch",
                   [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 4)


def build(verbose: bool = False):
    """Compile the kernel if its library is missing."""
    return kb.build_many([SOURCE], verbose)[0]


def triangulate_cuda(uv0, uv1, angle0, angle1, idx, valid, geom, cam: PinholeCamera,
                     optimal: bool = True, probe: torch.Tensor | None = None):
    """One launch: (X0 (N, 3) float32, ok (N,) bool) of the match (idx (N,)
    int64, valid (N,) bool) between keyframes 0 (uv0 (N, 2), angle0 (N,)) and
    1 (uv1 (M, 2), angle1 (M,)), with `geom` (hamming_match.GEOM_LEN float64:
    F, R_10, t_10, |t_10|). `probe` (N, 4) float32 receives the corrected
    pixels. Counts its launches in `triangulate_cuda.launches`."""
    lib = _library()
    dev = uv0.device
    if dev.type != "cuda":
        raise ValueError(f"triangulate_cuda needs CUDA tensors, got {dev}")
    N, M = uv0.shape[0], uv1.shape[0]
    if N == 0 or M == 0:
        raise ValueError("triangulate_cuda needs at least one row in each keyframe")
    kb.check_tensor("uv0", uv0, (N, 2), torch.float32, dev)
    kb.check_tensor("uv1", uv1, (M, 2), torch.float32, dev)
    kb.check_tensor("angle0", angle0, (N,), torch.float32, dev)
    kb.check_tensor("angle1", angle1, (M,), torch.float32, dev)
    kb.check_tensor("idx", idx, (N,), torch.int64, dev)
    kb.check_tensor("valid", valid, (N,), torch.bool, dev)
    kb.check_tensor("geom", geom, (hm.GEOM_LEN,), torch.float64, dev)
    if probe is not None:
        kb.check_tensor("probe", probe, (N, 4), torch.float32, dev)
    X0 = torch.empty((N, 3), dtype=torch.float32, device=dev)
    ok = torch.empty(N, dtype=torch.bool, device=dev)
    f = (ctypes.c_double * 4)(cam.fx, cam.fy, cam.cx, cam.cy)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.triangulate_launch(
            uv0.data_ptr(), uv1.data_ptr(), angle0.data_ptr(), angle1.data_ptr(),
            idx.data_ptr(), valid.data_ptr(), geom.data_ptr(), ctypes.addressof(f), N, M,
            int(optimal), X0.data_ptr(), ok.data_ptr(),
            None if probe is None else probe.data_ptr(), stream)
    if err != 0:
        raise KernelLaunchError(f"triangulate kernel launch failed: CUDA error {err}")
    triangulate_cuda.launches += 1
    return X0, ok


triangulate_cuda.launches = 0


def epipolar_triangulate_cuda(desc0, uv0, valid0, angle0, desc1, uv1, valid1, angle1,
                              T_new: SE3, T0: SE3, cam: PinholeCamera, optimal: bool = True,
                              probe: torch.Tensor | None = None):
    """runtime/hybrid._epipolar_triangulate on CUDA tensors, in two launches:
    (PairMatch of the epipolar match, X0, ok, |t_10|)."""
    c = lambda x: x.contiguous()   # noqa: E731
    m = hm.match_epipolar_cuda(c(desc0), c(uv0), c(valid0), c(desc1), c(uv1), c(valid1),
                               poses=(c(T_new.R), c(T_new.t), c(T0.R), c(T0.t)), cam=cam)
    X0, ok = triangulate_cuda(c(uv0), c(uv1), c(angle0), c(angle1), m.best, m.ok, m.geom, cam,
                              optimal, probe)
    return m, X0, ok, m.t_norm


def plain_triangulate(uv0, uv1, angle0, angle1, idx, valid, F, T_10: SE3, cam: PinholeCamera,
                      optimal: bool = True) -> dict:
    """The plain form of the kernel (PyTorch ops, any device and float
    type): orientation_check, optimal_correct (when `optimal`),
    triangulate_linear and the depth test on the match (idx, valid).
    Returns {"X0", "ok", "corrected" (N, 4)}."""
    from libcml_tpu_torch.models.indirect.matching import orientation_check
    from libcml_tpu_torch.models.indirect.pnp import triangulate_linear
    from libcml_tpu_torch.models.indirect.triangulation import optimal_correct

    ok = orientation_check(angle0, angle1, idx, valid)
    x1 = uv1[idx]
    uv0c, uv1c = optimal_correct(uv0, x1, F) if optimal else (uv0, x1)
    X0, tri_ok = triangulate_linear(uv0c, uv1c, T_10, cam)
    depth_ok = (X0[:, 2] > 1e-3) & (X0[:, 2] < 1e4)
    return {"X0": X0, "ok": ok & tri_ok & depth_ok, "corrected": torch.cat([uv0c, uv1c], -1)}


# -- the numpy model --------------------------------------------------------------------------


def model_bins(angle0, angle1, idx) -> np.ndarray:
    """orientation_check's bins in float32, as the plain form and the
    kernel: remainder (fmod, + 2 pi below 0), x 30 / (2 pi), int32
    truncation, clamped to [0, 29]."""
    d = (np.asarray(angle0, np.float32) - np.asarray(angle1, np.float32)[np.asarray(idx)])
    two_pi = np.float32(2.0 * math.pi)
    r = np.fmod(d, two_pi)
    r = np.where((r != 0) & (r < 0), (r + two_pi).astype(np.float32), r).astype(np.float32)
    b = (r * np.float32(N_BINS / (2.0 * math.pi))).astype(np.float32).astype(np.int32)
    return np.clip(b, 0, N_BINS - 1)


def model_orientation(angle0, angle1, idx, valid) -> np.ndarray:
    """orientation_check: the stable top 3 of the valid rows' histogram."""
    bins = model_bins(angle0, angle1, idx)
    valid = np.asarray(valid, bool)
    hist = np.bincount(bins[valid], minlength=N_BINS)
    top = np.argsort(-hist, kind="stable")[:KEEP_BINS]
    strong = hist[top] >= max(hist[top[0]] // 10, 1)
    return valid & np.isin(bins, top[strong])


def grid_angles() -> np.ndarray:
    """torch.linspace(-half, half, 129)'s formula, in float64 with every
    operation rounded: start + i step below the middle, end - (128 - i) step
    from it."""
    half = math.pi / 2 - 1e-3
    step = (half - (-half)) / (GRID - 1)
    i = np.arange(GRID, dtype=np.float64)
    return np.where(i < GRID // 2, -half + step * i, half - step * (GRID - 1 - i))


def _null(r0, r1, r2) -> np.ndarray:
    """The largest pairwise cross product of three (N, 3) rows, made unit (as
    the SVD's vector), then normalised so that e0^2 + e1^2 = 1."""
    c = np.stack([np.cross(r0, r1), np.cross(r0, r2), np.cross(r1, r2)], 1)   # (N, 3, 3)
    k = np.argmax(np.sum(c * c, -1), 1)
    e = c[np.arange(len(k)), k]
    n = np.sqrt(np.sum(e * e, -1))
    e = np.where(n[:, None] > 0, e / np.where(n > 0, n, 1.0)[:, None], 0.0)
    s = np.maximum(np.sqrt(e[:, 0] ** 2 + e[:, 1] ** 2), 1e-12)
    return e / s[:, None]


def _cost(t, a, b, c, d, f0, f1):
    At, Ct = a * t + b, c * t + d
    return t * t / (1.0 + (f0 * t) ** 2) + Ct * Ct / (At * At + (f1 * Ct) ** 2 + 1e-30)


def sequential_argmin(costs) -> np.ndarray:
    """The reference loop's grid index a row (N, 129): index 0 first, a
    later index only on a strictly smaller cost (NaN never is)."""
    costs = np.asarray(costs, np.float64)
    best = np.zeros(len(costs), np.int64)
    best_c = costs[:, 0].copy()
    for i in range(1, costs.shape[1]):
        take = costs[:, i] < best_c
        best = np.where(take, i, best)
        best_c = np.where(take, costs[:, i], best_c)
    return best


def _takes(c, i, bc, bi, last_on_ties: bool):
    """csrc/triangulate.cu takes: whether (c, i) beats (bc, bi); with
    `last_on_ties` the fault that breaks ties to the larger index."""
    tie = (i > bi) if last_on_ties else (i < bi)
    plain = ~np.isnan(c) & (np.isnan(bc) | (c < bc) | ((c == bc) & tie))
    return ~((bi == 0) & np.isnan(bc)) & (((i == 0) & np.isnan(c)) | plain)


def warp_argmin(costs, last_on_ties: bool = False) -> np.ndarray:
    """The kernel's grid index a row (N, 129) as its warp finds it: lane
    l folds its indices l, l + 32, ... in order, then the lanes merge by
    xor shuffles at offsets 16, 8, 4, 2, 1, each by `takes`."""
    costs = np.asarray(costs, np.float64)
    N, G = costs.shape
    per = -(-G // 32)
    lane = np.arange(32)
    bc = np.broadcast_to(costs[:, :32], (N, 32)).copy()
    bi = np.broadcast_to(lane, (N, 32)).copy()
    for k in range(1, per):
        i = lane + 32 * k
        ok = i < G
        c = np.where(ok, costs[:, np.minimum(i, G - 1)], np.nan)
        take = ok & _takes(c, np.broadcast_to(i, (N, 32)), bc, bi, last_on_ties)
        bc, bi = np.where(take, c, bc), np.where(take, i, bi)
    for off in (16, 8, 4, 2, 1):
        oc, oi = bc[:, lane ^ off], bi[:, lane ^ off]
        take = _takes(oc, oi, bc, bi, last_on_ties)
        bc, bi = np.where(take, oc, bc), np.where(take, oi, bi)
    assert (bi == bi[:, :1]).all(), "the lanes disagree"
    return bi[:, 0]


def lane_section(pencil, lo, hi):
    """The kernel's section search on (N,) brackets [lo, hi] of the pencils
    (a, b, c, d, f0, f1): SECTIONS rounds, each putting lane k at lo + (k +
    1) h, h = (hi - lo) / (SECTION_POINTS + 1), and keeping the neighbours
    of the first smallest cost (NaN as +inf). Returns the last round's
    smallest point (the last bracket's middle)."""
    col = lambda v: np.asarray(v, np.float64)[:, None]   # noqa: E731
    k = np.arange(1, SECTION_POINTS + 1, dtype=np.float64)[None, :]
    for _ in range(SECTIONS):
        h = (hi - lo) * (1.0 / (SECTION_POINTS + 1))
        v = _cost(np.tan(col(lo) + k * col(h)), *(col(x) for x in pencil))
        best = np.argmin(np.where(np.isnan(v), np.inf, v), 1)
        mid = lo + (best + 1) * h
        lo, hi = lo + best * h, lo + (best + 2) * h
    return mid


def model_min_cost_t(a, b, c, d, f0, f1, faults=(), search: str = "golden"):
    """_min_cost_t as the kernel computes it, float64, batched over (N,)
    pencils: (t_best, cost_best, the grid's index, the grid costs (N, 129)).
    The grid's index by the kernel's warp (warp_argmin: the first index on
    ties, or the last with the fault "grid_ties_to_the_last_index"); then
    the reference's 40 golden-section steps, or (search="lanes") the
    kernel's section search (lane_section)."""
    col = lambda v: np.asarray(v, np.float64)[:, None]   # noqa: E731
    theta = grid_angles()
    costs = _cost(np.tan(theta)[None, :], col(a), col(b), col(c), col(d), col(f0), col(f1))
    best = warp_argmin(costs, "grid_ties_to_the_last_index" in faults)
    step = theta[1] - theta[0]
    lo, hi = theta[best] - step, theta[best] + step
    if search == "lanes":
        lo = hi = lane_section((a, b, c, d, f0, f1), lo, hi)
    else:
        gr = 0.6180339887498949
        for _ in range(REFINE):
            m1, m2 = hi - gr * (hi - lo), lo + gr * (hi - lo)
            take_lo = (_cost(np.tan(m1), a, b, c, d, f0, f1)
                       < _cost(np.tan(m2), a, b, c, d, f0, f1))
            lo, hi = np.where(take_lo, lo, m1), np.where(take_lo, m2, hi)
    t = np.tan(0.5 * (lo + hi))
    return t, _cost(t, a, b, c, d, f0, f1), best, costs


def model_correct(F, x0, x1, faults=(), search: str = "golden") -> dict:
    """optimal_correct as the kernel computes it, float64: `corrected` (N, 4)
    and `basin_gap` (N,), the relative cost gap between the grid's two lowest
    local minima, or between the best and the asymptote (inf where there is
    no second). `faults`: "grid_ties_to_the_last_index",
    "asymptote_left_out"; `search`: model_min_cost_t's."""
    F = np.asarray(F, np.float64)
    x0, x1 = np.asarray(x0, np.float64), np.asarray(x1, np.float64)
    N = len(x0)
    G = np.broadcast_to(F, (N, 3, 3)).copy()
    G[:, :, 2] = F[None, :, 0] * x0[:, :1] + F[None, :, 1] * x0[:, 1:] + F[None, :, 2]
    Fp = G.copy()
    Fp[:, 2, :] = x1[:, :1] * G[:, 0, :] + x1[:, 1:] * G[:, 1, :] + G[:, 2, :]
    e0 = _null(Fp[:, 0], Fp[:, 1], Fp[:, 2])
    e1 = _null(Fp[:, :, 0], Fp[:, :, 1], Fp[:, :, 2])

    def rot(e):
        R = np.zeros((N, 3, 3))
        R[:, 0, 0], R[:, 0, 1], R[:, 1, 0], R[:, 1, 1], R[:, 2, 2] = e[:, 0], e[:, 1], \
            -e[:, 1], e[:, 0], 1.0
        return R

    R0, R1 = rot(e0), rot(e1)
    Fpp = np.einsum("nij,njk,nlk->nil", R1, Fp, R0)
    a, b, c, d = Fpp[:, 1, 1], Fpp[:, 1, 2], Fpp[:, 2, 1], Fpp[:, 2, 2]
    f0, f1 = e0[:, 2], e1[:, 2]
    col = lambda v: v[:, None]   # noqa: E731
    t, cost_best, best, costs = model_min_cost_t(a, b, c, d, f0, f1, faults, search)
    cost_inf = 1.0 / np.maximum(f0 * f0, 1e-30) + c * c / (a * a + f1 * f1 * c * c + 1e-30)
    use_inf = cost_inf < cost_best
    if "asymptote_left_out" in faults:
        use_inf = np.zeros(N, bool)
    one, zero = np.ones(N), np.zeros(N)
    ct = c * t + d
    l0 = np.where(col(use_inf), np.stack([f0, zero, -one], -1), np.stack([t * f0, one, -t], -1))
    l1 = np.where(col(use_inf), np.stack([-f1 * c, a, c], -1),
                  np.stack([-f1 * ct, a * t + b, ct], -1))
    out = np.empty((N, 4))
    for v, (l, e, x) in enumerate(((l0, e0, x0), (l1, e1, x1))):
        h0, h1, h2 = -l[:, 0] * l[:, 2], -l[:, 1] * l[:, 2], l[:, 0] ** 2 + l[:, 1] ** 2
        r0, r1 = e[:, 0] * h0 - e[:, 1] * h1, e[:, 1] * h0 + e[:, 0] * h1
        w = np.where(np.abs(h2) < 1e-12, 1e-12, h2)
        out[:, 2 * v] = (r0 + x[:, 0] * h2) / w
        out[:, 2 * v + 1] = (r1 + x[:, 1] * h2) / w
    # the gap between the two best basins (grid local minima), or the asymptote
    lm = np.ones_like(costs, bool)
    lm[:, 1:] &= costs[:, 1:] <= costs[:, :-1]
    lm[:, :-1] &= costs[:, :-1] <= costs[:, 1:]
    mins = np.sort(np.where(lm, costs, np.inf), 1)
    scale = np.maximum(np.abs(mins[:, 0]), 1e-30)
    gap = np.where(np.isfinite(mins[:, 1]), (mins[:, 1] - mins[:, 0]) / scale, np.inf)
    gap_inf = np.abs(cost_inf - cost_best) / np.maximum(np.abs(cost_best), 1e-30)
    return {"corrected": out, "basin_gap": np.minimum(gap, gap_inf), "use_inf": use_inf,
            "grid_best": best}


def model_dlt(c, geom, cam: PinholeCamera):
    """triangulate_linear on the corrected pixels c (N, 4), float64 by
    Cramer's rule: (X0 (N, 3), depth in view 1 (N,))."""
    g = np.asarray(geom, np.float64)
    R, t = g[9:18].reshape(3, 3), g[18:21]
    n = np.stack([(c[:, 0] - cam.cx) / cam.fx, (c[:, 1] - cam.cy) / cam.fy,
                  (c[:, 2] - cam.cx) / cam.fx, (c[:, 3] - cam.cy) / cam.fy], -1)
    N = len(c)
    A = np.zeros((N, 4, 3))
    A[:, 0, 0], A[:, 0, 2] = -1.0, n[:, 0]
    A[:, 1, 1], A[:, 1, 2] = -1.0, n[:, 1]
    A[:, 2] = n[:, 2:3] * R[2] - R[0]
    A[:, 3] = n[:, 3:4] * R[2] - R[1]
    b = np.zeros((N, 4))
    b[:, 2] = t[0] - n[:, 2] * t[2]
    b[:, 3] = t[1] - n[:, 3] * t[2]
    M = np.einsum("nkr,nks->nrs", A, A) + 1e-9 * np.eye(3)
    v = np.einsum("nkr,nk->nr", A, b)
    det = np.linalg.det(M)
    X = np.empty((N, 3))
    for k in range(3):
        C = M.copy()
        C[:, :, k] = v
        X[:, k] = np.linalg.det(C) / det
    return X, X @ R[2] + t[2]


def model_triangulate(uv0, uv1, angle0, angle1, idx, valid, geom, cam: PinholeCamera,
                      optimal: bool = True, faults=()) -> dict:
    """The kernel's outputs in numpy (X0 float64, ok) with the readings the
    verdict needs: corrected pixels, basin gaps, and the rows whose depth
    tests sit within DEPTH_REL of a limit."""
    idx = np.asarray(idx)
    x0 = np.asarray(uv0, np.float64)
    x1 = np.asarray(uv1, np.float64)[idx]
    g = np.asarray(geom, np.float64)
    in_top = model_orientation(angle0, angle1, idx, valid)
    if optimal:
        cor = model_correct(g[:9].reshape(3, 3), x0, x1, faults)
    else:
        cor = {"corrected": np.c_[x0, x1], "basin_gap": np.full(len(x0), np.inf)}
    X, z1 = model_dlt(cor["corrected"], g, cam)
    z0 = X[:, 2]
    ok = in_top & (z0 > 1e-4) & (z1 > 1e-4) & (z0 > 1e-3) & (z0 < 1e4)
    near = lambda z, lim: np.abs(z - lim) <= DEPTH_REL * lim   # noqa: E731
    depth_edge = near(z0, 1e-4) | near(z1, 1e-4) | near(z0, 1e-3) | near(z0, 1e4)
    return {"X0": X, "ok": ok, "corrected": cor["corrected"], "basin_gap": cor["basin_gap"],
            "depth_edge": depth_edge, "in_top": in_top, "valid": np.asarray(valid, bool)}


# -- the verdict ------------------------------------------------------------------------------


def _pix_idepth(X, cam: PinholeCamera):
    X = np.asarray(X, np.float64)
    z = np.where(np.abs(X[:, 2]) < 1e-12, 1e-12, X[:, 2])
    return np.stack([cam.fx * X[:, 0] / z + cam.cx, cam.fy * X[:, 1] / z + cam.cy], -1), 1.0 / z


def _errors(got: dict, ref: dict, valid: np.ndarray, cam: PinholeCamera) -> dict:
    """Per row: the matched rows' corrected-pixel distance, the keyframe-0
    pixel and inverse-depth distances of X0 (inverse depth also relative),
    and whether ok differs."""
    g = {k: np.asarray(v.cpu() if torch.is_tensor(v) else v) for k, v in got.items()}
    r = {k: np.asarray(v.cpu() if torch.is_tensor(v) else v) for k, v in ref.items()}
    gp, gi = _pix_idepth(g["X0"], cam)
    rp, ri = _pix_idepth(r["X0"], cam)
    c_err = np.abs(g["corrected"].astype(np.float64) - r["corrected"].astype(np.float64)).max(1)
    return {"corrected": np.where(valid, c_err, 0.0), "pixel": np.abs(gp - rp).max(1),
            "idepth": np.abs(gi - ri), "idepth_rel": np.abs(gi - ri) / np.abs(ri),
            "ok_diff": g["ok"].astype(bool) != r["ok"].astype(bool),
            "both_ok": g["ok"].astype(bool) & r["ok"].astype(bool)}


def _beyond(e: dict, px: float, idepth_key: str, idepth_tol: float) -> np.ndarray:
    """Rows whose corrected pixels, or (where ok in both) X0's pixel or
    inverse depth, lie beyond the tolerances."""
    return (e["corrected"] > px) | (e["both_ok"] & ((e["pixel"] > px)
                                                    | (e[idepth_key] > idepth_tol)))


def tri_parity(got: dict, plain: dict, model: dict, f64: dict, cam: PinholeCamera) -> dict:
    """The verdict on one triangulation call. `got` = the kernel's {"X0",
    "ok", "corrected"} (the probe), `plain` = the plain float32 form's,
    `model` = model_triangulate's on the same match, `f64` = the plain form
    run in float64. Held: against the model every row within MODEL_TOL and
    ok equal, except rows at a depth edge (and near ties, 0 < basin gap <
    1e-9, that double rounding may break); against float64 the same, except
    also basin edges (the gap under BASIN_REL: float64's SVD epipole may
    take the other basin of a tie); against the plain float32 form within
    PLAIN_TOL and ok equal, except at basin and depth edges, or where the
    plain form is the one further from float64 (counted: float32's DLT at a
    short baseline). Returns the verdict and its readings."""
    valid = model["valid"]
    basin = model["basin_gap"] < BASIN_REL
    depth = model["depth_edge"]
    tie = (model["basin_gap"] > 0) & (model["basin_gap"] < 1e-9)
    ek, e64, ep = (_errors(got, r, valid, cam) for r in (model, f64, plain))
    pf = _errors(plain, f64, valid, cam)          # the plain form's own distance from float64
    px, rel = MODEL_TOL["px"], MODEL_TOL["idepth_rel"]
    bad_model = (_beyond(ek, px, "idepth_rel", rel) | ek["ok_diff"]) & ~(depth | tie)
    bad_f64 = (_beyond(e64, px, "idepth_rel", rel) | e64["ok_diff"]) & ~(depth | basin)
    over = _beyond(ep, PLAIN_TOL["px"], "idepth", PLAIN_TOL["idepth"]) | ep["ok_diff"]
    plain_further = ((pf["corrected"] >= e64["corrected"]) & (pf["pixel"] >= e64["pixel"])
                     & (pf["idepth"] >= e64["idepth"]) & (~e64["ok_diff"] | pf["ok_diff"]))
    bad_plain = over & ~(depth | basin) & ~plain_further

    def reading(e, bad, exempt):
        return {"max_corrected_px": float(e["corrected"].max(initial=0.0)),
                "max_pixel": float(e["pixel"][e["both_ok"]].max(initial=0.0)),
                "max_idepth": float(e["idepth"][e["both_ok"]].max(initial=0.0)),
                "ok_differing": int(e["ok_diff"].sum()), "rows_beyond": int(bad.sum()),
                "exempt_rows": int(exempt.sum())}

    out = {"rows": int(len(valid)), "basin_edges": int(basin.sum()),
           "depth_edges": int(depth.sum()),
           "vs_model": reading(ek, bad_model, depth | tie),
           "vs_f64": reading(e64, bad_f64, depth | basin),
           "vs_plain": reading(ep, bad_plain, depth | basin),
           "plain_further_beyond_tol": int((over & plain_further & ~(depth | basin)).sum()),
           "plain_vs_f64_max_pixel": float(pf["pixel"][pf["both_ok"]].max(initial=0.0))}
    out["ok"] = bool(not (bad_model.any() or bad_f64.any() or bad_plain.any()))
    out["max_abs_err"] = max(out["vs_plain"]["max_corrected_px"], out["vs_plain"]["max_pixel"])
    return out
