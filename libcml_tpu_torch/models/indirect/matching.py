"""Feature matcher suite: batched Hamming matching with ratio / orientation /
window / projection / epipolar constraints, and the VFC outlier filter.

PyTorch port of libcml_tpu/models/indirect/matching.py (the reference's
matcher stack: BoWTracker.cpp:112 trackByBoW, :291 trackForInitialization,
:442 trackForTriangulation, :624 trackByProjection; CornerMatcher.h:295
resolveByRatio). Every constrained variant is the same dense masked
resolution with a different pair mask. `_resolve_from_desc` dispatches by
the tensors' device: the hand-written CUDA kernel (ops/hamming_match.py) for
CUDA tensors, the plain version for CPU tensors. On CUDA tensors
match_projection and match_epipolar compute their pair tests inside that
kernel (one launch, no (N, M) mask); `match_projection_plain` and
`match_epipolar_plain` are their plain forms.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from libcml_tpu_torch.core.camera import PinholeCamera
from libcml_tpu_torch.core.lie import SE3
from libcml_tpu_torch.ops import hamming_match as hm
from libcml_tpu_torch.ops.hamming_match import hamming_resolve, resolve_matrix

# reference thresholds (BoWTracker.h: TH_LOW=50, TH_HIGH=100, ratio 0.6-0.9)
TH_LOW = 50
TH_HIGH = 100


@dataclasses.dataclass
class MatchResult:
    """Fixed-shape matching: one candidate per query row (masked)."""

    idx: torch.Tensor     # (N,) index into the train set (argmin column)
    dist: torch.Tensor    # (N,) int32 best Hamming distance
    valid: torch.Tensor   # (N,) bool passed all checks
    num: torch.Tensor     # () number of valid matches


def _finish(d1, d2, best, col_best_row, max_dist: int, ratio: float):
    """Lowe ratio + distance gate + mutual cross-check (the chosen column's
    best row must be this row)."""
    ok = (d1 <= max_dist) & (d1.float() < ratio * d2.float())
    rows = torch.arange(d1.shape[0], device=d1.device)
    ok = ok & (col_best_row[best.long()] == rows)
    return best.long(), d1, ok


def _resolve_from_desc(desc_q, desc_t, row_mask, col_mask, pair_mask, max_dist: int,
                       ratio: float):
    """Masked-Hamming match resolution from raw descriptors (the reference's
    CornerMatchingGraph::resolveByRatio semantics, CornerMatcher.h:295):
    one fused kernel sweep on the card, the materialized matrix on the CPU."""
    d1, d2, best, col_best_row = hamming_resolve(desc_q, row_mask, desc_t, col_mask,
                                                 pair_mask)
    return _finish(d1, d2, best, col_best_row, max_dist, ratio)


def _resolve(D, row_mask, col_mask, pair_mask, max_dist: int, ratio: float):
    """Resolution over a materialized distance matrix (see
    _resolve_from_desc)."""
    d1, d2, best, col_best_row = resolve_matrix(D, row_mask, col_mask, pair_mask)
    return _finish(d1, d2, best, col_best_row, max_dist, ratio)


def orientation_check(angle_q, angle_t, idx, valid, n_bins: int = 30,
                      keep_bins: int = 3):
    """Rotation-consistency histogram check (reference: BoWTracker's
    CheckOrientation — keep only matches whose angle delta falls in the 3
    most-populated of 30 bins, dropping bins under 0.1x the best)."""
    dtheta = angle_q - angle_t[idx]
    dtheta = torch.remainder(dtheta, 2.0 * math.pi)
    bins = torch.clamp((dtheta * (n_bins / (2.0 * math.pi))).to(torch.int32), 0, n_bins - 1)
    hist = torch.zeros((n_bins,), dtype=torch.int32, device=idx.device)
    hist = hist.index_add(0, bins.long(), valid.to(torch.int32))
    # argsort(-hist) with ties in index order, as jnp.argsort (stable)
    order = torch.sort(-hist, stable=True).indices
    top = order[:keep_bins]
    strong = hist[top] >= torch.clamp(
        torch.div(hist[top[0]], 10, rounding_mode="floor"), min=1)
    in_top = torch.any((bins.long()[:, None] == top[None, :]) & strong[None, :], dim=1)
    return valid & in_top


def match_descriptors(desc_q, valid_q, desc_t, valid_t, max_dist: int = TH_LOW,
                      ratio: float = 0.75) -> MatchResult:
    """Unconstrained descriptor matching (the brute-force / LSH / BoW-node
    paths of the reference all reduce to this)."""
    idx, dist, ok = _resolve_from_desc(desc_q, desc_t, valid_q, valid_t, None,
                                       max_dist, ratio)
    return MatchResult(idx=idx, dist=dist, valid=ok, num=torch.sum(ok))


def match_window(desc_q, uv_q, valid_q, desc_t, uv_t, valid_t, radius: float = 100.0,
                 max_dist: int = TH_LOW, ratio: float = 0.9) -> MatchResult:
    """Spatial-window matching for initialization (reference:
    trackForInitialization, BoWTracker.cpp:291)."""
    d2 = torch.sum((uv_q[:, None, :] - uv_t[None, :, :]) ** 2, dim=-1)
    pair = d2 <= radius * radius
    idx, dist, ok = _resolve_from_desc(desc_q, desc_t, valid_q, valid_t, pair,
                                       max_dist, ratio)
    return MatchResult(idx=idx, dist=dist, valid=ok, num=torch.sum(ok))


def projection_pair_mask(Xw, valid_p, level_p, T: SE3, cam: PinholeCamera, uv_f, level_f,
                         radius: float):
    """The masks match_projection resolves under: the points visible at pose T
    (vis (P,)), the (point, corner) pairs within the level-scaled radius at
    compatible pyramid levels (pair (P, F)), and the projected pixels (P, 2)."""
    Xc = Xw @ T.R.T + T.t
    uv_p, z_ok = cam.project(Xc)
    vis = valid_p & z_ok & cam.in_bounds(uv_p, border=2.0)

    r = radius * (1.5 ** level_p.float())
    d2 = torch.sum((uv_p[:, None, :] - uv_f[None, :, :]) ** 2, dim=-1)
    pair = d2 <= (r * r)[:, None]
    pair = pair & (torch.abs(level_p[:, None] - level_f[None, :]) <= 1)
    return vis, pair, uv_p


def match_projection_plain(Xw, desc_p, valid_p, level_p, T: SE3, cam: PinholeCamera, desc_f,
                           uv_f, level_f, valid_f, radius: float = 15.0,
                           max_dist: int = TH_HIGH, ratio: float = 0.9):
    """The plain form of match_projection: the (P, F) pair mask written,
    then the resolution and _finish."""
    vis, pair, uv_p = projection_pair_mask(Xw, valid_p, level_p, T, cam, uv_f, level_f,
                                           radius)
    idx, dist, ok = _resolve_from_desc(desc_p, desc_f, vis, valid_f, pair,
                                       max_dist, ratio)
    return MatchResult(idx=idx, dist=dist, valid=ok, num=torch.sum(ok)), uv_p


def match_projection(
    Xw: torch.Tensor,
    desc_p: torch.Tensor,
    valid_p: torch.Tensor,
    level_p: torch.Tensor,
    T: SE3,
    cam: PinholeCamera,
    desc_f: torch.Tensor,
    uv_f: torch.Tensor,
    level_f: torch.Tensor,
    valid_f: torch.Tensor,
    radius: float = 15.0,
    max_dist: int = TH_HIGH,
    ratio: float = 0.9,
    max_depth_ratio: float = 0.0,
) -> tuple[MatchResult, torch.Tensor]:
    """Project map points into the frame at pose T and match to corners in a
    level-scaled radius at compatible pyramid levels (reference:
    trackByProjection BoWTracker.cpp:624 / ReprojectionTracker.h:10).
    Queries are POINTS, train is the frame's corner set. Also returns the
    projected pixel (P, 2). On CUDA tensors one launch of the Hamming kernel
    with the tests inside it; on CPU tensors match_projection_plain."""
    if Xw.is_cuda:
        c = lambda x: x.contiguous()   # noqa: E731
        m = hm.match_projection_cuda(c(Xw), c(desc_p), c(valid_p), c(level_p), c(T.R),
                                     c(T.t), cam, c(desc_f), c(uv_f), c(level_f),
                                     c(valid_f), radius, max_dist, ratio)
        return MatchResult(idx=m.best, dist=m.d1, valid=m.ok, num=m.num), m.uv_p
    if Xw.device.type != "cpu":
        raise ValueError(f"match_projection: unsupported device {Xw.device}")
    return match_projection_plain(Xw, desc_p, valid_p, level_p, T, cam, desc_f, uv_f,
                                  level_f, valid_f, radius, max_dist, ratio)


def epipolar_pair_mask(uv_q, uv_t, F01: torch.Tensor, epi_tol: float = 3.84) -> torch.Tensor:
    """match_epipolar's (N, M) pair mask: the train corner within epi_tol
    (squared pixels) of the query's epipolar line l = F01 @ [uv_q, 1]."""
    xq = torch.cat([uv_q, torch.ones_like(uv_q[:, :1])], dim=-1)
    lines = xq @ F01.T
    xt = torch.cat([uv_t, torch.ones_like(uv_t[:, :1])], dim=-1)
    num = lines @ xt.T
    den = lines[:, 0] ** 2 + lines[:, 1] ** 2
    d2 = num**2 / torch.clamp(den, min=1e-9)[:, None]
    return d2 <= epi_tol


def match_epipolar_plain(desc_q, uv_q, valid_q, desc_t, uv_t, valid_t, F01: torch.Tensor,
                         epi_tol: float = 3.84, max_dist: int = TH_LOW,
                         ratio: float = 0.8) -> MatchResult:
    """The plain form of match_epipolar: the pair mask written, then the
    resolution and _finish."""
    pair = epipolar_pair_mask(uv_q, uv_t, F01, epi_tol)
    idx, dist, ok = _resolve_from_desc(desc_q, desc_t, valid_q, valid_t, pair,
                                       max_dist, ratio)
    return MatchResult(idx=idx, dist=dist, valid=ok, num=torch.sum(ok))


def match_epipolar(desc_q, uv_q, valid_q, desc_t, uv_t, valid_t, F01: torch.Tensor,
                   epi_tol: float = 3.84, max_dist: int = TH_LOW,
                   ratio: float = 0.8) -> MatchResult:
    """Epipolar-constrained matching for triangulation (reference:
    trackForTriangulation, BoWTracker.cpp:442): the candidate must lie near
    the epipolar line l = F01 @ [uv_q, 1] in the train view. On CUDA tensors
    one launch of the Hamming kernel with the test inside it; on CPU
    tensors match_epipolar_plain."""
    if desc_q.is_cuda:
        c = lambda x: x.contiguous()   # noqa: E731
        m = hm.match_epipolar_cuda(c(desc_q), c(uv_q), c(valid_q), c(desc_t), c(uv_t),
                                   c(valid_t), F=c(F01), epi_tol=epi_tol, max_dist=max_dist,
                                   ratio=ratio)
        return MatchResult(idx=m.best, dist=m.d1, valid=m.ok, num=m.num)
    if desc_q.device.type != "cpu":
        raise ValueError(f"match_epipolar: unsupported device {desc_q.device}")
    return match_epipolar_plain(desc_q, uv_q, valid_q, desc_t, uv_t, valid_t, F01, epi_tol,
                                max_dist, ratio)


def vfc_filter(uv_q: torch.Tensor, uv_t: torch.Tensor, valid: torch.Tensor, iters: int = 30,
               gamma_init: float = 0.9, beta: float = 1.0, lam: float = 3.0,
               tau: float = 0.75, n_ctrl: int = 16) -> torch.Tensor:
    """Vector Field Consensus (reference: VFC.h:55, process VFC.h:124): EM
    over a Gaussian-RBF vector field fit to the match displacement field;
    matches whose displacement disagrees with the smooth field are outliers.
    The field uses n_ctrl control points taken from the valid matches
    (subset of regressors), so each M-step is a fixed (C, C) solve. Returns
    the refined validity mask."""
    N = uv_q.shape[0]
    w0 = valid.float()
    nv = torch.clamp(torch.sum(w0), min=1.0)

    def norm(a):
        # zero-mean, unit-std over the valid set (VFC.h:124)
        mu = torch.sum(a * w0[:, None], dim=0) / nv
        sd = torch.sqrt(torch.sum(torch.sum((a - mu) ** 2, -1) * w0) / nv)
        return (a - mu) / torch.clamp(sd, min=1e-6)

    x = norm(uv_q.float())
    yn = norm(uv_t.float()) - x                          # displacement field

    # control points: a strided subset of the valid matches, valid first in
    # index order (the stable argsort of ~valid)
    C = min(n_ctrl, N)
    order = torch.sort((~valid).to(torch.int32), stable=True).indices
    ctrl = x[order[:: max(1, N // C)][:C]]

    def kmat(a, b):
        return torch.exp(-beta * torch.sum((a[:, None, :] - b[None, :, :]) ** 2, dim=-1))

    K_xc = kmat(x, ctrl)                                 # (N, C)
    K_cc = kmat(ctrl, ctrl)                              # (C, C)
    eye = torch.eye(C, dtype=x.dtype, device=x.device)
    p = w0
    gamma = torch.full((), gamma_init, dtype=x.dtype, device=x.device)
    sigma2 = torch.full((), 0.05, dtype=x.dtype, device=x.device)
    for _ in range(iters):
        # M-step: weighted ridge fit of the coefficients A (C, 2); both
        # regularization floors keep the wide-RBF system solvable in f32
        W = p * w0
        lhs = K_xc.T @ (W[:, None] * K_xc) + lam * torch.clamp(sigma2, min=1e-2) * K_cc \
            + 1e-4 * eye
        rhs = K_xc.T @ (W[:, None] * yn)
        A, _ = torch.linalg.solve_ex(lhs, rhs)
        r2 = torch.sum((yn - K_xc @ A) ** 2, dim=-1)
        sw = torch.clamp(torch.sum(W), min=1.0)
        sigma2 = torch.clamp(torch.sum(W * r2) / (2.0 * sw), min=1e-3)
        # E-step: inlier posterior against a uniform outlier component over
        # the ~unit-variance normalized displacement domain (area 10)
        num = gamma * torch.exp(-r2 / (2.0 * sigma2)) / (2.0 * math.pi * sigma2)
        p = num / (num + (1.0 - gamma) / 10.0 + 1e-30)
        gamma = torch.clamp(torch.sum(p * w0) / sw, 0.05, 0.95)
    return valid & (p > tau)
