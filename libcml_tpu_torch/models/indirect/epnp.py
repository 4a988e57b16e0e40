"""EPnP absolute pose + RANSAC: pose from 3D-2D matches with no prior.

PyTorch port of libcml_tpu/models/indirect/epnp.py (the reference's EPnP,
src/cml/optimization/EPnP.h:116, and its RANSAC wrapper EPnP.h:129, used by
relocalization, which has no motion prior). All hypotheses run as one
batched program: each draws a six-point subset, solves EPnP (control points
by PCA, barycentric lift, null space of the 12x12 normal matrix, beta cases
N=1 and N=2 scored by reprojection, Procrustes pose), and scores inliers over
the whole correspondence set; the winner seeds the iterative LM polish
(solve_pnp).

Randomness: the subsets are drawn from a torch.Generator (Gumbel top-k on
the validity weights, i.e. without replacement) or passed in (`subsets`), so
a test can inject another RNG's draws.
"""

from __future__ import annotations

import dataclasses

import torch

from libcml_tpu_torch.core.camera import PinholeCamera
from libcml_tpu_torch.core.lie import SE3
from libcml_tpu_torch.models.indirect.pnp import solve_pnp

_PAIRS = ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))


def _pairs(dev: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    p = torch.tensor(_PAIRS, device=dev)
    return p[:, 0], p[:, 1]


def _control_points(Xw: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(S, 4, 3) control points: weighted centroid + principal axes scaled by
    the spread, for weights w (S, N)."""
    wsum = torch.clamp(torch.sum(w, -1), min=1e-9)                     # (S,)
    c0 = (w @ Xw) / wsum[:, None]                                       # (S, 3)
    d = (Xw[None] - c0[:, None]) * torch.sqrt(w)[..., None]            # (S, N, 3)
    cov = d.transpose(1, 2) @ d / wsum[:, None, None]
    lam, V = torch.linalg.eigh(cov)                                     # ascending
    s = torch.sqrt(torch.clamp(lam, min=1e-10))
    cs = c0[:, None, :] + (V * s[:, None, :]).transpose(1, 2)           # rows c0 + s_i v_i
    return torch.cat([c0[:, None, :], cs], dim=1)


def _barycentric(Xw: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """alphas (S, N, 4) with X = alphas @ C, sum(alphas) = 1."""
    S, N = C.shape[0], Xw.shape[0]
    Ch = torch.cat([C.transpose(1, 2), torch.ones((S, 1, 4), dtype=C.dtype, device=C.device)],
                   dim=1)                                               # (S, 4, 4)
    Xh = torch.cat([Xw.T, torch.ones((1, N), dtype=Xw.dtype, device=Xw.device)], dim=0)
    return torch.linalg.solve_ex(Ch, Xh.expand(S, 4, N))[0].transpose(1, 2)


def _build_M(alphas: torch.Tensor, uv: torch.Tensor, w: torch.Tensor,
             cam: PinholeCamera) -> torch.Tensor:
    """EPnP's (S, 2N, 12) weighted linear system rows."""
    S, N = alphas.shape[:2]
    du = (cam.cx - uv[:, 0])[None, :, None] * alphas
    dv = (cam.cy - uv[:, 1])[None, :, None] * alphas
    fxa = cam.fx * alphas
    fya = cam.fy * alphas
    z = torch.zeros_like(fxa)
    ru = torch.stack([fxa, z, du], dim=-1).reshape(S, N, 12)
    rv = torch.stack([z, fya, dv], dim=-1).reshape(S, N, 12)
    sw = torch.sqrt(w)[..., None]
    return torch.cat([ru * sw, rv * sw], dim=1)


def _dists6(C: torch.Tensor) -> torch.Tensor:
    """(S, 6) pairwise distances of the 4 control points (S, 4, 3)."""
    i, j = _pairs(C.device)
    d = C[:, i] - C[:, j]
    return torch.sqrt(torch.sum(d * d, dim=-1) + 1e-12)


def _procrustes(Xw: torch.Tensor, Xc: torch.Tensor, w: torch.Tensor) -> SE3:
    """Rigid alignment Xc ~ R Xw + t per hypothesis (Horn/Umeyama, no scale);
    Xc (S, N, 3), w (S, N)."""
    wsum = torch.clamp(torch.sum(w, -1), min=1e-9)[:, None]
    mw = (w @ Xw) / wsum                                                # (S, 3)
    mc = torch.sum(Xc * w[..., None], dim=1) / wsum
    H = ((Xw[None] - mw[:, None]) * w[..., None]).transpose(1, 2) @ (Xc - mc[:, None])
    U, _, Vt = torch.linalg.svd(H)
    d = torch.sign(torch.linalg.det(Vt.transpose(1, 2) @ U.transpose(1, 2)))
    one = torch.ones_like(d)
    D = torch.diag_embed(torch.stack([one, one, d], dim=-1))
    R = Vt.transpose(1, 2) @ D @ U.transpose(1, 2)
    t = mc - (R @ mw[..., None])[..., 0]
    return SE3(R=R, t=t)


def _apply(T: SE3, X: torch.Tensor) -> torch.Tensor:
    """Batched poses (S,) applied to the points X (N, 3) -> (S, N, 3)."""
    return X @ T.R.transpose(1, 2) + T.t[:, None, :]


def epnp_solve(Xw: torch.Tensor, uv: torch.Tensor, w: torch.Tensor,
               cam: PinholeCamera) -> SE3:
    """EPnP over weighted correspondences: Xw (N, 3), uv (N, 2), weights w
    (N,) or (S, N) for S hypotheses at once (0 disables a correspondence).
    Beta cases N=1 and N=2 (the dominant ones in practice); callers polish
    with the iterative PnP. Returns an SE3 with the weights' batch shape."""
    single = w.dim() == 1
    w = w[None] if single else w
    C = _control_points(Xw, w)
    alphas = _barycentric(Xw, C)
    M = _build_M(alphas, uv, w, cam)
    _, V = torch.linalg.eigh(M.transpose(1, 2) @ M)                   # ascending
    v1 = V[:, :, 0].reshape(-1, 4, 3)                                   # smallest
    v2 = V[:, :, 1].reshape(-1, 4, 3)
    dw = _dists6(C)

    # case N=1: x = b v1, b from the distance ratios (closed-form LS)
    d1 = _dists6(v1)
    b1 = torch.sum(d1 * dw, -1) / torch.clamp(torch.sum(d1 * d1, -1), min=1e-12)

    # case N=2: x = b1 v1 + b2 v2, LS on squared distances in (b1^2, b1 b2, b2^2)
    i, j = _pairs(C.device)
    e1 = v1[:, i] - v1[:, j]
    e2 = v2[:, i] - v2[:, j]
    A = torch.stack([torch.sum(e1 * e1, -1), 2 * torch.sum(e1 * e2, -1),
                     torch.sum(e2 * e2, -1)], dim=-1)                   # (S, 6, 3)
    At = A.transpose(1, 2)
    eye3 = torch.eye(3, dtype=A.dtype, device=A.device)
    sol = torch.linalg.solve_ex(At @ A + 1e-9 * eye3, (At @ (dw * dw)[..., None]))[0][..., 0]
    b11, b12, b22 = sol[:, 0], sol[:, 1], sol[:, 2]
    bb1 = torch.sqrt(torch.clamp(b11, min=1e-12))
    bb2 = torch.sqrt(torch.clamp(b22, min=1e-12)) * torch.sign(b12) * torch.sign(b11 + 1e-30)

    def pose_from(Cc: torch.Tensor) -> SE3:
        Xc = alphas @ Cc
        # cheirality: the null vector has a global sign ambiguity
        flip = torch.sign(torch.sum(torch.where(w > 0, Xc[..., 2], torch.zeros_like(w)), -1))
        flip = torch.where(flip == 0, torch.ones_like(flip), flip)
        return _procrustes(Xw, Xc * flip[:, None, None], w)

    def reproj_err(T: SE3) -> torch.Tensor:
        pred, ok = cam.project(_apply(T, Xw))
        e = torch.sum((pred - uv) ** 2, -1)
        e = torch.where(ok, e, torch.full_like(e, 1e12))
        return torch.sum(torch.where(w > 0, e, torch.zeros_like(e)), -1)

    T1 = pose_from(b1[:, None, None] * v1)
    T2 = pose_from(bb1[:, None, None] * v1 + bb2[:, None, None] * v2)
    use2 = reproj_err(T2) < reproj_err(T1)
    T = SE3(R=torch.where(use2[:, None, None], T2.R, T1.R),
            t=torch.where(use2[:, None], T2.t, T1.t))
    return T.index(0) if single else T


@dataclasses.dataclass
class EPnPResult:
    T: SE3
    inliers: torch.Tensor       # (N,) bool
    num_inliers: torch.Tensor
    ok: torch.Tensor            # enough inliers to trust the pose


def draw_subsets(valid: torch.Tensor, n_hyp: int, subset: int,
                 generator: torch.Generator) -> torch.Tensor:
    """(n_hyp, subset) index sets, each drawn without replacement with
    probability proportional to `valid` (Gumbel top-k)."""
    N = valid.shape[0]
    u = torch.rand((n_hyp, N), generator=generator, device=valid.device)
    gumbel = -torch.log(-torch.log(torch.clamp(u, min=1e-12, max=1.0 - 1e-7)))
    logp = torch.where(valid, torch.zeros_like(u), torch.full_like(u, -torch.inf))
    return torch.topk(logp + gumbel, subset, dim=1).indices


def epnp_ransac(Xw: torch.Tensor, uv: torch.Tensor, valid: torch.Tensor, cam: PinholeCamera,
                generator: torch.Generator | None = None, subsets: torch.Tensor | None = None,
                n_hyp: int = 64, subset: int = 6, inlier_px: float = 3.0,
                min_inliers: int = 12, sigma2: torch.Tensor | None = None) -> EPnPResult:
    """Batched EPnP RANSAC (reference: EPnPRansac EPnP.h:129): n_hyp
    minimal subsets solved together, scored by reprojection inliers over all
    correspondences, the winner (first on ties) polished with the iterative
    LM PnP on its inliers. The subsets come from `subsets` (n_hyp, subset)
    when given, else from `generator`."""
    N = Xw.shape[0]
    dev = Xw.device
    s2 = torch.ones((N,), dtype=torch.float32, device=dev) if sigma2 is None else sigma2
    if subsets is None:
        if generator is None:
            raise ValueError("epnp_ransac needs a generator or explicit subsets")
        subsets = draw_subsets(valid, n_hyp, subset, generator)
    subsets = subsets.to(dev).long()
    S = subsets.shape[0]
    w = torch.zeros((S, N), dtype=torch.float32, device=dev)
    w.scatter_(1, subsets, 1.0)
    w = w * valid.float()
    Ts = epnp_solve(Xw, uv, w, cam)

    Xc = _apply(Ts, Xw)
    pred, ok = cam.project(Xc)
    e2 = torch.sum((pred - uv) ** 2, -1)
    inl = valid & ok & (e2 < inlier_px ** 2 * s2) & (Xc[..., 2] > 1e-3)
    best = torch.argmax(torch.sum(inl, -1))                             # first on ties
    T_best = Ts.index(best)

    # the winner's inliers, polished with the LM PnP
    Xc = T_best.apply(Xw)
    pred, okz = cam.project(Xc)
    e2 = torch.sum((pred - uv) ** 2, -1)
    inl = valid & okz & (e2 < inlier_px ** 2 * s2) & (Xc[..., 2] > 1e-3)
    res = solve_pnp(Xw, uv, inl, T_best, cam, sigma2=s2)
    return EPnPResult(T=res.T, inliers=res.inlier, num_inliers=res.num_inliers,
                      ok=res.num_inliers >= min_inliers)
