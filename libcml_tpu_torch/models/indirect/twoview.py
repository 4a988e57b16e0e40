"""Two-view geometric bootstrap: batched RANSAC for F and H, model
selection, and motion recovery with cheirality voting.

PyTorch port of libcml_tpu/models/indirect/twoview.py (the reference's
RobustFundamental8Points, RobustHomography, the RANSAC driver
robust/backend/Ransac.h:224 and the ORB-SLAM-style initializer
RobustRaulmurInitializer.h:10,17). All hypotheses are generated and scored at
once: minimal sets are an (S, k) gather, the 8-point and DLT fits are batched
eigensolves of (S, 9, 9) normal matrices, and scoring is one (S, N) sweep.
H is chosen when its score takes more than 0.45 of the combined score; the
motion comes from the essential matrix of a least-squares F over the chosen
model's inliers, by cheirality and parallax voting over its four
decompositions.

Randomness: the minimal sets are drawn from a torch.Generator or passed in
(`idx_f`, `idx_h`), so a test can inject another RNG's draws.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from libcml_tpu_torch.core.camera import PinholeCamera
from libcml_tpu_torch.core.lie import SE3
from libcml_tpu_torch.models.indirect.pnp import triangulate_linear


def _normalize_points(x: torch.Tensor, valid: torch.Tensor):
    """Hartley normalization over the valid points: zero mean, mean distance
    sqrt(2). Returns (x_n (N, 2), T (3, 3)) with x_n = T x."""
    w = valid.to(x.dtype)
    n = torch.clamp(torch.sum(w), min=1.0)
    mean = torch.sum(x * w[:, None], dim=0) / n
    d = torch.sqrt(torch.sum((x - mean) ** 2, dim=-1) + 1e-12)
    md = torch.sum(d * w) / n
    s = math.sqrt(2.0) / torch.clamp(md, min=1e-9)
    T = torch.eye(3, dtype=x.dtype, device=x.device)
    T[0, 0] = s
    T[1, 1] = s
    T[0, 2] = -s * mean[0]
    T[1, 2] = -s * mean[1]
    return (x - mean) * s, T


def _design_f(x0: torch.Tensor, x1: torch.Tensor) -> torch.Tensor:
    """8-point rows [u1u0, u1v0, u1, v1u0, v1v0, v1, u0, v0, 1]."""
    u0, v0 = x0[..., 0], x0[..., 1]
    u1, v1 = x1[..., 0], x1[..., 1]
    return torch.stack([u1 * u0, u1 * v0, u1, v1 * u0, v1 * v0, v1, u0, v0,
                        torch.ones_like(u0)], dim=-1)


def _rank2(F: torch.Tensor) -> torch.Tensor:
    U, s, Vt = torch.linalg.svd(F)
    s = torch.cat([s[..., :2], torch.zeros_like(s[..., 2:])], dim=-1)
    return U @ torch.diag_embed(s) @ Vt


def _fit_fundamental(x0: torch.Tensor, x1: torch.Tensor) -> torch.Tensor:
    """Batched normalized 8-point: x0/x1 (S, 8, 2) -> F (S, 3, 3), rank 2."""
    A = _design_f(x0, x1)                                   # (S, 8, 9)
    _, V = torch.linalg.eigh(A.transpose(1, 2) @ A)
    return _rank2(V[..., 0].reshape(-1, 3, 3))


def _fit_homography(x0: torch.Tensor, x1: torch.Tensor) -> torch.Tensor:
    """Batched DLT: x0/x1 (S, 4, 2) -> H (S, 3, 3) with x1 ~ H x0."""
    u0, v0 = x0[..., 0], x0[..., 1]
    u1, v1 = x1[..., 0], x1[..., 1]
    z, o = torch.zeros_like(u0), torch.ones_like(u0)
    r1 = torch.stack([u0, v0, o, z, z, z, -u1 * u0, -u1 * v0, -u1], dim=-1)
    r2 = torch.stack([z, z, z, u0, v0, o, -v1 * u0, -v1 * v0, -v1], dim=-1)
    A = torch.cat([r1, r2], dim=1)                          # (S, 2k, 9)
    _, V = torch.linalg.eigh(A.transpose(1, 2) @ A)
    return V[..., 0].reshape(-1, 3, 3)


def _sampson_f(F: torch.Tensor, x0h: torch.Tensor, x1h: torch.Tensor) -> torch.Tensor:
    """Squared Sampson distances (S, N) of F (S, 3, 3) on x0h/x1h (N, 3)."""
    Fx0 = torch.einsum("sij,nj->sni", F, x0h)
    Ftx1 = torch.einsum("sji,nj->sni", F, x1h)
    num = torch.einsum("ni,sni->sn", x1h, Fx0) ** 2
    den = Fx0[..., 0] ** 2 + Fx0[..., 1] ** 2 + Ftx1[..., 0] ** 2 + Ftx1[..., 1] ** 2
    return num / torch.clamp(den, min=1e-12)


def _symmetric_transfer_h(H: torch.Tensor, x0h: torch.Tensor, x1h: torch.Tensor) -> torch.Tensor:
    """Symmetric transfer errors (S, N) of H (S, 3, 3)."""
    eye = torch.eye(3, dtype=H.dtype, device=H.device)
    Hinv, _ = torch.linalg.inv_ex(H + 1e-12 * eye)

    def err(M, xa, xb):
        xp = torch.einsum("sij,nj->sni", M, xa)
        z = xp[..., 2:]
        return torch.sum((xp[..., :2] / torch.clamp(torch.abs(z), min=1e-9) * torch.sign(z)
                          - xb[None, :, :2]) ** 2, -1)

    return err(Hinv, x1h, x0h) + err(H, x0h, x1h)


@dataclasses.dataclass
class TwoViewResult:
    T_10: SE3                   # pose of view 1 w.r.t. view 0 (w2c delta; |t| = 1)
    X0: torch.Tensor            # (N, 3) triangulated points in the view-0 frame
    inlier: torch.Tensor        # (N,) bool final inliers with positive depth
    num_inliers: torch.Tensor
    used_homography: torch.Tensor
    score_f: torch.Tensor
    score_h: torch.Tensor
    ok: torch.Tensor            # enough inliers + a clear cheirality winner


def _decompose_essential(E: torch.Tensor):
    """E (3, 3) -> the four (R, t) candidates (Hartley-Zisserman)."""
    U, _, Vt = torch.linalg.svd(E)
    U = U * torch.sign(torch.linalg.det(U))
    Vt = Vt * torch.sign(torch.linalg.det(Vt))
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                     dtype=E.dtype, device=E.device)
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    t = U[:, 2]
    return torch.stack([R1, R1, R2, R2]), torch.stack([t, -t, t, -t])


def two_view_init(uv0: torch.Tensor, uv1: torch.Tensor, valid: torch.Tensor,
                  cam: PinholeCamera, generator: torch.Generator | None = None,
                  idx_f: torch.Tensor | None = None, idx_h: torch.Tensor | None = None,
                  n_hyp: int = 256, th_px: float = 1.5, min_inliers: int = 30) -> TwoViewResult:
    """ORB-SLAM-style robust two-view bootstrap (reference:
    RobustRaulmurInitializer::track) over matched pixels uv0/uv1 (N, 2).
    The minimal sets (n_hyp, 8) for F and (n_hyp, 4) for H are `idx_f` and
    `idx_h` when given, else drawn uniformly (with replacement) from
    `generator`."""
    N = uv0.shape[0]
    dev, dt = uv0.device, uv0.dtype
    if idx_f is None or idx_h is None:
        if generator is None:
            raise ValueError("two_view_init needs a generator or explicit index sets")
        idx_f = torch.randint(0, N, (n_hyp, 8), generator=generator, device=dev)
        idx_h = torch.randint(0, N, (n_hyp, 4), generator=generator, device=dev)
    idx_f, idx_h = idx_f.to(dev).long(), idx_h.to(dev).long()
    ones = torch.ones((N, 1), dtype=dt, device=dev)
    x0h = torch.cat([uv0, ones], -1)
    x1h = torch.cat([uv1, ones], -1)

    # normalized fits (one normalization over all matches), denormalized
    xn0, T0 = _normalize_points(uv0, valid)
    xn1, T1 = _normalize_points(uv1, valid)
    F = T1.T @ _fit_fundamental(xn0[idx_f], xn1[idx_f]) @ T0
    H = torch.linalg.inv(T1) @ _fit_homography(xn0[idx_h], xn1[idx_h]) @ T0

    th2 = th_px * th_px
    d_f = _sampson_f(F, x0h, x1h)
    d_h = _symmetric_transfer_h(H, x0h, x1h)
    vmask = valid[None, :]
    zero = torch.zeros_like(d_f)
    # ORB-SLAM scoring: sum of (th - d) over the inliers
    sc_f = torch.sum(torch.where(vmask & (d_f < th2), th2 - d_f, zero), dim=1)
    sc_h = torch.sum(torch.where(vmask & (d_h < 2 * th2), 2 * th2 - d_h, zero), dim=1)
    best_f = torch.argmax(sc_f)
    best_h = torch.argmax(sc_h)
    score_f, score_h = sc_f[best_f], sc_h[best_h]
    use_h = score_h / torch.clamp(score_f + score_h, min=1e-9) > 0.45
    inlier0 = torch.where(use_h, valid & (d_h[best_h] < 2 * th2), valid & (d_f[best_f] < th2))

    # E from one least-squares F over all of the chosen model's inliers
    K = cam.K(dev)
    xn0i, T0i = _normalize_points(uv0, inlier0)
    xn1i, T1i = _normalize_points(uv1, inlier0)
    A = _design_f(xn0i, xn1i) * inlier0.to(dt)[:, None]
    _, V = torch.linalg.eigh(A.T @ A)
    F_all = T1i.T @ _rank2(V[:, 0].reshape(3, 3)) @ T0i
    E = K.T @ F_all @ K
    Rs, ts = _decompose_essential(E)

    cos_min = math.cos(math.radians(1.0))
    votes, par_votes, X0s, goods = [], [], [], []
    for R, t in zip(Rs, ts):
        X0, okd = triangulate_linear(uv0, uv1, SE3(R=R, t=t), cam)
        good = inlier0 & okd & (X0[..., 2] > 1e-3) & (X0[..., 2] < 1e4)
        # parallax: the angle between the two observation rays (CheckRT's
        # minimum median parallax; under pure rotation the rays are parallel)
        C1 = -(R.T @ t)
        ray0 = X0 / torch.clamp(torch.linalg.norm(X0, dim=-1, keepdim=True), min=1e-9)
        d1 = X0 - C1
        ray1 = d1 / torch.clamp(torch.linalg.norm(d1, dim=-1, keepdim=True), min=1e-9)
        cospar = torch.sum(ray0 * ray1, dim=-1)
        votes.append(torch.sum(good))
        par_votes.append(torch.sum(good & (cospar < cos_min)))
        X0s.append(X0)
        goods.append(good)
    votes = torch.stack(votes)
    best = torch.argmax(votes)
    n_best = votes[best]
    second = torch.sort(votes).values[-2]
    # the winner must clearly dominate and carry real parallax
    ok = (n_best >= min_inliers) & (n_best > 1.5 * second + 1) \
        & (torch.stack(par_votes)[best] > 0.5 * n_best)
    return TwoViewResult(T_10=SE3(R=Rs[best], t=ts[best]), X0=torch.stack(X0s)[best],
                         inlier=torch.stack(goods)[best], num_inliers=n_best,
                         used_homography=use_h, score_f=score_f, score_h=score_h, ok=ok)
