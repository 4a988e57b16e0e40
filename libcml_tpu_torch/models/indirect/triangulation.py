"""Two-view triangulation: the OPTIMAL (Hartley-Sturm) correction.

PyTorch port of libcml_tpu/models/indirect/triangulation.py (the reference's
Triangulation module, src/cml/optimization/Triangulation.h:141 optimal
Hartley2003). The reference corrects one match at a time through the roots of
a degree-6 polynomial; here the same objective (least total squared
correction subject to the epipolar constraint, 1-D in the epipolar-pencil
parameter t) is minimized directly over the whole match set: a 129-point
tan-spaced grid finds the global basin (first index on ties) and 40
golden-section steps polish it, all in float32.
"""

from __future__ import annotations

import math

import torch

from libcml_tpu_torch.core.camera import PinholeCamera
from libcml_tpu_torch.core.lie import SE3


def _closest_point_on_line(l: torch.Tensor) -> torch.Tensor:
    """Homogeneous point on line l=(lam, mu, nu) closest to the origin."""
    lam, mu, nu = l[..., 0], l[..., 1], l[..., 2]
    return torch.stack([-lam * nu, -mu * nu, lam * lam + mu * mu], dim=-1)


def _min_cost_t(a, b, c, d, f0, f1, grid: int = 129, refine: int = 40):
    """Globally minimize the Hartley-Sturm pencil cost
        s(t) = t^2/(1 + f0^2 t^2) + (ct+d)^2/((at+b)^2 + f1^2 (ct+d)^2)
    over t = tan(theta), theta in (-pi/2, pi/2), batched over N
    correspondences. Returns (t_best, cost_best)."""

    def cost(t):
        At = a[:, None] * t + b[:, None]
        Ct = c[:, None] * t + d[:, None]
        s1 = t * t / (1.0 + (f0[:, None] * t) ** 2)
        s2 = Ct * Ct / (At * At + (f1[:, None] * Ct) ** 2 + 1e-30)
        return s1 + s2

    half = math.pi / 2 - 1e-3
    theta = torch.linspace(-half, half, grid, dtype=a.dtype, device=a.device)
    costs = cost(torch.tan(theta)[None, :])                  # (N, G)
    best = torch.argmin(costs, dim=-1)                        # first index on ties
    step = theta[1] - theta[0]
    lo = theta[best] - step
    hi = theta[best] + step

    gr = 0.6180339887498949
    for _ in range(refine):
        m1 = hi - gr * (hi - lo)
        m2 = lo + gr * (hi - lo)
        c1 = cost(torch.tan(m1)[:, None])[:, 0]
        c2 = cost(torch.tan(m2)[:, None])[:, 0]
        take_lo = c1 < c2
        lo, hi = torch.where(take_lo, lo, m1), torch.where(take_lo, m2, hi)
    t_best = torch.tan(0.5 * (lo + hi))
    return t_best, cost(t_best[:, None])[:, 0]


def _translation(x: torch.Tensor) -> torch.Tensor:
    """(N, 3, 3) translations taking the points x (N, 2) to the origin."""
    N = x.shape[0]
    T = torch.eye(3, dtype=x.dtype, device=x.device).repeat(N, 1, 1)
    T[:, 0, 2] = -x[:, 0]
    T[:, 1, 2] = -x[:, 1]
    return T


def _rotation_of(e: torch.Tensor) -> torch.Tensor:
    """(N, 3, 3) rotations taking the epipoles e (N, 3) to (1, 0, e3)."""
    N = e.shape[0]
    R = torch.zeros((N, 3, 3), dtype=e.dtype, device=e.device)
    R[:, 0, 0], R[:, 0, 1] = e[:, 0], e[:, 1]
    R[:, 1, 0], R[:, 1, 1] = -e[:, 1], e[:, 0]
    R[:, 2, 2] = 1.0
    return R


def _right_null(M: torch.Tensor) -> torch.Tensor:
    return torch.linalg.svd(M)[2][..., -1, :]


def _norm_epi(e: torch.Tensor) -> torch.Tensor:
    s = torch.sqrt(e[..., 0] ** 2 + e[..., 1] ** 2)
    return e / torch.clamp(s, min=1e-12)[..., None]


def optimal_correct(x0: torch.Tensor, x1: torch.Tensor,
                    F: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Hartley-Sturm optimal correction (HZ Algorithm 12.1): move each
    correspondence (x0 (N, 2), x1 (N, 2), x1^T F x0 = 0 wanted) the least
    total squared distance so it satisfies the epipolar constraint exactly.
    Returns the corrected (x0', x1')."""
    # 1. translate both points to the origin; F' = T1^-T F T0^-1
    T0inv = _translation(-x0)
    T1inv = _translation(-x1)
    Fp = torch.einsum("nji,jk,nkl->nil", T1inv, F, T0inv)

    # 2. epipoles (right / left null vectors), scaled so e1^2 + e2^2 = 1
    e0 = _norm_epi(_right_null(Fp))
    e1 = _norm_epi(_right_null(Fp.transpose(-1, -2)))
    R0 = _rotation_of(e0)
    R1 = _rotation_of(e1)
    Fpp = torch.einsum("nij,njk,nlk->nil", R1, Fp, R0)       # R1 F' R0^T

    f0, f1 = e0[:, 2], e1[:, 2]
    a, b = Fpp[:, 1, 1], Fpp[:, 1, 2]
    c, d = Fpp[:, 2, 1], Fpp[:, 2, 2]

    # 3. minimize s(t) over the epipolar pencil
    t_best, cost_best = _min_cost_t(a, b, c, d, f0, f1)

    # 4. against the t -> inf asymptote
    cost_inf = 1.0 / torch.clamp(f0 * f0, min=1e-30) + c * c / (a * a + f1 * f1 * c * c + 1e-30)
    use_inf = (cost_inf < cost_best)[:, None]
    one, zero = torch.ones_like(t_best), torch.zeros_like(t_best)
    l0_t = torch.stack([t_best * f0, one, -t_best], -1)
    l1_t = torch.stack([-f1 * (c * t_best + d), a * t_best + b, c * t_best + d], -1)
    l0_inf = torch.stack([f0, zero, -one], -1)
    l1_inf = torch.stack([-f1 * c, a, c], -1)
    x0_hat = _closest_point_on_line(torch.where(use_inf, l0_inf, l0_t))
    x1_hat = _closest_point_on_line(torch.where(use_inf, l1_inf, l1_t))

    # 5. transfer back: x = T^-1 R^T x_hat
    x0_new = torch.einsum("nij,nkj,nk->ni", T0inv, R0, x0_hat)
    x1_new = torch.einsum("nij,nkj,nk->ni", T1inv, R1, x1_hat)

    def dehom(x):
        w = torch.where(torch.abs(x[..., 2]) < 1e-12, torch.full_like(x[..., 2], 1e-12),
                        x[..., 2])
        return x[..., :2] / w[..., None]

    return dehom(x0_new), dehom(x1_new)


def fundamental(T_10: SE3, cam: PinholeCamera) -> torch.Tensor:
    """F with x1^T F x0 = 0 for pixels of views 0 and 1: K^-T [t]x R K^-1."""
    dev = T_10.t.device
    Kinv = torch.linalg.inv(cam.K(dev))
    t = T_10.t
    z = torch.zeros((), dtype=t.dtype, device=dev)
    tx = torch.stack([
        torch.stack([z, -t[2], t[1]]),
        torch.stack([t[2], z, -t[0]]),
        torch.stack([-t[1], t[0], z]),
    ])
    return Kinv.T @ tx @ T_10.R @ Kinv


def triangulate_optimal(uv0: torch.Tensor, uv1: torch.Tensor, T_10: SE3,
                        cam: PinholeCamera) -> tuple[torch.Tensor, torch.Tensor]:
    """Optimal two-view triangulation: Hartley-Sturm correction of the pixel
    pairs, then the linear DLT (reference: Triangulation.h:141). Returns
    (X in frame 0 (N, 3), valid (N,)), as pnp.triangulate_linear."""
    from libcml_tpu_torch.models.indirect.pnp import triangulate_linear

    uv0c, uv1c = optimal_correct(uv0, uv1, fundamental(T_10, cam))
    return triangulate_linear(uv0c, uv1c, T_10, cam)
