"""Photometric residuals and analytic Jacobians, batched over point arenas.

PyTorch port of libcml_tpu/models/direct/residuals.py: the numerical core
shared by the direct tracker, initializer and windowed photometric BA
(reference: src/cml/optimization/dso/DSOTracker.cpp:421-470 computeHessian,
DSOBundleAdjustment residual linearization). Every quantity is a tensor over
(points, pattern) and the Hessian assembly is one einsum.

Model (DSO): point p lives in host frame i at pixel uv with inverse depth
rho; observed in target frame j through relative pose T_ji = T_j ∘ T_i^-1.
Each pattern pixel warps with the shared rho. The affine brightness residual
is  r_k = I_j[warp(uv + d_k)] - b_ji - s_ji * color_k,  s_ji = exp(a_ji).
Geometric Jacobians are evaluated at the point center and shared across the
pattern; the image gradient is per-pattern.
"""

from __future__ import annotations

import dataclasses

import torch

from libcml_tpu_torch._device import const
from libcml_tpu_torch.core.camera import PinholeCamera
from libcml_tpu_torch.core.lie import SE3, skew
from libcml_tpu_torch.ops.image import bilinear

# DSO's 8-pixel residual pattern ("spread staircase", pattern #8).
PATTERN = ((0, -2), (-1, -1), (1, -1), (-2, 0), (0, 0), (2, 0), (-1, 1), (0, 2))
PATTERN_N = 8

# Single-pixel "pattern" of the coarse tracker (reference:
# CoarseTracker::calcRes uses ONE pixel per point at every level).
PATTERN_CENTER = ((0, 0),)


def pattern_tensor(pattern, device) -> torch.Tensor:
    """(K, 2) float32 pattern offsets on `device` (cached)."""
    return const(tuple(map(tuple, pattern)), torch.device(device))


@dataclasses.dataclass
class ResidualEval:
    """Everything the solvers need from one (points x target-frame) sweep."""

    r: torch.Tensor          # (P, K) residuals
    w: torch.Tensor          # (P, K) robust (Huber x gradient) weights
    valid: torch.Tensor      # (P,) point-level validity
    energy: torch.Tensor     # (P,) Huber energy per point (masked)
    uv_j: torch.Tensor       # (P, 2) warped center pixel in target
    g: torch.Tensor          # (P, K, 2) target image gradient at warped pattern
    J_uv_Xj: torch.Tensor    # (P, 2, 3) d(pixel)/d(target-frame point)
    X_i: torch.Tensor        # (P, 3) point in host camera frame
    X_j: torch.Tensor        # (P, 3) point in target camera frame
    s_ji: torch.Tensor       # scalar brightness scale exp(a_ji)


def huber_weight(r: torch.Tensor, k: float) -> torch.Tensor:
    """Huber IRLS weight: 1 inside, k/|r| outside."""
    ar = torch.abs(r)
    return torch.where(ar <= k, torch.ones_like(r), k / torch.clamp(ar, min=1e-12))


def huber_energy(r: torch.Tensor, k: float) -> torch.Tensor:
    """Huber loss value (so accept/reject compares the true robust energy)."""
    ar = torch.abs(r)
    return torch.where(ar <= k, 0.5 * r * r, k * (ar - 0.5 * k))


def pattern_uv(uv: torch.Tensor, level_scale: float = 1.0, pattern=None) -> torch.Tensor:
    """(P, 2) center pixels -> (P, K, 2) pattern pixels."""
    pat = pattern_tensor(PATTERN if pattern is None else pattern, uv.device)
    return uv[:, None, :] + pat[None, :, :] * level_scale


def proj_jacobian(cam: PinholeCamera, X: torch.Tensor) -> torch.Tensor:
    """d(pixel)/d(camera point): (..., 2, 3) for points (..., 3)."""
    x, y, z = X[..., 0], X[..., 1], X[..., 2]
    iz = 1.0 / torch.clamp(z, min=1e-8)
    iz2 = iz * iz
    zero = torch.zeros_like(z)
    row_u = torch.stack([cam.fx * iz, zero, -cam.fx * x * iz2], dim=-1)
    row_v = torch.stack([zero, cam.fy * iz, -cam.fy * y * iz2], dim=-1)
    return torch.stack([row_u, row_v], dim=-2)


def evaluate_residuals(
    grad_j: torch.Tensor,    # (H, W, 3) target [value, gx, gy] at this level
    cam: PinholeCamera,      # intrinsics at this level
    uv: torch.Tensor,        # (P, 2) host pixels at this level
    idepth: torch.Tensor,    # (P,) inverse depth in host frame
    color: torch.Tensor,     # (P, K) host pattern intensities
    weight: torch.Tensor,    # (P, K) per-pixel gradient weights
    T_ji: SE3,               # relative pose target<-host
    a_ji: torch.Tensor,      # relative log brightness scale
    b_ji: torch.Tensor,      # relative brightness offset
    huber_k: float = 9.0,
    border: float = 2.0,
    cutoff: float | None = None,
    pattern=None,
) -> ResidualEval:
    """One masked sweep of photometric residuals of a point set against one
    target frame. Everything out-of-bounds or behind the camera is masked,
    not branched. `pattern` selects the residual support (default: the DSO
    8-pattern; the tracker passes PATTERN_CENTER)."""
    X_i = cam.unproject(uv, idepth)                       # (P, 3)
    X_j = T_ji.apply(X_i)                                 # (P, 3)
    uv_j_center, valid_z = cam.project(X_j)

    p_uv = pattern_uv(uv, pattern=pattern)                # (P, K, 2)
    Xp_i = cam.unproject(p_uv, idepth[:, None])           # (P, K, 3)
    Xp_j = T_ji.apply(Xp_i)
    uv_jk, valid_zk = cam.project(Xp_j)                   # (P, K, 2)

    in_bounds = cam.in_bounds(uv_jk, border=border)
    valid = valid_z & torch.all(valid_zk & in_bounds, dim=-1)

    sample = bilinear(grad_j, uv_jk)                      # (P, K, 3)
    I_j = sample[..., 0]
    g = sample[..., 1:3]

    s_ji = torch.exp(a_ji)
    r = I_j - b_ji - s_ji * color

    w = huber_weight(r, huber_k) * weight
    e_pat = huber_energy(r, huber_k)
    if cutoff is not None:
        # DSO's hard cutoff (setting_coarseCutoffTH): residuals beyond
        # `cutoff` get ZERO weight while their energy saturates at the cap
        over = torch.abs(r) > cutoff
        w = torch.where(over, torch.zeros_like(w), w)
        cap = huber_energy(torch.tensor(cutoff, dtype=torch.float32), huber_k).item()
        e_pat = torch.clamp(e_pat, max=cap)
    w = torch.where(valid[:, None], w, torch.zeros_like(w))
    energy = torch.where(valid, torch.sum(weight * e_pat, dim=-1),
                         torch.zeros_like(valid, dtype=r.dtype))

    return ResidualEval(
        r=r, w=w, valid=valid, energy=energy, uv_j=uv_j_center, g=g,
        J_uv_Xj=proj_jacobian(cam, X_j), X_i=X_i, X_j=X_j, s_ji=s_ji,
    )


def rel_pose_jacobian(ev: ResidualEval, color: torch.Tensor) -> torch.Tensor:
    """Jacobian of residuals wrt the 8-dof RELATIVE state
    [v(3), w(3), a_ji, b_ji] under a left-multiplicative perturbation of
    T_ji (dX_j/dv = I, dX_j/dw = -skew(X_j)). Returns (P, K, 8)."""
    X_j = ev.X_j
    eye = torch.eye(3, dtype=X_j.dtype, device=X_j.device).expand(*X_j.shape[:-1], 3, 3)
    J_Xj_xi = torch.cat([eye, -skew(X_j)], dim=-1)               # (P, 3, 6)
    J_uv_xi = ev.J_uv_Xj @ J_Xj_xi                               # (P, 2, 6)
    J_geo = ev.g @ J_uv_xi                                       # (P, K, 6)
    J_a = (-ev.s_ji * color)[..., None]                          # (P, K, 1)
    J_b = -torch.ones_like(J_a)
    return torch.cat([J_geo, J_a, J_b], dim=-1)


def idepth_jacobian(ev: ResidualEval, T_ji: SE3, idepth: torch.Tensor) -> torch.Tensor:
    """Jacobian of residuals wrt the host inverse depth: (P, K).
    dX_j/drho = -(X_j - t_ji)/rho."""
    dXj_drho = -(ev.X_j - T_ji.t) / torch.clamp(idepth, min=1e-8)[:, None]
    J_uv_rho = (ev.J_uv_Xj @ dXj_drho[..., None])[..., 0]            # (P, 2)
    return (ev.g @ J_uv_rho[..., None])[..., 0]                      # (P, K)


def gauss_newton_system(J: torch.Tensor, r: torch.Tensor, w: torch.Tensor):
    """Weighted GN normal equations from per-pattern Jacobians.
    J: (P, K, D), r: (P, K), w: (P, K) -> H (D, D), b (D,), chi2 scalar."""
    Jw = J * w[..., None]
    H = torch.einsum("pkd,pke->de", Jw, J)
    b = torch.einsum("pkd,pk->d", Jw, r)
    chi2 = torch.sum(w * r * r)
    return H, b, chi2
