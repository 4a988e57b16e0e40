"""Windowed photometric bundle adjustment with FEJ + marginalization.

PyTorch port of libcml_tpu/models/direct/ba.py, the mixed (photometric +
reprojection) half included (the reference's DSOBundleAdjustment:
src/cml/optimization/dso/DSOBundleAdjustment.cpp:744 run, :1284
solveLevenbergMarquardt, :2674 addIndirectToProblem,
DSOBundleAdjustment.h:35 marginalizeFrame, :48 computeNullspaces).

  - The window is a FIXED arena of F keyframe slots and P point slots with
    validity masks; the residual set is the dense (P, F) grid of
    (point, target-frame) pairs with an activity mask.
  - One linearization = one sweep producing all residuals, robust weights
    and Jacobians as (P, F, ...) tensors; the 8-dof-per-frame Hessian blocks
    are assembled with one-hot einsums and the per-point inverse depths are
    Schur-eliminated with a batched divide.
  - First-Estimate Jacobians: geometry at the linearization point, the
    photometric residual at the current state.
  - Marginalization folds a frame into a dense prior (H_m, b_m) over the
    window slots; the runtime does that algebra in host float64
    (`marginalize_frame_f64`), as the reference does it in double.
  - With a `mesh` (parallel/sharding.py), each rank sweeps its block of
    point rows; the point sums are all-reduced, the terms every rank holds
    whole are added once after, and the inverse-depth steps are
    all-gathered. Without one, nothing of that runs.

State layout (F = frame slots, P = point slots):
  frames : T (F), ab (F, 2), FEJ copies, delta (F, 8), valid (F,)
  points : uv (P, 2), host (P,), idepth (P,), idepth_fej (P,),
           color (P, 8), weight (P, 8), valid (P,)
  resid  : active (P, F) bool
  prior  : H_m (F*8, F*8), b_m (F*8,)
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as Fnn

from libcml_tpu_torch._device import const
from libcml_tpu_torch.core.camera import PinholeCamera
from libcml_tpu_torch.core.lie import SE3, se3_exp, se3_select, skew
from libcml_tpu_torch.models.direct.config import DirectConfig
from libcml_tpu_torch.models.direct.residuals import (
    huber_energy,
    huber_weight,
    pattern_uv,
    proj_jacobian,
)
from libcml_tpu_torch.ops import ba_sweep as bk
from libcml_tpu_torch.ops.image import bilinear_stack
from libcml_tpu_torch.parallel.sharding import Mesh, local_rows

_D = 8  # per-frame state dim: [v(3), w(3), a, b]


@dataclasses.dataclass
class BAState:
    # frames (F slots)
    T: SE3                     # current world-to-camera poses
    ab: torch.Tensor           # (F, 2) per-frame affine brightness [a, b]
    T_fej: SE3                 # linearization-point poses
    ab_fej: torch.Tensor       # (F, 2)
    delta: torch.Tensor        # (F, 8) accumulated left-tangent state - FEJ
    frame_valid: torch.Tensor  # (F,) bool

    # points (P slots)
    uv: torch.Tensor           # (P, 2) level-0 pixel in host frame
    host: torch.Tensor         # (P,) int32 host slot index
    idepth: torch.Tensor       # (P,)
    idepth_fej: torch.Tensor   # (P,)
    color: torch.Tensor        # (P, 8) host pattern intensities
    weight: torch.Tensor       # (P, 8) host gradient weights
    point_valid: torch.Tensor  # (P,) bool

    res_active: torch.Tensor   # (P, F) bool residual activity

    H_m: torch.Tensor          # (F*8, F*8) marginalization prior
    b_m: torch.Tensor          # (F*8,)

    def replace(self, **kw) -> "BAState":
        return dataclasses.replace(self, **kw)

    @property
    def num_frames(self) -> int:
        return self.ab.shape[0]

    @property
    def num_points(self) -> int:
        return self.uv.shape[0]


def empty_state(cfg: DirectConfig, device: str | torch.device = "cpu") -> BAState:
    F, P = cfg.max_frames, cfg.max_points
    f32 = dict(dtype=torch.float32, device=device)
    return BAState(
        T=SE3.identity((F,), device=device),
        ab=torch.zeros((F, 2), **f32),
        T_fej=SE3.identity((F,), device=device),
        ab_fej=torch.zeros((F, 2), **f32),
        delta=torch.zeros((F, _D), **f32),
        frame_valid=torch.zeros((F,), dtype=torch.bool, device=device),
        uv=torch.zeros((P, 2), **f32),
        host=torch.zeros((P,), dtype=torch.int32, device=device),
        idepth=torch.ones((P,), **f32),
        idepth_fej=torch.ones((P,), **f32),
        color=torch.zeros((P, 8), **f32),
        weight=torch.zeros((P, 8), **f32),
        point_valid=torch.zeros((P,), dtype=torch.bool, device=device),
        res_active=torch.zeros((P, F), dtype=torch.bool, device=device),
        H_m=torch.zeros((F * _D, F * _D), **f32),
        b_m=torch.zeros((F * _D,), **f32),
    )


def anchor_first_frame(state: BAState, slot: int, cfg: DirectConfig) -> BAState:
    """Gauge anchor: a strong pose prior on the first keyframe's slot."""
    idx = slot * _D + torch.arange(6, device=state.H_m.device)
    H_m = state.H_m.clone()
    H_m[idx, idx] += cfg.pose_prior_first
    return state.replace(H_m=H_m)


# ---------------------------------------------------------------------------
# Linearization
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Linearization:
    """All (P, F) residual quantities one BA iteration needs."""

    r: torch.Tensor        # (P, F, 8) residuals at CURRENT state
    w: torch.Tensor        # (P, F, 8) robust*gradient*active weights
    J_t: torch.Tensor      # (P, F, 8, 8) d r / d target-frame state (FEJ)
    J_h: torch.Tensor      # (P, F, 8, 8) d r / d host-frame state (FEJ)
    J_rho: torch.Tensor    # (P, F, 8) d r / d idepth (FEJ)
    active: torch.Tensor   # (P, F) residual active & in-bounds & positive depth
    energy: torch.Tensor   # (P, F) per-residual Huber energy (masked)


def _pairwise_rel(T: SE3) -> SE3:
    """All relative poses T_rel[i, j] = T_j ∘ T_i^-1 (target j <- host i)."""
    F = T.t.shape[0]
    Ti = SE3(R=T.R[:, None].expand(F, F, 3, 3), t=T.t[:, None].expand(F, F, 3))
    Tj = SE3(R=T.R[None, :].expand(F, F, 3, 3), t=T.t[None, :].expand(F, F, 3))
    return Tj.compose(Ti.inverse())


def _onehot(host: torch.Tensor, F: int, dtype=torch.float32) -> torch.Tensor:
    return Fnn.one_hot(host.long(), F).to(dtype)


def linearize(
    state: BAState,
    images: torch.Tensor,   # (F, H, W, 3) level-0 gradient images per slot
    cam: PinholeCamera,
    cfg: DirectConfig,
) -> Linearization:
    """One dense (P, F) linearization sweep. FEJ: geometry at linearization
    point, residual at current state."""
    P, F = state.num_points, state.num_frames
    dev = state.uv.device
    host = state.host.long()

    rel_cur = _pairwise_rel(state.T)
    rel_fej = _pairwise_rel(state.T_fej)
    R_cur, t_cur = rel_cur.R[host], rel_cur.t[host]    # (P, F, 3, 3)/(P, F, 3)
    R_fej, t_fej = rel_fej.R[host], rel_fej.t[host]

    # ---- current-state warp + residual -----------------------------------
    p_uv = pattern_uv(state.uv)                            # (P, 8, 2)
    Xp_i = cam.unproject(p_uv, state.idepth[:, None])      # (P, 8, 3)
    Xp_j = torch.einsum("pfij,pkj->pfki", R_cur, Xp_i) + t_cur[:, :, None, :]
    uv_j, valid_z = cam.project(Xp_j)                      # (P, F, 8, 2)
    in_b = cam.in_bounds(uv_j, border=2.0)
    geo_ok = torch.all(valid_z & in_b, dim=-1)             # (P, F)

    # sample every target image at its own warped pixels
    sample = bilinear_stack(images, uv_j)                  # (P, F, 8, 3)
    I_j = sample[..., 0]                                   # (P, F, 8)
    g = sample[..., 1:3]                                   # (P, F, 8, 2)

    # r = I_j - b_j - e^{a_j - a_i} * (color - b_i)
    a_i = state.ab[host, 0][:, None]                       # (P, 1)
    b_i = state.ab[host, 1][:, None]
    a_j = state.ab[None, :, 0]                             # (1, F)
    b_j = state.ab[None, :, 1]
    s_ji = torch.exp(a_j - a_i)                            # (P, F)
    r = I_j - b_j[:, :, None] - s_ji[:, :, None] * (state.color[:, None, :] - b_i[:, :, None])

    # ---- FEJ geometry for Jacobians ---------------------------------------
    X_i0 = cam.unproject(state.uv, state.idepth_fej)       # (P, 3)
    X_j0 = torch.einsum("pfij,pj->pfi", R_fej, X_i0) + t_fej
    J_uv_Xj = proj_jacobian(cam, X_j0)                     # (P, F, 2, 3)

    eye3 = torch.eye(3, dtype=r.dtype, device=dev)
    J_Xj_t = torch.cat([eye3.expand(P, F, 3, 3), -skew(X_j0)], dim=-1)   # (P, F, 3, 6)
    J_Xi = torch.cat([eye3.expand(P, 3, 3), -skew(X_i0)], dim=-1)        # (P, 3, 6)
    J_Xj_h = -torch.einsum("pfij,pjd->pfid", R_fej, J_Xi)                # (P, F, 3, 6)

    J_uv_t = J_uv_Xj @ J_Xj_t                              # (P, F, 2, 6)
    J_uv_h = J_uv_Xj @ J_Xj_h
    Jg_t = g @ J_uv_t                                      # (P, F, 8, 6)
    Jg_h = g @ J_uv_h

    dXj_drho = -(X_j0 - t_fej) / torch.clamp(state.idepth_fej, min=1e-8)[:, None, None]
    J_uv_rho = (J_uv_Xj @ dXj_drho[..., None])[..., 0]     # (P, F, 2)
    J_rho = (g @ J_uv_rho[..., None])[..., 0]              # (P, F, 8)

    a_i0 = state.ab_fej[host, 0][:, None]
    b_i0 = state.ab_fej[host, 1][:, None]
    a_j0 = state.ab_fej[None, :, 0]
    s0 = torch.exp(a_j0 - a_i0)                            # (P, F)
    col0 = state.color[:, None, :] - b_i0[:, :, None]      # (P, F, 8)
    dr_daj = -s0[:, :, None] * col0
    dr_dai = s0[:, :, None] * col0
    dr_dbj = -torch.ones_like(r)
    dr_dbi = s0[:, :, None].expand(r.shape)

    J_t = torch.cat([Jg_t, dr_daj[..., None], dr_dbj[..., None]], dim=-1)
    J_h = torch.cat([Jg_h, dr_dai[..., None], dr_dbi[..., None]], dim=-1)

    # ---- masks + robust weights -------------------------------------------
    fv = state.frame_valid
    not_self = host[:, None] != torch.arange(F, device=dev)[None, :]
    active = (
        state.res_active
        & state.point_valid[:, None]
        & fv[None, :]
        & fv[host][:, None]
        & not_self
        & geo_ok
    )
    w = huber_weight(r, cfg.huber_intensity) * state.weight[:, None, :]
    w = torch.where(active[..., None], w, torch.zeros_like(w))
    energy = torch.where(
        active,
        torch.sum(state.weight[:, None, :] * huber_energy(r, cfg.huber_intensity), dim=-1),
        torch.zeros_like(active, dtype=r.dtype),
    )
    return Linearization(r=r, w=w, J_t=J_t, J_h=J_h, J_rho=J_rho,
                         active=active, energy=energy)


# ---------------------------------------------------------------------------
# Normal equations: frame blocks + idepth Schur complement
# ---------------------------------------------------------------------------


def _assemble(
    lin: Linearization,
    state: BAState,
    cfg: DirectConfig,
    r_shift: torch.Tensor | None = None,
):
    """Build the Schur-reducible camera system.

    Returns (H (F*8, F*8), b (F*8,), H_rho (P,), b_rho (P,), H_xr (P, F*8)).
    If r_shift is given it replaces the residual used for b (the res_toZeroF
    FEJ shift at marginalization time)."""
    P, F = state.num_points, state.num_frames
    D = F * _D
    r = lin.r if r_shift is None else r_shift
    w = lin.w
    onehot_h = _onehot(state.host, F, r.dtype)                        # (P, F)

    Jt_w = lin.J_t * w[..., None]                                     # (P, F, 8, 8)
    Jh_w = lin.J_h * w[..., None]

    H_tt = torch.einsum("pfkd,pfke->fde", Jt_w, lin.J_t)              # (F, 8, 8)
    H_hh = torch.einsum("pde,ph->hde", torch.einsum("pfkd,pfke->pde", Jh_w, lin.J_h),
                        onehot_h)
    H_th = torch.einsum("pfde,ph->fhde", torch.einsum("pfkd,pfke->pfde", Jt_w, lin.J_h),
                        onehot_h)                                     # (F, F, 8, 8)

    b_t = torch.einsum("pfkd,pfk->fd", Jt_w, r)                       # (F, 8)
    b_h = torch.einsum("pd,ph->hd", torch.einsum("pfkd,pfk->pd", Jh_w, r), onehot_h)

    # H[f,g] += J_t^T W J_h, H[g,f] its transpose, the diagonal collects both
    # roles (same-slot residuals are masked, so nothing is counted twice)
    diag = H_tt + H_hh
    idx = torch.arange(F, device=r.device)
    H_full = H_th + H_th.permute(1, 0, 3, 2)
    H_full = H_full.clone()
    H_full[idx, idx] += diag
    b_full = (b_t + b_h).reshape(D)
    H_dense = H_full.permute(0, 2, 1, 3).reshape(D, D)

    Jr_w = lin.J_rho * w                                              # (P, F, 8)
    H_rho = torch.einsum("pfk,pfk->p", Jr_w, lin.J_rho)
    b_rho = torch.einsum("pfk,pfk->p", Jr_w, r)
    Hx_t = torch.einsum("pfkd,pfk->pfd", Jt_w, lin.J_rho)             # (P, F, 8)
    Hx_h = torch.einsum("pfkd,pfk->pd", Jh_w, lin.J_rho)              # (P, 8)
    H_xr = Hx_t.reshape(P, D) + (Hx_h[:, None, :] * onehot_h[:, :, None]).reshape(P, D)
    return H_dense, b_full, H_rho, b_rho, H_xr


def _schur_terms(H_rho, b_rho, H_xr, lam, point_valid):
    """The (diagonal) idepth block's Schur corrections with LM damping: the
    point sums to subtract from the camera system, and the damped block."""
    one = torch.ones_like(H_rho)
    H_rho_d = torch.where(point_valid, H_rho * (1.0 + lam) + 1e-10, one)
    scale = torch.where(point_valid, 1.0 / H_rho_d, torch.zeros_like(H_rho))
    H_corr = torch.einsum("pd,p,pe->de", H_xr, scale, H_xr)
    b_corr = torch.einsum("pd,p->d", H_xr, b_rho * scale)
    return H_corr, b_corr, H_rho_d


def _ab_flat(ab: torch.Tensor) -> torch.Tensor:
    """(F, 2) affine states -> (F*8,) vector with them in the a/b rows."""
    F = ab.shape[0]
    return torch.cat([torch.zeros((F, 6), dtype=ab.dtype, device=ab.device), ab],
                     dim=1).reshape(F * _D)


def _gauge_priors(state: BAState, cfg: DirectConfig):
    """Diagonal priors: affine anchoring on valid slots + an identity guard on
    invalid slots so the dense solve stays non-singular."""
    F = state.num_frames
    ab_w = const((0.0,) * 6 + (cfg.ba_prior_a, cfg.ba_prior_b), state.ab.device).repeat(F)
    fv = torch.repeat_interleave(state.frame_valid, _D)
    diag = torch.where(fv, ab_w, torch.ones_like(ab_w))
    b_prior = torch.where(fv, diag * _ab_flat(state.ab), torch.zeros_like(ab_w))
    return diag, b_prior


# ---------------------------------------------------------------------------
# Mixed-BA indirect factors
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class IndirectFactors:
    """Fixed-capacity reprojection factors injected into the photometric
    window — MOD-SLAM's mixed bundle adjustment (reference:
    DSOBundleAdjustment.h:161 addIndirectToProblem,
    DSOBundleAdjustment.cpp:2674-2700 indirect Schur solve).

    Each of Q indirect map points is idepth-parameterized in a HOST window
    slot (anchor pixel uv, inverse depth rho) and observed as a matched ORB
    corner in other slots; the 2-d reprojection residuals add to the pose
    block of the normal equations and the idepths are Schur-eliminated
    alongside the photometric ones. The factors are rebuilt from the live
    indirect map at every keyframe event and never marginalized, so their
    Jacobians use the current state (no FEJ)."""

    uv: torch.Tensor           # (Q, 2) anchor pixel in the host frame (level 0)
    host: torch.Tensor         # (Q,) int32 host window slot
    idepth: torch.Tensor       # (Q,) inverse depth in the host frame
    point_valid: torch.Tensor  # (Q,) bool
    obs_uv: torch.Tensor       # (Q, F, 2) observed corner in each target slot
    obs_valid: torch.Tensor    # (Q, F) bool
    sigma2: torch.Tensor       # (Q, F) measurement variance (px^2, per level)

    def replace(self, **kw) -> "IndirectFactors":
        return dataclasses.replace(self, **kw)

    @property
    def num_points(self) -> int:
        return self.uv.shape[0]


def empty_indirect(num_points: int, num_frames: int,
                   device: str | torch.device = "cpu") -> IndirectFactors:
    Q, F = num_points, num_frames
    f32 = dict(dtype=torch.float32, device=device)
    return IndirectFactors(
        uv=torch.zeros((Q, 2), **f32),
        host=torch.zeros((Q,), dtype=torch.int32, device=device),
        idepth=torch.ones((Q,), **f32),
        point_valid=torch.zeros((Q,), dtype=torch.bool, device=device),
        obs_uv=torch.zeros((Q, F, 2), **f32),
        obs_valid=torch.zeros((Q, F), dtype=torch.bool, device=device),
        sigma2=torch.ones((Q, F), **f32),
    )


_CHI2_2D = 5.991  # 95% chi2 with 2 dof (the reference's g2o Huber delta)


def _linearize_indirect(state: BAState, ind: IndirectFactors, cam: PinholeCamera,
                        cfg: DirectConfig):
    """(Q, F) reprojection residual sweep: r = proj(T_f T_h^-1 X_h) - obs.

    Returns r (Q, F, 2), w (Q, F) scalar robust weights (already / sigma2 and
    scaled by cfg.mixed_weight), J_t (Q, F, 2, 6), J_h (Q, F, 2, 6), J_rho
    (Q, F, 2), active (Q, F) and the robust energy (scalar)."""
    Q, F = ind.num_points, state.num_frames
    dev = ind.uv.device
    host = ind.host.long()
    rel = _pairwise_rel(state.T)
    R_qf, t_qf = rel.R[host], rel.t[host]                      # (Q, F, 3, 3)/(Q, F, 3)

    X_h = cam.unproject(ind.uv, ind.idepth)                    # (Q, 3)
    X_t = torch.einsum("qfij,qj->qfi", R_qf, X_h) + t_qf       # (Q, F, 3)
    pred, z_ok = cam.project(X_t)
    r = pred - ind.obs_uv

    J_uv_Xt = proj_jacobian(cam, X_t)                          # (Q, F, 2, 3)
    eye3 = torch.eye(3, dtype=r.dtype, device=dev)
    J_Xt_t = torch.cat([eye3.expand(Q, F, 3, 3), -skew(X_t)], dim=-1)     # (Q, F, 3, 6)
    J_Xh = torch.cat([eye3.expand(Q, 3, 3), -skew(X_h)], dim=-1)          # (Q, 3, 6)
    J_Xt_h = -torch.einsum("qfij,qjd->qfid", R_qf, J_Xh)                  # (Q, F, 3, 6)
    J_t = J_uv_Xt @ J_Xt_t                                     # (Q, F, 2, 6)
    J_h = J_uv_Xt @ J_Xt_h
    dXt_drho = -(X_t - t_qf) / torch.clamp(ind.idepth, min=1e-8)[:, None, None]
    J_rho = (J_uv_Xt @ dXt_drho[..., None])[..., 0]           # (Q, F, 2)

    fv = state.frame_valid
    not_self = host[:, None] != torch.arange(F, device=dev)[None, :]
    active = (ind.obs_valid & ind.point_valid[:, None] & fv[None, :] & fv[host][:, None]
              & not_self & z_ok & (X_t[..., 2] > 1e-4))
    chi2 = torch.sum(r * r, -1) / ind.sigma2                   # (Q, F)
    hub = torch.where(chi2 > _CHI2_2D, torch.sqrt(_CHI2_2D / torch.clamp(chi2, min=1e-12)),
                      torch.ones_like(chi2))
    zero = torch.zeros_like(chi2)
    w = torch.where(active, cfg.mixed_weight * hub / ind.sigma2, zero)
    e = torch.where(chi2 <= _CHI2_2D, chi2,
                    2.0 * torch.sqrt(_CHI2_2D * torch.clamp(chi2, min=1e-12)) - _CHI2_2D)
    energy = cfg.mixed_weight * torch.sum(torch.where(active, e, zero))
    return r, w, J_t, J_h, J_rho, active, energy


def _assemble_indirect(state: BAState, ind: IndirectFactors, cam: PinholeCamera,
                       cfg: DirectConfig):
    """Normal-equation contributions of the indirect factors: the dense
    pose-only H (F*8, F*8 — affine rows zero) and b, plus the diagonal idepth
    block and its camera coupling for the Schur complement. Returns
    (H, b, H_rho (Q,), b_rho (Q,), H_xr (Q, F*8), active, energy)."""
    Q, F = ind.num_points, state.num_frames
    D = F * _D
    r, w, J_t, J_h, J_rho, active, energy = _linearize_indirect(state, ind, cam, cfg)

    # lift the (.., 6) pose Jacobians to the 8-dof slot layout (affine cols 0)
    J_t8 = Fnn.pad(J_t, (0, 2))                                 # (Q, F, 2, 8)
    J_h8 = Fnn.pad(J_h, (0, 2))
    onehot_h = _onehot(ind.host, F, r.dtype)                    # (Q, F)
    Jt_w = J_t8 * w[..., None, None]
    Jh_w = J_h8 * w[..., None, None]

    H_tt = torch.einsum("qfud,qfue->fde", Jt_w, J_t8)
    H_hh = torch.einsum("qde,qh->hde", torch.einsum("qfud,qfue->qde", Jh_w, J_h8), onehot_h)
    H_th = torch.einsum("qfde,qh->fhde", torch.einsum("qfud,qfue->qfde", Jt_w, J_h8),
                        onehot_h)                               # (F, F, 8, 8)
    b_t = torch.einsum("qfud,qfu->fd", Jt_w, r)
    b_h = torch.einsum("qd,qh->hd", torch.einsum("qfud,qfu->qd", Jh_w, r), onehot_h)

    idx = torch.arange(F, device=r.device)
    H_full = (H_th + H_th.permute(1, 0, 3, 2)).clone()
    H_full[idx, idx] += H_tt + H_hh
    H = H_full.permute(0, 2, 1, 3).reshape(D, D)
    b = (b_t + b_h).reshape(D)

    # idepth block (diagonal over Q) and its coupling rows
    H_rho = torch.einsum("qfu,qf,qfu->q", J_rho, w, J_rho)
    b_rho = torch.einsum("qfu,qf,qfu->q", J_rho, w, r)
    Hx_t = torch.einsum("qfud,qf,qfu->qfd", J_t8, w, J_rho)   # (Q, F, 8)
    Hx_h = torch.einsum("qfud,qf,qfu->qd", J_h8, w, J_rho)    # (Q, 8)
    H_xr = Hx_t.reshape(Q, D) + (Hx_h[:, None, :] * onehot_h[:, :, None]).reshape(Q, D)
    return H, b, H_rho, b_rho, H_xr, active, energy


def indirect_energy(state: BAState, ind: IndirectFactors, cam: PinholeCamera,
                    cfg: DirectConfig) -> torch.Tensor:
    return _linearize_indirect(state, ind, cam, cfg)[-1]


def total_energy_plain(state: BAState, images: torch.Tensor, cam: PinholeCamera,
                       cfg: DirectConfig, ind: IndirectFactors | None = None,
                       mesh: Mesh | None = None) -> torch.Tensor:
    """The exact functional the solver minimizes (photometric + prior +
    affine anchors + the optional mixed-BA reprojection terms), for
    accept/reject consistency. With a mesh the photometric sum is the
    ranks' partial sums, all-reduced. The plain form of the sweep kernel's
    energy mode (total_energy dispatches)."""
    lin = linearize(local_rows(state, mesh), images, cam, cfg)
    e_photo = torch.sum(lin.energy)
    if mesh is not None:
        (e_photo,) = mesh.all_reduce(e_photo)
    delta_flat = state.delta.reshape(-1)
    e_prior = torch.dot(state.b_m, delta_flat) + 0.5 * torch.dot(
        delta_flat, state.H_m @ delta_flat)
    fv = state.frame_valid
    e_ab = 0.5 * torch.sum(torch.where(
        fv, cfg.ba_prior_a * state.ab[:, 0] ** 2 + cfg.ba_prior_b * state.ab[:, 1] ** 2,
        torch.zeros_like(state.ab[:, 0])))
    e = e_photo + e_prior + e_ab
    if ind is not None:
        e = e + indirect_energy(state, ind, cam, cfg)
    return e


def _sweep_plain(rows: BAState, images: torch.Tensor, cam: PinholeCamera, cfg: DirectConfig,
                 lam: torch.Tensor):
    """linearize + _assemble + _schur_terms over `rows`: the plain form of
    the sweep kernel's system mode. Returns (lin, {H, b, H_corr, b_corr,
    H_rho_d, b_rho, H_xr})."""
    lin = linearize(rows, images, cam, cfg)
    H, b, H_rho, b_rho, H_xr = _assemble(lin, rows, cfg)
    H_corr, b_corr, H_rho_d = _schur_terms(H_rho, b_rho, H_xr, lam, rows.point_valid)
    return lin, {"H": H, "b": b, "H_corr": H_corr, "b_corr": b_corr, "H_rho_d": H_rho_d,
                 "b_rho": b_rho, "H_xr": H_xr}


def _solve_plain(system: dict, state: BAState, cfg: DirectConfig, lam: torch.Tensor,
                 rows: BAState, extra: tuple | None = None):
    """From the reduced system (and, for the mixed BA, `extra` = the
    reprojection terms' (H, b, H_corr, b_corr)) to the step dx and the
    rows' inverse-depth steps: the plain form of the solve kernel (the
    state update is ba_step_plain's)."""
    D = state.num_frames * _D
    H, b = system["H"], system["b"]
    if extra is not None:
        H = H + extra[0]
        b = b + extra[1]

    # marginalization prior (gradient at current state: b_m + H_m delta)
    delta_flat = state.delta.reshape(-1)
    H = H + state.H_m
    b = b + state.b_m + state.H_m @ delta_flat

    diag_prior, b_prior = _gauge_priors(state, cfg)
    H = H + torch.diag(diag_prior)
    b = b + b_prior

    H_sc, b_sc = H - system["H_corr"], b - system["b_corr"]
    if extra is not None:
        H_sc, b_sc = H_sc - extra[2], b_sc - extra[3]
    eye = torch.eye(D, dtype=H.dtype, device=H.device)
    H_sc = H_sc + lam * torch.diag(torch.diag(H_sc)) + 1e-6 * eye
    dx, _ = torch.linalg.solve_ex(H_sc, b_sc)

    # project the SCALE gauge mode out of the step (reference: orthogonalize
    # after solving, DSOBundleAdjustment.h:149); translation/rotation stay
    # pinned by the first-frame anchor and its marginalized descendant
    N = _nullspaces(state)[:, 6:7]                                     # (D, 1)
    NtN = N.T @ N + 1e-6 * torch.eye(1, dtype=dx.dtype, device=dx.device)
    coeff, _ = torch.linalg.solve_ex(NtN, N.T @ dx)
    dx = dx - N @ coeff

    d_rho = (system["b_rho"] - system["H_xr"] @ dx) / system["H_rho_d"]
    d_rho = torch.where(rows.point_valid, d_rho, torch.zeros_like(d_rho))
    return dx, d_rho


def _indirect_terms(state: BAState, ind: IndirectFactors, cam: PinholeCamera,
                    cfg: DirectConfig, lam: torch.Tensor):
    """The mixed BA's reprojection terms of an LM step: the additive (H, b)
    and the Schur pair (H_corr, b_corr) of the camera system, and (b_rho,
    H_xr, H_rho_d) for the inverse-depth steps of the indirect points."""
    Hi, bi, Hi_rho, bi_rho, Hi_xr, _, _ = _assemble_indirect(state, ind, cam, cfg)
    Hi_corr, bi_corr, Hi_rho_d = _schur_terms(Hi_rho, bi_rho, Hi_xr, lam, ind.point_valid)
    return (Hi, bi, Hi_corr, bi_corr), (bi_rho, Hi_xr, Hi_rho_d)


def _indirect_idepth(ind: IndirectFactors, back: tuple, dx: torch.Tensor,
                     cfg: DirectConfig) -> torch.Tensor:
    """The indirect points' inverse depths after the step dx."""
    bi_rho, Hi_xr, Hi_rho_d = back
    d_rho = (bi_rho - Hi_xr @ dx) / Hi_rho_d
    d_rho = torch.where(ind.point_valid, d_rho, torch.zeros_like(d_rho))
    return torch.clamp(ind.idepth - d_rho, cfg.idepth_min, cfg.idepth_max)


def ba_step_plain(state: BAState, images: torch.Tensor, cam: PinholeCamera,
                  cfg: DirectConfig, lam: torch.Tensor, ind: IndirectFactors | None = None,
                  mesh: Mesh | None = None):
    """One LM iteration: linearize, Schur-solve, back-substitute idepths
    (the plain form of the sweep and solve kernels; ba_step dispatches).
    With `ind`, the mixed-BA reprojection factors join the normal equations
    and their idepths are Schur-eliminated alongside the photometric ones.
    With a mesh, this rank's point rows only; one all-reduce of the point
    sums, one all-gather of the idepth steps (`lin` holds this rank's rows).
    Returns (new_state, lin), or (new_state, new_ind, lin) with `ind`."""
    F = state.num_frames
    rows = local_rows(state, mesh)
    lin, system = _sweep_plain(rows, images, cam, cfg, lam)
    if mesh is not None:
        red = mesh.all_reduce(*(system[k] for k in ("H", "b", "H_corr", "b_corr")))
        system.update(zip(("H", "b", "H_corr", "b_corr"), red))
    # the terms every rank holds whole join after the reduction (once)
    extra, back = (None, None) if ind is None else _indirect_terms(state, ind, cam, cfg, lam)
    dx, d_rho = _solve_plain(system, state, cfg, lam, rows, extra)
    if mesh is not None:
        d_rho = mesh.all_gather_rows(d_rho)

    dx_f = dx.reshape(F, _D)
    dx_f = torch.where(state.frame_valid[:, None], dx_f, torch.zeros_like(dx_f))
    T_new = se3_exp(-dx_f[:, :6]).compose(state.T)
    new_state = state.replace(
        T=se3_select(state.frame_valid, T_new, state.T),
        ab=state.ab - dx_f[:, 6:],
        delta=state.delta - dx_f,
        idepth=torch.clamp(state.idepth - d_rho, cfg.idepth_min, cfg.idepth_max),
    )
    if ind is None:
        return new_state, lin
    return new_state, ind.replace(idepth=_indirect_idepth(ind, back, dx, cfg)), lin


def _select_state(accept: torch.Tensor, a: BAState, b: BAState) -> BAState:
    """where(accept, a, b) over every leaf of a BAState."""
    out = {}
    for f in dataclasses.fields(BAState):
        x, y = getattr(a, f.name), getattr(b, f.name)
        out[f.name] = (se3_select(accept, x, y) if isinstance(x, SE3)
                       else torch.where(accept, x, y))
    return BAState(**out)


def run_ba_plain(state: BAState, images: torch.Tensor, cam: PinholeCamera,
                 cfg: DirectConfig, mesh: Mesh | None = None,
                 trace: list | None = None) -> tuple[BAState, torch.Tensor]:
    """Fixed-iteration LM loop with accept/reject (reference:
    DSOBundleAdjustment::run, energy-based step control). The accept test
    stays on the device: no host read per iteration. With a mesh, every
    rank runs it on the same state and ends with the same state. The plain
    form of the BA kernels' loop (run_ba dispatches). With `trace`, each
    step appends its (E, E_new) as a (2,) tensor."""
    E = total_energy_plain(state, images, cam, cfg, mesh=mesh)
    lam = torch.full((), cfg.ba_lambda_init, dtype=torch.float32, device=E.device)
    for _ in range(cfg.ba_iters):
        cand, _ = ba_step_plain(state, images, cam, cfg, lam, mesh=mesh)
        E_new = total_energy_plain(cand, images, cam, cfg, mesh=mesh)
        if trace is not None:
            trace.append(torch.stack([E, E_new]))
        accept = E_new < E
        state = _select_state(accept, cand, state)
        E = torch.where(accept, E_new, E)
        lam = torch.where(accept, torch.clamp(lam * 0.4, min=1e-7),
                          torch.clamp(lam * 5.0, max=1e2))
    return state, E


def run_ba_mixed_plain(state: BAState, images: torch.Tensor, cam: PinholeCamera,
                       cfg: DirectConfig, ind: IndirectFactors, mesh: Mesh | None = None,
                       trace: list | None = None,
                       ) -> tuple[BAState, IndirectFactors, torch.Tensor]:
    """Joint photometric + indirect-reprojection LM over the window — the
    mixed bundle adjustment (reference: DSOBundleAdjustment.cpp:2674
    addIndirectToProblem + joint Schur solve). run_ba's accept/reject loop
    with the reprojection terms in the normal equations and the energy; the
    indirect idepths ride along. With a mesh only the photometric points are
    split: every rank holds and sweeps the indirect factors whole. The plain
    form (run_ba_mixed dispatches). With `trace`, as run_ba_plain's."""
    E = total_energy_plain(state, images, cam, cfg, ind, mesh=mesh)
    lam = torch.full((), cfg.ba_lambda_init, dtype=torch.float32, device=E.device)
    for _ in range(cfg.ba_iters):
        cand, cand_i, _ = ba_step_plain(state, images, cam, cfg, lam, ind, mesh=mesh)
        E_new = total_energy_plain(cand, images, cam, cfg, cand_i, mesh=mesh)
        if trace is not None:
            trace.append(torch.stack([E, E_new]))
        accept = E_new < E
        state = _select_state(accept, cand, state)
        ind = ind.replace(idepth=torch.where(accept, cand_i.idepth, ind.idepth))
        E = torch.where(accept, E_new, E)
        lam = torch.where(accept, torch.clamp(lam * 0.4, min=1e-7),
                          torch.clamp(lam * 5.0, max=1e2))
    return state, ind, E


def relinearize(state: BAState) -> BAState:
    """Move the linearization point to the CURRENT state, shifting the
    marginalization prior's expansion point along (exact for a quadratic:
    b' = b + H delta, H unchanged). Called once per keyframe event."""
    delta_flat = state.delta.reshape(-1)
    return state.replace(
        b_m=state.b_m + state.H_m @ delta_flat,
        delta=torch.zeros_like(state.delta),
        T_fej=state.T,
        ab_fej=state.ab,
        idepth_fej=state.idepth,
    )


def refresh_fej(state: BAState) -> BAState:
    """Re-anchor the linearization point at the CURRENT state (only valid
    while the prior holds no off-diagonal marginalization information)."""
    return state.replace(
        T_fej=state.T,
        ab_fej=state.ab,
        idepth_fej=state.idepth,
        delta=torch.zeros_like(state.delta),
    )


# ---------------------------------------------------------------------------
# Outlier management
# ---------------------------------------------------------------------------


def update_residual_status_plain(state: BAState, images: torch.Tensor,
                                 cam: PinholeCamera, cfg: DirectConfig,
                                 mesh: Mesh | None = None) -> BAState:
    """Deactivate residuals whose energy exceeds the outlier threshold and
    points left with no active residual at all. With a mesh each rank
    decides its rows and the rows are all-gathered. The plain form of the
    sweep kernel's status mode (update_residual_status dispatches)."""
    rows = local_rows(state, mesh)
    lin = linearize(rows, images, cam, cfg)
    good = lin.active & (lin.energy < cfg.outlier_energy)
    res_active = rows.res_active & (good | ~lin.active)
    n_good = torch.sum(good, dim=1)
    point_valid = rows.point_valid & (n_good >= 1)
    if mesh is not None:
        both = mesh.all_gather_rows(torch.cat([res_active, point_valid[:, None]], dim=1))
        res_active, point_valid = both[:, :-1], both[:, -1]
    return state.replace(res_active=res_active, point_valid=point_valid)


# ---------------------------------------------------------------------------
# Marginalization
# ---------------------------------------------------------------------------


def _psd_project(H: torch.Tensor) -> torch.Tensor:
    """Project a (nearly) symmetric matrix onto the PSD cone (f32 Schur
    complements leave small negative eigenvalues, and an indefinite
    quadratic prior is unbounded below)."""
    H = 0.5 * (H + H.T)
    w, V = torch.linalg.eigh(H)
    w = torch.clamp(w, min=0.0)
    return (V * w[None, :]) @ V.T


def _psd_project_with_gradient(H: torch.Tensor, b: torch.Tensor,
                               rel_floor: float = 1e-7):
    """PSD-project H AND restrict b to the numerically significant range of
    H (a Gaussian marginal's gradient lies in the range of its Hessian)."""
    H = 0.5 * (H + H.T)
    w, V = torch.linalg.eigh(H)
    w = torch.clamp(w, min=0.0)
    keep = w > rel_floor * torch.max(w)
    zero = torch.zeros_like(w)
    H_out = (V * torch.where(keep, w, zero)[None, :]) @ V.T
    b_out = V @ torch.where(keep, V.T @ b, zero)
    return H_out, b_out


def _nullspaces(state: BAState) -> torch.Tensor:
    """(F*8, 7) global gauge directions: world translation (3), world
    rotation (3), scale (1) — reference: computeNullspaces."""
    F = state.num_frames
    R, t = state.T.R, state.T.t
    fv = state.frame_valid[:, None, None].to(R.dtype)
    N = torch.zeros((F, _D, 7), dtype=torch.float32, device=R.device)
    N[:, 0:3, 0:3] = R * fv
    N[:, 0:3, 3:6] = (skew(t) @ R) * fv
    N[:, 3:6, 3:6] = R * fv
    N[:, 0:3, 6] = t * fv[..., 0]
    return N.reshape(F * _D, 7)


def orthogonalize_gradient(state: BAState, b: torch.Tensor) -> torch.Tensor:
    """Project the gauge directions out of a gradient vector (reference:
    orthogonalize, DSOBundleAdjustment.h:149)."""
    N = _nullspaces(state)
    NtN = N.T @ N + 1e-6 * torch.eye(7, dtype=b.dtype, device=b.device)
    coeff, _ = torch.linalg.solve_ex(NtN, N.T @ b)
    return b - N @ coeff


def _fej_shifted(state: BAState, images, cam, cfg, slot):
    """Linearize the points hosted in `slot` and FEJ-shift their residuals
    (res_toZeroF): r0 = r - J_t dx_t - J_h dx_h - J_rho d_rho."""
    hosted = state.point_valid & (state.host == slot)
    marg_state = state.replace(point_valid=hosted)
    lin = linearize(marg_state, images, cam, cfg)
    d_t = state.delta[None, :, None, :]                                # (1,F,1,8)
    d_h = state.delta[state.host.long()][:, None, None, :]             # (P,1,1,8)
    d_rho = (state.idepth - state.idepth_fej)[:, None, None]
    r0 = (lin.r - torch.sum(lin.J_t * d_t, dim=-1)
          - torch.sum(lin.J_h * d_h, dim=-1) - lin.J_rho * d_rho)
    return hosted, marg_state, lin, r0


def marginalize_frame(
    state: BAState,
    images: torch.Tensor,
    cam: PinholeCamera,
    cfg: DirectConfig,
    slot,
    exact: bool = False,
) -> BAState:
    """Marginalize the keyframe in `slot` in f32 on the device:
      1. fold the FEJ-shifted residuals of points hosted there into the
         prior (Schur over their idepths),
      2. drop those points + all residuals targeting the slot,
      3. Schur-eliminate the slot's 8 dof from (H_m, b_m),
      4. orthogonalize the prior gradient against the gauge nullspace."""
    F = state.num_frames
    D = F * _D
    dev = state.uv.device

    hosted, marg_state, lin, r0 = _fej_shifted(state, images, cam, cfg, slot)
    H_pts, b_pts, H_rho, b_rho, H_xr = _assemble(lin, marg_state, cfg, r_shift=r0)
    H_rho_d = torch.where(hosted, H_rho + 1e-8, torch.ones_like(H_rho))
    scale = torch.where(hosted, 1.0 / H_rho_d, torch.zeros_like(H_rho))
    H_add = H_pts - torch.einsum("pd,p,pe->de", H_xr, scale, H_xr)
    b_add = b_pts - torch.einsum("pd,p->d", H_xr, b_rho * scale)

    mw = cfg.marg_weight
    H_m = state.H_m + mw * _psd_project(H_add)
    b_m = state.b_m + mw * b_add

    ar_F = torch.arange(F, device=dev)
    point_valid = state.point_valid & ~hosted
    res_active = state.res_active & (ar_F[None, :] != slot)

    sel = (torch.arange(D, device=dev) // _D) == slot
    aff_w = const((0.0,) * 6 + (cfg.ba_prior_a, cfg.ba_prior_b), dev).repeat(F)
    zero_D = torch.zeros(D, dtype=torch.float32, device=dev)
    H_m = H_m + torch.diag(torch.where(sel, aff_w, zero_D))
    b_m = b_m + torch.where(sel, aff_w * _ab_flat(state.ab_fej), zero_D)

    delta_flat = state.delta.reshape(-1) * sel
    b_m = b_m + H_m @ delta_flat

    self_f = sel.to(torch.float32)
    keep_f = (~sel).to(torch.float32)
    Hmm = H_m * self_f[:, None] * self_f[None, :]
    Hmm_block = Hmm + torch.diag(torch.where(sel, zero_D + 1e-6, zero_D + 1.0))
    H_am = H_m * keep_f[:, None] * self_f[None, :]
    Hmm_inv = torch.linalg.inv_ex(Hmm_block)[0] * self_f[:, None] * self_f[None, :]
    H_m_new = H_m * keep_f[:, None] * keep_f[None, :] - H_am @ Hmm_inv @ H_am.T
    b_m_new = b_m * keep_f - H_am @ (Hmm_inv @ (b_m * self_f))

    state = state.replace(
        point_valid=point_valid,
        res_active=res_active,
        frame_valid=state.frame_valid & (ar_F != slot),
        H_m=H_m_new,
        b_m=b_m_new,
        delta=torch.where((ar_F == slot)[:, None], torch.zeros_like(state.delta),
                          state.delta),
    )
    if exact:
        return state
    b_m_new = orthogonalize_gradient(state, state.b_m)
    H_m_fix, b_m_fix = _psd_project_with_gradient(state.H_m, b_m_new)
    return state.replace(H_m=H_m_fix, b_m=b_m_fix)


def _marg_pieces_plain(state: BAState, images: torch.Tensor, cam: PinholeCamera,
                       cfg: DirectConfig, slot, mesh: Mesh | None = None):
    """Device half of f64 marginalization: linearize the points hosted in
    `slot`, FEJ-shift the residuals, and contract the (P, F, 8, ...) tensors
    down to the small normal-equation pieces. The point-Schur CORRECTION is
    contracted here, but the cancellation-sensitive subtraction
    H_pts - H_corr (both ~1e10, their difference along the scale direction
    ~1e6) is left to the host in f64. With a mesh each rank contracts its
    rows and the four point sums are all-reduced. The plain form of the
    sweep kernel's marg mode (_marg_pieces dispatches)."""
    hosted, marg_state, lin, r0 = _fej_shifted(local_rows(state, mesh), images, cam, cfg,
                                               slot)
    H_pts, b_pts, H_rho, b_rho, H_xr = _assemble(lin, marg_state, cfg, r_shift=r0)
    scale = torch.where(hosted, 1.0 / (H_rho + 1e-12), torch.zeros_like(H_rho))
    H_corr = torch.einsum("pd,p,pe->de", H_xr, scale, H_xr)
    b_corr = H_xr.T @ (b_rho * scale)
    if mesh is not None:
        H_pts, b_pts, H_corr, b_corr = mesh.all_reduce(H_pts, b_pts, H_corr, b_corr)
        hosted = state.point_valid & (state.host == slot)
    return (H_pts, b_pts, H_corr, b_corr, hosted,
            state.T.R, state.T.t, state.frame_valid, state.delta,
            state.ab_fej, state.H_m, state.b_m)


def marginalize_frame_f64(state: BAState, images: torch.Tensor,
                          cam: PinholeCamera, cfg: DirectConfig, slot: int) -> BAState:
    """Frame marginalization with the prior algebra in HOST float64 (the
    reference runs this math in double, types.h:365: photometric Hessians
    reach ~1e10 and the f32 Schur cancellation noise swamps the weak scale
    direction). Synchronous form of the runtime's asynchronous
    dispatch-pieces / host-Schur / apply sequence."""
    slot = int(slot)
    pieces = _marg_pieces(state, images, cam, cfg, slot)
    packed, hosted = marg_host_schur(pieces, slot, cfg)
    return _marg_apply(state, torch.as_tensor(packed).to(state.uv.device), hosted, slot)


def marg_host_schur(pieces_dev, slot: int, cfg: DirectConfig):
    """Host f64 half of marginalization: consume the device pieces, run the
    Schur/nullspace/PSD algebra in numpy float64, return (packed
    [H_new; b_new] float32 ndarray, device-resident hosted mask)."""
    hosted_dev = pieces_dev[4]
    (H_pts, b_pts, H_corr, b_corr,
     T_R, T_t, fv, delta, ab_fej, H_m_f32, b_m_f32) = (
        x.cpu().numpy() for x in pieces_dev[:4] + pieces_dev[5:])
    D = H_m_f32.shape[0]
    F = D // _D
    H_pts, b_pts, H_corr, b_corr = (
        np.asarray(x, np.float64) for x in (H_pts, b_pts, H_corr, b_corr))
    H_add = H_pts - H_corr
    b_add = b_pts - b_corr
    delta = np.asarray(delta, np.float64)
    ab_fej = np.asarray(ab_fej, np.float64)

    mw = cfg.marg_weight
    H_m = np.asarray(H_m_f32, np.float64) + mw * H_add
    b_m = np.asarray(b_m_f32, np.float64) + mw * b_add

    # fold the slot's affine anchors (see marginalize_frame)
    H_m[slot * _D + 6, slot * _D + 6] += cfg.ba_prior_a
    H_m[slot * _D + 7, slot * _D + 7] += cfg.ba_prior_b
    b_m[slot * _D + 6] += cfg.ba_prior_a * ab_fej[slot, 0]
    b_m[slot * _D + 7] += cfg.ba_prior_b * ab_fej[slot, 1]

    # fold the slot's delta, then Schur its 8 dofs
    sel = np.zeros(D, bool)
    sel[slot * _D : slot * _D + _D] = True
    b_m = b_m + H_m @ (delta.reshape(-1) * sel)
    keep = ~sel
    Hmm = H_m[np.ix_(sel, sel)]
    Hkm = H_m[np.ix_(keep, sel)]
    Hmm_inv = np.linalg.inv(Hmm + 1e-10 * np.eye(_D))
    H_new = np.zeros((D, D))
    b_new = np.zeros(D)
    H_new[np.ix_(keep, keep)] = H_m[np.ix_(keep, keep)] - Hkm @ Hmm_inv @ Hkm.T
    b_new[keep] = b_m[keep] - Hkm @ (Hmm_inv @ b_m[sel])
    H_new = 0.5 * (H_new + H_new.T)

    # gauge-orthogonalize b against the post-drop nullspaces + PSD floor
    R_np = np.asarray(T_R, np.float64)
    t_np = np.asarray(T_t, np.float64)
    fv_np = np.asarray(fv).copy()
    fv_np[slot] = False
    Nmat = np.zeros((F, _D, 7))
    for f in range(F):
        if not fv_np[f]:
            continue
        Nmat[f, 0:3, 0:3] = R_np[f]
        Nmat[f, 0:3, 3:6] = _skew_np(t_np[f]) @ R_np[f]
        Nmat[f, 3:6, 3:6] = R_np[f]
        Nmat[f, 0:3, 6] = t_np[f]
    N = Nmat.reshape(D, 7)
    coeff = np.linalg.solve(N.T @ N + 1e-9 * np.eye(7), N.T @ b_new)
    b_new = b_new - N @ coeff
    ew, V = np.linalg.eigh(H_new)
    ew = np.maximum(ew, 0.0)
    H_new = (V * ew[None, :]) @ V.T

    packed = np.concatenate([H_new, b_new[None, :]], axis=0).astype(np.float32)
    return packed, hosted_dev


def _skew_np(v: np.ndarray) -> np.ndarray:
    return np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])


def _marg_apply(state: BAState, packed: torch.Tensor, hosted: torch.Tensor,
                slot) -> BAState:
    """Apply the marginalization's state mutations: drop hosted points +
    residuals targeting the slot, invalidate the frame, zero its delta,
    install the new prior. `packed` is the (D+1, D) [H_new; b_new]."""
    F = state.num_frames
    ar_F = torch.arange(F, device=state.uv.device)
    return state.replace(
        point_valid=state.point_valid & ~hosted,
        res_active=state.res_active & (ar_F[None, :] != slot),
        frame_valid=state.frame_valid & (ar_F != slot),
        delta=torch.where((ar_F == slot)[:, None], torch.zeros_like(state.delta),
                          state.delta),
        H_m=packed[:-1],
        b_m=packed[-1],
    )


# ---------------------------------------------------------------------------
# The public entry points: the BA kernels for CUDA tensors, the plain forms
# for CPU tensors
# ---------------------------------------------------------------------------


def _on_card(state: BAState) -> bool:
    """True for a state on a CUDA device (the kernels), False on the CPU (the
    plain forms); any other device raises."""
    kind = state.uv.device.type
    if kind not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {state.uv.device}")
    return kind == "cuda"


def _contiguous(state: BAState) -> BAState:
    """The state with every tensor contiguous (the same tensors when they
    already are, as the runtime's always are)."""
    out = {}
    for f in dataclasses.fields(BAState):
        x = getattr(state, f.name)
        out[f.name] = (SE3(R=x.R.contiguous(), t=x.t.contiguous()) if isinstance(x, SE3)
                       else x.contiguous())
    return BAState(**out)


def _contiguous_ind(ind: IndirectFactors | None) -> IndirectFactors | None:
    """The factors with every tensor contiguous (the same tensors when they
    already are, as the runtime's always are)."""
    if ind is None:
        return None
    return IndirectFactors(**{f.name: getattr(ind, f.name).contiguous()
                              for f in dataclasses.fields(IndirectFactors)})


def _energy_cuda(state: BAState, images, cam, cfg, mesh, finish: bk.Finish | None, ind=None):
    """An energy sweep over this rank's rows (and the factors `ind`, whole),
    then `finish`: in the sweep's launch without a mesh, after the
    all-reduce of the photometric sum with one (the reprojection energy
    added last, not reduced). Returns the photometric energy (reduced)."""
    rows = local_rows(state, mesh)
    if mesh is None:
        return bk.ba_sweep_cuda(rows, images, cam, cfg, "energy", finish=finish,
                                ind=ind)["e_photo"]
    out = bk.ba_sweep_cuda(rows, images, cam, cfg, "energy", ind=ind)
    (e_photo,) = mesh.all_reduce(out["e_photo"])
    if finish is not None:
        finish.e_extra = out.get("e_ind")
        bk.ba_finish_cuda(e_photo, state, cfg, finish)
    return e_photo


def _step_cuda(src: BAState, images, cam, cfg, lam, mesh, ind=None):
    """ba_step on the card: the system sweep over this rank's rows (its
    Schur-complemented H and b all-reduced with a mesh), then the solve. With `ind`, the
    same sweep also sweeps the mixed BA's reprojection factors (whole, on
    every rank), whose additive system and second Schur pair enter the solve
    after the all-reduce, and the solve back-substitutes their inverse
    depths. Returns the candidate state and, with `ind`, the candidate
    inverse depths of the factor points."""
    rows = local_rows(src, mesh)
    system = bk.ba_sweep_cuda(rows, images, cam, cfg, "system", lam=lam, ind=ind)
    if mesh is not None:
        system.update(zip(("H", "b"), mesh.all_reduce(system["H"], system["b"])))
    cand = bk.ba_solve_cuda(system, src, cfg, lam, rows, mesh=mesh is not None, ind=ind)
    if mesh is None:
        idepth = cand["idepth"]
    else:
        d_rho = mesh.all_gather_rows(cand["d_rho"])
        idepth = torch.clamp(src.idepth - d_rho, cfg.idepth_min, cfg.idepth_max)
    new = src.replace(T=SE3(R=cand["R"], t=cand["t"]), ab=cand["ab"], delta=cand["delta"],
                      idepth=idepth)
    if ind is None:
        return new, None
    return new, cand.get("ind_idepth", ind.idepth)


def _run_ba_cuda(state: BAState, images, cam, cfg, mesh, ind=None,
                 trace: torch.Tensor | None = None):
    """run_ba (run_ba_mixed with `ind`) on the card, with no host read.
    Without a mesh, one launch of the run kernel. With one, split launches
    of the same device functions in the same orders (the same bits): the
    energy sweep at the start (which also sets lambda), then each LM step's
    system sweep, solve and energy sweep of the candidate, and the sweep
    kernel's FINISH launch after the all-reduce of the photometric energy:
    the accept test, lambda's update and the select into the result's
    buffers. The factors `ind` ride in the same launches, whole on every
    rank. With `trace` (a (ba_iters, 2) float32 tensor on the card), each
    step's (E, E_new). Returns (state, E) or (state, indirect inverse
    depths, E)."""
    state = _contiguous(state)
    images = images.contiguous()
    ind = _contiguous_ind(ind)
    if mesh is None:
        out = bk.ba_run_cuda(state, images, cam, cfg, trace=trace, ind=ind)
        new = state.replace(T=SE3(R=out["R"], t=out["t"]), ab=out["ab"], delta=out["delta"],
                            idepth=out["idepth"])
        return (new, out["E"]) if ind is None else (new, out["idepth_i"], out["E"])
    dev = state.uv.device
    f32 = dict(dtype=torch.float32, device=dev)
    E, lam = torch.empty((), **f32), torch.empty((), **f32)
    _energy_cuda(state, images, cam, cfg, mesh,
                 bk.Finish("energy", E=E, lam=lam, init_lam=True), ind)
    src, src_i = state, None if ind is None else ind.idepth
    F, P = state.num_frames, state.num_points
    dst = {"R": torch.empty((F, 3, 3), **f32), "t": torch.empty((F, 3), **f32),
           "ab": torch.empty((F, 2), **f32), "delta": torch.empty((F, _D), **f32),
           "idepth": torch.empty((P,), **f32)}
    dst_i = None if ind is None else torch.empty_like(src_i)
    for it in range(cfg.ba_iters):
        cur_i = None if ind is None else ind.replace(idepth=src_i)
        cand, cand_i = _step_cuda(src, images, cam, cfg, lam, mesh, cur_i)
        fin = bk.Finish("accept", E=E, lam=lam, src=src, cand_idepth=cand.idepth, dst=dst,
                        trace=None if trace is None else trace[it],
                        extra=None if ind is None else (src_i, cand_i, dst_i))
        _energy_cuda(cand, images, cam, cfg, mesh, fin,
                     None if ind is None else ind.replace(idepth=cand_i))
        src = state.replace(T=SE3(R=dst["R"], t=dst["t"]), ab=dst["ab"], delta=dst["delta"],
                            idepth=dst["idepth"])
        src_i = dst_i
    if ind is None:
        return src, E
    return src, src_i, E


def total_energy(state: BAState, images: torch.Tensor, cam: PinholeCamera,
                 cfg: DirectConfig, ind: IndirectFactors | None = None,
                 mesh: Mesh | None = None) -> torch.Tensor:
    """total_energy_plain's functional: one energy sweep kernel (its last
    block adds the prior and affine terms, and the reprojection energy of
    `ind`, swept in the same launch) for CUDA tensors, the plain form for
    CPU tensors."""
    if not _on_card(state):
        return total_energy_plain(state, images, cam, cfg, ind, mesh)
    state = _contiguous(state)
    E = torch.empty((), dtype=torch.float32, device=state.uv.device)
    _energy_cuda(state, images.contiguous(), cam, cfg, mesh, bk.Finish("energy", E=E),
                 _contiguous_ind(ind))
    return E


def ba_step(state: BAState, images: torch.Tensor, cam: PinholeCamera,
            cfg: DirectConfig, lam: torch.Tensor, ind: IndirectFactors | None = None,
            mesh: Mesh | None = None):
    """One LM iteration (ba_step_plain's): the system sweep and the solve
    kernel for CUDA tensors (`lam` a 0-d float32 tensor on the card), the
    plain form for CPU tensors. On the card the Jacobians are never formed,
    so the third value (the Linearization) is None."""
    if not _on_card(state):
        return ba_step_plain(state, images, cam, cfg, lam, ind, mesh)
    lam = torch.as_tensor(lam, dtype=torch.float32, device=state.uv.device).reshape(())
    ind = _contiguous_ind(ind)
    new, cand_i = _step_cuda(_contiguous(state), images.contiguous(), cam, cfg, lam, mesh, ind)
    if ind is None:
        return new, None
    return new, ind.replace(idepth=cand_i), None


def run_ba(state: BAState, images: torch.Tensor, cam: PinholeCamera,
           cfg: DirectConfig, mesh: Mesh | None = None) -> tuple[BAState, torch.Tensor]:
    """run_ba_plain's LM loop: on the card the BA kernels with no host read
    (one launch without a mesh; with one, 2 + 3 x ba_iters sweep launches
    and ba_iters solves), on the CPU the plain form."""
    if not _on_card(state):
        return run_ba_plain(state, images, cam, cfg, mesh)
    return _run_ba_cuda(state, images, cam, cfg, mesh)


def run_ba_mixed(state: BAState, images: torch.Tensor, cam: PinholeCamera, cfg: DirectConfig,
                 ind: IndirectFactors, mesh: Mesh | None = None,
                 ) -> tuple[BAState, IndirectFactors, torch.Tensor]:
    """run_ba_mixed_plain's joint LM loop: on the card the BA kernels with
    no host read (one launch of the run kernel, the reprojection terms
    inside it; with a mesh the split route, 2 + 3 x ba_iters sweep launches
    and ba_iters solves), on the CPU the plain form."""
    if not _on_card(state):
        return run_ba_mixed_plain(state, images, cam, cfg, ind, mesh)
    new, idepth_i, E = _run_ba_cuda(state, images, cam, cfg, mesh, ind)
    return new, ind.replace(idepth=idepth_i), E


def update_residual_status(state: BAState, images: torch.Tensor,
                           cam: PinholeCamera, cfg: DirectConfig,
                           mesh: Mesh | None = None) -> BAState:
    """update_residual_status_plain's masks: the sweep kernel's status mode
    for CUDA tensors, the plain form for CPU tensors."""
    if not _on_card(state):
        return update_residual_status_plain(state, images, cam, cfg, mesh)
    state = _contiguous(state)
    out = bk.ba_sweep_cuda(local_rows(state, mesh), images.contiguous(), cam, cfg, "status")
    res_active, point_valid = out["res_active"], out["point_valid"]
    if mesh is not None:
        both = mesh.all_gather_rows(torch.cat([res_active, point_valid[:, None]], dim=1))
        res_active, point_valid = both[:, :-1], both[:, -1]
    return state.replace(res_active=res_active, point_valid=point_valid)


def _marg_pieces(state: BAState, images: torch.Tensor, cam: PinholeCamera,
                 cfg: DirectConfig, slot, mesh: Mesh | None = None):
    """_marg_pieces_plain's pieces: the sweep kernel's marg mode for CUDA
    tensors (`slot` an int or a 0-d device tensor, never read on the
    host), the plain form for CPU tensors."""
    if not _on_card(state):
        return _marg_pieces_plain(state, images, cam, cfg, slot, mesh)
    state = _contiguous(state)
    out = bk.ba_sweep_cuda(local_rows(state, mesh), images.contiguous(), cam, cfg, "marg",
                           slot=slot)
    pieces = tuple(out[k] for k in ("H", "b", "H_corr", "b_corr"))
    if mesh is not None:
        pieces = mesh.all_reduce(*pieces)
    hosted = state.point_valid & (state.host == slot)
    return (*pieces, hosted, state.T.R, state.T.t, state.frame_valid, state.delta,
            state.ab_fej, state.H_m, state.b_m)
