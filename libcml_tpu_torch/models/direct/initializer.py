"""Two-frame direct bootstrap (monocular initialization).

PyTorch port of libcml_tpu/models/direct/initializer.py (the reference's
DSOInitializer, src/cml/optimization/dso/DSOInitializer.cpp:7 setFirst,
:111/117 tryInitialize, DSOInitializer.h:98 calcResAndGS). One point set
selected at level 0 and reused at every pyramid level; joint state
[xi(6), a, b] + per-point idepth, the (diagonal) idepth block
Schur-complemented; DSO's alpha scale anchoring until the translation is
observable ("snapped"), neighbour coupling after.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from libcml_tpu_torch._device import const
from libcml_tpu_torch.core.camera import PinholeCamera
from libcml_tpu_torch.core.lie import SE3, se3_exp, se3_select
from libcml_tpu_torch.models.direct.config import DirectConfig
from libcml_tpu_torch.models.direct.residuals import (
    evaluate_residuals,
    idepth_jacobian,
    pattern_uv,
    rel_pose_jacobian,
)
from libcml_tpu_torch.models.direct.selector import select_points
from libcml_tpu_torch.ops.image import bilinear

_NEIGHBORS = 8


@dataclasses.dataclass
class InitializerState:
    """First-frame data + current estimates, all static shapes."""

    uv: torch.Tensor        # (P, 2) level-0 pixels in the first frame
    color: torch.Tensor     # (L, P, 8) host pattern intensities per level
    weight: torch.Tensor    # (L, P, 8) gradient weights per level
    valid: torch.Tensor     # (L, P)
    nbr: torch.Tensor       # (P, K) neighbor indices (host-computed k-NN)
    idepth: torch.Tensor    # (P,) current inverse-depth estimate
    T: SE3                  # current relative pose cur <- first
    ab: torch.Tensor        # (2,) current relative affine
    snapped: torch.Tensor   # bool: translation has become observable
    snapped_age: torch.Tensor  # int: consecutive snapped frames

    def replace(self, **kw) -> "InitializerState":
        return dataclasses.replace(self, **kw)


def set_first(
    grad_pyr: tuple[torch.Tensor, ...],
    cam0: PinholeCamera,
    cfg: DirectConfig,
    prior_idepth: torch.Tensor | None = None,
) -> InitializerState:
    """Select points on the first frame and build the initializer state.
    The optional `prior_idepth` is a dense (H, W) inverse-depth map; point
    idepths are seeded from it when given, else at 1.0."""
    dev = grad_pyr[0].device
    uv, valid0, _ = select_points(grad_pyr[0], cfg.init_points)

    colors, weights, valids = [], [], []
    for l, G in enumerate(grad_pyr):
        cam_l = cam0.level(l)
        s = 0.5**l
        uv_l = (uv + 0.5) * s - 0.5
        sample = bilinear(G, pattern_uv(uv_l))
        color = sample[..., 0]
        gsq = sample[..., 1] ** 2 + sample[..., 2] ** 2
        w = torch.sqrt(cfg.gradient_weight_c2 / (cfg.gradient_weight_c2 + gsq))
        colors.append(color)
        weights.append(w)
        valids.append(valid0 & cam_l.in_bounds(uv_l, border=3.0))

    # k-NN over pixel coords (small P — exact, host-side once)
    uv_np = uv.cpu().numpy()
    d2 = ((uv_np[:, None, :] - uv_np[None, :, :]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    d2[:, ~valid0.cpu().numpy()] = np.inf
    nbr = np.argsort(d2, axis=1)[:, :_NEIGHBORS].astype(np.int64)

    if prior_idepth is not None:
        rho0 = bilinear(prior_idepth, uv)
        med = torch.quantile(torch.where(valid0, rho0, torch.ones_like(rho0)), 0.5)
        rho0 = torch.clamp(rho0 / torch.clamp(med, min=1e-6), 0.1, 10.0)
    else:
        rho0 = torch.ones(uv.shape[0], dtype=torch.float32, device=dev)

    return InitializerState(
        uv=uv,
        color=torch.stack(colors),
        weight=torch.stack(weights),
        valid=torch.stack(valids),
        nbr=torch.as_tensor(nbr).to(dev),
        idepth=rho0,
        T=SE3.identity(device=dev),
        ab=torch.zeros(2, dtype=torch.float32, device=dev),
        snapped=torch.zeros((), dtype=torch.bool, device=dev),
        snapped_age=torch.zeros((), dtype=torch.int32, device=dev),
    )


def _neighbor_mean(idepth: torch.Tensor, nbr: torch.Tensor) -> torch.Tensor:
    return torch.mean(idepth[nbr], dim=-1)


def _init_level(
    grad_l: torch.Tensor,
    cam_l: PinholeCamera,
    uv_l: torch.Tensor,
    color: torch.Tensor,
    weight: torch.Tensor,
    valid: torch.Tensor,
    nbr: torch.Tensor,
    T0: SE3,
    ab0: torch.Tensor,
    rho0: torch.Tensor,
    cfg: DirectConfig,
    alpha_w: torch.Tensor,
    coupling_w: torch.Tensor,
    iters: int,
):
    """GN/LM at one pyramid level: joint [xi, a, b] + per-point idepth with
    the idepth block Schur-complemented (diagonal => one batched divide)."""
    dev = uv_l.device
    weight = torch.where(valid[:, None], weight, torch.zeros_like(weight))
    zero = torch.zeros((), dtype=torch.float32, device=dev)

    def energy(T, ab, rho, rho_ref):
        """The exact functional GN minimizes (sums, incl. priors)."""
        ev = evaluate_residuals(
            grad_l, cam_l, uv_l, rho, color, weight, T, ab[0], ab[1],
            huber_k=cfg.huber_intensity,
        )
        ok = ev.valid & valid
        # out-of-bounds points pay the outlier energy instead of zero cost
        e_photo = torch.sum(torch.where(
            ok, ev.energy,
            torch.where(valid, torch.full_like(ev.energy, cfg.outlier_energy), zero)))
        e_prior = 0.5 * torch.sum(torch.where(
            valid,
            alpha_w * (rho - 1.0) ** 2 + coupling_w * (rho - rho_ref) ** 2, zero))
        e_ab = 0.5 * (50.0 * ab[0] ** 2 + 0.5 * ab[1] ** 2)
        return e_photo + e_prior + e_ab

    ab_w = const((0.0,) * 6 + (50.0, 0.5), dev)
    s = const((1.0,) * 6 + (cfg.scale_a, cfg.scale_b), dev)
    eye8 = torch.eye(8, dtype=torch.float32, device=dev)

    T, ab, rho = T0, ab0, rho0
    lam = torch.full((), 0.1, dtype=torch.float32, device=dev)
    E = energy(T0, ab0, rho0, _neighbor_mean(rho0, nbr))
    for _ in range(iters):
        rho_ref = _neighbor_mean(rho, nbr)
        ev = evaluate_residuals(
            grad_l, cam_l, uv_l, rho, color, weight, T, ab[0], ab[1],
            huber_k=cfg.huber_intensity,
        )
        J_x = rel_pose_jacobian(ev, color)           # (P, 8, 8) wrt [xi, a, b]
        J_rho = idepth_jacobian(ev, T, rho)          # (P, 8)

        w = ev.w
        Jw = J_x * w[..., None]
        H_xx = torch.einsum("pkd,pke->de", Jw, J_x)
        b_x = torch.einsum("pkd,pk->d", Jw, ev.r)
        H_xr = torch.einsum("pkd,pk->pd", Jw, J_rho)
        H_rr = torch.einsum("pk,pk->p", J_rho * w, J_rho)
        b_r = torch.einsum("pk,pk->p", J_rho * w, ev.r)

        # idepth priors (diagonal): alpha anchor + neighbor coupling
        prior_w = torch.where(valid, alpha_w + coupling_w, zero)
        H_rr = H_rr + prior_w
        b_r = b_r + torch.where(
            valid, alpha_w * (rho - 1.0) + coupling_w * (rho - rho_ref), zero)

        # weak affine prior (no exposure metadata during bootstrap)
        H_xx = H_xx + torch.diag(ab_w)
        b_x = b_x + ab_w * torch.cat([torch.zeros(6, dtype=torch.float32, device=dev), ab])

        # LM damping + Schur complement on idepths
        H_rr_d = H_rr * (1.0 + lam) + 1e-10
        Hs = H_xx - torch.einsum("pd,pe->de", H_xr / H_rr_d[:, None], H_xr)
        bs = b_x - torch.einsum("pd,p->d", H_xr, b_r / H_rr_d)

        Hs = Hs * s[:, None] * s[None, :]
        Hs = Hs + lam * torch.diag(torch.diag(Hs)) + 1e-8 * eye8
        dx, _ = torch.linalg.solve_ex(Hs, bs * s)
        dx = dx * s

        d_rho = (b_r - H_xr @ dx) / H_rr_d
        T_new = se3_exp(-dx[:6]).compose(T)
        ab_new = ab - dx[6:]
        rho_new = torch.clamp(rho - d_rho, cfg.idepth_min, cfg.idepth_max)
        rho_new = torch.where(
            valid,
            (1.0 - cfg.init_smooth_blend) * rho_new
            + cfg.init_smooth_blend * _neighbor_mean(rho_new, nbr),
            rho_new,
        )

        E_new = energy(T_new, ab_new, rho_new, _neighbor_mean(rho_new, nbr))
        accept = E_new < E
        T = se3_select(accept, T_new, T)
        ab = torch.where(accept, ab_new, ab)
        rho = torch.where(accept, rho_new, rho)
        E = torch.where(accept, E_new, E)
        lam = torch.where(accept, torch.clamp(lam * 0.5, min=1e-6),
                          torch.clamp(lam * 5.0, max=1e3))
    return T, ab, rho, E


@dataclasses.dataclass
class InitResult:
    state: InitializerState
    success: torch.Tensor     # ready to promote into the window
    energy: torch.Tensor
    num_valid: torch.Tensor


def try_initialize(
    state: InitializerState,
    grad_pyr: tuple[torch.Tensor, ...],
    cam0: PinholeCamera,
    cfg: DirectConfig,
) -> InitResult:
    """One initialization attempt against a new frame, coarse-to-fine;
    success once translation is observable ("snapped") for
    `init_snapped_age` consecutive frames (reference: DSOInitializer
    snapped/snappedAt logic)."""
    num_levels = len(grad_pyr)
    T, ab, rho = state.T, state.ab, state.idepth
    zero = torch.zeros((), dtype=torch.float32, device=rho.device)

    alpha_w = torch.where(state.snapped, zero, zero + cfg.init_alpha_w)
    coupling_w = torch.where(state.snapped, zero + cfg.init_coupling, zero + 0.05)

    E = zero
    for l in range(num_levels - 1, -1, -1):
        s = 0.5**l
        uv_l = (state.uv + 0.5) * s - 0.5
        T, ab, rho, E = _init_level(
            grad_pyr[l], cam0.level(l), uv_l,
            state.color[l], state.weight[l], state.valid[l], state.nbr,
            T, ab, rho, cfg, alpha_w, coupling_w,
            cfg.init_iters if l > 0 else cfg.init_iters * 2,
        )

    # snap test: enough parallax (|t| * mean rho)
    t_norm = torch.linalg.norm(T.t) * torch.mean(torch.where(state.valid[0], rho, zero))
    snapped_now = t_norm > cfg.init_min_translation
    snapped = state.snapped | snapped_now
    snapped_age = torch.where(snapped, state.snapped_age + 1,
                              torch.zeros_like(state.snapped_age))

    new_state = state.replace(
        T=T, ab=ab, idepth=rho, snapped=snapped, snapped_age=snapped_age
    )
    num_valid = torch.sum(state.valid[0])
    success = snapped & (snapped_age >= cfg.init_snapped_age) & (num_valid > 64)
    return InitResult(state=new_state, success=success, energy=E, num_valid=num_valid)


def normalize_scale(state: InitializerState) -> tuple[InitializerState, torch.Tensor]:
    """Rescale so the mean valid inverse depth is 1 (monocular gauge fix).
    Returns the state and the applied scale factor."""
    v = state.valid[0]
    zero = torch.zeros((), dtype=state.idepth.dtype, device=v.device)
    mean_rho = torch.sum(torch.where(v, state.idepth, zero)) / torch.clamp(
        torch.sum(v), min=1)
    factor = 1.0 / torch.clamp(mean_rho, min=1e-6)
    return (
        state.replace(
            idepth=state.idepth / torch.clamp(mean_rho, min=1e-6),
            T=SE3(R=state.T.R, t=state.T.t * mean_rho),
        ),
        factor,
    )
