"""Direct frame-to-keyframe tracker: coarse-to-fine LM over SE3 + affine.

PyTorch port of libcml_tpu/models/direct/tracker.py (the reference's
DSOTracker: src/cml/optimization/dso/DSOTracker.cpp:15 optimize, :421-470
8x8 Hessian accumulation, :93-100 LM damping + solve). Each LM iteration is
one batched residual sweep over the whole point arena per pyramid level.

The JAX package runs each level's LM as a `lax.while_loop` on a device
`done` flag and vmaps the hypotheses of `track_multi`. Here, on the card,
`track` runs its levels and `track_multi` its coarse battery (grid = the
hypotheses) as one launch each of a hand-written kernel (ops/track_lm.py,
csrc/track_lm.cu) that ends every level on the device; the battery's winner
is picked by `torch.argmin` on the device. No host read sits inside the
loops; `track`'s statistics sweep at level 0 runs in the same launch. On
the CPU `track_levels_plain` runs the same schedule (each level at most
`tracker_iters` iterations, stopping when `done` holds) and
`track_stats_plain` the statistics.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from libcml_tpu_torch._device import const
from libcml_tpu_torch.core.camera import PinholeCamera
from libcml_tpu_torch.core.lie import SE3, se3_exp, se3_select, se3_stack
from libcml_tpu_torch.models.direct.config import DirectConfig
from libcml_tpu_torch.models.direct.residuals import (
    PATTERN_CENTER,
    evaluate_residuals,
    gauss_newton_system,
    pattern_uv,
    rel_pose_jacobian,
)
from libcml_tpu_torch.ops.image import bilinear
from libcml_tpu_torch.ops.kf_programs import tracker_ref_cuda
from libcml_tpu_torch.ops.track_lm import track_lm_cuda


@dataclasses.dataclass
class TrackerRef:
    """Per-level views of the reference keyframe's point set, stacked over
    levels: uv (L, P, 2), color (L, P, 1), weight (L, P, 1), valid (L, P);
    idepth (P,) is level-independent."""

    uv: torch.Tensor
    color: torch.Tensor
    weight: torch.Tensor
    valid: torch.Tensor
    idepth: torch.Tensor

    def replace(self, **kw) -> "TrackerRef":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass
class TrackResult:
    T_ji: SE3                 # relative pose: new frame <- reference keyframe
    ab: torch.Tensor          # (2,) relative affine [a_ji, b_ji]
    energy: torch.Tensor      # final mean Huber energy per valid point
    num_valid: torch.Tensor   # valid points at the finest level
    cov_pose: torch.Tensor    # (6, 6) pose covariance (affine marginalized)
    flow: torch.Tensor        # RMS pixel flow at the finest level
    flow_no_trans: torch.Tensor  # RMS flow from rotation only
    saturated: torch.Tensor   # fraction of residuals pinned at the cutoff


def _level_uv(uv0: torch.Tensor, level: int) -> torch.Tensor:
    """Level-0 pixel coords -> level-l (DSO half-pixel convention)."""
    s = 0.5**level
    return (uv0 + 0.5) * s - 0.5


def make_tracker_ref(
    kf_grad_pyr: tuple[torch.Tensor, ...],
    cam0: PinholeCamera,
    uv0: torch.Tensor,
    idepth: torch.Tensor,
    valid: torch.Tensor,
    cfg: DirectConfig,
) -> TrackerRef:
    """Sample the host keyframe's intensities and gradient weights at every
    pyramid level (single-pixel support, as CoarseTracker::calcRes): one
    launch of the hand-written kernel (ops/kf_programs.tracker_ref_cuda)
    for CUDA tensors, make_tracker_ref_plain for CPU tensors; any other
    device raises."""
    if uv0.is_cuda:
        return TrackerRef(**tracker_ref_cuda(kf_grad_pyr, cam0, cfg,
                                             points=(uv0, idepth, valid)))
    if uv0.device.type == "cpu":
        return make_tracker_ref_plain(kf_grad_pyr, cam0, uv0, idepth, valid, cfg)
    raise ValueError(f"make_tracker_ref: unsupported device {uv0.device}")


def make_tracker_ref_plain(
    kf_grad_pyr: tuple[torch.Tensor, ...],
    cam0: PinholeCamera,
    uv0: torch.Tensor,
    idepth: torch.Tensor,
    valid: torch.Tensor,
    cfg: DirectConfig,
) -> TrackerRef:
    """make_tracker_ref in plain PyTorch."""
    uvs, colors, weights, valids = [], [], [], []
    for l, G in enumerate(kf_grad_pyr):
        cam_l = cam0.level(l)
        uv_l = _level_uv(uv0, l)
        sample = bilinear(G, pattern_uv(uv_l, pattern=PATTERN_CENTER))  # (P, 1, 3)
        color = sample[..., 0]
        gsq = sample[..., 1] ** 2 + sample[..., 2] ** 2
        w = torch.sqrt(cfg.gradient_weight_c2 / (cfg.gradient_weight_c2 + gsq))
        uvs.append(uv_l)
        colors.append(color)
        weights.append(w)
        valids.append(valid & cam_l.in_bounds(uv_l, border=3.0))
    return TrackerRef(
        uv=torch.stack(uvs), color=torch.stack(colors),
        weight=torch.stack(weights), valid=torch.stack(valids), idepth=idepth,
    )


def _solve_scaled(H: torch.Tensor, b: torch.Tensor, lam: torch.Tensor,
                  cfg: DirectConfig) -> torch.Tensor:
    """LM-damped solve of the 8x8 system with DSO-style state scaling.
    `solve_ex` gives nan/inf for a singular system, as jnp.linalg.solve
    does, where `solve` would raise."""
    s = const((cfg.scale_trans,) * 3 + (cfg.scale_rot,) * 3
              + (cfg.scale_a, cfg.scale_b), H.device)
    Hs = H * s[:, None] * s[None, :]
    bs = b * s
    eye = torch.eye(8, dtype=H.dtype, device=H.device)
    Hs = Hs + lam * torch.diag(torch.diag(Hs)) + 1e-8 * eye
    dx, _ = torch.linalg.solve_ex(Hs, bs)
    return dx * s


def _track_level_plain(
    grad_j: torch.Tensor,
    cam_l: PinholeCamera,
    uv: torch.Tensor,
    idepth: torch.Tensor,
    color: torch.Tensor,
    weight: torch.Tensor,
    valid: torch.Tensor,
    T0: SE3,
    ab0: torch.Tensor,
    cfg: DirectConfig,
    ab_center: torch.Tensor | None = None,
):
    """At most cfg.tracker_iters LM iterations at one pyramid level.
    Returns (T, ab, E, steps run, trace (tracker_iters, 3): each step's E,
    E_new and |dx|, NaN past the last step)."""
    dev = uv.device
    weight = torch.where(valid[:, None], weight, torch.zeros_like(weight))

    def total_energy(T, ab):
        ev = evaluate_residuals(
            grad_j, cam_l, uv, idepth, color, weight, T, ab[0], ab[1],
            huber_k=cfg.huber_intensity, cutoff=cfg.tracker_cutoff,
            pattern=PATTERN_CENTER,
        )
        ok = ev.valid & valid
        n = torch.clamp(torch.sum(ok), min=1)
        return torch.sum(torch.where(ok, ev.energy, torch.zeros_like(ev.energy))) / n

    if ab_center is None:
        ab_center = torch.zeros_like(ab0)
    prior = const((0.0,) * 6 + (1e-1, 1e-3), dev)
    T, ab = T0, ab0
    E = total_energy(T0, ab0)
    lam = torch.full((), 1e-4, dtype=torch.float32, device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    trace = torch.full((cfg.tracker_iters, 3), float("nan"), device=dev)
    it = -1
    for it in range(cfg.tracker_iters):
        ev = evaluate_residuals(
            grad_j, cam_l, uv, idepth, color, weight, T, ab[0], ab[1],
            huber_k=cfg.huber_intensity, cutoff=cfg.tracker_cutoff,
            pattern=PATTERN_CENTER,
        )
        J = rel_pose_jacobian(ev, color)
        H, b, _ = gauss_newton_system(J, ev.r, ev.w)
        # small prior keeping affine params near their PREDICTION
        H = H + torch.diag(prior)
        b = b + prior * torch.cat([torch.zeros(6, dtype=H.dtype, device=dev),
                                   ab - ab_center])
        dx = _solve_scaled(H, b, lam, cfg)
        T_new = se3_exp(-dx[:6]).compose(T)
        ab_new = ab - dx[6:]
        E_new = total_energy(T_new, ab_new)
        accept = E_new < E
        E_before = E
        step = ~done
        take = accept & step
        T = se3_select(take, T_new, T)
        ab = torch.where(take, ab_new, ab)
        E = torch.where(take, E_new, E)
        lam_new = torch.where(accept, torch.clamp(lam * 0.5, min=1e-7),
                              torch.clamp(lam * 4.0, max=1e2))
        lam = torch.where(step, lam_new, lam)
        # convergence early-exit (reference: DSOTracker.cpp:101-110)
        step_norm = torch.linalg.norm(dx)
        trace[it] = torch.stack([E_before, E_new, step_norm])
        done_now = (accept & (step_norm < cfg.tracker_converge_eps)) | (
            ~accept & (lam_new >= 1e2 - 1e-6))
        done = done | (step & done_now)
        if bool(done):
            break
    return T, ab, E, it + 1, trace


def track_levels_plain(grads, cams, uv, color, weight, valid, idepth: torch.Tensor,
                       R0: torch.Tensor, t0: torch.Tensor, ab0: torch.Tensor,
                       ab_center: torch.Tensor, cfg: DirectConfig, stats: bool = False):
    """The plain PyTorch form of the tracker kernel (ops/track_lm.py,
    csrc/track_lm.cu), with its arguments and outputs: per hypothesis b,
    _track_level_plain over the listed levels in turn from (R0[b], t0[b],
    ab0[b]). Returns (R (B, 3, 3), t (B, 3), ab (B, 2), E (B,), steps run
    (B, levels) int32, trace (B, levels, tracker_iters, 3), stats): with
    `stats`, track_stats_plain at the last level from each result, each
    output with a leading B; else None."""
    out, st = [], []
    for h in range(R0.shape[0]):
        T, ab = SE3(R=R0[h], t=t0[h]), ab0[h]
        E = torch.zeros((), dtype=torch.float32, device=ab0.device)
        its, traces = [], []
        for l in range(len(grads)):
            T, ab, E, it, trace = _track_level_plain(
                grads[l], cams[l], uv[l], idepth, color[l], weight[l], valid[l], T, ab, cfg,
                ab_center=ab_center)
            its.append(it)
            traces.append(trace)
        out.append((T.R, T.t, ab, E, torch.tensor(its, dtype=torch.int32, device=ab0.device),
                    torch.stack(traces)))
        if stats:
            st.append(track_stats_plain(grads[-1], cams[-1], uv[-1], idepth, color[-1],
                                        weight[-1], valid[-1], T, ab, cfg))
    stacked = tuple(torch.stack(x) for x in zip(*out))
    return (*stacked, tuple(torch.stack(x) for x in zip(*st)) if stats else None)


def _track_levels(new_grad_pyr, cam0: PinholeCamera, ref: TrackerRef, levels,
                  R0: torch.Tensor, t0: torch.Tensor, ab0: torch.Tensor,
                  ab_center: torch.Tensor, cfg: DirectConfig, stats: bool = False):
    """The LM of `levels` (in order) for the B hypotheses (R0, t0, ab0), and
    with `stats` track's statistics at the last level: one kernel launch for
    CUDA tensors, track_levels_plain for CPU tensors. Returns
    track_levels_plain's tuple."""
    args = ([new_grad_pyr[l] for l in levels], [cam0.level(l) for l in levels],
            [ref.uv[l] for l in levels], [ref.color[l] for l in levels],
            [ref.weight[l] for l in levels], [ref.valid[l] for l in levels])
    rest = (ref.idepth, R0, t0, ab0, ab_center)
    if R0.is_cuda:
        return track_lm_cuda([g.contiguous() for g in args[0]], args[1],
                             *([x.contiguous() for x in xs] for xs in args[2:]),
                             *(x.contiguous() for x in rest), cfg, stats)
    if R0.device.type == "cpu":
        return track_levels_plain(*args, *rest, cfg, stats)
    raise ValueError(f"tracker: unsupported device {R0.device}")


def motion_hypotheses(T_pred: SE3, T_zero: SE3, n_rot: int = 8,
                      rot_eps: float = 0.02, T_extra: SE3 | None = None) -> SE3:
    """Batched tracker initializations (reference: trackWithMotionModel's
    candidate battery, DSOTracker.h:238): the constant-velocity prediction,
    0.5x/0.7x/1.3x/2x translation variants, the zero-motion pose, an optional
    external candidate, and small rotation perturbations of the prediction.
    Returns a batched SE3 with leading dim N = 6 (+1) + n_rot."""
    def scale_t(T, s):
        return SE3(R=T.R, t=T.t * s)

    cands = [T_pred, scale_t(T_pred, 0.5), scale_t(T_pred, 0.7),
             scale_t(T_pred, 1.3), scale_t(T_pred, 2.0), T_zero]
    if T_extra is not None:
        cands.append(T_extra)
    dev = T_pred.R.device
    for k in range(n_rot):
        # f32 arithmetic as the JAX package: eye(3)[k%3] * sign * eps * (1 + k//6)
        w = [0.0, 0.0, 0.0]
        w[k % 3] = float(np.float32(1.0 if k < 3 else -1.0) * np.float32(rot_eps)
                         * np.float32(1 + k // 6))
        dT = se3_exp(const((0.0, 0.0, 0.0, *w), dev))
        cands.append(dT.compose(T_pred))
    return se3_stack(cands)


def track_multi(
    new_grad_pyr: tuple[torch.Tensor, ...],
    cam0: PinholeCamera,
    ref: TrackerRef,
    T_inits: SE3,            # batched (N,) hypotheses
    ab_init: torch.Tensor,
    cfg: DirectConfig,
) -> TrackResult:
    """Multi-hypothesis tracking (reference: trackWithMotionModel): refine
    every hypothesis at the TWO coarsest levels, pick the winner by achieved
    energy (first on ties, as argmin), then finish the standard coarse-to-fine
    track from it. Each hypothesis runs with its own early exit, as under the
    JAX package's vmap; on the card the battery is one kernel launch."""
    L = len(new_grad_pyr)
    levels = [min(L - 1, 1), 0] if L == 1 else [L - 1, L - 2]
    B = T_inits.t.shape[0]
    R, t, ab, E, _, _, _ = _track_levels(new_grad_pyr, cam0, ref, levels, T_inits.R,
                                         T_inits.t, ab_init.expand(B, 2), ab_init, cfg)
    T_best, ab_best = _best_hypothesis(R, t, ab, E)
    return track(new_grad_pyr, cam0, ref, T_best, ab_best, cfg)


def _best_hypothesis(R: torch.Tensor, t: torch.Tensor, ab: torch.Tensor,
                     E: torch.Tensor) -> tuple[SE3, torch.Tensor]:
    """The start of least energy, the first of a tie as jnp.argmin, picked
    and gathered on the device (no host read). Returns (pose, ab)."""
    best = torch.argmin(E).reshape(1)
    return (SE3(R=R.index_select(0, best)[0], t=t.index_select(0, best)[0]),
            ab.index_select(0, best)[0])


def track(
    new_grad_pyr: tuple[torch.Tensor, ...],
    cam0: PinholeCamera,
    ref: TrackerRef,
    T_init: SE3,
    ab_init: torch.Tensor,
    cfg: DirectConfig,
) -> TrackResult:
    """Track a new frame against the reference keyframe point set,
    coarse-to-fine, then one statistics sweep at level 0 (on the card all of
    it one kernel launch)."""
    num_levels = len(new_grad_pyr)
    R, t, ab, _, _, _, st = _track_levels(new_grad_pyr, cam0, ref,
                                          range(num_levels - 1, -1, -1), T_init.R[None],
                                          T_init.t[None], ab_init[None], ab_init, cfg,
                                          stats=True)
    energy, num_valid, cov_pose, flow, flow_no_trans, saturated = (x[0] for x in st)
    return TrackResult(T_ji=SE3(R=R[0], t=t[0]), ab=ab[0], energy=energy,
                       num_valid=num_valid, cov_pose=cov_pose, flow=flow,
                       flow_no_trans=flow_no_trans, saturated=saturated)


def track_stats_plain(grad0: torch.Tensor, cam_l0: PinholeCamera, uv: torch.Tensor,
                      idepth: torch.Tensor, color: torch.Tensor, weight: torch.Tensor,
                      valid: torch.Tensor, T: SE3, ab: torch.Tensor, cfg: DirectConfig):
    """track's statistics sweep at level 0 from the tracked (T, ab): (energy,
    num_valid, cov_pose (6, 6), flow, flow_no_trans, saturated)."""
    w0 = torch.where(valid[:, None], weight, torch.zeros_like(weight))
    ev = evaluate_residuals(
        grad0, cam_l0, uv, idepth, color, w0,
        T, ab[0], ab[1], huber_k=cfg.huber_intensity, cutoff=cfg.tracker_cutoff,
        pattern=PATTERN_CENTER,
    )
    ok = ev.valid & valid
    n = torch.clamp(torch.sum(ok), min=1)

    J = rel_pose_jacobian(ev, color)
    H, _, _ = gauss_newton_system(J, ev.r, ev.w)
    H = H + 1e-6 * torch.eye(8, dtype=H.dtype, device=H.device)
    cov_full, _ = torch.linalg.inv_ex(H)
    cov_pose = cov_full[:6, :6]

    zero = torch.zeros((), dtype=H.dtype, device=H.device)
    flow_sq = torch.sum((ev.uv_j - uv) ** 2, dim=-1)
    flow = torch.sqrt(torch.sum(torch.where(ok, flow_sq, zero)) / n)
    # rotation-only flow: warp with translation zeroed
    T_rot = SE3(R=T.R, t=torch.zeros_like(T.t))
    ev_rot = evaluate_residuals(
        grad0, cam_l0, uv, idepth, color, w0,
        T_rot, ab[0], ab[1], huber_k=cfg.huber_intensity, cutoff=cfg.tracker_cutoff,
        pattern=PATTERN_CENTER,
    )
    flow_rot_sq = torch.sum((ev_rot.uv_j - uv) ** 2, dim=-1)
    flow_no_trans = torch.sqrt(torch.sum(torch.where(ok, flow_rot_sq, zero)) / n)

    # saturation = residuals pinned at the hard cutoff
    sat_r = torch.abs(ev.r[:, 0]) >= 0.98 * cfg.tracker_cutoff
    saturated = torch.sum(ok & sat_r) / n
    energy = torch.sum(torch.where(ok, ev.energy, zero)) / n
    return energy, torch.sum(ok), cov_pose, flow, flow_no_trans, saturated
