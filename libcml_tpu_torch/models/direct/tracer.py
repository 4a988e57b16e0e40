"""Batched epipolar inverse-depth search (immature-point tracing).

PyTorch port of libcml_tpu/models/direct/tracer.py (the reference's
DSOTracer, src/cml/optimization/dso/DSOTracer.cpp:13 traceNewCoarse, :59
activatePoints, :496 makeNewTraces; status machine DSOTracer.h:38). Every
point searches a FIXED grid of `trace_steps` inverse-depth hypotheses; the
whole trace is one (P, S, 8) gather + reduction with a parabolic refine and
a best/second-best quality ratio.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from libcml_tpu_torch.core.camera import PinholeCamera
from libcml_tpu_torch.core.lie import SE3
from libcml_tpu_torch.models.direct.config import DirectConfig
from libcml_tpu_torch.models.direct.residuals import pattern_uv
from libcml_tpu_torch.ops.image import bilinear
from libcml_tpu_torch.ops.kf_programs import seed_cuda
from libcml_tpu_torch.ops.trace_epipolar import trace_rows_cuda

_BIG = 1e12


def _linspace(lo: torch.Tensor, hi: torch.Tensor, S: int) -> torch.Tensor:
    """jnp.linspace(lo, hi, S) along a new last axis, in f32 as XLA
    computes it (lo * (1 - s) + hi * s with s = iota * f32(1 / (S - 1)), the
    endpoint appended exactly), so the hypothesis grids match the JAX
    package to the bit."""
    step = torch.arange(S - 1, dtype=torch.float32, device=lo.device) * float(
        np.float32(1.0 / (S - 1)))
    out = lo[..., None] * (1.0 - step) + hi[..., None] * step
    return torch.cat([out, hi[..., None]], dim=-1)


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[..., idx[...]] along the last axis (take_along_axis, one index)."""
    return torch.gather(x, -1, idx[..., None])[..., 0]


@dataclasses.dataclass
class TraceResult:
    idepth: torch.Tensor      # (P,) refined inverse depth in the HOST frame
    good: torch.Tensor        # (P,) bool: unambiguous, in-bounds match
    quality: torch.Tensor     # (P,) second-best/best SSD ratio
    pixel_span: torch.Tensor  # (P,) epipolar search length in pixels


def trace_points(
    host_color: torch.Tensor,   # (P, 8) pattern intensities in the host frame
    uv_host: torch.Tensor,      # (P, 2) level-0 pixels in the host frame
    valid: torch.Tensor,        # (P,) candidate mask
    obs_grad: torch.Tensor,     # (H, W, 3) observer gradient image (level 0)
    T_oh: SE3,                  # observer <- host relative pose
    ab_oh: torch.Tensor,        # (2,) relative affine [a, b]
    cam: PinholeCamera,
    cfg: DirectConfig,
    rho_min: float | None = None,
    rho_max: float | None = None,
) -> TraceResult:
    """One batched epipolar sweep for all P candidates."""
    dev = uv_host.device
    S = cfg.trace_steps
    rho_lo = cfg.idepth_min if rho_min is None else rho_min
    rho_hi = cfg.idepth_max if rho_max is None else rho_max

    lo = torch.log(torch.full((), rho_lo + 1e-6, dtype=torch.float32, device=dev))
    hi = torch.log(torch.full((), rho_hi, dtype=torch.float32, device=dev))
    log_grid = _linspace(lo, hi, S)                               # (S,)
    rho_s = torch.exp(log_grid)                                   # (S,)

    p_uv = pattern_uv(uv_host)                                    # (P, 8, 2)
    Xh = cam.unproject(p_uv[:, None, :, :], rho_s[None, :, None])  # (P, S, 8, 3)
    Xo = T_oh.apply(Xh)
    uv_o, z_ok = cam.project(Xo)                                  # (P, S, 8, 2)
    in_b = cam.in_bounds(uv_o, border=2.0)
    hyp_ok = torch.all(z_ok & in_b, dim=-1)                       # (P, S)

    I_o = bilinear(obs_grad[..., 0], uv_o)                        # (P, S, 8)
    pred = torch.exp(ab_oh[0]) * host_color[:, None, :] + ab_oh[1]
    ssd = torch.sum((I_o - pred) ** 2, dim=-1)                    # (P, S)
    ssd = torch.where(hyp_ok, ssd, torch.full_like(ssd, _BIG))

    best = torch.argmin(ssd, dim=1)                               # (P,)
    best_ssd = _take(ssd, best)

    # second best outside a +-2-step exclusion window
    steps = torch.arange(S, device=dev)[None, :]
    excl = torch.abs(steps - best[:, None]) <= 2
    second_ssd = torch.amin(torch.where(excl, torch.full_like(ssd, _BIG), ssd), dim=1)
    quality = second_ssd / torch.clamp(best_ssd, min=1e-6)

    # parabolic sub-step refinement in log-idepth
    bm = torch.clamp(best, 1, S - 2)
    f0 = _take(ssd, bm - 1)
    f1 = _take(ssd, bm)
    f2 = _take(ssd, bm + 1)
    denom = f0 - 2.0 * f1 + f2
    delta = torch.where(torch.abs(denom) > 1e-9, 0.5 * (f0 - f2) / denom,
                        torch.zeros_like(denom))
    delta = torch.clamp(delta, -1.0, 1.0)
    dlog = log_grid[1] - log_grid[0]
    idepth = torch.exp(log_grid[bm] + delta * dlog)

    span = torch.linalg.norm(uv_o[:, -1, 0, :] - uv_o[:, 0, 0, :], dim=-1)

    n_ok = torch.sum(hyp_ok, dim=1)
    good = (
        valid
        & (best_ssd < _BIG)
        & (quality > cfg.trace_min_quality)
        & (n_ok >= 3)
        & (span > 1.5)
    )
    return TraceResult(idepth=idepth, good=good, quality=quality, pixel_span=span)


# ---------------------------------------------------------------------------
# Immature-point lifecycle (the reference's DSOTracer immature machinery)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ImmatureArena:
    """Per-window-slot immature candidates: (F, K) layout. Candidates are
    created on a new keyframe, then re-traced against every subsequent frame,
    each trace narrowing their inverse-depth interval [rho_lo, rho_hi]; only
    converged candidates are activated into the BA."""

    uv: torch.Tensor       # (F, K, 2) pixel in host keyframe
    color: torch.Tensor    # (F, K, 8) host pattern intensities
    rho_lo: torch.Tensor   # (F, K) interval lower bound (inverse depth)
    rho_hi: torch.Tensor   # (F, K) upper bound
    n_ok: torch.Tensor     # (F, K) int32 successful traces
    n_fail: torch.Tensor   # (F, K) int32 failed traces
    valid: torch.Tensor    # (F, K) bool

    def replace(self, **kw) -> "ImmatureArena":
        return dataclasses.replace(self, **kw)

    def map(self, fn) -> "ImmatureArena":
        return ImmatureArena(**{f.name: fn(getattr(self, f.name))
                                for f in dataclasses.fields(self)})


def empty_immatures(F: int, K: int, device: str | torch.device = "cpu") -> ImmatureArena:
    return ImmatureArena(
        uv=torch.zeros((F, K, 2), dtype=torch.float32, device=device),
        color=torch.zeros((F, K, 8), dtype=torch.float32, device=device),
        rho_lo=torch.full((F, K), 1e-4, dtype=torch.float32, device=device),
        rho_hi=torch.full((F, K), 50.0, dtype=torch.float32, device=device),
        n_ok=torch.zeros((F, K), dtype=torch.int32, device=device),
        n_fail=torch.zeros((F, K), dtype=torch.int32, device=device),
        valid=torch.zeros((F, K), dtype=torch.bool, device=device),
    )


def seed_immatures(
    arena: ImmatureArena,
    slot,
    grad0: torch.Tensor,       # (H, W, 3) the new keyframe's gradient image
    uv: torch.Tensor,          # (K, 2) selected candidate pixels
    valid: torch.Tensor,       # (K,)
    rho_lo: torch.Tensor,      # scalar working-range bounds
    rho_hi: torch.Tensor,
) -> ImmatureArena:
    """Reset `slot`'s row with fresh candidates (makeNewTraces): one launch
    of the hand-written kernel (ops/kf_programs.seed_cuda) for CUDA
    tensors, seed_immatures_plain for CPU tensors; any other device
    raises."""
    if _on_card(uv):
        return ImmatureArena(**seed_cuda(arena, slot, grad0, uv, valid, rho_lo, rho_hi))
    if uv.device.type == "cpu":
        return seed_immatures_plain(arena, slot, grad0, uv, valid, rho_lo, rho_hi)
    raise ValueError(f"seed_immatures: unsupported device {uv.device}")


def seed_immatures_plain(
    arena: ImmatureArena,
    slot,
    grad0: torch.Tensor,
    uv: torch.Tensor,
    valid: torch.Tensor,
    rho_lo: torch.Tensor,
    rho_hi: torch.Tensor,
) -> ImmatureArena:
    """seed_immatures in plain PyTorch."""
    color = bilinear(grad0[..., 0], pattern_uv(uv))          # (K, 8)
    F = arena.valid.shape[0]
    onehot = torch.arange(F, device=uv.device) == slot
    K = uv.shape[0]

    def set_row(old, new):
        return torch.where(onehot.reshape((-1,) + (1,) * (old.ndim - 1)), new[None], old)

    return ImmatureArena(
        uv=set_row(arena.uv, uv),
        color=set_row(arena.color, color),
        rho_lo=set_row(arena.rho_lo, rho_lo.expand(K)),
        rho_hi=set_row(arena.rho_hi, rho_hi.expand(K)),
        n_ok=set_row(arena.n_ok, torch.zeros((K,), dtype=torch.int32, device=uv.device)),
        n_fail=set_row(arena.n_fail, torch.zeros((K,), dtype=torch.int32, device=uv.device)),
        valid=set_row(arena.valid, valid),
    )


def _on_card(x: torch.Tensor) -> bool:
    return x.is_cuda


def trace_immatures_rows(
    arena: ImmatureArena,
    rows: torch.Tensor,        # (R,) int32 host-slot indices to trace (-1 pad)
    T_hosts: SE3,
    host_valid: torch.Tensor,
    obs_grad: torch.Tensor,
    T_obs: SE3,
    cam: PinholeCamera,
    cfg: DirectConfig,
    probes: torch.Tensor | None = None,
) -> ImmatureArena:
    """Trace the R most-recently-seeded arena rows against a new frame: one
    launch of the hand-written kernel (ops/trace_epipolar.py) for CUDA
    tensors, trace_immatures_rows_plain for CPU tensors; any other device
    raises. A failure to build or launch the kernel raises. `probes`: see
    trace_immatures_rows_plain."""
    if _on_card(arena.uv):
        return trace_rows_cuda(arena, rows.contiguous(), SE3(R=T_hosts.R.contiguous(),
                                                             t=T_hosts.t.contiguous()),
                               host_valid.contiguous(), obs_grad.contiguous(),
                               SE3(R=T_obs.R.contiguous(), t=T_obs.t.contiguous()), cam, cfg,
                               probes)
    if arena.uv.device.type == "cpu":
        return trace_immatures_rows_plain(arena, rows, T_hosts, host_valid, obs_grad, T_obs,
                                          cam, cfg, probes)
    raise ValueError(f"tracer: unsupported device {arena.uv.device}")


def trace_immatures_rows_plain(
    arena: ImmatureArena,
    rows: torch.Tensor,        # (R,) int host-slot indices to trace (-1 pad)
    T_hosts: SE3,
    host_valid: torch.Tensor,
    obs_grad: torch.Tensor,
    T_obs: SE3,
    cam: PinholeCamera,
    cfg: DirectConfig,
    probes: torch.Tensor | None = None,
) -> ImmatureArena:
    """Trace only the R most-recently-seeded arena rows (gather → trace →
    scatter back). The -1 pad rows are gathered from row 0 (masked dead),
    and their results are NOT written back: they are masked out of the
    scatter, never clamped onto row 0 (which may be a genuine row). With
    `probes` ((R, K, 7) float32), every traced point's deciding values
    (ops/trace_epipolar.PROBE_FIELDS) are written there, by trace row."""
    rows_c = torch.clamp(rows, min=0).long()
    row_ok = rows >= 0
    sub = arena.map(lambda x: x[rows_c])
    sub = sub.replace(valid=sub.valid & row_ok[:, None])
    sub_T = SE3(R=T_hosts.R[rows_c], t=T_hosts.t[rows_c])
    sub_hv = host_valid[rows_c] & row_ok
    traced = trace_immatures(sub, sub_T, sub_hv, obs_grad, T_obs, cam, cfg, probes)

    F = arena.valid.shape[0]
    # (F, R) one-hot of the written rows; rows are distinct window slots
    hit = (torch.arange(F, device=rows.device)[:, None] == rows_c[None, :]) & row_ok[None, :]
    src = torch.argmax(hit.int(), dim=1)           # which traced row lands in f
    written = hit.any(dim=1)

    def scatter(a, s):
        mask = written.reshape((-1,) + (1,) * (a.ndim - 1))
        return torch.where(mask, s[src], a)

    return ImmatureArena(**{f.name: scatter(getattr(arena, f.name), getattr(traced, f.name))
                            for f in dataclasses.fields(arena)})


def trace_immatures(
    arena: ImmatureArena,
    T_hosts: SE3,              # (F,) batched host keyframe poses (w2c)
    host_valid: torch.Tensor,  # (F,) which slots hold live keyframes
    obs_grad: torch.Tensor,    # (H, W, 3) NEW frame gradient image
    T_obs: SE3,                # new frame pose (w2c)
    cam: PinholeCamera,
    cfg: DirectConfig,
    probes: torch.Tensor | None = None,
) -> ImmatureArena:
    """One epipolar sweep of every immature candidate against a new frame,
    narrowing each candidate's inverse-depth interval (traceNewCoarse):
    S hypotheses geometrically spaced inside [rho_lo, rho_hi], pattern SSD,
    parabolic refine, interval shrinks to best +- 1.2 grid steps; failures
    are counted and repeat failures dropped. With `probes` ((F, K, 7)
    float32), each candidate's deciding values are written there
    (ops/trace_epipolar.PROBE_FIELDS)."""
    F, K = arena.valid.shape
    S = cfg.trace_steps
    dev = arena.uv.device

    T_oh = T_obs.compose(T_hosts.inverse())                  # (F,)

    lo = torch.log(torch.clamp(arena.rho_lo, min=1e-6))      # (F, K)
    hi = torch.log(torch.clamp(arena.rho_hi, min=2e-6))
    frac = _linspace(torch.zeros((), device=dev), torch.ones((), device=dev), S)
    log_grid = lo[..., None] + (hi - lo)[..., None] * frac   # (F, K, S)
    rho_s = torch.exp(log_grid)

    p_uv = pattern_uv(arena.uv.reshape(F * K, 2)).reshape(F, K, 8, 2)
    Xh = cam.unproject(p_uv[:, :, None, :, :], rho_s[..., None])   # (F, K, S, 8, 3)
    Xo = torch.einsum("fij,fkspj->fkspi", T_oh.R, Xh) + T_oh.t[:, None, None, None, :]
    uv_o, z_ok = cam.project(Xo)
    in_b = cam.in_bounds(uv_o, border=2.0)
    hyp_ok = torch.all(z_ok & in_b, dim=-1)                  # (F, K, S)

    I_o = bilinear(obs_grad[..., 0], uv_o)                   # (F, K, S, 8)
    ssd = torch.sum((I_o - arena.color[:, :, None, :]) ** 2, dim=-1)
    ssd = torch.where(hyp_ok, ssd, torch.full_like(ssd, _BIG))

    best = torch.argmin(ssd, dim=-1)                         # (F, K)
    best_ssd = _take(ssd, best)

    steps = torch.arange(S, device=dev)
    excl = torch.abs(steps[None, None, :] - best[..., None]) <= 2
    second = torch.amin(torch.where(excl, torch.full_like(ssd, _BIG), ssd), dim=-1)
    quality = second / torch.clamp(best_ssd, min=1e-6)

    bm = torch.clamp(best, 1, S - 2)
    f0 = _take(ssd, bm - 1)
    f1 = _take(ssd, bm)
    f2 = _take(ssd, bm + 1)
    denom = f0 - 2.0 * f1 + f2
    delta = torch.where(torch.abs(denom) > 1e-9, 0.5 * (f0 - f2) / denom,
                        torch.zeros_like(denom))
    delta = torch.clamp(delta, -1.0, 1.0)
    dlog = (hi - lo) / (S - 1)                               # (F, K)
    log_best = _take(log_grid, bm) + delta * dlog

    span = torch.linalg.norm(uv_o[:, :, -1, 0, :] - uv_o[:, :, 0, 0, :], dim=-1)

    ok = (
        arena.valid
        & host_valid[:, None]
        & (best_ssd < _BIG)
        & (best_ssd < (8.0 * 12.0**2))          # absolute match sanity
        & (quality > cfg.trace_min_quality)
    )
    informative = ok & (span > 1.0)

    if probes is not None:
        _write_probes(probes, ssd, best, best_ssd, second, span, uv_o, dlog, cam)

    new_lo = torch.exp(log_best - 1.2 * dlog)
    new_hi = torch.exp(log_best + 1.2 * dlog)
    rho_lo = torch.where(informative, torch.clamp(new_lo, min=1e-5), arena.rho_lo)
    rho_hi = torch.where(informative, new_hi, arena.rho_hi)

    n_ok = arena.n_ok + informative.int()
    n_fail = torch.where(ok, arena.n_fail, arena.n_fail + arena.valid.int())
    valid = arena.valid & (n_fail < 4)
    return arena.replace(rho_lo=rho_lo, rho_hi=rho_hi, n_ok=n_ok, n_fail=n_fail,
                         valid=valid)


def _write_probes(probes: torch.Tensor, ssd, best, best_ssd, second, span, uv_o, dlog,
                  cam: PinholeCamera) -> None:
    """Fill `probes` (..., 7) with trace_immatures' deciding values: the
    argmin, its SSD, the least SSD of any other hypothesis, the windowed
    second best, the span, every projected pattern pixel's least distance
    from the in-bounds limits, the grid step."""
    others = torch.where(torch.arange(ssd.shape[-1], device=ssd.device) == best[..., None],
                         torch.full_like(ssd, float("inf")), ssd)
    u, v = uv_o[..., 0], uv_o[..., 1]
    lim_u, lim_v = float(cam.width - 3), float(cam.height - 3)
    edge = torch.minimum(torch.minimum((u - 2.0).abs(), (u - lim_u).abs()),
                         torch.minimum((v - 2.0).abs(), (v - lim_v).abs()))
    edge = torch.nan_to_num(edge, nan=float("inf")).flatten(-2).amin(-1)
    probes.copy_(torch.stack([best.float(), best_ssd, others.amin(-1), second, span, edge,
                              dlog], dim=-1))


def mature_mask(arena: ImmatureArena, cfg: DirectConfig):
    """(F, K) bool: candidates ready for activation + their idepth estimate
    (traced successfully >= activate_min_traces times, interval converged
    below activate_max_relwidth; reference: activatePoints)."""
    mid = torch.sqrt(arena.rho_lo * arena.rho_hi)
    relwidth = (arena.rho_hi - arena.rho_lo) / torch.clamp(mid, min=1e-6)
    ready = (
        arena.valid
        & (arena.n_ok >= cfg.activate_min_traces)
        & (relwidth < cfg.activate_max_relwidth)
    )
    return ready, mid
