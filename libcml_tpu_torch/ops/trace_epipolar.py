"""The direct frame's epipolar tracer as one CUDA kernel launch a call.

  trace_rows_cuda   hand-written sm_90a kernel (csrc/trace_epipolar.cu): the
                    whole `trace_immatures_rows` (the relative poses, the
                    16-hypothesis sweep of every traced point, the gates,
                    the narrowed intervals) and the new arena, rows that are
                    not traced copied through; no host read. It replaces the
                    XLA fusion of the JAX package's `trace_immatures_rows`
                    (libcml_tpu/models/direct/tracer.py:185) and
                    `trace_immatures` (:224).

Its plain PyTorch form, the CPU path and the yardstick on the card, is
`models/direct/tracer.trace_immatures_rows_plain` (same arguments and
results); `tracer.trace_immatures_rows` dispatches between the two by the
tensors' device. The kernel builds with nvcc on first use
(ops/kernel_build.py).
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from libcml_tpu_torch.core.camera import PinholeCamera
from libcml_tpu_torch.core.lie import SE3
from libcml_tpu_torch.models.direct.config import DirectConfig
from libcml_tpu_torch.models.direct.residuals import PATTERN_N
from libcml_tpu_torch.ops import kernel_build as kb
from libcml_tpu_torch.ops.kernel_build import KernelLaunchError

SOURCE = kb.CSRC / "trace_epipolar.cu"
STEPS = 16              # csrc/trace_epipolar.cu S: two lanes a hypothesis
PATTERN = 8             # csrc/trace_epipolar.cu NP: four pixels a lane
MAX_ROWS = 32           # csrc/trace_epipolar.cu MAX_ROWS: a lane a row, a lane a host slot
VECTOR_ALIGN = 16       # the kernel loads an entry's pixel and colours as float2 / float4
# what a probe row holds, per traced point: the argmin, its SSD, the least
# SSD of any other hypothesis, the second best outside the +-2-step window,
# the pixel span, the least distance of any projected pattern pixel from the
# in-bounds limits, and the grid step in log inverse depth
PROBE_FIELDS = ("best", "best_ssd", "runner_up", "second", "span", "edge", "dlog")

# How far the kernel may sit from its plain form on the same inputs. Both
# round every elementwise op alike, and the kernel takes the 3x3 products
# and the 8-term SSD as the card's libraries do, but where those round
# otherwise (a few ulps of a projected pixel or of an SSD) the results may
# differ.
# A point's statuses (n_ok, n_fail, valid) and its argmin may then differ
# only where a deciding value of the plain form (the reference: the
# kernel's own probes never excuse it) sits within DECISION_TOL of its
# threshold: the quality (relative to trace_min_quality), the span (pixels
# from 1.0), the best SSD (relative to 8 x 12^2), the best against the
# runner-up (their gap relative to the best: a near tie, which also bounds
# how far the parabola's denominator may cancel), and a projected pattern
# pixel's distance from the in-bounds limits (pixels; a hypothesis in
# bounds in one form and not the other). Where the plain form's every
# hypothesis failed (best SSD 1e12) only the border can have decided, and
# a value that is not finite or is denormal excuses nothing.
# RHO_TOL bounds the narrowed interval of a point whose decisions agree, in
# log inverse depth: RHO_TOL["steps"] of its grid step (the refine's delta
# carries the SSDs' rounding through the parabola, whose denominator the
# tie margin keeps from cancelling: at most 0.0069 of a step over 110
# captured calls on the H100 (PERF.md), where a point that takes another
# argmin moves by whole steps, and a refine off by 0.02 of a step fails)
# plus RHO_TOL["abs"] (the last bits of the logs and exponentials).
DECISION_TOL = {"quality_rel": 1e-3, "span_px": 1e-3, "ssd_rel": 1e-3, "tie_rel": 1e-3,
                "border_px": 1e-3}
RHO_TOL = {"steps": 1e-2, "abs": 1e-6}
_BIG = np.float32(1e12)     # a failed hypothesis's SSD

# in pointers, out pointers, dims, conf, probes, stream
ARGTYPES = [ctypes.c_void_p] * 6


def _check(arena, rows: torch.Tensor, T_hosts: SE3, host_valid: torch.Tensor,
           obs_grad: torch.Tensor, T_obs: SE3, cam: PinholeCamera, cfg: DirectConfig,
           probes: torch.Tensor | None) -> None:
    """Raise on what the kernel does not take (before anything is built)."""
    if cfg.trace_steps != STEPS:
        raise ValueError(f"trace_rows_cuda takes {STEPS} hypotheses, cfg has {cfg.trace_steps}")
    if PATTERN_N != PATTERN:
        raise ValueError(f"trace_rows_cuda takes an {PATTERN}-pixel pattern, not {PATTERN_N}")
    F, K = arena.valid.shape
    R = rows.shape[0]
    if not 0 < F <= MAX_ROWS or R > MAX_ROWS:
        raise ValueError(f"trace_rows_cuda takes 1-{MAX_ROWS} frame slots and at most "
                         f"{MAX_ROWS} traced rows, got F {F}, R {R}")
    if K == 0:
        raise ValueError("trace_rows_cuda needs a non-empty arena")
    if 3 * cam.height * cam.width >= 2 ** 31:
        raise ValueError("trace_rows_cuda indexes the image with 32-bit offsets: "
                         f"{cam.height} x {cam.width} x 3 is too large")
    dev, f32 = arena.uv.device, torch.float32
    for name, x, shape, dtype in (
            ("uv", arena.uv, (F, K, 2), f32), ("color", arena.color, (F, K, PATTERN), f32),
            ("rho_lo", arena.rho_lo, (F, K), f32), ("rho_hi", arena.rho_hi, (F, K), f32),
            ("n_ok", arena.n_ok, (F, K), torch.int32),
            ("n_fail", arena.n_fail, (F, K), torch.int32),
            ("valid", arena.valid, (F, K), torch.bool), ("rows", rows, (R,), torch.int32),
            ("T_hosts.R", T_hosts.R, (F, 3, 3), f32), ("T_hosts.t", T_hosts.t, (F, 3), f32),
            ("host_valid", host_valid, (F,), torch.bool),
            ("obs_grad", obs_grad, (cam.height, cam.width, 3), f32),
            ("T_obs.R", T_obs.R, (3, 3), f32), ("T_obs.t", T_obs.t, (3,), f32)):
        kb.check_tensor(name, x, shape, dtype, dev)
    if probes is not None:
        kb.check_tensor("probes", probes, (R, K, len(PROBE_FIELDS)), f32, dev)
    for name, x in (("uv", arena.uv), ("color", arena.color)):   # loaded as vectors
        if x.data_ptr() % VECTOR_ALIGN:
            raise ValueError(f"trace_rows_cuda loads {name} as {VECTOR_ALIGN}-byte vectors: "
                             f"its data must be {VECTOR_ALIGN}-byte aligned")
    if dev.type != "cuda":
        raise ValueError(f"trace_rows_cuda needs CUDA tensors, got {dev}")


def trace_rows_cuda(arena, rows: torch.Tensor, T_hosts: SE3, host_valid: torch.Tensor,
                    obs_grad: torch.Tensor, T_obs: SE3, cam: PinholeCamera, cfg: DirectConfig,
                    probes: torch.Tensor | None = None):
    """Launch the kernel on the current stream: trace_immatures_rows_plain's
    result (a new ImmatureArena; the inputs are not written). Every tensor
    contiguous on one CUDA device: the arena's fields, rows (R,) int32 (-1
    pads), T_hosts (F,), host_valid (F,) bool, obs_grad (H, W, 3) float32
    at cam's size, T_obs. `probes`, when given, an (R, K, 7) float32
    tensor: each swept point's PROBE_FIELDS are written at its trace's row
    (a point of a dead slot, an invalid one and the padding rows are left
    as they were). Counts its launches in `trace_rows_cuda.launches`."""
    _check(arena, rows, T_hosts, host_valid, obs_grad, T_obs, cam, cfg, probes)
    lib = kb.load(SOURCE, "trace_epipolar_launch", ARGTYPES)
    dev = arena.uv.device
    F, K = arena.valid.shape
    out = {f.name: torch.empty_like(getattr(arena, f.name)) for f in dataclasses.fields(arena)}
    ins = (arena.uv, arena.color, arena.rho_lo, arena.rho_hi, arena.n_ok, arena.n_fail,
           arena.valid, rows, T_hosts.R, T_hosts.t, host_valid, obs_grad, T_obs.R, T_obs.t)
    outs = (out["uv"], out["color"], out["rho_lo"], out["rho_hi"], out["n_ok"],
            out["n_fail"], out["valid"])
    dims = (ctypes.c_int * 5)(F, K, rows.shape[0], cam.height, cam.width)
    one = np.float32(1.0)
    conf = (ctypes.c_float * 8)(cam.fx, cam.fy, cam.cx, cam.cy, float(one / np.float32(STEPS - 1)),
                                cfg.trace_min_quality, float(one / np.float32(cam.fx)),
                                float(one / np.float32(cam.fy)))
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.trace_epipolar_launch(
            (ctypes.c_void_p * len(ins))(*(x.data_ptr() for x in ins)),
            (ctypes.c_void_p * len(outs))(*(x.data_ptr() for x in outs)), dims, conf,
            None if probes is None else probes.data_ptr(), stream)
    if err != 0:
        raise KernelLaunchError(f"trace_epipolar kernel launch failed: CUDA error {err}")
    trace_rows_cuda.launches += 1
    return type(arena)(**out)


trace_rows_cuda.launches = 0


def _sound(x: np.ndarray) -> np.ndarray:
    """Finite and not denormal: a value a probe can have computed."""
    return np.isfinite(x) & ((x == 0) | (np.abs(x) >= np.finfo(np.float32).tiny))


def _margins(p: np.ndarray, cfg: DirectConfig) -> dict:
    """Each deciding value's distance from its threshold, per point, from
    the plain form's probe rows (..., 7), in DECISION_TOL's units; inf (no
    excuse) where a value it reads is not sound, and for all but the
    border where every hypothesis failed."""
    best_ssd, runner, second, span, edge = (p[..., i] for i in range(1, 6))
    swept = best_ssd < _BIG
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        quality = second / np.maximum(best_ssd, np.float32(1e-6))
        q_min = cfg.trace_min_quality
        m = {"quality_rel": (np.abs(quality - q_min) / q_min, (second, best_ssd), swept),
             "span_px": (np.abs(span - 1.0), (span,), swept),
             "ssd_rel": (np.abs(best_ssd - 1152.0) / 1152.0, (best_ssd,), swept),
             "tie_rel": ((runner - best_ssd) / np.maximum(np.abs(best_ssd), 1e-6),
                         (runner, best_ssd), swept),
             "border_px": (edge, (edge,), True)}
    out = {}
    for n, (margin, reads, decides) in m.items():
        keep = np.logical_and.reduce([_sound(x) for x in reads]) & decides
        out[n] = np.where(keep, margin, np.inf)
    return out


def parity(got, want, probes: tuple[torch.Tensor, torch.Tensor], rows: torch.Tensor,
           cfg: DirectConfig) -> dict:
    """The kernel's arena `got` against the plain form's `want` on the same
    inputs, with `probes` = (the kernel's, the plain form's) probe rows of
    the call. Rows that are not traced, and every pixel and colour, must be
    equal bit for bit. A traced point must have equal statuses and its
    interval within RHO_TOL, unless a deciding value of the plain form sits
    within DECISION_TOL of its threshold (_margins): every such point is
    counted and listed with its margins. `ok` when nothing else differs.
    The kernel's probes only count its swept points and report its argmin.
    `max_abs_err`: the largest interval difference of the points that
    agree."""
    g = {f.name: getattr(got, f.name).detach().cpu().numpy() for f in dataclasses.fields(got)}
    w = {f.name: getattr(want, f.name).detach().cpu().numpy() for f in dataclasses.fields(want)}
    pk, pp = (p.detach().cpu().numpy() for p in probes)
    src: dict[int, int] = {}
    for r, f in enumerate(rows.cpu().tolist()):
        if f >= 0:
            src.setdefault(f, r)
    F = g["valid"].shape[0]
    copied = [f for f in range(F) if f not in src]
    untraced_equal = all(np.array_equal(g[n][copied], w[n][copied], equal_nan=True)
                         for n in g)
    pixels_equal = all(np.array_equal(g[n], w[n], equal_nan=True) for n in ("uv", "color"))
    differ, worst_rho, worst_abs, traced, swept = [], 0.0, 0.0, 0, 0
    for f, r in src.items():
        same = ((g["n_ok"][f] == w["n_ok"][f]) & (g["n_fail"][f] == w["n_fail"][f])
                & (g["valid"][f] == w["valid"][f]))
        dlog = pp[r, :, 6].astype(np.float64)
        gap, dev = np.zeros(same.shape), np.zeros(same.shape)
        for n in ("rho_lo", "rho_hi"):
            a, b = g[n][f].astype(np.float64), w[n][f].astype(np.float64)
            moved = a != b
            dev = np.maximum(dev, np.where(moved, np.abs(a - b), 0.0))
            with np.errstate(divide="ignore", invalid="ignore"):
                e = np.abs(np.log(a) - np.log(b)) - RHO_TOL["abs"]
                e = np.where(moved, e / np.maximum(dlog, 1e-30), 0.0)
            gap = np.maximum(gap, np.nan_to_num(e, nan=np.inf))
        bad = ~same | (gap > RHO_TOL["steps"])
        worst_rho = max(worst_rho, float(gap[~bad].max(initial=0.0)))
        worst_abs = max(worst_abs, float(dev[~bad].max(initial=0.0)))
        traced += same.size
        swept += int(np.isfinite(pk[r, :, 0]).sum())
        mp = _margins(pp[r], cfg)
        for k in np.flatnonzero(bad):
            margin = {n: float(mp[n][k]) for n in DECISION_TOL}
            near = {n: m for n, m in margin.items() if m <= DECISION_TOL[n]}
            differ.append({"row": f, "point": int(k), "statuses_equal": bool(same[k]),
                           "rho_steps": float(gap[k]), "best": [float(pk[r, k, 0]),
                                                                float(pp[r, k, 0])],
                           "within": near})
    ok = untraced_equal and pixels_equal and all(d["within"] for d in differ)
    return {"ok": ok, "traced_points": traced, "swept_points": swept,
            "untraced_equal": untraced_equal, "pixels_equal": pixels_equal,
            "max_rho_steps_agreeing": worst_rho, "max_abs_err": worst_abs,
            "differing": len(differ),
            "edge_points": differ}
