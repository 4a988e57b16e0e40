"""The direct tracker's coarse-to-fine LM as one CUDA kernel launch a solve.

  track_lm_cuda   hand-written sm_90a kernel (csrc/track_lm.cu): for B
                  starting poses, the complete LM loop of each listed pyramid
                  level in turn, one thread block cluster a hypothesis and
                  one sweep a step, ending every level on the device; no
                  host read inside the loop. It replaces the
                  JAX package's `_track_level` while loop
                  (libcml_tpu/models/direct/tracker.py:118), chained by
                  `track` and vmapped by `track_multi`.

Its plain PyTorch form, the CPU path and the yardstick on the card, is
`models/direct/tracker.track_levels_plain` (same arguments and outputs);
`tracker._track_levels` dispatches between the two by the tensors' device.
The kernel builds with nvcc on first use (ops/kernel_build.py).
"""

from __future__ import annotations

import ctypes
from collections.abc import Sequence

import numpy as np
import torch

from libcml_tpu_torch.core.camera import PinholeCamera
from libcml_tpu_torch.models.direct.config import DirectConfig
from libcml_tpu_torch.models.direct.residuals import huber_energy
from libcml_tpu_torch.ops import kernel_build as kb
from libcml_tpu_torch.ops.kernel_build import KernelLaunchError

SOURCE = kb.CSRC / "track_lm.cu"
MAX_LEVELS = 8          # csrc/track_lm.cu MAX_LEVELS

# How far the kernel may sit from its plain form on the same inputs. The
# two sum the normal equations and energies in other orders, and nvcc
# contracts products into FMAs. The residual is a difference of values of
# ~100 grey levels (an interpolated intensity, the brightness-corrected
# reference) that is ~0.1 near convergence, so rounding in its fourth digit
# moves the energies, and the step is solved from a gradient b that cancels
# to nearly 0 there, so |dx| carries b's rounding. Near convergence a step's
# accept test (E_new < E) or its convergence test (|dx| <
# tracker_converge_eps) can then go either way, and a level takes other
# steps: on the H100 (chip_smoke.py phase 13, PERF.md PR 7) the first such
# decision sat within 4.2e-5 of E or at 0.86 x eps, and the results stayed
# within 5.2e-6 in R and t and 1.7e-4 in E. PARITY_TOL bounds the outputs
# (abs for R, t, ab; relative for E; b, in grey levels of 0-255, is the
# least constrained); DECISION_TOL says how near its threshold the first
# differing decision must sit: |E_new - E| within E_rel of E, or |dx|
# within a factor of step_factor of the threshold.
PARITY_TOL = {"R": 1e-3, "t": 1e-3, "ab": 5e-3, "E_rel": 1e-3}
DECISION_TOL = {"E_rel": 1e-3, "step_factor": 4.0}
# track's statistics at the result: relative for energy, flows and cov (to
# its largest entry; the 8x8 inverse of a sum in another order); points
# for num_valid and saturated, where a point at the in-bounds border or at
# 0.98 x the cutoff may count in one version and not the other
STATS_TOL = {"energy_rel": 1e-3, "flow_rel": 1e-3, "cov_rel": 1e-2, "points": 2}

_VP, _INT = ctypes.c_void_p, ctypes.c_int
ARGTYPES = ([_INT] + [_VP] * 3 + [_VP] * 4 + [_VP, _INT] + [_VP] * 4 + [_INT, _VP, _INT]
            + [_VP] * 6 + [_INT] + [_VP] * 3 + [_VP])


def _energy_cap(cfg: DirectConfig) -> float:
    """The capped Huber energy at the tracker's cutoff, in f32 as
    residuals.evaluate_residuals computes it."""
    return huber_energy(torch.tensor(cfg.tracker_cutoff, dtype=torch.float32),
                        cfg.huber_intensity).item()


def track_lm_cuda(grads: Sequence[torch.Tensor], cams: Sequence[PinholeCamera],
                  uv: Sequence[torch.Tensor], color: Sequence[torch.Tensor],
                  weight: Sequence[torch.Tensor], valid: Sequence[torch.Tensor],
                  idepth: torch.Tensor, R0: torch.Tensor, t0: torch.Tensor,
                  ab0: torch.Tensor, ab_center: torch.Tensor, cfg: DirectConfig,
                  stats: bool = False):
    """Launch the kernel on the current stream (one launch for all B
    hypotheses and every level). Per level, in the order run: grads (H, W,
    3), cams, uv (P, 2), color (P, 1), weight (P, 1) float32 and valid (P,)
    bool; then idepth (P,), R0 (B, 3, 3), t0 (B, 3), ab0 (B, 2) and
    ab_center (2,) float32; all contiguous on one CUDA device. Returns (R (B,
    3, 3), t (B, 3), ab (B, 2), E (B,), iterations (B, levels) int32, trace
    (B, levels, tracker_iters, 3): each step's E, E_new and |dx|, NaN past
    a level's last step, stats): with `stats` (track's), the statistics
    sweep at the last level, (energy, num_valid int64, cov_pose (6, 6),
    flow, flow_no_trans, saturated) each with a leading B; else None.
    Counts its launches in `track_lm_cuda.launches`."""
    dev = R0.device
    L, P, B = len(grads), idepth.shape[0], R0.shape[0]
    if not 1 <= L <= MAX_LEVELS or not (len(cams) == len(uv) == len(color) == len(weight)
                                         == len(valid) == L):
        raise ValueError(f"track_lm_cuda takes 1-{MAX_LEVELS} levels, each with every input")
    f32 = torch.float32
    for l in range(L):
        kb.check_tensor(f"grads[{l}]", grads[l], (cams[l].height, cams[l].width, 3), f32, dev)
        kb.check_tensor(f"uv[{l}]", uv[l], (P, 2), f32, dev)
        kb.check_tensor(f"color[{l}]", color[l], (P, 1), f32, dev)
        kb.check_tensor(f"weight[{l}]", weight[l], (P, 1), f32, dev)
        kb.check_tensor(f"valid[{l}]", valid[l], (P,), torch.bool, dev)
    kb.check_tensor("idepth", idepth, (P,), f32, dev)
    kb.check_tensor("R0", R0, (B, 3, 3), f32, dev)
    kb.check_tensor("t0", t0, (B, 3), f32, dev)
    kb.check_tensor("ab0", ab0, (B, 2), f32, dev)
    kb.check_tensor("ab_center", ab_center, (2,), f32, dev)
    if dev.type != "cuda":
        raise ValueError(f"track_lm_cuda needs CUDA tensors, got {dev}")
    if B == 0:
        raise ValueError("track_lm_cuda needs at least one hypothesis")
    lib = kb.load(SOURCE, "track_lm_launch", ARGTYPES)

    def ptrs(ts):
        return (ctypes.c_void_p * L)(*(x.data_ptr() for x in ts))

    hw = (ctypes.c_int * (2 * L))(*(v for c in cams for v in (c.height, c.width)))
    cam = (ctypes.c_float * (4 * L))(*(v for c in cams for v in (c.fx, c.fy, c.cx, c.cy)))
    k = cfg.huber_intensity
    scales = (cfg.scale_trans,) * 3 + (cfg.scale_rot,) * 3 + (cfg.scale_a, cfg.scale_b)
    conf = (ctypes.c_float * 14)(k, float(np.float32(0.5 * k)), cfg.tracker_cutoff,
                                 _energy_cap(cfg), cfg.tracker_converge_eps, *scales,
                                 float(np.float32(0.98 * cfg.tracker_cutoff)))
    R = torch.empty((B, 3, 3), dtype=f32, device=dev)
    t = torch.empty((B, 3), dtype=f32, device=dev)
    ab = torch.empty((B, 2), dtype=f32, device=dev)
    E = torch.empty((B,), dtype=f32, device=dev)
    iters = torch.empty((B, L), dtype=torch.int32, device=dev)
    trace = torch.empty((B, L, cfg.tracker_iters, 3), dtype=f32, device=dev)
    stat = torch.empty((B, 4), dtype=f32, device=dev) if stats else None
    nvalid = torch.empty((B,), dtype=torch.int64, device=dev) if stats else None
    cov = torch.empty((B, 6, 6), dtype=f32, device=dev) if stats else None
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.track_lm_launch(
            L, ptrs(grads), hw, cam, ptrs(uv), ptrs(color), ptrs(weight), ptrs(valid),
            idepth.data_ptr(), P, R0.data_ptr(), t0.data_ptr(), ab0.data_ptr(),
            ab_center.data_ptr(), B, conf, cfg.tracker_iters, R.data_ptr(), t.data_ptr(),
            ab.data_ptr(), E.data_ptr(), iters.data_ptr(), trace.data_ptr(), int(stats),
            *(None if x is None else x.data_ptr() for x in (stat, nvalid, cov)), stream)
    if err != 0:
        raise KernelLaunchError(f"track_lm kernel launch failed: CUDA error {err}")
    track_lm_cuda.launches += 1
    out = None if not stats else (stat[:, 0], nvalid, cov, stat[:, 1], stat[:, 2], stat[:, 3])
    return R, t, ab, E, iters, trace, out


track_lm_cuda.launches = 0


def cluster_info(device: torch.device | None = None) -> dict:
    """The kernel's cluster size (blocks a solve) and how many such clusters
    the card holds at once (cudaOccupancyMaxActiveClusters)."""
    return kb.cluster_info(SOURCE, "track_lm_cluster_info", device)


def _decisions(trace: np.ndarray, steps: int) -> list[tuple[bool, bool]]:
    """(accepted, ended the level) of each step run."""
    return [(bool(trace[j, 1] < trace[j, 0]), j == steps - 1) for j in range(steps)]


def parity(got, want, cfg: DirectConfig) -> dict:
    """The kernel's outputs `got` against the plain form's `want` on the same
    inputs (track_lm_cuda's and track_levels_plain's tuples): the largest
    errors, and every hypothesis whose steps differ with the first step
    whose decision differs and that decision's margin (from the plain
    form's trace). `ok` when the errors are within PARITY_TOL and every such
    decision sits within DECISION_TOL of its threshold."""
    g = [x.detach().cpu().numpy() for x in got[:6]]
    w = [x.detach().cpu().numpy() for x in want[:6]]
    E_scale = np.maximum(np.abs(w[3]), 1e-30)
    err = {"R": float(np.abs(g[0] - w[0]).max()), "t": float(np.abs(g[1] - w[1]).max()),
           "ab": float(np.abs(g[2] - w[2]).max()),
           "E_rel": float((np.abs(g[3] - w[3]) / E_scale).max())}
    finite = bool(np.isfinite(g[0]).all() == np.isfinite(w[0]).all()
                  and np.isfinite(g[1]).all() == np.isfinite(w[1]).all())
    eps = cfg.tracker_converge_eps
    diverged = []
    for h in range(g[4].shape[0]):
        if np.array_equal(g[4][h], w[4][h]):
            continue
        case = {"hypothesis": h, "steps": g[4][h].tolist(), "plain_steps": w[4][h].tolist()}
        for lv in range(g[4].shape[1]):
            dg = _decisions(g[5][h, lv], int(g[4][h, lv]))
            dw = _decisions(w[5][h, lv], int(w[4][h, lv]))
            j = next((j for j in range(min(len(dg), len(dw))) if dg[j] != dw[j]), None)
            if j is None:
                continue
            E, E_new, norm = (float(v) for v in w[5][h, lv, j])
            if dg[j][0] != dw[j][0]:
                margin = abs(E_new - E) / max(abs(E), 1e-30)
                case.update(level=lv, step=j, decision="accept", margin=margin,
                            within=margin <= DECISION_TOL["E_rel"])
            else:
                ratio = norm / eps
                f = DECISION_TOL["step_factor"]
                case.update(level=lv, step=j, decision="converged", step_over_eps=ratio,
                            within=1.0 / f <= ratio <= f)
            break
        diverged.append(case)
    ok = (finite and all(err[k] <= PARITY_TOL[k] for k in PARITY_TOL)
          and all(c.get("within", False) for c in diverged))
    stats = None
    if got[6] is not None and want[6] is not None:
        gs = [x.detach().cpu().numpy().astype(np.float64) for x in got[6]]
        ws = [x.detach().cpu().numpy().astype(np.float64) for x in want[6]]
        n = np.maximum(ws[1], 1.0)

        def rel(i):
            return float((np.abs(gs[i] - ws[i]) / np.maximum(np.abs(ws[i]), 1e-30)).max())

        stats = {"energy_rel": rel(0), "num_valid": float(np.abs(gs[1] - ws[1]).max()),
                 "cov_rel": float(np.abs(gs[2] - ws[2]).max() / max(np.abs(ws[2]).max(), 1e-30)),
                 "flow_rel": max(rel(3), rel(4)),
                 "saturated_points": float((np.abs(gs[5] - ws[5]) * n).max())}
        ok = ok and all(stats[k] <= STATS_TOL[k] for k in ("energy_rel", "flow_rel", "cov_rel"))
        ok = ok and max(stats["num_valid"], stats["saturated_points"]) <= STATS_TOL["points"]
    return {"ok": ok, "max_err": err, "finite_alike": finite, "diverged": diverged,
            "stats_err": stats}
