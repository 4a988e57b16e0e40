"""Smoke run of libcml_tpu_torch on one CUDA card (an NVIDIA H100).

    python3 chip_smoke.py

Phases (any failure exits non-zero, and no result line is printed):
  0. the card: `nvidia-smi` name and power limit, torch's device name;
     exits non-zero without CUDA.
  1. build the three hand-written kernels (csrc/hamming_match.cu,
     track_lm.cu, pnp_lm.cu) from the sources in this checkout, one nvcc
     each, all started together.
  2. the kernel against its plain PyTorch version on the card, at the
     main path's shapes (random masks and frame 1's real phase-4 masks)
     and at edge cases, exact equality required; kernel times with CUDA
     events, cold L2 and warm, the plain version's (cold), the launches
     and device operations a call makes (torch.profiler), and the kernel's bound
     (HBM bytes or popcounts at the card's highest SM clock, whichever
     takes longer) with the share of it that the cold time reaches; a
     share above 1 fails the run.
  3. direct path at full width: DirectOdometry with bench.py's config on 60
     rendered 640x480 frames; fps, ATE < 0.1, no lost segment.
  4. hybrid tracking programs at full width: ORB (512 per level, 3 levels)
     on the same frames, a 4096-slot map from frame 0, then per frame
     _project_match_pnp and _local_map_pass2; every frame must launch the
     Hamming kernel twice, keep >= 12 PnP inliers and stay within the
     two-view pose budget (0.04 translation, 0.01 rad).
  5. the full sequential HybridOdometry (bench.py's hybrid) on the same 60
     frames, after building the BoW vocabulary (timed apart): fps, ATE,
     keyframes, indirect keyframes, map points, modes, mixed-BA events and
     rollbacks, local-BA events, and the kernel's launches per call site;
     ATE < 0.1, no lost segment, and at least one indirect keyframe that
     triangulated points and completed a local BA.
  6. relocalization at full width: 24 frames, 4 black frames, then frame
     20 again (tests/test_recovery.py's run, one stored keyframe later:
     workload.py says why); it must relocalize within 3 frames, within 0.15
     of frame 20's earlier estimate.
  7. the entry points: the corridor of the port's bench (data/corridor.py),
     its first 60 frames written at 640x480 as a KITTI layout by the port's
     writer, then `libcml_tpu_torch.cli.main` on it with presets/modslam.yaml
     (ORB 800 per level: the kernel meets 4096x2400): the five-file export,
     stats.csv and run.json, ATE < 0.1, no lost segment, kernel launches,
     and the first match_projection resolution of the run as a real-input
     kernel case.
  8. repeatability and resume, on that sequence read back through
     KittiCapture: bench.py's hybrid over 24 frames twice (the second saves
     its state before frame 16 and goes on), then a fresh instance loads the
     file and runs frames 16-23; trajectories, map arena and modes must be
     bit-identical, and the same for DirectOdometry (trajectory and window).
     The card's checkpoint must load into an instance on the CPU. Before it,
     a probe runs the hybrid and the direct path under
     torch.use_deterministic_algorithms(True, warn_only=True) and lists the
     operations torch warns about.
  9. the pipelined direct mode (DirectOdometry(pipelined=True), the lag-1
     finalize) on phase 3's frames: fps, ATE < 0.1, no lost segment, its
     keyframe frames beside phase 3's, and the host's stream/event syncs and
     memcpys a frame of both modes (torch.profiler, frames 15-19 of a fresh
     run each).
 10. the hybrid pipelined (every keyframe postprocess tick staged over later
     frames) and sequential with staged BA ticks (staged_indpost=True), each
     on phase 5's 60 frames: ATE < 0.1, no lost segment, an indirect keyframe
     event that triangulated and completed its local BA through the ticks,
     a tick that ran after its keyframe's frame, nothing left in flight, and
     the kernel's launches per call site; the pipelined run's first
     keyframe-postprocess match_projection with a live map row (whose
     results the staged tick reads) becomes a real-input kernel case.
 11. CalibSlam on 24 frames rendered through radtan distortion (k1 -0.12,
     k2 0.02, yaw 0.02 a frame): the fitted k1 negative and the fitted remap
     closer to the true one than the identity; then DirectOdometry on phase
     3's frames initialized from a depth-prior callable that returns the
     renderer's inverse depth (ATE < 0.1).
 12. sharded BA and the last modules: DirectOdometry(mesh=make_mesh()) and
     the hybrid with the same mesh (a world of one, NCCL) on phase 3's and
     phase 5's 60 frames; trajectories, windows and maps bit-identical to
     phases 3 and 5 (a world of one is the unsharded arithmetic plus
     identity collectives); fps and the all-reduces and all-gathers a frame.
     Then orb.match_ratio on frames 0 and 1's real ORB features (1536x1536):
     idx_b and good equal to its plain version on the card, one launch, and
     its resolution as a phase-2 kernel case.
 13. the LM kernels: track_lm (the tracker's coarse-to-fine LM, one launch
     a solve) and pnp_lm (motion-only PnP, one launch a solve) against their
     plain forms on the card (track_lm.parity, pnp_lm.parity: outputs within
     PARITY_TOL, and a start whose steps differ, or a match classified
     otherwise, only where its first differing decision sits within
     DECISION_TOL of its threshold; every such case is printed) on inputs
     captured in phases 3, 5 and 6: two `track` launches of phase 3, the
     recovery battery about the first (15 starts, an exact tie among them),
     the first battery the runs made, phase 5's two PnP passes of one frame
     (`_project_match_pnp`, `_local_map_pass2`), relocalization's EPnP refine,
     the all-invalid cases, and a `track` and a PnP pass with every point
     three times (past the points a thread holds in registers); one launch
     a call (counted and profiled), cold and warm ms (median of 30),
     microseconds an LM step, the plain form's ms (median of 5), the bound
     (bytes, or f32 operations of the sweeps and systems the run's steps
     need) and its share. Then
     `track` on the card with every point invalid (finite, no valid point,
     zero energy), `track_multi` (2 track_lm launches), and the host waits
     of a track, track_multi and PnP call, which must be none (no sync, no
     copy); the starts whose levels took other steps than the plain form,
     counted; last, the kernels' cluster size (8) and the clusters the card
     holds at once (cudaOccupancyMaxActiveClusters).
Every phase from 3 on reports the LM kernels' launches of its run (counted
from 0 just before it and read just after); phase 3 must launch track_lm on
every tracked frame, phase 4 pnp_lm twice a frame, phases 5 and 7 both.
Then phase 2's real-input cases captured in phases 5, 6 and 10 (the first
keyframe's epipolar band, a relocalization match_descriptors call, the
staged tick's match_projection) and 12 (match_ratio), held to the plain
version exactly; the phases' results, the card's name and power limit, the
kernel table ({"kernels": [...]}: for hamming_resolve the launches of the
paths' runs, phases 5, 7, 8, 10, 11 and 12, each counted from 0 just before
its run and read just after, with each path's count beside them; times and
bound of the phase-4 masks case, cold, and of the staged-tick and
match_ratio cases; for track_lm and pnp_lm the launches of every path's run
and the times and bound of phase 13's first case, each case beside them),
and the result line {"ok": true, "device": {...}} last.
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import warnings
from collections import Counter

import numpy as np
import torch
import torch.distributed as dist

from libcml_tpu_torch import cli
from libcml_tpu_torch import workload as wl
from libcml_tpu_torch.data import corridor
from libcml_tpu_torch.data.kitti import KittiCapture
from libcml_tpu_torch.eval.trajectory import ate_rmse
from libcml_tpu_torch.core.lie import SE3
from libcml_tpu_torch.models.direct import tracker
from libcml_tpu_torch.models.indirect import matching, orb
from libcml_tpu_torch.models.indirect import pnp as pnp_mod
from libcml_tpu_torch.models.indirect.bow import default_vocabulary
from libcml_tpu_torch.ops import hamming_match as hm
from libcml_tpu_torch.ops import kernel_build, pnp_lm, track_lm
from libcml_tpu_torch.parallel.sharding import make_mesh
from libcml_tpu_torch.runtime import hybrid, odometry
from libcml_tpu_torch.runtime.odometry import DirectOdometry

# published H100 SXM memory rate at 700 W (NVIDIA's data sheet)
HBM_BYTES_PER_S = 3.35e12
# published H100 SXM float32 rate outside the tensor cores at 700 W
F32_FLOP_PER_S = 67e12
# population count issues 16 per clock and SM on sm_90 (CUDA C++ Programming
# Guide, arithmetic instruction throughput, compute capability 9.0); the
# XOR and the adds of an entry go to the 64-per-clock integer pipe and take
# at most half as long, so popcount is the operations floor
POPC_PER_SM_CLOCK = 16

N_DIRECT = 60
WARMUP = 10                  # frames before the steady-state clock starts
HYBRID_FRAMES = range(1, 21)


class SmokeFailure(RuntimeError):
    pass


# the LM kernels' wrappers, whose launch counts each path's run reports
LM_KERNELS = {"track_lm": track_lm.track_lm_cuda, "pnp_lm": pnp_lm.pnp_lm_cuda}


def reset_launches() -> None:
    """Every kernel's launch count to 0 (just before a path's run)."""
    hm.hamming_resolve_cuda.launches = 0
    for fn in LM_KERNELS.values():
        fn.launches = 0


def lm_launches() -> dict:
    """The LM kernels' launch counts since the last reset_launches()."""
    return {name: fn.launches for name, fn in LM_KERNELS.items()}


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def nvidia_smi(query: str, *fmt: str) -> str:
    cmd = ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader" + "".join(fmt)]
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def popc_per_s() -> float:
    """The card's popcount rate: SMs x 16 per clock x its highest SM clock."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock_mhz = float(nvidia_smi("clocks.max.sm", ",nounits"))
    rate = sms * POPC_PER_SM_CLOCK * clock_mhz * 1e6
    print(f"popcount rate {rate:.6g}/s ({sms} SMs x {POPC_PER_SM_CLOCK} x {clock_mhz:g} MHz)")
    return rate


# a buffer larger than the 50 MB L2: writing it before a call evicts the
# call's inputs, so the call reads them from device memory
FLUSH_BYTES = 128 * 2**20
_flush: torch.Tensor | None = None


def cuda_ms(fn, reps: int = 30, warmup: int = 3, cold: bool = True) -> float:
    """Median device milliseconds of one call of `fn`, CUDA events around
    each call alone. Cold (the default): a 128 MB buffer is written before
    each call, outside the events, so the call finds its inputs out of L2;
    warm: the calls run back to back on the same inputs. A spin kernel first
    holds the card while the host queues every call, so the host's launch
    overhead stays out of the events' intervals."""
    global _flush
    if cold and _flush is None:
        _flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.int32, device="cuda")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
          for _ in range(reps)]
    torch.cuda._sleep(100_000_000)
    for i, (a, b) in enumerate(ev):
        if cold:
            _flush.fill_(i)
        a.record()
        fn()
        b.record()
    ev[-1][1].synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in ev)


# CUDA runtime and driver calls that put work on the device
ENQUEUE_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
                 "cudaLaunchCooperativeKernel", "cudaMemsetAsync", "cudaMemcpyAsync")


def launches_per_call(fn, calls: int = 10) -> tuple[float, float]:
    """(runtime calls that enqueue device work, device operations) per call
    of `fn`, from torch.profiler: the host's kernel launches, fills and
    copies (the ctypes library's launch included), and the kernels, fills
    and copies on the device timeline."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = prof.events()
    host = sum(e.device_type.name == "CPU" and e.name in ENQUEUE_CALLS for e in events)
    device = sum(e.device_type.name != "CPU" for e in events)
    return host / calls, device / calls


# -- phase 2 ------------------------------------------------------------------


def hamming_bound(args, popc_rate: float) -> tuple[float, str, int]:
    """Least time for one resolution, in milliseconds: the larger of the bytes
    over the HBM rate and the popcounts over the card's popcount rate. Bytes:
    the pair-mask rows of the query rows whose mask_q is true (a masked row
    needs none of its row), both masks, the descriptors of the rows and
    columns that have a live entry, each read once, and d1/d2/idx/col_row
    written once. Popcounts: 8 for each live entry (one that all three masks
    leave). Also returns the number of live entries."""
    dq, mq, dt, mt, pm = args
    N, M = dq.shape[0], dt.shape[0]
    live = mq[:, None] & mt[None, :]
    if pm is not None:
        live &= pm
    pair_bytes = int(mq.sum()) * M if pm is not None else 0
    desc_bytes = (int(live.any(1).sum()) + int(live.any(0).sum())) * 32
    nbytes = pair_bytes + N + M + desc_bytes + N * 12 + M * 4
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    n_live = int(live.sum())
    t_ops = 8.0 * n_live / popc_rate * 1e3
    return (t_ops, "operations", n_live) if t_ops >= t_bytes else (t_bytes, "bytes", n_live)


def _dev(dev, *arrays):
    return tuple(None if a is None else torch.as_tensor(a).to(dev) for a in arrays)


def random_case(rng, N, M, dev, p_mask=0.2, pair="random"):
    dq = rng.integers(-2**31, 2**31, (N, 8), dtype=np.int64).astype(np.int32)
    dt = rng.integers(-2**31, 2**31, (M, 8), dtype=np.int64).astype(np.int32)
    mq = rng.random(N) > p_mask
    mt = rng.random(M) > p_mask
    if pair == "random":
        pm = rng.random((N, M)) > 0.3
    elif pair == "radius":
        # corners of a 640x480 frame vs projected points, 15 px * 1.5^level
        uq = rng.uniform([0, 0], [wl.W, wl.H], (N, 2))
        ut = rng.uniform([0, 0], [wl.W, wl.H], (M, 2))
        lq = rng.integers(0, 3, N)
        lt = rng.integers(0, 3, M)
        r = 15.0 * 1.5 ** lq
        d2 = ((uq[:, None] - ut[None]) ** 2).sum(-1)
        pm = (d2 <= (r * r)[:, None]) & (np.abs(lq[:, None] - lt[None]) <= 1)
    elif pair == "epipolar":
        # match_epipolar's test: squared distance of the train corner to the
        # query's epipolar line F [u, v, 1] within epi_tol; a sideways
        # translation gives near-horizontal lines, and epi_tol = 2.4^2 px^2
        # leaves a band of about 1 % of the frame
        uq = rng.uniform([0, 0], [wl.W, wl.H], (N, 2))
        ut = rng.uniform([0, 0], [wl.W, wl.H], (M, 2))
        F = np.array([[0.0, -0.1, 0.0], [0.1, 0.0, -1.0], [0.0, 1.0, 0.0]])
        lines = np.c_[uq, np.ones(N)] @ F.T
        num = lines @ np.c_[ut, np.ones(M)].T
        d2 = num ** 2 / np.maximum(lines[:, 0] ** 2 + lines[:, 1] ** 2, 1e-9)[:, None]
        pm = d2 <= 2.4 ** 2
    else:
        pm = None
    return _dev(dev, dq, mq, dt, mt, pm)


def edge_case(rng, dev):
    """All-masked row and column, exact distance ties (duplicate train
    descriptors), a query identical to two train columns."""
    N, M = 40, 70
    dq, mq, dt, mt, pm = (x.cpu().numpy() for x in random_case(rng, N, M, "cpu"))
    dt[10] = dt[20] = dt[30] = dq[5]          # d1 == d2 == 0 for row 5, ties
    dt[40:50] = dt[0]                          # many exact ties
    dq[6] = dq[7]                              # two rows tie for each column
    mq[:] = True
    mt[:] = True
    mq[3] = False                              # fully masked row
    mt[4] = False                              # fully masked column
    pm[:, 60] = False                          # column masked by the pair mask
    pm[8, :] = False                           # row masked by the pair mask
    return _dev(dev, dq, mq, dt, mt, pm)


PHASE4_CASE = "4096x1536 phase-4 masks (frame 1, match_projection)"


def kernel_vs_plain(dev, card: str, popc_rate: float, phase4_args) -> tuple[list[dict], float]:
    rng = np.random.default_rng(11)
    cases = [
        ("67x301 random masks + pair", random_case(rng, 67, 301, dev)),
        ("4096x1536 radius pair (match_projection)", random_case(rng, 4096, 1536, dev,
                                                                pair="radius")),
        ("1536x1536 radius pair (match_window)", random_case(rng, 1536, 1536, dev,
                                                            pair="radius")),
        ("1536x1536 no pair (match_descriptors)", random_case(rng, 1536, 1536, dev,
                                                             pair=None)),
        ("edge cases: masked row/column, ties", edge_case(rng, dev)),
        (PHASE4_CASE, phase4_args),
        ("1536x1536 epipolar band (match_epipolar)", random_case(rng, 1536, 1536, dev,
                                                                pair="epipolar")),
        ("1x1", random_case(rng, 1, 1, dev, p_mask=0.0, pair=None)),
        ("4096x17 unaligned M", random_case(rng, 4096, 17, dev)),
    ]
    # the fixed cost of any call timed this way: one one-element PyTorch
    # kernel between the same events
    tiny = torch.zeros(1, device=dev)
    print(json.dumps({"launch_floor_ms": cuda_ms(lambda: tiny.add_(1)),
                      "launch_floor_warm_ms": cuda_ms(lambda: tiny.add_(1), cold=False),
                      "card": card}))
    rows = [kernel_case(name, args, card, popc_rate) for name, args in cases]
    return rows, max(r["max_abs_err"] for r in rows)


def kernel_case(name: str, args, card: str, popc_rate: float) -> dict:
    """One phase-2 case: the kernel's outputs equal to the plain version's
    (else the run fails), its times, launches and bound."""
    got = hm.hamming_resolve_cuda(*args)
    want = hm.hamming_resolve_plain(*args)
    torch.cuda.synchronize()
    max_err = 0.0
    for g, w_, what in zip(got, want, ("d1", "d2", "idx", "col_row")):
        max_err = max(max_err, float((g.long() - w_.long()).abs().max()))
        require(torch.equal(g, w_), f"hamming kernel != plain on {name}: {what}")
    N, M = args[0].shape[0], args[2].shape[0]
    bound, by, n_live = hamming_bound(args, popc_rate)
    kernel_ms = cuda_ms(lambda: hm.hamming_resolve_cuda(*args))
    launches, device_ops = launches_per_call(lambda: hm.hamming_resolve_cuda(*args))
    pm = args[4]
    row = {"case": name, "N": N, "M": M,
           "kernel_ms": kernel_ms,
           "kernel_warm_ms": cuda_ms(lambda: hm.hamming_resolve_cuda(*args), cold=False),
           "plain_ms": cuda_ms(lambda: hm.hamming_resolve_plain(*args), reps=20),
           "bound_ms": bound, "bound_by": by, "bound_share": bound / kernel_ms,
           "launches_per_call": launches, "device_ops_per_call": device_ops,
           "live_rows": int(args[1].sum()), "live_entries": n_live,
           "pair_density": None if pm is None else float(pm.float().mean()),
           # the popcounts of all N * M entries (a kernel that skips no entry)
           "dense_popc_ms": 8.0 * N * M / popc_rate * 1e3,
           "equal": True, "max_abs_err": max_err, "card": card}
    print(json.dumps(row))
    require(row["bound_share"] <= 1.0,
            f"{name}: {kernel_ms} ms is under its bound {bound} ms: the bound is wrong")
    return row


# -- phases 3 and 4 -----------------------------------------------------------


def direct_phase(dev, cam, traj, frames) -> tuple[dict, dict]:
    odo = DirectOdometry(cam, wl.BENCH_CFG)         # default device: the card
    imgs = [f[0].cpu().numpy() for f in frames[:N_DIRECT]]
    gt = []
    kf = lost = 0
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    for i, img in enumerate(imgs):
        if i == WARMUP:
            torch.cuda.synchronize()
            t_steady = time.perf_counter()
        out = odo.process(img, float(i))
        kf += int(bool(out.get("kf", False)))
        lost += int(out.get("state") == "LOST")
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    wall = t_end - t0
    launches = hm.hamming_resolve_cuda.launches   # the direct path runs no Hamming kernel
    lm = lm_launches()
    for R, t in traj[:N_DIRECT]:
        M = np.eye(4)
        M[:3, :3], M[:3, 3] = R, t
        gt.append(np.linalg.inv(M))
    _, est = odo.trajectory_c2w()
    ate = ate_rmse(est[:, :3, 3], np.asarray(gt)[:, :3, 3], with_scale=True)
    # host milliseconds per stage (enqueue plus the syncs inside the stage)
    host_ms = {name: statistics.mean(odo.sheet.stat(name).series()[1])
               for name in ("time_preprocess", "time_track", "time_keyframe")}
    res = {"phase": "direct", "frames": len(imgs), "fps": len(imgs) / wall,
           "steady_fps": (len(imgs) - WARMUP) / (t_end - t_steady),
           "wall_s": wall, "ate": ate, "segments": odo.segments, "lost_frames": lost,
           "keyframes": kf, "keyframe_frames": _keyframe_frames(odo),
           "host_ms_per_stage": host_ms,
           "kernel_launches": {"hamming_resolve": launches, **lm}}
    print(json.dumps(res))
    require(np.isfinite(ate) and ate < 0.1, f"direct ATE {ate} >= 0.1")
    require(lm["track_lm"] >= len(imgs) - WARMUP and lm["pnp_lm"] == 0,
            f"the direct path's LM launches {lm}")
    require(odo.segments == 0 and lost == 0, "direct path lost tracking")
    return res, _snapshot(odo)


def hybrid_phase(dev, cam, traj, frames) -> dict:
    map_, n_map = wl.build_map(cam, traj, frames, dev)
    feats = {i: wl.extract(frames[i]) for i in HYBRID_FRAMES}
    torch.cuda.synchronize()
    reset_launches()
    per_frame = []
    for i in HYBRID_FRAMES:
        before = hm.hamming_resolve_cuda.launches
        pnp_before = pnp_lm.pnp_lm_cuda.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res, bundle, bundle2 = wl.track_frame(map_, cam, traj, feats[i], i, dev)
        b1, b2 = bundle.cpu().numpy(), bundle2.cpu().numpy()
        ms = (time.perf_counter() - t0) * 1e3
        R_gt, t_gt = traj[i]
        R_est = res.T.R.cpu().numpy().astype(np.float64)
        t_err = float(np.linalg.norm(res.T.t.cpu().numpy() - t_gt))
        r_err = float(np.arccos(np.clip((np.trace(R_est @ R_gt.T) - 1) / 2, -1, 1)))
        launched = hm.hamming_resolve_cuda.launches - before
        pnp_launched = pnp_lm.pnp_lm_cuda.launches - pnp_before
        row = {"frame": i, "matches": int(b1[0]), "inliers": int(b1[1]),
               "pass2_matches": int(b2[0]), "pass2_inliers": int(b2[1]),
               "t_err": t_err, "r_err": r_err, "ms": ms, "kernel_launches": launched,
               "pnp_lm_launches": pnp_launched}
        per_frame.append(row)
        print(json.dumps(row))
        require(launched == 2, f"frame {i}: {launched} kernel launches, expected 2")
        require(pnp_launched == 2, f"frame {i}: {pnp_launched} PnP kernel launches, expected 2")
        require(b1[2] > 0.5 and b1[1] >= 12 and b2[1] >= 12,
                f"frame {i}: PnP failed ({b1[1]} / {b2[1]} inliers)")
        require(t_err < 0.04 and r_err < 0.01,
                f"frame {i}: pose error {t_err:.4f} / {r_err:.4f} rad out of budget")
    launches = hm.hamming_resolve_cuda.launches
    res = {"phase": "hybrid_tracking", "frames": len(per_frame), "map_points": n_map,
           "launches": launches, "lm_launches": lm_launches(),
           "ms_per_frame": statistics.median(r["ms"] for r in per_frame),
           "min_inliers": min(r["inliers"] for r in per_frame),
           "max_t_err": max(r["t_err"] for r in per_frame),
           "max_r_err": max(r["r_err"] for r in per_frame)}
    print(json.dumps(res))
    require(launches == 2 * len(per_frame), "kernel launch count off")
    return res


# -- phases 5 and 6 ------------------------------------------------------------

# the hybrid's six Hamming call sites, functions of runtime/hybrid.py that
# HybridOdometry looks up at call time (runtime/hybrid.py, "Device programs")
CALL_SITES = ("_project_match_pnp", "_local_map_pass2", "_epipolar_triangulate",
              "_map_projection_match", "match_window", "match_descriptors")


class CallSites:
    """Counts the kernel's launches inside each call site, and keeps (cloned)
    the resolution inputs of the first call of the sites named in
    `capture_at`, for phase 2's real-input cases."""

    def __init__(self):
        self.launches = Counter()
        self.calls = Counter()
        self.captured: dict[str, tuple] = {}
        self.capture_at: set[str] = set()
        self.capture_live = False    # capture only a call with a live query row
        self._site: str | None = None
        self._saved = {name: getattr(hybrid, name) for name in CALL_SITES}
        self._resolve = matching.hamming_resolve

    def _wrap(self, name, fn):
        def run(*args, **kw):
            before, outer = hm.hamming_resolve_cuda.launches, self._site
            self._site = name
            try:
                return fn(*args, **kw)
            finally:
                self._site = outer
                self.launches[name] += hm.hamming_resolve_cuda.launches - before
                self.calls[name] += 1
        return run

    def _capture(self, *args):
        if (self._site in self.capture_at and self._site not in self.captured
                and (not self.capture_live or bool(args[1].any()))):
            self.captured[self._site] = tuple(None if a is None else a.clone() for a in args)
        return self._resolve(*args)

    def __enter__(self):
        for name, fn in self._saved.items():
            setattr(hybrid, name, self._wrap(name, fn))
        matching.hamming_resolve = self._capture
        return self

    def __exit__(self, *exc):
        for name, fn in self._saved.items():
            setattr(hybrid, name, fn)
        matching.hamming_resolve = self._resolve


def gt_centres(traj) -> np.ndarray:
    out = []
    for R, t in traj:
        M = np.eye(4)
        M[:3, :3], M[:3, 3] = R, t
        out.append(np.linalg.inv(M)[:3, 3])
    return np.asarray(out)


def watch_hybrid(odo) -> Counter:
    """Counts the hybrid's keyframe events on `odo`: indirect keyframes, the
    points each triangulated, mixed-BA completions, local-BA write-backs, and the kernel launches inside the keyframe postprocess.
    `ok_kf` counts the indirect keyframes that triangulated points and then
    completed a local BA."""
    ev = Counter()
    cur = {}

    def wrap(name, before=None, after=None):
        fn = getattr(odo, name)

        def run(*args, **kw):
            if before:
                before(*args)
            out = fn(*args, **kw)
            if after:
                after(*args)
            return out
        setattr(odo, name, run)

    def kf_start(*_):
        ev["indirect_keyframes"] += 1
        cur.update(tri=0, lba=False, launches=hm.hamming_resolve_cuda.launches)

    def kf_end(*_):
        ev["kf_launches"] += hm.hamming_resolve_cuda.launches - cur["launches"]
        ev["ok_kf"] += int(cur["tri"] > 0 and cur["lba"])

    def added(Xw, desc, level, ok):
        cur["tri"] = cur.get("tri", 0) + int(np.sum(ok))
        ev["triangulated"] += int(np.sum(ok))

    def lba(lb, fetched):
        if np.isfinite(fetched[0]).all():
            cur["lba"] = True
            ev["local_ba"] += 1

    def mixed(*_):
        ev["mixed_ba"] += 1

    wrap("_indirect_postprocess", kf_start, kf_end)
    wrap("_add_map_points", added)
    wrap("_complete_indirect_local_ba", lba)
    wrap("_complete_mixed_window_ba", mixed)
    return ev


def full_hybrid_phase(dev, cam, traj, frames, sites: CallSites) -> tuple[dict, dict]:
    t0 = time.perf_counter()
    voc = default_vocabulary()
    voc_s = time.perf_counter() - t0
    print(f"BoW vocabulary: {voc.num_words} words in {voc_s:.1f} s (before the timed loop)")
    odo = wl.hybrid_odometry(cam, dev=dev)
    ev = watch_hybrid(odo)
    imgs = [f[0].cpu().numpy() for f in frames[:N_DIRECT]]
    kf = lost = 0
    sites.capture_at = {"_epipolar_triangulate"}
    torch.cuda.synchronize()
    reset_launches()
    sites.launches.clear()
    sites.calls.clear()
    t0 = time.perf_counter()
    for i, img in enumerate(imgs):
        if i == WARMUP:
            torch.cuda.synchronize()
            t_steady = time.perf_counter()
        out = odo.process(img, float(i))
        kf += int(bool(out.get("kf", False)))
        lost += int(out.get("state") == "LOST")
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    launches = hm.hamming_resolve_cuda.launches
    lm = lm_launches()
    wall = t_end - t0
    _, est = odo.trajectory_c2w()
    ate = ate_rmse(est[:, :3, 3], gt_centres(traj[:N_DIRECT]), with_scale=True)
    host_ms = {name: statistics.mean(odo.sheet.stat(name).series()[1])
               for name in ("time_preprocess", "time_orb", "time_pnp", "time_track",
                            "time_keyframe", "time_ind_post", "time_mixed_ba", "time_local_ba")
               if odo.sheet.stat(name).series()[1]}
    n = len(imgs)
    res = {"phase": "hybrid", "frames": n, "fps": n / wall,
           "steady_fps": (n - WARMUP) / (t_end - t_steady), "wall_s": wall,
           "vocabulary_s": voc_s, "ate": ate, "segments": odo.segments, "lost_frames": lost,
           "keyframes": kf, "indirect_keyframes": ev["indirect_keyframes"],
           "indirect_keyframe_frames": [k["frame"] for k in odo._ind_kfs],
           "map_points": int(odo._pt_valid.sum()), "triangulated": ev["triangulated"],
           "modes": dict(Counter(odo.mode_history)),
           "mixed_ba": ev["mixed_ba"],
           "mixed_ba_rollbacks": len(odo.sheet.stat("mixed_ba_rollback").series()[1]),
           "local_ba": ev["local_ba"], "keyframes_triangulated_and_local_ba": ev["ok_kf"],
           "kernel_launches": launches, "kernel_launches_per_frame": launches / n,
           "kernel_launches_per_indirect_keyframe":
               ev["kf_launches"] / max(ev["indirect_keyframes"], 1),
           "launches_per_site": dict(sites.launches),
           "launches_per_site_per_frame": {k: v / n for k, v in sites.launches.items()},
           "calls_per_site": dict(sites.calls), "host_ms_per_stage": host_ms,
           "lm_launches": lm, "lm_launches_per_frame": {k: v / n for k, v in lm.items()}}
    print(json.dumps(res))
    require(np.isfinite(ate) and ate < 0.1, f"hybrid ATE {ate} >= 0.1")
    require(lm["track_lm"] > 0 and lm["pnp_lm"] > 0, f"the hybrid's LM launches {lm}")
    require(odo.segments == 0 and lost == 0, "hybrid lost tracking")
    require(ev["ok_kf"] >= 1, "no indirect keyframe triangulated points and completed a local BA")
    require(launches == sum(sites.launches.values()),
            "kernel launched outside the six call sites")
    # the four sites a tracked run reaches (match_window serves the bootstrap,
    # match_descriptors the relocalization of phase 6)
    for site in CALL_SITES[:4]:
        require(sites.launches[site] > 0, f"the hybrid launched no kernel at {site}")
    return res, _snapshot(odo)


def relocalization_phase(dev, cam, traj, frames, sites: CallSites) -> dict:
    odo = wl.hybrid_odometry(cam, wl.RELOC_CFG, dev=dev)
    seq = wl.relocalization_frames(frames)
    sites.capture_at = {"match_descriptors"}
    torch.cuda.synchronize()
    reset_launches()
    sites.launches.clear()
    sites.calls.clear()
    states, at, view_before = [], None, None
    t0 = time.perf_counter()
    for k, (view, img) in enumerate(seq):
        out = odo.process(img, float(k))
        states.append(out.get("state"))
        if k == wl.RELOC_SEEN - 1:
            require(odo.state == "TRACKING", f"not tracking before the blackout: {odo.state}")
            _, est = odo.trajectory_c2w()
            view_before = est[wl.RELOC_VIEW, :3, 3].copy()
        if out.get("relocalized"):
            at = k
            break
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = hm.hamming_resolve_cuda.launches
    lm = lm_launches()
    require(at is not None, f"never relocalized (states {states})")
    _, est = odo.trajectory_c2w()
    err = float(np.linalg.norm(est[-1, :3, 3] - view_before))
    res = {"phase": "relocalization", "frames": len(states), "relocalized_at": at,
           "black_frames": wl.RELOC_BLACK, "error": err, "states": states,
           "segments": odo.segments, "map_points": int(odo._pt_valid.sum()),
           "stored_keyframes": len(odo._kf_store), "wall_s": wall,
           "kernel_launches": launches, "launches_per_site": dict(sites.launches),
           "lm_launches": lm}
    print(json.dumps(res))
    require(err < 0.15, f"relocalized pose off by {err:.3f}")
    require(sites.launches["match_descriptors"] >= 1, "relocalization ran no descriptor match")
    return res


# -- phases 7 and 8 -------------------------------------------------------------

CLI_FRAMES = 60
CLI_PRESET = "presets/modslam.yaml"
EXPORT_FILES = ("result_tum.txt", "result_kitti.txt", "result.csv", "result_gt_tum.txt",
                "result_gt_kitti.txt", "stats.csv", "run.json")
CLI_CASE = "4096x2400 real match_projection (phase 7, modslam preset)"


def entry_points_phase(dev, work: str, sites: CallSites) -> tuple[dict, str]:
    """Phase 7: the corridor written by the port's writer, then the CLI on it
    with the modslam preset. Returns (result, the sequence directory)."""
    t0 = time.perf_counter()
    seq = corridor.write_sequence(os.path.join(work, "kitti"), CLI_FRAMES, device=dev)
    torch.cuda.synchronize()
    write_s = time.perf_counter() - t0
    out_dir = os.path.join(work, "cli_out")
    log_path = os.path.join(work, "cli.log")
    sites.capture_at = {"_project_match_pnp"}
    sites.launches.clear()
    sites.calls.clear()
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    with open(log_path, "w") as log, contextlib.redirect_stdout(log):
        rc = cli.main(["-d", seq, "-c", CLI_PRESET, "-r", out_dir, "-f", "all", "-z"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = hm.hamming_resolve_cuda.launches
    lm = lm_launches()
    with open(log_path) as f:
        lines = f.read().splitlines()
    missing = [n for n in EXPORT_FILES if not os.path.isfile(os.path.join(out_dir, n))]
    run = {}
    if os.path.isfile(os.path.join(out_dir, "run.json")):
        with open(os.path.join(out_dir, "run.json")) as f:
            run = json.load(f)
    res = {"phase": "entry_points", "frames": run.get("frames"), "rc": rc,
           "sequence_write_s": write_s, "cli_wall_s": wall, "fps": run.get("fps"),
           "ate": run.get("ate_rmse"), "rpe": run.get("rpe_rmse"),
           "segments": run.get("segments"), "device": run.get("device"),
           "missing_files": missing, "stat_lines": sum(l.startswith("STAT ") for l in lines),
           "cli_tail": [l for l in lines if not l.startswith("STAT ")][-4:],
           "kernel_launches": launches, "launches_per_site": dict(sites.launches),
           "calls_per_site": dict(sites.calls), "lm_launches": lm}
    print(json.dumps(res))
    require(lm["track_lm"] > 0 and lm["pnp_lm"] > 0, f"the CLI run's LM launches {lm}")
    require(rc == 0 and not missing, f"the CLI failed (rc {rc}, missing {missing})")
    require(run.get("frames") == CLI_FRAMES, f"the CLI ran {run.get('frames')} frames")
    ate = run.get("ate_rmse", float("nan"))
    require(np.isfinite(ate) and ate < 0.1, f"CLI ATE {ate} >= 0.1")
    require(run.get("segments") == 0, "the CLI run lost tracking")
    require(launches > 0, "the CLI run launched no Hamming kernel")
    require("_project_match_pnp" in sites.captured, "no match_projection captured")
    shape = (sites.captured["_project_match_pnp"][0].shape[0],
             sites.captured["_project_match_pnp"][2].shape[0])
    require(shape == (4096, 2400), f"the modslam preset's match_projection is {shape}")
    return res, seq


def _same(a, b) -> bool:
    """Bit-identical: numpy arrays, tensors, lists of either."""
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return np.array_equal(np.asarray(a), np.asarray(b))


def _snapshot(odo) -> dict:
    """What two runs must agree on bit for bit."""
    require(odo._window is not None, "the run never initialized")
    _, est = odo.trajectory_c2w()
    out = {"trajectory": est}
    if isinstance(odo, hybrid.HybridOdometry):
        out.update(pt_valid=odo._pt_valid.copy(), pt_Xw=odo._pt_Xw.copy(),
                   mode_history=list(odo.mode_history))
    else:
        ba = odo._window.ba
        out.update(idepth=ba.idepth, point_valid=ba.point_valid, T_R=ba.T.R, T_t=ba.T.t)
    return out


REPEAT_FRAMES, SAVE_AT = 24, 16


def repeat_and_resume(make, imgs, work: str, name: str) -> dict:
    """Run `make()` over the frames twice (the second saves its state before
    frame SAVE_AT and goes on), then a fresh instance from the file over
    frames SAVE_AT..: everything in _snapshot must be bit-identical. The
    file must also load into an instance on the CPU."""
    ckpt = os.path.join(work, f"{name}.ckpt")
    reset_launches()
    t0 = time.perf_counter()
    a = make("cuda")
    for i, img in enumerate(imgs):
        a.process(img, i * 0.1)
    snap_a = _snapshot(a)
    b = make("cuda")
    for i, img in enumerate(imgs):
        if i == SAVE_AT:
            pending = getattr(b, "_pending_marg", None) is not None
            b.save_state(ckpt)
        b.process(img, i * 0.1)
    snap_b = _snapshot(b)
    c = make("cuda")
    c.load_state(ckpt)
    loaded_R = c._window.ba.T.R.cpu()
    for i in range(SAVE_AT, len(imgs)):
        c.process(imgs[i], i * 0.1)
    snap_c = _snapshot(c)
    torch.cuda.synchronize()
    launches = hm.hamming_resolve_cuda.launches
    lm = lm_launches()
    wall = time.perf_counter() - t0
    cpu = make("cpu")
    cpu.load_state(ckpt)
    cpu_ok = (cpu._window.ba.T.R.device.type == "cpu"
              and torch.equal(cpu._window.ba.T.R, loaded_R))
    repeat = {k: _same(snap_a[k], snap_b[k]) for k in snap_a}
    resume = {k: _same(snap_a[k], snap_c[k]) for k in snap_a}
    res = {"phase": f"repeat_resume_{name}", "frames": len(imgs), "save_at": SAVE_AT,
           "pending_marg_at_save": pending, "repeat_identical": repeat,
           "resume_identical": resume, "cpu_load": cpu_ok,
           "max_abs_traj_diff_repeat": float(np.abs(snap_a["trajectory"]
                                                    - snap_b["trajectory"]).max()),
           "max_abs_traj_diff_resume": float(np.abs(snap_a["trajectory"]
                                                    - snap_c["trajectory"]).max()),
           "kernel_launches": launches, "lm_launches": lm, "wall_s": wall}
    print(json.dumps(res))
    require(all(repeat.values()), f"{name}: two runs differ: {repeat}")
    require(all(resume.values()), f"{name}: the resumed run differs: {resume}")
    require(cpu_ok, f"{name}: the card's checkpoint did not load on the CPU")
    return res


def determinism_probe(cam, imgs) -> dict:
    """The hybrid (24 frames, its direct spine included) and the direct path
    (12 frames) under torch.use_deterministic_algorithms(True,
    warn_only=True): the distinct warnings torch raises, with their counts.
    It names the operations torch knows to be order-dependent on CUDA and
    has no deterministic form of; the ones it has a form of switch silently,
    and phase 8's bit-identity checks catch those."""
    seen: Counter = Counter()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            odo = wl.hybrid_odometry(cam, dev="cuda")
            for i, img in enumerate(imgs[:24]):
                odo.process(img, i * 0.1)
            odo = DirectOdometry(cam, wl.BENCH_CFG)
            for i, img in enumerate(imgs[:12]):
                odo.process(img, i * 0.1)
            torch.cuda.synchronize()
        for w in caught:
            seen[str(w.message).splitlines()[0][:160]] += 1
    finally:
        torch.use_deterministic_algorithms(False)
    res = {"phase": "determinism_probe", "warnings": dict(seen)}
    print(json.dumps(res))
    return res


def repeatability_phase(seq: str, work: str) -> dict:
    """Phase 8 on the phase-7 sequence, read back through KittiCapture."""
    cap = KittiCapture(seq)
    cam = cap.calibration.pinhole
    imgs = []
    for frame in cap.frames():
        if len(imgs) == REPEAT_FRAMES:
            break
        imgs.append(frame.image)
    t0 = time.perf_counter()
    probe = determinism_probe(cam, imgs)
    probe_s = time.perf_counter() - t0
    hyb = repeat_and_resume(lambda d: wl.hybrid_odometry(cam, dev=d), imgs, work, "hybrid")
    direct = repeat_and_resume(lambda d: DirectOdometry(cam, wl.BENCH_CFG, device=d), imgs,
                               work, "direct")
    return {"probe": probe, "probe_s": probe_s, "hybrid": hyb, "direct": direct}


# -- phases 9 to 11 ------------------------------------------------------------

# CUDA runtime calls that make the host wait for the device, and copies
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize")
COPY_CALLS = ("cudaMemcpyAsync", "cudaMemcpy")
SYNC_WINDOW = range(15, 20)      # frames profiled for the host waits of a mode


def host_waits(make, imgs) -> dict:
    """Stream/event syncs and memcpys a frame (torch.profiler's CUDA runtime
    calls) of a fresh `make()` run over SYNC_WINDOW (it holds a keyframe of
    phase 3), after the frames before it; the window's end includes the
    in-flight frame's finalize."""
    odo = make()
    for i in range(SYNC_WINDOW.start):
        odo.process(imgs[i], float(i))
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for i in SYNC_WINDOW:
            odo.process(imgs[i], float(i))
        torch.cuda.synchronize()
    counts = Counter()
    for e in prof.events():
        if e.device_type.name == "CPU" and e.name in SYNC_CALLS + COPY_CALLS:
            counts[e.name] += 1
    n = len(SYNC_WINDOW)
    return {"syncs_per_frame": sum(counts[k] for k in SYNC_CALLS) / n,
            "memcpys_per_frame": sum(counts[k] for k in COPY_CALLS) / n,
            "calls_per_frame": {k: v / n for k, v in counts.items()}}


def _keyframe_frames(odo) -> list[int]:
    return [int(f) for f in odo.sheet.stat("time_keyframe").series()[0]]


def timed_run(odo, imgs) -> dict:
    """Drive `odo` over the frames on the card: wall and steady clocks, the
    kernel launches of the run (counted from 0), lost frames."""
    lost = 0
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    t_steady = t0
    for i, img in enumerate(imgs):
        if i == WARMUP:
            torch.cuda.synchronize()
            t_steady = time.perf_counter()
        out = odo.process(img, float(i))
        lost += int(out.get("state") == "LOST")
    _, est = odo.trajectory_c2w()
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    return {"wall_s": t_end - t0, "fps": len(imgs) / (t_end - t0),
            "steady_fps": (len(imgs) - WARMUP) / (t_end - t_steady),
            "kernel_launches": hm.hamming_resolve_cuda.launches, "lm_launches": lm_launches(),
            "lost_frames": lost, "est": est}


def pipelined_direct_phase(cam, traj, frames, direct: dict) -> dict:
    """Phase 9: DirectOdometry(pipelined=True) on phase 3's frames."""
    imgs = [f[0].cpu().numpy() for f in frames[:N_DIRECT]]
    odo = DirectOdometry(cam, wl.BENCH_CFG, pipelined=True)
    run = timed_run(odo, imgs)
    ate = ate_rmse(run.pop("est")[:, :3, 3], gt_centres(traj[:N_DIRECT]), with_scale=True)
    waits = {"sequential": host_waits(lambda: DirectOdometry(cam, wl.BENCH_CFG), imgs),
             "pipelined": host_waits(lambda: DirectOdometry(cam, wl.BENCH_CFG, pipelined=True),
                                     imgs)}
    res = {"phase": "pipelined_direct", "frames": len(imgs), **run, "ate": ate,
           "segments": odo.segments, "keyframe_frames": _keyframe_frames(odo),
           "sequential_keyframe_frames": direct["keyframe_frames"],
           "sequential_ate": direct["ate"], "sequential_steady_fps": direct["steady_fps"],
           "host_waits": waits}
    print(json.dumps(res))
    require(np.isfinite(ate) and ate < 0.1, f"pipelined direct ATE {ate} >= 0.1")
    require(odo.segments == 0 and run["lost_frames"] == 0, "pipelined direct lost tracking")
    return res


def watch_events(odo) -> tuple[Counter, Counter, set]:
    """watch_hybrid for the staged postprocess: the points each keyframe
    event triangulated and whether its local BA completed are booked to the
    event (the in-flight tick's frame) whichever frame its ticks run in.
    Returns (event counts, points triangulated by event, events whose local
    BA completed)."""
    ev = Counter()
    tri, lba = Counter(), set()

    def wrap(name, after):
        fn = getattr(odo, name)

        def run(*args, **kw):
            out = fn(*args, **kw)
            after(*args)
            return out
        setattr(odo, name, run)

    def added(Xw, desc, level, ok):
        tri[odo._indpost["frame_idx"]] += int(np.sum(ok))
        ev["triangulated"] += int(np.sum(ok))

    def local(lb, fetched):
        if np.isfinite(fetched[0]).all():
            lba.add(odo._indpost["frame_idx"])
            ev["local_ba"] += 1

    wrap("_add_map_points", added)
    wrap("_complete_indirect_local_ba", local)
    wrap("_complete_mixed_window_ba", lambda *_: ev.update(mixed_ba=1))
    return ev, tri, lba


STAGED_CASE = "4096x1536 real staged-tick match_projection (phase 10, pipelined hybrid)"
STAGED_FRAMES = 60          # phase 5's 60 frames


def staged_hybrid_phase(cam, traj, frames, sites: CallSites, mode: str) -> dict:
    """Phase 10: the hybrid pipelined (every postprocess tick staged) or
    sequential with staged BA ticks, on phase 5's frames."""
    kw = {"pipelined": True} if mode == "pipelined" else {"staged_indpost": True}
    odo = hybrid.HybridOdometry(cam, wl.BENCH_CFG, orb_budget=wl.ORB_BUDGET,
                                orb_levels=wl.ORB_LEVELS, **kw)
    ev, tri, lba = watch_events(odo)
    imgs = [f[0].cpu().numpy() for f in frames[:STAGED_FRAMES]]
    sites.capture_at = {"_map_projection_match"}
    sites.capture_live = True
    sites.launches.clear()
    sites.calls.clear()
    run = timed_run(odo, imgs)
    ate = ate_rmse(run.pop("est")[:, :3, 3], gt_centres(traj[:STAGED_FRAMES]), with_scale=True)
    events = [int(f) for f in odo.sheet.stat("time_ind_post").series()[0]]
    ticks = [int(f) for f in odo.sheet.stat("time_ind_tick").series()[0]]
    ok_kf = sorted(f for f in lba if tri[f] > 0)
    n = len(imgs)
    res = {"phase": f"hybrid_{mode}", "frames": n, **run, "ate": ate, "segments": odo.segments,
           "keyframe_frames": _keyframe_frames(odo), "indirect_keyframe_events": events,
           "tick_frames": ticks, "map_points": int(odo._pt_valid.sum()),
           "triangulated": ev["triangulated"], "mixed_ba": ev["mixed_ba"],
           "local_ba": ev["local_ba"], "events_triangulated_and_local_ba": ok_kf,
           "modes": dict(Counter(odo.mode_history)),
           "kernel_launches_per_frame": run["kernel_launches"] / n,
           "launches_per_site": dict(sites.launches), "calls_per_site": dict(sites.calls)}
    print(json.dumps(res))
    require(np.isfinite(ate) and ate < 0.1, f"{mode} hybrid ATE {ate} >= 0.1")
    require(odo.segments == 0 and run["lost_frames"] == 0, f"{mode} hybrid lost tracking")
    require(ok_kf, f"{mode} hybrid: no indirect keyframe triangulated and completed a local BA")
    require(odo._indpost is None, f"{mode} hybrid: a postprocess tick left in flight")
    require(run["kernel_launches"] == sum(sites.launches.values()),
            "kernel launched outside the call sites")
    for site in CALL_SITES[:4]:
        require(sites.launches[site] > 0, f"the {mode} hybrid launched no kernel at {site}")
    later = [t for t in ticks if t not in events]
    require(later, f"{mode} hybrid: no postprocess tick ran after its keyframe's frame")
    return res


CALIB_FRAMES = 24
CALIB_K1, CALIB_K2 = -0.12, 0.02


def calib_phase(cam, traj, frames) -> dict:
    """Phase 11: CalibSlam on frames rendered through radtan distortion, and
    DirectOdometry initialized from a depth-prior callable."""
    from libcml_tpu_torch.core.camera import build_remap, invert_distortion, radtan_distort
    from libcml_tpu_torch.data.synthetic import SyntheticScene, forward_trajectory
    from libcml_tpu_torch.runtime.calib import CalibSlam

    def distort(xn):
        return radtan_distort(xn, CALIB_K1, CALIB_K2, 0.0, 0.0)

    sc = SyntheticScene.default(cam, seed=3)
    sc_d = SyntheticScene(sc.planes, cam, tex3d=sc.tex3d,
                          undistort_xn=lambda xn: invert_distortion(distort, xn))
    calib_traj = forward_trajectory(CALIB_FRAMES, step=0.08, yaw_rate=0.02)
    t0 = time.perf_counter()
    imgs = [sc_d.render_device(R, t, "cuda")[0].cpu().numpy() for R, t in calib_traj]
    render_s = time.perf_counter() - t0
    odo = CalibSlam(cam, wl.BENCH_CFG, orb_budget=wl.ORB_BUDGET, orb_levels=wl.ORB_LEVELS)
    run = timed_run(odo, imgs)
    est = run.pop("est")
    ate = ate_rmse(est[:, :3, 3], gt_centres(calib_traj), with_scale=True)
    params = odo.fit_distortion()
    require(params is not None, "CalibSlam harvested too few correspondences")
    cal = odo.finalize()
    true_remap = build_remap(cam, np.asarray(cam.K()), distort)
    H, W = cam.height, cam.width
    u, v = np.meshgrid(np.arange(W, dtype=np.float32), np.arange(H, dtype=np.float32))
    sl = np.s_[H // 6: -H // 6, W // 6: -W // 6]
    err_fit = float(np.linalg.norm(cal.remap[sl] - true_remap[sl], axis=-1).mean())
    err_id = float(np.linalg.norm(np.stack([u, v], -1)[sl] - true_remap[sl], axis=-1).mean())

    # the depth prior: the renderer's inverse depth of the first frame
    prior_calls = []

    def prior(image, frame_idx, path):
        prior_calls.append(frame_idx)
        return frames[0][1].cpu().numpy()

    direct = DirectOdometry(cam, wl.BENCH_CFG, depth_prior=prior)
    d_imgs = [f[0].cpu().numpy() for f in frames[:CALIB_FRAMES]]
    direct.process(d_imgs[0], 0.0)
    seeded = direct._init_state.idepth.cpu().numpy()
    for i, img in enumerate(d_imgs[1:], 1):
        direct.process(img, float(i))
    _, d_est = direct.trajectory_c2w()
    d_ate = ate_rmse(d_est[:, :3, 3], gt_centres(traj[:len(d_imgs)]), with_scale=True)
    res = {"phase": "calib", "frames": len(imgs), "render_s": render_s, **run, "ate": ate,
           "segments": odo.segments, "fitted": [float(p) for p in params],
           "true": [CALIB_K1, CALIB_K2, 0.0, 0.0],
           "geometric_correspondences": int(sum(len(a) for a in odo._geo_Xc)),
           "remap_err_px": err_fit, "identity_err_px": err_id,
           "prior": {"calls": prior_calls, "seeded_idepth_std": float(np.std(seeded)),
                     "frames": len(d_imgs), "ate": d_ate, "segments": direct.segments,
                     "state": direct.state}}
    print(json.dumps(res))
    require(params[0] < 0, f"fitted k1 {params[0]} is not negative")
    require(err_fit < err_id, f"the fitted remap ({err_fit} px) is no closer than the identity "
            f"({err_id} px)")
    require(prior_calls == [0] and np.std(seeded) > 0.01,
            "the depth prior did not seed the initializer")
    require(direct.state == "TRACKING" and direct.segments == 0 and d_ate < 0.1,
            f"DirectOdometry from the prior: {direct.state}, ATE {d_ate}")
    return res


# -- phase 12 ---------------------------------------------------------------------

RATIO_CASE = "1536x1536 real match_ratio (phase 12, frames 0-1 ORB)"


def sharded_phase(cam, traj, frames, direct_snap: dict, hybrid_snap: dict) -> dict:
    """Phase 12: DirectOdometry and HybridOdometry with mesh=make_mesh() (a
    world of one, NCCL) on phase 3's and phase 5's frames: bit-identical to
    the unsharded runs, with fps and the collectives a frame."""
    mesh = make_mesh()
    require(dist.get_backend() == "nccl" and mesh.world_size == 1,
            f"mesh: {dist.get_backend()} over {mesh.world_size} ranks")
    imgs = [f[0].cpu().numpy() for f in frames[:N_DIRECT]]
    out = {"phase": "sharded", "backend": dist.get_backend(), "world_size": mesh.world_size,
           "device": str(mesh.device)}
    for name, make, want in (
            ("direct", lambda: DirectOdometry(cam, wl.BENCH_CFG, mesh=mesh), direct_snap),
            ("hybrid", lambda: wl.hybrid_odometry(cam, mesh=mesh), hybrid_snap)):
        odo = make()
        mesh.all_reduces = mesh.all_gathers = 0
        run = timed_run(odo, imgs)
        ate = ate_rmse(run.pop("est")[:, :3, 3], gt_centres(traj[:N_DIRECT]), with_scale=True)
        got = _snapshot(odo)
        same = {k: _same(want[k], got[k]) for k in want}
        n = len(imgs)
        out[name] = {**run, "frames": n, "ate": ate, "segments": odo.segments,
                     "identical_to_unsharded": same,
                     "all_reduces": mesh.all_reduces, "all_gathers": mesh.all_gathers,
                     "all_reduces_per_frame": mesh.all_reduces / n,
                     "all_gathers_per_frame": mesh.all_gathers / n}
        require(all(same.values()), f"sharded {name} differs from the unsharded run: {same}")
        require(mesh.all_reduces > 0, f"sharded {name}: no all-reduce ran")
    dist.destroy_process_group()
    print(json.dumps(out))
    require(out["hybrid"]["kernel_launches"] > 0, "the sharded hybrid launched no kernel")
    return out


def match_ratio_phase(frames, card: str, popc_rate: float) -> tuple[dict, dict]:
    """Phase 12's match_ratio: frames 0 and 1's real ORB features on the card
    against the plain version on the card (idx_b and good exactly), and the
    resolution it runs as a phase-2 kernel case."""
    f0, f1 = wl.extract(frames[0]), wl.extract(frames[1])
    torch.cuda.synchronize()
    reset_launches()
    idx_b, good = orb.match_ratio(f0.desc, f1.desc, f0.valid, f1.valid)
    torch.cuda.synchronize()
    launches = hm.hamming_resolve_cuda.launches
    want = orb.ratio_gate(hm.hamming_resolve_plain(f0.desc, f0.valid, f1.desc, f1.valid),
                          f0.valid)
    equal = torch.equal(idx_b, want[0]) and torch.equal(good, want[1])
    res = {"phase": "match_ratio", "N": f0.desc.shape[0], "M": f1.desc.shape[0],
           "good": int(good.sum()), "launches": launches, "equal_to_plain": equal}
    print(json.dumps(res))
    require(equal, "match_ratio on the card differs from its plain version")
    require(launches == 1, f"match_ratio launched the kernel {launches} times")
    require(int(good.sum()) > 0, "match_ratio matched nothing between frames 0 and 1")
    row = kernel_case(RATIO_CASE, (f0.desc, f0.valid, f1.desc, f1.valid, None), card, popc_rate)
    return res, row


# -- phase 13 ----------------------------------------------------------------------

# arithmetic a point costs in each sweep, counted from the kernels' sources
# (an FMA as 2): track_lm.cu's energy sweep (unproject, transform, project,
# bilinear of 3 channels, residual, Huber, cap), linear sweep (that, the
# 2x6 projection Jacobian, the 8-vector J and the 44 sums) and statistics
# sweep (the linear sweep without b, a rotation-only warp, 5 sums); pnp_lm.cu's
# linear sweep (transform, project, chi2, Huber weight, 2x6 J, 27 sums and
# the robust energy), energy sweep (two transforms and projections),
# re-classification and final sweep
TRACK_ENERGY_FLOPS, TRACK_LINEAR_FLOPS, TRACK_STATS_FLOPS = 73, 253, 265
PNP_LINEAR_FLOPS, PNP_ENERGY_FLOPS, PNP_RECLASS_FLOPS, PNP_FINAL_FLOPS = 227, 64, 32, 219
TRACK_FROM = 12     # phase 3's track launches kept for phase 13: two from this one on
PNP_FROM = 20       # phase 5's PnP launches: a frame's two passes from this one on


def _clone(x):
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, (list, tuple)):
        return type(x)(_clone(v) for v in x)
    return x


class LMCapture:
    """Keeps (cloned) the inputs of chosen calls while the paths run: two
    single-start track_lm launches from launch `start["track_lm"]` on (counted
    from arming), a frame's two solve_pnp passes from launch
    `start["pnp_lm"]` on (pass 1, `_project_match_pnp`, and the launch right
    after it, pass 2, `_local_map_pass2`, named by the active CallSites), the
    first track_lm launch of more than one start (a recovery battery), the
    first solve_pnp launch off the map arena (relocalization's EPnP refine),
    and the odometry's first `track` call from `start["track_lm"]` on."""

    def __init__(self):
        self.saved: dict[str, list] = {"track_lm": [], "pnp_lm": [], "battery": [],
                                       "epnp_refine": [], "track": []}
        self.start: dict[str, int | None] = {"track_lm": None, "pnp_lm": None}
        self.count = Counter()
        self.sites: CallSites | None = None
        self._orig = (tracker.track_lm_cuda, pnp_mod.pnp_lm_cuda, odometry.track)

    def arm(self, name: str, start: int) -> None:
        self.count[name] = 0
        self.start[name] = start

    def _armed(self, name: str, k: int) -> bool:
        return self.start[name] is not None and k >= self.start[name]

    def _track_lm(self, *args):
        k = self.count["track_lm"]
        self.count["track_lm"] += 1
        got = self.saved["track_lm"]
        if self._armed("track_lm", k) and len(got) < 2 and args[7].shape[0] == 1:
            got.append((k, _clone(args)))
        if args[7].shape[0] > 1 and not self.saved["battery"]:
            self.saved["battery"].append(_clone(args))
        return self._orig[0](*args)

    def _pnp_lm(self, *args):
        k = self.count["pnp_lm"]
        self.count["pnp_lm"] += 1
        site = None if self.sites is None else self.sites._site
        got = self.saved["pnp_lm"]
        if self._armed("pnp_lm", k) and len(got) < 2:
            pair = len(got) == 1 and k == got[0][0] + 1 and site == "_local_map_pass2"
            if not pair:
                got.clear()
            if pair or site == "_project_match_pnp":
                got.append((k, site, _clone(args)))
        if args[0].shape[0] != hybrid.MAP_CAP and not self.saved["epnp_refine"]:
            self.saved["epnp_refine"].append(_clone(args))
        return self._orig[1](*args)

    def _track(self, *args, **kw):
        if not self.saved["track"] and self._armed("track_lm", self.count["track_lm"]):
            self.saved["track"].append(_clone(args))
        return self._orig[2](*args, **kw)

    def __enter__(self):
        tracker.track_lm_cuda, pnp_mod.pnp_lm_cuda = self._track_lm, self._pnp_lm
        odometry.track = self._track
        return self

    def __exit__(self, *exc):
        tracker.track_lm_cuda, pnp_mod.pnp_lm_cuda, odometry.track = self._orig


def _texels(grad: torch.Tensor, cam, uv, idepth, R, t) -> int:
    """Distinct texels the bilinear sampler gathers for the points warped by
    each pose (R (B, 3, 3), t (B, 3)), as ops/image.py clamps them."""
    H, W = grad.shape[0], grad.shape[1]
    X = cam.unproject(uv, idepth)
    Xj = torch.einsum("bij,pj->bpi", R, X) + t[:, None]
    uvj, _ = cam.project(Xj)
    x0 = torch.nan_to_num(torch.clamp(torch.floor(uvj[..., 0]), 0, W - 2), nan=0.0).long()
    y0 = torch.nan_to_num(torch.clamp(torch.floor(uvj[..., 1]), 0, H - 2), nan=0.0).long()
    base = (y0 * W + x0).reshape(-1)
    ids = torch.cat([base, base + 1, base + W, base + W + 1])
    return int(torch.unique(ids).numel())


def _systems(trace: torch.Tensor, steps: torch.Tensor) -> torch.Tensor:
    """The normal equations an LM loop needs, from its per-step trace (...,
    steps, >= 2: E, E_new) and the steps it ran (...): one at its start when
    it takes a step, and one at each accepted pose a later step starts from.
    After a rejected step the pose, and so its system, is the one held."""
    n = trace.shape[-2]
    acc = (trace[..., 1] < trace[..., 0]) & (torch.arange(n) < (steps[..., None] - 1))
    return (steps > 0).long() + acc.long().sum(-1)


def track_bound(args, got) -> tuple[float, str, dict]:
    """Least time of one track_lm call, in ms: the larger of its bytes over
    the HBM rate and its arithmetic over the f32 rate. Bytes: each level's
    point data and idepth read once, the texels gathered at the final pose
    of every hypothesis (12 bytes each), the starts, and the outputs written
    once. Arithmetic, from the kernel's trace: an energy sweep at each trial
    pose (at the start of a level that takes no step, one at its pose), a
    linear sweep (which includes the energy's work) for each system the
    level needs (_systems), and track's statistics sweep when the call
    runs it."""
    grads, cams, uv, color, weight, valid, idepth, R0, t0, ab0, abc, cfg = args[:12]
    stats = len(args) > 12 and args[12]
    L, P, B = len(grads), idepth.numel(), R0.shape[0]
    its = got[4].long().cpu()
    systems = _systems(got[5].cpu(), its)
    texels = sum(_texels(grads[l], cams[l], uv[l], idepth, got[0], got[1]) for l in range(L))
    nbytes = (L * P * (8 + 4 + 4 + 1) + P * 4 + 12 * texels + B * 14 * 4 + 8
              + B * 15 * 4 + B * L * 4 + B * L * cfg.tracker_iters * 12
              + (B * (4 * 4 + 8 + 36 * 4) if stats else 0))
    # E0 is the start's linear sweep's; an accepted pose's energy sweep is
    # part of the linear sweep there
    energy = its + (its == 0).long() - (systems - (its > 0).long())
    flops = P * float((TRACK_ENERGY_FLOPS * energy + TRACK_LINEAR_FLOPS * systems).sum()
                      + (B * TRACK_STATS_FLOPS if stats else 0))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    detail = {"bytes": nbytes, "flops": flops, "texels": texels,
              "steps": its.tolist() if B <= 2 else int(its.sum()),
              "systems": systems.tolist() if B <= 2 else int(systems.sum())}
    return (t_ops, "operations", detail) if t_ops >= t_bytes else (t_bytes, "bytes", detail)


def pnp_bound(args, got) -> tuple[float, str, dict]:
    """Least time of one pnp_lm call, in ms: matches, starts and outputs
    read or written once. Arithmetic, from the kernel's trace: an energy
    sweep at each trial pose, a linear sweep for each system a round needs
    (_systems: its first step's, and the accepted poses a later step starts
    from; the projection it shares with the energy at that pose counted
    twice), the re-classifications and the final sweep."""
    Xw, rounds, iters = args[0], args[7], args[8]
    N = Xw.shape[0]
    trace = got[6].cpu()
    systems = int(_systems(trace, torch.full(trace.shape[:1], iters)).sum())
    nbytes = N * (12 + 8 + 1 + 4) + 48 + N + 48 + 8 + 144 + 4 + rounds * iters * 8
    flops = float(N * (systems * PNP_LINEAR_FLOPS + rounds * iters * PNP_ENERGY_FLOPS
                       + rounds * PNP_RECLASS_FLOPS + PNP_FINAL_FLOPS))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    detail = {"bytes": nbytes, "flops": flops, "systems": systems}
    return (t_ops, "operations", detail) if t_ops >= t_bytes else (t_bytes, "bytes", detail)


def _lm_times(kernel, plain, bound: float, steps: int) -> dict:
    """A kernel's launches a call (torch.profiler), cold and warm times
    (median of 30), microseconds an LM step (cold, over the `steps` of the
    longest start), the plain form's time (median of 5) and the share of
    its bound that the cold time reaches."""
    host, device_ops = launches_per_call(kernel)
    ms = cuda_ms(kernel)
    return {"kernel_ms": ms, "kernel_warm_ms": cuda_ms(kernel, cold=False),
            "us_per_step": ms * 1e3 / max(steps, 1),
            "plain_ms": cuda_ms(plain, reps=5, warmup=1), "launches_per_call": host,
            "device_ops_per_call": device_ops, "bound_share": bound / ms}


def track_case(name: str, args, card: str) -> dict:
    """One phase-13 tracker case: the kernel against track_levels_plain on
    the card (track_lm.parity), one launch a call, its times and bound."""
    before = track_lm.track_lm_cuda.launches
    got = track_lm.track_lm_cuda(*args)
    torch.cuda.synchronize()
    calls = track_lm.track_lm_cuda.launches - before
    want = tracker.track_levels_plain(*args)
    rep = track_lm.parity(got, want, args[11])
    bound, by, detail = track_bound(args, got)
    row = {"case": name, "B": args[7].shape[0], "levels": len(args[0]), "P": args[6].numel(),
           "stats": got[6] is not None,
           "parity": rep, "steps": got[4].cpu().tolist() if args[7].shape[0] <= 2 else None,
           "plain_steps": want[4].cpu().tolist() if args[7].shape[0] <= 2 else None,
           **_lm_times(lambda: track_lm.track_lm_cuda(*args),
                       lambda: tracker.track_levels_plain(*args), bound,
                       int(got[4].sum(-1).max())),
           "bound_ms": bound, "bound_by": by, "bound_detail": detail,
           "max_abs_err": max(rep["max_err"]["R"], rep["max_err"]["t"]), "card": card}
    print(json.dumps(row))
    for c in rep["diverged"]:
        print(f"  {name}: hypothesis {c['hypothesis']} took steps {c['steps']} against the "
              f"plain form's {c['plain_steps']}: first differing decision {c}")
    require(calls == 1 and row["launches_per_call"] == 1,
            f"{name}: {calls} counted / {row['launches_per_call']} profiled launches a call")
    require(rep["ok"], f"track_lm != plain on {name}: {rep}")
    require(row["bound_share"] <= 1.0, f"{name}: under its bound: the bound is wrong")
    return row


def pnp_case(name: str, args, card: str) -> dict:
    """One phase-13 PnP case: the kernel against pnp_lm_plain on the card
    (pnp_lm.parity), one launch a call, its times and bound."""
    before = pnp_lm.pnp_lm_cuda.launches
    got = pnp_lm.pnp_lm_cuda(*args)
    torch.cuda.synchronize()
    calls = pnp_lm.pnp_lm_cuda.launches - before
    want = pnp_mod.pnp_lm_plain(*args)
    rep = pnp_lm.parity(got, want, *args[:4], args[6])
    bound, by, detail = pnp_bound(args, got)
    row = {"case": name, "N": args[0].shape[0], "valid": int(args[2].sum()),
           "inliers": int(got[3]), "plain_inliers": int(want[3]), "parity": rep,
           **_lm_times(lambda: pnp_lm.pnp_lm_cuda(*args),
                       lambda: pnp_mod.pnp_lm_plain(*args), bound, args[7] * args[8]),
           "bound_ms": bound, "bound_by": by, "bound_detail": detail,
           "max_abs_err": max(rep["max_err"]["R"], rep["max_err"]["t"]), "card": card}
    print(json.dumps(row))
    if rep["first_step_differing"] or rep["classes_differing"]:
        print(f"  {name}: differs at a decision: {rep['first_step_differing']}, "
              f"classes {rep['classes_differing']}")
    require(calls == 1 and row["launches_per_call"] == 1,
            f"{name}: {calls} counted / {row['launches_per_call']} profiled launches a call")
    require(rep["ok"], f"pnp_lm != plain on {name}: {rep}")
    require(row["bound_share"] <= 1.0, f"{name}: under its bound: the bound is wrong")
    return row


def _syncs(fn) -> dict:
    """Host waits, copies and enqueued device operations of one call of
    `fn` (torch.profiler), less those of profiling an empty call (the
    profiler synchronizes the device when it stops)."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]

    def count(f) -> Counter:
        f()
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            f()
        return Counter(e.name for e in prof.events()
                       if e.device_type.name == "CPU" and e.name in SYNC_CALLS + COPY_CALLS
                       + ENQUEUE_CALLS)

    counts = count(fn)
    counts.subtract(count(lambda: None))
    return {"syncs": sum(counts[k] for k in SYNC_CALLS),
            "memcpys": sum(counts[k] for k in COPY_CALLS),
            "enqueues": sum(counts[k] for k in ENQUEUE_CALLS)}


def lm_phase(cap: LMCapture, card: str) -> tuple[list[dict], list[dict], dict]:
    """Phase 13: the two LM kernels against their plain forms on the card, at
    inputs captured in phases 3, 5 and 6, and the all-invalid cases; the
    public track / track_multi on a captured frame (the all-invalid probe
    finite; host waits a call)."""
    require(len(cap.saved["track_lm"]) == 2, "phase 3's track calls not captured")
    require(len(cap.saved["pnp_lm"]) == 2, "phase 5's two PnP passes of a frame not captured")
    require(cap.saved["track"], "no odometry track call captured")
    t_rows, p_rows = [], []
    for k, args in cap.saved["track_lm"]:
        t_rows.append(track_case(f"track, phase-3 launch {k} ({len(args[0])} levels, B 1)",
                                 args, card))
    # the recovery battery of _frame_step about the first captured start:
    # motion_hypotheses(T_init, T_zero = T_init, T_extra = T_init), the two
    # coarse levels (starts 0, 5 and 6 identical: an exact energy tie)
    k0, args = cap.saved["track_lm"][0]
    T0 = SE3(R=args[7][0], t=args[8][0])
    H = tracker.motion_hypotheses(T0, T0, T_extra=T0)
    B = H.t.shape[0]
    battery = (*(a[:2] for a in args[:6]), args[6], H.R.contiguous(), H.t.contiguous(),
               args[9][:1].expand(B, 2).contiguous(), args[10], args[11], False)
    row = track_case(f"track_multi battery about phase-3 launch {k0} (2 levels, B {B})",
                     battery, card)
    E = tracker.track_levels_plain(*battery)[3]
    row["tie"] = {"E0": float(E[0]), "E5": float(E[5]), "E6": float(E[6])}
    t_rows.append(row)
    if cap.saved["battery"]:
        t_rows.append(track_case("track_multi battery, the first run in phases 3-6",
                                 cap.saved["battery"][0], card))
    dead = (*args[:5], [torch.zeros_like(v) for v in args[5]], *args[6:])
    t_rows.append(track_case("track, all points invalid", dead, card))
    # every point three times (P 6144): the points past those a thread
    # holds in registers are read from memory each sweep
    tripled = (*args[:2], *([torch.cat([v] * 3) for v in a] for a in args[2:6]),
               torch.cat([args[6]] * 3), *args[7:])
    t_rows.append(track_case("track, every point three times (P 6144)", tripled, card))
    for (k, site, args), name in zip(cap.saved["pnp_lm"], ("pass 1", "pass 2")):
        p_rows.append(pnp_case(f"solve_pnp {name} ({site}), phase-5 launch {k} "
                               f"(N {args[0].shape[0]})", args, card))
    args = cap.saved["pnp_lm"][0][2]
    p_rows.append(pnp_case("solve_pnp, all matches invalid",
                           (*args[:2], torch.zeros_like(args[2]), *args[3:]), card))
    p_rows.append(pnp_case("solve_pnp, every match three times (N 12288)",
                           (*(torch.cat([v] * 3) for v in args[:4]), *args[4:]), card))
    if cap.saved["epnp_refine"]:
        args = cap.saved["epnp_refine"][0]
        p_rows.append(pnp_case(f"EPnP refine, phase 6 (N {args[0].shape[0]})", args, card))

    # the public entry points on the captured frame, on the card
    grad_pyr, cam, ref, T_init, ab0, cfg = cap.saved["track"][0]
    probe = tracker.track(grad_pyr, cam, ref.replace(valid=torch.zeros_like(ref.valid)),
                          T_init, ab0, cfg)
    finite = bool(torch.isfinite(probe.T_ji.t).all() and torch.isfinite(probe.T_ji.R).all())
    require(finite and int(probe.num_valid) == 0 and float(probe.energy) == 0.0,
            "the all-invalid probe is not finite on the card")
    Hs = tracker.motion_hypotheses(T_init, T_init, T_extra=T_init)
    before = track_lm.track_lm_cuda.launches
    tracker.track_multi(grad_pyr, cam, ref, Hs, ab0, cfg)
    torch.cuda.synchronize()
    multi_launches = track_lm.track_lm_cuda.launches - before
    public = {"all_invalid_finite": finite, "track_multi_launches": multi_launches,
              "track": _syncs(lambda: tracker.track(grad_pyr, cam, ref, T_init, ab0, cfg)),
              "track_multi": _syncs(lambda: tracker.track_multi(grad_pyr, cam, ref, Hs, ab0,
                                                                cfg)),
              "solve_pnp": _syncs(lambda: pnp_lm.pnp_lm_cuda(*cap.saved["pnp_lm"][0][2]))}
    # starts whose levels took other steps than the plain form, over the
    # captured converging cases (the all-invalid ones take the same steps)
    converging = [r for r in t_rows if not any(w in r["case"] for w in ("invalid", "three"))]
    public["starts_taking_other_steps"] = {
        "starts": sum(r["B"] for r in converging),
        "differ": sum(len(r["parity"]["diverged"]) for r in converging)}
    # the cluster size and the clusters the card holds at once
    public["cluster"] = {"track_lm": track_lm.cluster_info(), "pnp_lm": pnp_lm.cluster_info()}
    print(json.dumps({"phase": "lm_public", **public}))
    print(f"phase 13: {public['starts_taking_other_steps']['differ']} of "
          f"{public['starts_taking_other_steps']['starts']} starts took other steps than "
          f"the plain form; clusters {public['cluster']}; microseconds an LM step: "
          + ", ".join(f"{r['case']} {r['us_per_step']:.3f}" for r in t_rows + p_rows))
    require(multi_launches == 2, f"track_multi made {multi_launches} track_lm launches")
    for name in ("track", "track_multi", "solve_pnp"):
        require(public[name]["syncs"] == 0 and public[name]["memcpys"] == 0,
                f"{name} waits for the device: {public[name]}")
    return t_rows, p_rows, public


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = nvidia_smi("name,power.limit")
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card} | torch: {kind} | torch {torch.__version__} cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    for path, secs, log in kernel_build.build_many(kernel_build.SOURCES, verbose=True):
        print(f"built {path.name} in {secs:.1f} s")
        print(log.strip())
    print(f"kernels built in {time.perf_counter() - t0:.1f} s (one nvcc each, in parallel)")

    t0 = time.perf_counter()
    cam, traj, frames = wl.render_frames(dev, N_DIRECT)
    torch.cuda.synchronize()
    print(f"rendered {len(frames)} frames in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    map_, _ = wl.build_map(cam, traj, frames, dev)
    phase4_args = wl.projection_match_inputs(map_, cam, traj, wl.extract(frames[1]), 1, dev)
    popc_rate = popc_per_s()
    rows, max_err = kernel_vs_plain(dev, card, popc_rate, phase4_args)
    print(f"phase 2 (kernel vs plain) {time.perf_counter() - t0:.1f} s")

    with LMCapture() as cap:
        cap.arm("track_lm", TRACK_FROM)
        t0 = time.perf_counter()
        direct, direct_snap = direct_phase(dev, cam, traj, frames)
        print(f"phase 3 (direct) {time.perf_counter() - t0:.1f} s")

        t0 = time.perf_counter()
        hyb = hybrid_phase(dev, cam, traj, frames)
        print(f"phase 4 (hybrid tracking) {time.perf_counter() - t0:.1f} s")

        cap.arm("pnp_lm", PNP_FROM)
        with CallSites() as sites:
            cap.sites = sites
            t0 = time.perf_counter()
            full, hybrid_snap = full_hybrid_phase(dev, cam, traj, frames, sites)
            print(f"phase 5 (hybrid) {time.perf_counter() - t0:.1f} s")
            t0 = time.perf_counter()
            reloc = relocalization_phase(dev, cam, traj, frames, sites)
            print(f"phase 6 (relocalization) {time.perf_counter() - t0:.1f} s")
    real = {"_epipolar_triangulate": "1536x1536 first keyframe's epipolar band (phase 5)",
            "match_descriptors": "1536x1536 relocalization match_descriptors (phase 6)"}
    for site, name in real.items():
        require(site in sites.captured, f"no resolution captured at {site}")
        row = kernel_case(name, sites.captured[site], card, popc_rate)
        rows.append(row)
        max_err = max(max_err, row["max_abs_err"])

    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        with CallSites() as sites:
            t0 = time.perf_counter()
            entry, seq = entry_points_phase(dev, work, sites)
            print(f"phase 7 (entry points) {time.perf_counter() - t0:.1f} s")
        row = kernel_case(CLI_CASE, sites.captured["_project_match_pnp"], card, popc_rate)
        rows.append(row)
        max_err = max(max_err, row["max_abs_err"])
        t0 = time.perf_counter()
        repeat = repeatability_phase(seq, work)
        print(f"phase 8 (repeatability and resume) {time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(work, ignore_errors=True)

    t0 = time.perf_counter()
    pipe_direct = pipelined_direct_phase(cam, traj, frames, direct)
    print(f"phase 9 (pipelined direct) {time.perf_counter() - t0:.1f} s")
    staged = {}
    with CallSites() as sites:
        for mode in ("pipelined", "staged"):
            t0 = time.perf_counter()
            staged[mode] = staged_hybrid_phase(cam, traj, frames, sites, mode)
            print(f"phase 10 (hybrid {mode}) {time.perf_counter() - t0:.1f} s")
            if mode == "pipelined":
                require("_map_projection_match" in sites.captured,
                        "no staged-tick match_projection captured")
                row = kernel_case(STAGED_CASE, sites.captured["_map_projection_match"], card,
                                  popc_rate)
                rows.append(row)
                max_err = max(max_err, row["max_abs_err"])
    t0 = time.perf_counter()
    calib = calib_phase(cam, traj, frames)
    print(f"phase 11 (calib SLAM, depth prior) {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    sharded = sharded_phase(cam, traj, frames, direct_snap, hybrid_snap)
    ratio, row = match_ratio_phase(frames, card, popc_rate)
    rows.append(row)
    max_err = max(max_err, row["max_abs_err"])
    print(f"phase 12 (sharded BA, match_ratio) {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    t_rows, p_rows, lm_public = lm_phase(cap, card)
    print(f"phase 13 (LM kernels) {time.perf_counter() - t0:.1f} s")

    main_row = next(r for r in rows if r["case"] == PHASE4_CASE)
    cli_row = next(r for r in rows if r["case"] == CLI_CASE)
    staged_row = next(r for r in rows if r["case"] == STAGED_CASE)
    ratio_row = next(r for r in rows if r["case"] == RATIO_CASE)
    by_path = {"hybrid": full["kernel_launches"], "cli_modslam": entry["kernel_launches"],
               "repeat_resume_hybrid": repeat["hybrid"]["kernel_launches"],
               "hybrid_pipelined": staged["pipelined"]["kernel_launches"],
               "hybrid_staged": staged["staged"]["kernel_launches"],
               "calib_slam": calib["kernel_launches"],
               "sharded_hybrid": sharded["hybrid"]["kernel_launches"],
               "match_ratio": ratio["launches"]}
    kernels = [{
        "name": "hamming_resolve",
        "route": "cuda",
        "source": "libcml_tpu_torch/csrc/hamming_match.cu",
        "replaces": "libcml_tpu/ops/pallas_match.py:107",
        "launches": sum(by_path.values()),
        "launches_by_path": {**by_path, "hybrid_tracking": hyb["launches"],
                             "relocalization": reloc["kernel_launches"]},
        "launches_per_hybrid_frame": full["kernel_launches_per_frame"],
        "max_abs_err": max_err,
        "ms": main_row["kernel_ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": None,
        "case_4096x2400": {k: cli_row[k] for k in ("kernel_ms", "kernel_warm_ms", "plain_ms",
                                                   "bound_ms", "bound_by", "bound_share",
                                                   "live_entries")},
        "case_staged_tick": {k: staged_row[k] for k in ("kernel_ms", "kernel_warm_ms",
                                                        "plain_ms", "bound_ms", "bound_by",
                                                        "bound_share", "live_entries",
                                                        "max_abs_err")},
        "case_match_ratio": {k: ratio_row[k] for k in ("kernel_ms", "kernel_warm_ms", "plain_ms",
                                                       "bound_ms", "bound_by", "bound_share",
                                                       "live_entries", "max_abs_err")},
        "launches_per_site": {m: staged[m]["launches_per_site"] for m in staged},
    }]
    runs = {"direct": direct["kernel_launches"], "hybrid": full["lm_launches"],
            "relocalization": reloc["lm_launches"], "cli_modslam": entry["lm_launches"],
            "repeat_resume_hybrid": repeat["hybrid"]["lm_launches"],
            "repeat_resume_direct": repeat["direct"]["lm_launches"],
            "direct_pipelined": pipe_direct["lm_launches"],
            "hybrid_pipelined": staged["pipelined"]["lm_launches"],
            "hybrid_staged": staged["staged"]["lm_launches"],
            "calib_slam": calib["lm_launches"],
            "sharded_direct": sharded["direct"]["lm_launches"],
            "sharded_hybrid": sharded["hybrid"]["lm_launches"]}
    keys = ("kernel_ms", "kernel_warm_ms", "us_per_step", "plain_ms", "bound_ms", "bound_by",
            "bound_share", "launches_per_call", "max_abs_err")
    for name, source, replaces, rows in (
            ("track_lm", "libcml_tpu_torch/csrc/track_lm.cu",
             "libcml_tpu/models/direct/tracker.py:118", t_rows),
            ("pnp_lm", "libcml_tpu_torch/csrc/pnp_lm.cu",
             "libcml_tpu/models/indirect/pnp.py:64", p_rows)):
        by_path = {k: v[name] for k, v in runs.items() if v[name]}
        if name == "pnp_lm":
            by_path["hybrid_tracking"] = hyb["lm_launches"]["pnp_lm"]
        main_row = rows[0]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": main_row["kernel_ms"], "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
            "library_ms": None, "us_per_step": main_row["us_per_step"],
            "cluster": lm_public["cluster"][name],
            "cases": {r["case"]: {k: r[k] for k in keys} for r in rows}})
    print(json.dumps({"direct": direct, "hybrid_tracking": hyb, "hybrid": full,
                      "relocalization": reloc, "entry_points": entry,
                      "repeatability": repeat, "pipelined_direct": pipe_direct,
                      "hybrid_pipelined": staged["pipelined"],
                      "hybrid_staged": staged["staged"], "calib": calib,
                      "sharded": sharded, "match_ratio": ratio, "lm_public": lm_public}))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
