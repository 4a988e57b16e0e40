"""Smoke run of libcml_tpu_torch on one CUDA card (an NVIDIA H100).

    python3 chip_smoke.py

Phases (any failure exits non-zero, and no result line is printed):
  0. the card: `nvidia-smi` name and power limit, torch's device name;
     exits non-zero without CUDA.
  1. build the hand-written kernel from the sources in this checkout.
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
Then phase 2's real-input cases captured in phases 5 and 6 (the first
keyframe's epipolar band, a relocalization match_descriptors call), held to
the plain version exactly; the phases' results, the card's name and power
limit, the kernel table ({"kernels": [...]}: launches of phase 5, the main
path, with each path's count beside them; times and bound of the phase-4
masks case, cold), and the result line {"ok": true, "device": {...}} last.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from collections import Counter

import numpy as np
import torch

from libcml_tpu_torch import workload as wl
from libcml_tpu_torch.eval.trajectory import ate_rmse
from libcml_tpu_torch.models.indirect import matching
from libcml_tpu_torch.models.indirect.bow import default_vocabulary
from libcml_tpu_torch.ops import hamming_match as hm
from libcml_tpu_torch.runtime import hybrid
from libcml_tpu_torch.runtime.odometry import DirectOdometry

# published H100 SXM memory rate at 700 W (NVIDIA's data sheet)
HBM_BYTES_PER_S = 3.35e12
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


def direct_phase(dev, cam, traj, frames) -> dict:
    odo = DirectOdometry(cam, wl.BENCH_CFG)         # default device: the card
    imgs = [f[0].cpu().numpy() for f in frames[:N_DIRECT]]
    gt = []
    kf = lost = 0
    torch.cuda.synchronize()
    hm.hamming_resolve_cuda.launches = 0
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
    launches = hm.hamming_resolve_cuda.launches   # the direct path runs no kernel yet
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
           "keyframes": kf, "host_ms_per_stage": host_ms,
           "kernel_launches": {"hamming_resolve": launches}}
    print(json.dumps(res))
    require(np.isfinite(ate) and ate < 0.1, f"direct ATE {ate} >= 0.1")
    require(odo.segments == 0 and lost == 0, "direct path lost tracking")
    return res


def hybrid_phase(dev, cam, traj, frames) -> dict:
    map_, n_map = wl.build_map(cam, traj, frames, dev)
    feats = {i: wl.extract(frames[i]) for i in HYBRID_FRAMES}
    torch.cuda.synchronize()
    hm.hamming_resolve_cuda.launches = 0
    per_frame = []
    for i in HYBRID_FRAMES:
        before = hm.hamming_resolve_cuda.launches
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
        row = {"frame": i, "matches": int(b1[0]), "inliers": int(b1[1]),
               "pass2_matches": int(b2[0]), "pass2_inliers": int(b2[1]),
               "t_err": t_err, "r_err": r_err, "ms": ms, "kernel_launches": launched}
        per_frame.append(row)
        print(json.dumps(row))
        require(launched == 2, f"frame {i}: {launched} kernel launches, expected 2")
        require(b1[2] > 0.5 and b1[1] >= 12 and b2[1] >= 12,
                f"frame {i}: PnP failed ({b1[1]} / {b2[1]} inliers)")
        require(t_err < 0.04 and r_err < 0.01,
                f"frame {i}: pose error {t_err:.4f} / {r_err:.4f} rad out of budget")
    launches = hm.hamming_resolve_cuda.launches
    res = {"phase": "hybrid_tracking", "frames": len(per_frame), "map_points": n_map,
           "launches": launches,
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
        if self._site in self.capture_at and self._site not in self.captured:
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


def full_hybrid_phase(dev, cam, traj, frames, sites: CallSites) -> dict:
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
    hm.hamming_resolve_cuda.launches = 0
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
           "calls_per_site": dict(sites.calls), "host_ms_per_stage": host_ms}
    print(json.dumps(res))
    require(np.isfinite(ate) and ate < 0.1, f"hybrid ATE {ate} >= 0.1")
    require(odo.segments == 0 and lost == 0, "hybrid lost tracking")
    require(ev["ok_kf"] >= 1, "no indirect keyframe triangulated points and completed a local BA")
    require(launches == sum(sites.launches.values()),
            "kernel launched outside the six call sites")
    # the four sites a tracked run reaches (match_window serves the bootstrap,
    # match_descriptors the relocalization of phase 6)
    for site in CALL_SITES[:4]:
        require(sites.launches[site] > 0, f"the hybrid launched no kernel at {site}")
    return res


def relocalization_phase(dev, cam, traj, frames, sites: CallSites) -> dict:
    odo = wl.hybrid_odometry(cam, wl.RELOC_CFG, dev=dev)
    seq = wl.relocalization_frames(frames)
    sites.capture_at = {"match_descriptors"}
    torch.cuda.synchronize()
    hm.hamming_resolve_cuda.launches = 0
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
    require(at is not None, f"never relocalized (states {states})")
    _, est = odo.trajectory_c2w()
    err = float(np.linalg.norm(est[-1, :3, 3] - view_before))
    res = {"phase": "relocalization", "frames": len(states), "relocalized_at": at,
           "black_frames": wl.RELOC_BLACK, "error": err, "states": states,
           "segments": odo.segments, "map_points": int(odo._pt_valid.sum()),
           "stored_keyframes": len(odo._kf_store), "wall_s": wall,
           "kernel_launches": launches, "launches_per_site": dict(sites.launches)}
    print(json.dumps(res))
    require(err < 0.15, f"relocalized pose off by {err:.3f}")
    require(sites.launches["match_descriptors"] >= 1, "relocalization ran no descriptor match")
    return res


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = nvidia_smi("name,power.limit")
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card} | torch: {kind} | torch {torch.__version__} cuda {torch.version.cuda}")

    path, secs, log = hm.build(verbose=True)
    print(f"built hamming_resolve: {path.name} in {secs:.1f} s")
    print(log.strip())

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

    t0 = time.perf_counter()
    direct = direct_phase(dev, cam, traj, frames)
    print(f"phase 3 (direct) {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    hyb = hybrid_phase(dev, cam, traj, frames)
    print(f"phase 4 (hybrid tracking) {time.perf_counter() - t0:.1f} s")

    with CallSites() as sites:
        t0 = time.perf_counter()
        full = full_hybrid_phase(dev, cam, traj, frames, sites)
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

    main_row = next(r for r in rows if r["case"] == PHASE4_CASE)
    kernels = [{
        "name": "hamming_resolve",
        "route": "cuda",
        "source": "libcml_tpu_torch/csrc/hamming_match.cu",
        "replaces": "libcml_tpu/ops/pallas_match.py:107",
        "launches": full["kernel_launches"],
        "launches_by_path": {"hybrid_tracking": hyb["launches"], "hybrid": full["kernel_launches"],
                             "relocalization": reloc["kernel_launches"]},
        "launches_per_hybrid_frame": full["kernel_launches_per_frame"],
        "max_abs_err": max_err,
        "ms": main_row["kernel_ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": None,
    }]
    print(json.dumps({"direct": direct, "hybrid_tracking": hyb, "hybrid": full,
                      "relocalization": reloc}))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
