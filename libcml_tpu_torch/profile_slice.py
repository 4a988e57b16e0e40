"""Where the time goes on the card: torch.profiler over the slice's main path.

    python -m libcml_tpu_torch.profile_slice [--out DIR]

Runs sequential DirectOdometry on chip_smoke.py's workload (libcml_tpu_torch/
workload.py: 640x480, bench.py's configuration) for 40 frames, profiling the
last 10, then profiles 10 frames of the hybrid's tracking programs
(_project_match_pnp + _local_map_pass2 against the 4096-slot map), then runs
bench.py's sequential HybridOdometry for 40 frames, profiling the last 10
(its stages carry the names of the hybrid's stats timers: time_orb,
time_pnp, time_ind_post, time_mixed_ba, time_local_ba; inside
time_mixed_ba, `_build_mixed_factors`, the factors' host loop, and
`run_ba_mixed`). For each window it
prints one JSON line: wall milliseconds per frame, the device's
busy share (summed device time of kernels, copies and fills over wall time),
kernel launches and host-to-device synchronizations per frame, the kernels
and the host operators that take the most time, and a per-stage breakdown.
The stages are the port's own functions, wrapped here in `record_function`
spans for the profiled windows only; a stage's numbers include the stages
nested in it. A stage's device time is that of the work its CUDA runtime
calls enqueued, matched by their correlation ids, so a kernel launched
through ctypes (the hand-written kernels) counts as well as one launched by
a torch operator; `kf_activate`, `kf_refresh` and `kf_tracker_ref` are the
keyframe programs' kernels (inside `_activate_and_clear`,
`_refresh_after_kf` and the hybrid's reference rebuilds); `track_lm` and
`pnp_lm` are the LM kernels' launches
(inside `track`, `track_multi` and `solve_pnp`), `trace_epipolar` the
tracer kernel's (inside `trace_immatures_rows`), `local_ba` the local BA
kernel's (inside `time_local_ba`). `_preprocess` (or
`_preprocess_rect` where the sequence has a calibration) is the frame's
gradient pyramid, `_frame_step` the whole tracked frame (the tracking, the
tracer and `_scalar_bundle`, the frame's scalars for the host, among it).
A Chrome trace of each
window goes under `--out`. Needs a
CUDA card; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

from libcml_tpu_torch import workload as wl
from libcml_tpu_torch.models.direct import ba, tracer, tracker
from libcml_tpu_torch.models.indirect import indirect_ba, matching, pnp
from libcml_tpu_torch.models.indirect.bow import default_vocabulary
from libcml_tpu_torch.runtime import hybrid, odometry
from libcml_tpu_torch.runtime.odometry import DirectOdometry

FRAMES = 40                  # direct frames run, the last WINDOW of them profiled
WINDOW = 10                  # frames in each profiled window
SYNC_OPS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaMemcpyAsync",
            "cudaEventSynchronize")
LAUNCH_OPS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
              "cudaLaunchCooperativeKernel")
# (module or class, function name, stage name) of each stage, outermost
# first; the hybrid's stages are named after the stats timers around them
HYB = hybrid.HybridOdometry
STAGES = (
    (odometry, "_preprocess", "_preprocess"), (hybrid, "_preprocess", "_preprocess"),
    (odometry, "_preprocess_rect", "_preprocess_rect"),
    (odometry, "_frame_step", "_frame_step"),
    (odometry, "track", "track"), (odometry, "track_multi", "track_multi"),
    (tracker, "track_lm_cuda", "track_lm"),
    (tracker, "evaluate_residuals", "evaluate_residuals"), (tracker, "se3_exp", "se3_exp"),
    (odometry, "trace_immatures_rows", "trace_immatures_rows"),
    (tracer, "trace_rows_cuda", "trace_epipolar"),
    (odometry, "_scalar_bundle", "_scalar_bundle"),
    (odometry, "_kf_insert_and_ba", "_kf_insert_and_ba"),
    (odometry, "_activate_and_clear", "_activate_and_clear"),
    (odometry, "kf_activate_cuda", "kf_activate"),
    (odometry, "_refresh_after_kf", "_refresh_after_kf"),
    (odometry, "refresh_cuda", "kf_refresh"),
    (odometry, "tracker_ref_cuda", "kf_tracker_ref"),
    (ba, "run_ba", "run_ba"), (ba, "update_residual_status", "update_residual_status"),
    (ba, "_marg_pieces", "_marg_pieces"), (ba, "marg_host_schur", "marg_host_schur"),
    (hybrid, "_extract", "time_orb"), (hybrid, "_project_match_pnp", "time_pnp"),
    (hybrid, "_local_map_pass2", "_local_map_pass2"),
    (HYB, "_indirect_postprocess", "time_ind_post"),
    (hybrid, "_epipolar_triangulate", "_epipolar_triangulate"),
    (HYB, "_dispatch_mixed_window_ba", "time_mixed_ba"),
    (HYB, "_complete_mixed_window_ba", "time_mixed_ba"),
    (HYB, "_build_mixed_factors", "_build_mixed_factors"), (ba, "run_ba_mixed", "run_ba_mixed"),
    (HYB, "_dispatch_indirect_local_ba", "time_local_ba"),
    (HYB, "_complete_indirect_local_ba", "time_local_ba"),
    (indirect_ba, "local_ba_cuda", "local_ba"),
    (hybrid, "match_projection", "match_projection"),
    (matching, "hamming_resolve", "hamming_resolve"), (hybrid, "solve_pnp", "solve_pnp"),
    (pnp, "pnp_lm_cuda", "pnp_lm"),
)


def _span(name, fn):
    def wrapped(*args, **kw):
        with torch.profiler.record_function("stage:" + name):
            return fn(*args, **kw)
    return wrapped


def instrument() -> None:
    """Wrap every stage function in a named span (profiling windows only)."""
    for owner, attr, name in STAGES:
        setattr(owner, attr, _span(name, getattr(owner, attr)))


def _is_span(name: str) -> bool:
    return name.startswith("stage:")


def _is_runtime_call(e) -> bool:
    """A CUDA runtime or driver call on the host (cudaLaunchKernel, ...)."""
    return e.device_type.name == "CPU" and e.name.startswith("cu") and "::" not in e.name


def _device_events(prof) -> list:
    """Kernels, copies and fills on the device timeline (not the spans'
    device-side copies)."""
    return [e for e in prof.events() if e.device_type.name != "CPU" and not _is_span(e.name)]


def stage_table(prof, n_frames: int) -> dict:
    """Per stage: calls, host ms, device ms and kernel launches a frame. A
    stage's device ms sums the device work whose correlation id is that of a
    runtime call made inside the span."""
    dev_us = collections.Counter()
    for e in _device_events(prof):
        dev_us[e.id] += e.time_range.elapsed_us()
    out = {}
    for e in prof.events():
        if not _is_span(e.name) or e.device_type.name != "CPU":
            continue
        launches, device_us, todo = 0, 0.0, list(e.cpu_children)
        while todo:
            c = todo.pop()
            if _is_runtime_call(c):
                launches += c.name in LAUNCH_OPS
                device_us += dev_us.get(c.id, 0.0)
            todo.extend(c.cpu_children)
        row = out.setdefault(e.name[6:], [0, 0.0, 0.0, 0])
        row[0] += 1
        row[1] += e.cpu_time_total * 1e-3
        row[2] += device_us * 1e-3
        row[3] += launches
    return {k: {"calls": v[0] / n_frames, "host_ms": v[1] / n_frames,
                "device_ms": v[2] / n_frames, "launches": v[3] / n_frames}
            for k, v in out.items()}


def summarize(prof, name: str, n_frames: int, wall_s: float, out_dir: str) -> dict:
    by_kernel = collections.Counter()
    for e in _device_events(prof):
        by_kernel[e.name[:80]] += e.time_range.elapsed_us()
    host = [e for e in prof.key_averages() if not _is_span(e.key)]
    syncs = {e.key: e.count for e in host if e.key in SYNC_OPS}
    top_cpu = sorted(host, key=lambda e: e.self_cpu_time_total, reverse=True)[:15]
    launches = sum(e.count for e in host if e.key in LAUNCH_OPS)
    prof.export_chrome_trace(os.path.join(out_dir, f"trace_{name}.json.gz"))
    return {
        "window": name, "frames": n_frames,
        "wall_ms_per_frame": wall_s * 1e3 / n_frames,
        "device_busy_share": sum(by_kernel.values()) * 1e-6 / wall_s,
        "kernel_launches_per_frame": launches / n_frames,
        "sync_calls_per_frame": {k: v / n_frames for k, v in syncs.items()},
        "top_device_ms_per_frame": {k: us * 1e-3 / n_frames
                                    for k, us in by_kernel.most_common(15)},
        "top_host_ms_per_frame": {e.key[:80]: e.self_cpu_time_total * 1e-3 / n_frames
                                  for e in top_cpu},
        "stages_per_frame": stage_table(prof, n_frames),
    }


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="profile_out", help="directory for the Chrome traces")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_slice: CUDA is not available", file=sys.stderr)
        return 1
    os.makedirs(args.out, exist_ok=True)
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60, check=True).stdout.strip().splitlines()[0]
    cam, traj, frames = wl.render_frames(dev, FRAMES)
    imgs = [f[0].cpu().numpy() for f in frames]
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]

    odo = DirectOdometry(cam, wl.BENCH_CFG)
    start = FRAMES - WINDOW
    for i in range(start):
        odo.process(imgs[i], float(i))
    torch.cuda.synchronize()
    instrument()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for i in range(start, FRAMES):
            odo.process(imgs[i], float(i))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    res = summarize(prof, "direct", WINDOW, wall, args.out)
    res["card"] = card
    print(json.dumps(res))

    map_, _ = wl.build_map(cam, traj, frames, dev)
    feats = {i: wl.extract(frames[i]) for i in range(1, WINDOW + 2)}

    def track(i):
        return wl.track_frame(map_, cam, traj, feats[i], i, dev)[2].cpu()

    track(1)
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for i in range(2, WINDOW + 2):
            track(i)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    res = summarize(prof, "hybrid_tracking", WINDOW, wall, args.out)
    res["card"] = card
    print(json.dumps(res))

    default_vocabulary()                    # built (or loaded) outside the window
    odo = wl.hybrid_odometry(cam)
    for i in range(start):
        odo.process(imgs[i], float(i))
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for i in range(start, FRAMES):
            odo.process(imgs[i], float(i))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    res = summarize(prof, "hybrid", WINDOW, wall, args.out)
    res["card"] = card
    res["indirect_keyframes_in_window"] = sum(
        start <= f < FRAMES for f in odo.sheet.stat("time_ind_post").series()[0])
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
