"""The headline benchmark on the port: bench.py's run over the synthetic
corridor, read from disk through the port's KITTI loader.

    python -m libcml_tpu_torch.bench [--frames 500] [--mode direct|hybrid|both] [--pipelined]

It renders the corridor (libcml_tpu_torch/data/corridor.py, at 640x480) into
libcml_tpu_torch/_build/kitti_synth/sequences/04 when the frames are not
there yet, reads it back through KittiCapture, and runs bench.py's run_mode
(bench.py:61-108): its DirectConfig, DirectOdometry and/or HybridOdometry
(ORB 512 per level x 3 levels), sequential unless `--pipelined` (the lag-1
finalize; the pipelined hybrid stages its keyframe postprocess over later
frames, runtime/hybrid.py), WARMUP frames before the
steady clock starts, and the same ATE alignment. It runs on the CUDA card
(`--device cpu` only when asked) and prints one JSON line with bench.py's
keys, the card's name and power limit (nvidia-smi), and per mode: total
seconds, lost segments, the stats sheet's host milliseconds per stage, the
Hamming kernel's launches, where the error builds up (error_profile), and
the frames of the keyframe and back-end events.
`--out DIR` also writes each mode's trajectory there as `<mode>_tum.txt`.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import time

import numpy as np
import torch

from libcml_tpu_torch._device import resolve_device
from libcml_tpu_torch.data import corridor
from libcml_tpu_torch.data.kitti import KittiCapture
from libcml_tpu_torch.eval.trajectory import ate_rmse, poses_to_tum, umeyama_alignment
from libcml_tpu_torch.models.direct.config import DirectConfig
from libcml_tpu_torch.ops import hamming_match as hm

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build", "kitti_synth")
REF_FPS = 3.74      # bench.py: the reference modslam binary, same sequence, host CPU
REF_ATE = 0.051     # bench.py: its scale-aligned ATE over the 500-frame run
WARMUP = 30
# bench.py:71-73, verbatim
CFG = DirectConfig(num_levels=4, max_points=2048, points_per_kf=512, init_points=512,
                   max_frames=7, tracker_iters=10, ba_iters=4)
PROFILE_EVERY = 50  # error_profile's prefix step, in frames
JUMP = 2.0          # error_profile: a step this many times the median is a jump
# frames of the stats sheet's keyframe and back-end events, beside the jumps
EVENTS = ("time_keyframe", "time_ind_post", "time_mixed_ba", "mixed_ba_rollback",
          "time_local_ba", "time_ind_tick")
STAGES = ("time_preprocess", "time_orb", "time_pnp", "time_bundle_fetch", "time_track",
          "time_keyframe", "time_ind_post", "time_ind_tick", "time_mixed_ba",
          "time_local_ba")


def card() -> str | None:
    """`nvidia-smi`'s name and power limit of the first card."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def ensure_sequence(frames: int, device: torch.device, root: str = ROOT) -> str:
    """The corridor's KITTI directory under `root`, rendered on `device`
    up to max(frames, 200) frames if it holds fewer than `frames`."""
    seq_dir = os.path.join(root, "sequences", corridor.SEQ)
    img_dir = os.path.join(seq_dir, "image_0")
    have = len(os.listdir(img_dir)) if os.path.isdir(img_dir) else 0
    if have < frames:
        corridor.write_sequence(root, max(frames, 200), device=device)
    return seq_dir


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def error_profile(frame_idx: np.ndarray, est_xyz: np.ndarray, gt_xyz: np.ndarray,
                  every: int = PROFILE_EVERY) -> dict:
    """Where a run's error builds up: the scale-aligned ATE of every prefix
    of `every`, 2 `every`, ... frames, each aligned on its own (the first
    prefix over a target bounds the frame where the run leaves it), the
    frame with the largest error under the whole run's alignment, and the
    jumps: the frames the estimate reaches by a step over JUMP times the
    median step (the ground truth moves a constant 0.08 m a frame), with
    that ratio."""
    R, t, s = umeyama_alignment(est_xyz, gt_xyz, with_scale=True)
    err = np.linalg.norm((s * (R @ est_xyz.T)).T + t - gt_xyz, axis=1)
    step = np.linalg.norm(np.diff(est_xyz, axis=0), axis=1)
    ratio = step / max(float(np.median(step)), 1e-12) if len(step) else step
    prefix = {}
    for k in range(every, int(frame_idx.max()) + 1, every):
        keep = frame_idx < k
        prefix[str(k)] = float(ate_rmse(est_xyz[keep], gt_xyz[keep], with_scale=True))
    worst = int(np.argmax(err))
    return {"ate_prefix": prefix, "worst_frame": int(frame_idx[worst]),
            "worst_err": float(err[worst]),
            "jumps": [[int(frame_idx[j + 1]), float(ratio[j])]
                      for j in np.flatnonzero(ratio > JUMP)]}


def run_mode(seq_dir: str, mode: str, frames: int, device: torch.device,
             cfg: DirectConfig = CFG, out_dir: str | None = None,
             pipelined: bool = False) -> dict:
    """bench.py's run_mode (with its `pipelined`) on the port: the first `frames` frames of the
    KITTI sequence at `seq_dir`, decoded before the clock starts; the
    trajectory goes to `out_dir`/<mode>_tum.txt when it is given."""
    from libcml_tpu_torch.runtime.hybrid import HybridOdometry
    from libcml_tpu_torch.runtime.odometry import DirectOdometry

    cap = KittiCapture(seq_dir)
    cam = cap.calibration.pinhole
    n = min(frames, len(cap))
    if mode == "hybrid":
        odo = HybridOdometry(cam, cfg, pipelined=pipelined, device=device)
    else:
        odo = DirectOdometry(cam, cfg, pipelined=pipelined, device=device)
    imgs = []
    for frame in cap.frames():
        if len(imgs) == n:
            break
        imgs.append(frame.image)
    gt = cap.gt[:n] if cap.gt is not None else None

    hm.hamming_resolve_cuda.launches = 0
    _sync(device)
    t_steady = None
    t0 = time.perf_counter()
    for i, img in enumerate(imgs):
        if i == WARMUP:
            _sync(device)
            t_steady = time.perf_counter()
        odo.process(img, i * 0.1)
    ts, est = odo.trajectory_c2w()
    _sync(device)
    t_end = time.perf_counter()

    out = {
        "steady_fps": (n - WARMUP) / (t_end - t_steady) if t_steady is not None else None,
        "total_s": t_end - t0,
        "frames": n,
        "segments": odo.segments,
        "pipelined": pipelined,
        "host_ms_per_stage": {name: statistics.mean(odo.sheet.stat(name).series()[1])
                              for name in STAGES if odo.sheet.stat(name).series()[1]},
        "stage_calls": {name: len(odo.sheet.stat(name).series()[1]) for name in STAGES
                        if odo.sheet.stat(name).series()[1]},
        "kernel_launches": hm.hamming_resolve_cuda.launches,
    }
    if mode == "hybrid":
        out["modes"] = {m: odo.mode_history.count(m) for m in sorted(set(odo.mode_history))}
        out["map_points"] = int(odo._pt_valid.sum())
        out["indirect_keyframes"] = len(odo._ind_kfs)
    if gt is not None:
        idx = np.clip(np.round(np.asarray(ts) / 0.1).astype(int), 0, n - 1)
        out["ate"] = float(ate_rmse(est[:, :3, 3], gt[idx, :3, 3], with_scale=True))
        out["error_profile"] = error_profile(idx, est[:, :3, 3], gt[idx, :3, 3])
    out["event_frames"] = {name: [int(f) for f in odo.sheet.stat(name).series()[0]]
                           for name in EVENTS if odo.sheet.stat(name).series()[0]}
    if out_dir is not None:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, f"{mode}_tum.txt"), "w") as f:
            f.write(poses_to_tum(np.asarray(ts), est))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("libcml_tpu_torch.bench")
    ap.add_argument("--frames", type=int, default=500)
    ap.add_argument("--mode", default="both", choices=["direct", "hybrid", "both"])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--out", default=None, help="directory for each mode's trajectory")
    ap.add_argument("--pipelined", action="store_true",
                    help="the lag-1 pipelined modes (bench.py's direct_pipelined / "
                         "hybrid_pipelined)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    t0 = time.perf_counter()
    seq_dir = ensure_sequence(args.frames, dev)
    prepare_s = time.perf_counter() - t0
    modes = ["direct", "hybrid"] if args.mode == "both" else [args.mode]
    details = {m: run_mode(seq_dir, m, args.frames, dev, out_dir=args.out,
                           pipelined=args.pipelined) for m in modes}

    first = details[modes[0]]
    tag = "_pipelined" if args.pipelined else ""
    result = {
        "metric": f"{modes[0]}{tag}_measured_fps_640x480_2048pts_{first['frames']}f",
        "value": first["steady_fps"],
        "unit": "frames/s",
        "vs_baseline": (first["steady_fps"] / REF_FPS
                        if first["steady_fps"] is not None else None),
        "baseline": {"reference_fps_measured": REF_FPS, "reference_ate_measured": REF_ATE},
        "frames": first["frames"],
    }
    if "direct" in details:
        result["direct_ate"] = details["direct"].get("ate")
        result["direct_segments"] = details["direct"]["segments"]
    if "hybrid" in details:
        result["hybrid_fps"] = details["hybrid"]["steady_fps"]
        result["hybrid_ate"] = details["hybrid"].get("ate")
        result["hybrid_segments"] = details["hybrid"]["segments"]
    result.update({
        "device": str(dev),
        "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "card": card() if dev.type == "cuda" else None,
        "sequence_s": prepare_s,
        "details": details,
    })
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
