"""Command-line entry point: the reference `modslam` binary, on the port.

Port of libcml_tpu/cli.py (reference: src/cml/slam/modslam.cpp:249-286 —
-d dataset, -c config, -r result dir, -f format tum|kitti|all, -z stats,
-b reverse, -s image dump; :53-127 dataset auto-detection; :393-410 result
export). Runs on the CUDA card unless `--device cpu` asks for the CPU.

Usage:
    python -m libcml_tpu_torch.cli -d /path/to/KITTI/sequences/04 \
        -c presets/modslam.yaml -r out -f all
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np

from libcml_tpu_torch._device import resolve_device
from libcml_tpu_torch.models.direct.config import DirectConfig
from libcml_tpu_torch.models.hybrid.decision import DecisionConfig


@dataclasses.dataclass(frozen=True)
class SlamConfig:
    """Top-level config tree addressed by dotted YAML keys (presets under
    presets/*.yaml mirror the reference's evaluation/*.yaml surface)."""

    direct: DirectConfig = dataclasses.field(default_factory=DirectConfig)
    decision: DecisionConfig = dataclasses.field(default_factory=DecisionConfig)
    max_frames_to_process: int = 0   # 0 = all
    print_stats: bool = False
    slam: str = "hybrid"             # hybrid (MOD-SLAM) | direct (DSO-only)
    orb_budget: int = 512
    orb_levels: int = 3


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("libcml-tpu-torch")
    ap.add_argument("-d", "--dataset", required=True, help="dataset path (auto-detected)")
    ap.add_argument("-c", "--config", default=None, help="YAML preset")
    ap.add_argument("-r", "--result", default=None, help="result output directory")
    ap.add_argument("-f", "--format", default="all", choices=["tum", "kitti", "all"])
    ap.add_argument("-z", "--stats", action="store_true", help="print STAT lines")
    ap.add_argument("-n", "--num-frames", type=int, default=0)
    ap.add_argument("-b", "--reverse", action="store_true",
                    help="play the sequence backwards (modslam -b)")
    ap.add_argument("-s", "--save-images", default=None,
                    help="dump processed frames as PNGs into this directory")
    ap.add_argument("-m", "--mode", default=None, choices=["hybrid", "direct"],
                    help="override config.slam")
    ap.add_argument("--snapshot-every", type=int, default=0, metavar="N",
                    help="write a map/trajectory snapshot (PLY + HTML "
                         "viewer) every N frames into <result>/snapshots "
                         "(the GUI's watch-the-map-evolve analogue; "
                         "reference: gui/MainSlamWidget.h:36)")
    ap.add_argument("--memory-limit", type=int, default=0, metavar="MB",
                    help="stop the run when host RSS exceeds this many MB "
                         "(reference: AbstractSlam.cpp:150-154)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on: cuda (default) or cpu")
    args = ap.parse_args(argv)

    from libcml_tpu_torch.data.capture import load_dataset
    from libcml_tpu_torch.runtime.config import load_yaml_config

    device = resolve_device(args.device)
    cfg = SlamConfig()
    if args.config:
        cfg = load_yaml_config(cfg, args.config)
    if args.memory_limit:
        cfg = dataclasses.replace(
            cfg, direct=dataclasses.replace(cfg.direct, memory_limit_mb=args.memory_limit))
    mode = args.mode or cfg.slam

    capture = load_dataset(args.dataset)
    # pass the FULL calibration: rectification + photometric correction run
    # on the device inside the odometry's preprocess
    if mode == "hybrid":
        from libcml_tpu_torch.runtime.hybrid import HybridOdometry

        odo = HybridOdometry(capture.calibration, cfg.direct, dcfg=cfg.decision,
                             orb_budget=cfg.orb_budget, orb_levels=cfg.orb_levels,
                             device=device)
    else:
        from libcml_tpu_torch.runtime.odometry import DirectOdometry

        odo = DirectOdometry(capture.calibration, cfg.direct, device=device)
    odo.sheet.emit = args.stats

    frames = capture.frames()
    if args.reverse:
        frames = reversed(list(frames))
    if args.save_images:
        os.makedirs(args.save_images, exist_ok=True)

    t0 = time.perf_counter()
    n_done = 0
    limit = args.num_frames or cfg.max_frames_to_process or len(capture)
    for frame in frames:
        if n_done >= limit:
            break
        stats = odo.process(frame.image, frame.timestamp,
                            gt_pose_c2w=frame.gt_pose_c2w,
                            exposure=getattr(frame, "exposure", None))
        n_done += 1
        if stats.get("state") == "STOPPED":
            break
        if args.save_images:
            from libcml_tpu_torch.native.io import write_png_gray

            write_png_gray(os.path.join(args.save_images, f"{frame.index:06d}.png"),
                           np.clip(frame.image, 0, 255).astype(np.uint8))
        if args.snapshot_every and n_done % args.snapshot_every == 0:
            from libcml_tpu_torch.viewer import snapshot

            snap_dir = os.path.join(args.result or ".", "snapshots")
            snapshot(odo, snap_dir, name=f"map_{n_done:06d}")
    wall = time.perf_counter() - t0

    print(f"Time : {wall:.2f}s  ({n_done / max(wall, 1e-9):.2f} fps)")

    err = odo.live_error()
    if err is not None:
        print(f"ATE RMSE (scale-corrected): {err['ate_rmse']:.4f} m   "
              f"RPE RMSE: {err['rpe_rmse']:.4f}")

    if args.result:
        os.makedirs(args.result, exist_ok=True)
        # five-file export straight from the system-of-record map
        # (reference: Map::exportResults, modslam.cpp:393-410)
        odo.export_results(args.result)
        odo.sheet.to_csv(os.path.join(args.result, "stats.csv"))
        with open(os.path.join(args.result, "run.json"), "w") as f:
            json.dump({"frames": n_done, "wall_s": wall,
                       "fps": n_done / max(wall, 1e-9),
                       "segments": odo.segments, "device": str(device),
                       **(err or {})}, f)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
