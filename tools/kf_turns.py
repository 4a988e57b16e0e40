"""The direct path's keyframe cost in this tree and another, in turns, on one
card.

    python3 tools/kf_turns.py --parent DIR [--out DIR2]

DIR is another checkout of the repository (`git archive <commit> | tar -x
-C _archive/DIR`, a git-ignored directory). The turns run parent, tree,
tree, parent; each turn, in its tree's own directory and process, builds
that tree's kernels, runs its own `python -m libcml_tpu_torch.profile_slice`
(its JSON lines as profile_<turn>.log in DIR2, profile_out/ by default; its
Chrome traces in the temporary directory), then runs DirectOdometry on
workload.py's 60 frames twice and reads the stats sheet's `time_keyframe`
(host ms of each keyframe event: the activation, the insert and window
BA, the refresh). Prints, per turn, the profile's windows (wall ms a
frame, device-busy share, launches and host waits a frame; the keyframe
programs' spans) and the keyframe times. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
SPANS = ("_activate_and_clear", "_refresh_after_kf", "kf_activate", "kf_refresh",
         "kf_tracker_ref", "_kf_insert_and_ba", "_frame_step", "time_mixed_ba")
WINDOW_KEYS = ("window", "wall_ms_per_frame", "device_busy_share", "kernel_launches_per_frame",
               "sync_calls_per_frame")


def keyframe_times(runs: int = 2) -> list[dict]:
    """time_keyframe of `runs` fresh 60-frame DirectOdometry runs of the
    package on sys.path (run inside a turn's process)."""
    import torch

    from libcml_tpu_torch import workload as wl
    from libcml_tpu_torch.runtime.odometry import DirectOdometry

    cam, _, frames = wl.render_frames(torch.device("cuda"), 60)
    imgs = [f[0].cpu().numpy() for f in frames]
    out = []
    for run in range(runs):
        odo = DirectOdometry(cam, wl.BENCH_CFG)
        for i, img in enumerate(imgs):
            odo.process(img, float(i))
        torch.cuda.synchronize()
        _, ms = odo.sheet.stat("time_keyframe").series()
        out.append({"run": run, "keyframes": len(ms), "mean_ms": statistics.mean(ms),
                    "median_ms": statistics.median(ms), "ms": list(ms)})
    return out


def turn(name: str, tree: Path, out: Path) -> dict:
    """One turn in `tree`'s directory: its kernels, its profile_slice, the
    keyframe times."""
    py = sys.executable
    subprocess.run([py, "-c", "from libcml_tpu_torch.ops import kernel_build as kb; "
                    "kb.build_many(kb.SOURCES)"], cwd=tree, check=True)
    log = out / f"profile_{name}.log"
    with open(log, "w") as f:
        subprocess.run([py, "-m", "libcml_tpu_torch.profile_slice", "--out",
                        str(Path(tempfile.gettempdir()) / f"kf_turns_{name}")], cwd=tree,
                       stdout=f, stderr=subprocess.STDOUT, check=True)
    kf = subprocess.run([py, str(Path(__file__).resolve()), "--keyframe-times"], cwd=tree,
                        capture_output=True, text=True, check=True,
                        env={**os.environ, "PYTHONPATH": str(tree)})
    windows = []
    for line in log.read_text().splitlines():
        if line.startswith("{"):
            d = json.loads(line)
            st = d.get("stages_per_frame", {})
            windows.append({**{k: d.get(k) for k in WINDOW_KEYS},
                            "spans": {k: st[k] for k in SPANS if k in st}})
    return {"turn": name, "tree": str(tree), "windows": windows,
            "time_keyframe": json.loads(kf.stdout.strip().splitlines()[-1])}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=Path, help="another checkout of the repository")
    ap.add_argument("--out", type=Path, default=ROOT / "profile_out")
    ap.add_argument("--keyframe-times", action="store_true", help=argparse.SUPPRESS)
    opts = ap.parse_args(argv)
    if opts.keyframe_times:        # inside a turn: the tree's package is on sys.path
        print(json.dumps(keyframe_times()))
        return 0
    import torch

    if not torch.cuda.is_available():
        print("kf_turns: CUDA is not available", file=sys.stderr)
        return 1
    if opts.parent is None:
        ap.error("--parent is required")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    print(card)
    opts.out.mkdir(parents=True, exist_ok=True)
    for name, tree in (("parent", opts.parent.resolve()), ("tree", ROOT), ("tree2", ROOT),
                       ("parent2", opts.parent.resolve())):
        print(json.dumps({"card": card, **turn(name, tree, opts.out)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
