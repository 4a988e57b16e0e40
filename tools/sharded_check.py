"""Point-sharded odometry across the cards of one machine.

    python3 -m torch.distributed.run --standalone --nproc_per_node=N \\
        tools/sharded_check.py [--frames 60] [--modes direct,hybrid]
    python3 tools/sharded_check.py            # a world of one, this card

Every rank runs the smoke's workload (libcml_tpu_torch/workload.py: 640x480
frames, bench.py's configuration) unsharded on its own card (which also
warms the card), then with `mesh=make_mesh()` (NCCL, one card a rank).
Rank 0 prints one JSON line a mode: the card's name and power limit, the
world size, fps of both runs, the all-reduces and all-gathers a frame,
whether every rank's sharded trajectory and window (the hybrid: its map)
equal rank 0's bit for bit, the ATE of both runs, where the sharded
trajectory first leaves the unsharded one by more than 1e-4, and whether it
keeps tests/test_multichip.py's 12-frame bounds (per-frame relative
translations rtol 1e-2 / atol 1e-5, path length rtol 2e-3). Exits non-zero
when a rank's sharded state differs from rank 0's. Needs CUDA.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from libcml_tpu_torch import workload as wl  # noqa: E402
from libcml_tpu_torch.eval.trajectory import ate_rmse  # noqa: E402
from libcml_tpu_torch.ops import hamming_match as hm  # noqa: E402
from libcml_tpu_torch.parallel.sharding import make_mesh  # noqa: E402
from libcml_tpu_torch.runtime.odometry import DirectOdometry  # noqa: E402


def _make(mode: str, cam, mesh):
    if mode == "direct":
        return DirectOdometry(cam, wl.BENCH_CFG, mesh=mesh)
    return wl.hybrid_odometry(cam, mesh=mesh)


def _run(odo, imgs) -> tuple[float, np.ndarray, dict]:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i, img in enumerate(imgs):
        odo.process(img, float(i))
    _, est = odo.trajectory_c2w()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ba = odo._window.ba
    state = {"trajectory": est, "idepth": ba.idepth.cpu().numpy(),
             "point_valid": ba.point_valid.cpu().numpy(), "T_t": ba.T.t.cpu().numpy()}
    if hasattr(odo, "_pt_Xw"):
        state.update(pt_valid=odo._pt_valid, pt_Xw=odo._pt_Xw)
    return wall, est, state


def _digest(state: dict) -> str:
    h = hashlib.sha256()
    for k in sorted(state):
        h.update(k.encode())
        h.update(np.ascontiguousarray(state[k]).tobytes())
    return h.hexdigest()


def _centres(traj) -> np.ndarray:
    out = []
    for R, t in traj:
        M = np.eye(4)
        M[:3, :3], M[:3, 3] = R, t
        out.append(np.linalg.inv(M)[:3, 3])
    return np.asarray(out)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--modes", default="direct,hybrid")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("sharded_check: CUDA is not available", file=sys.stderr)
        return 1
    mesh = make_mesh()
    dev = mesh.device
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader", "-i", str(dev.index)],
                          capture_output=True, text=True, check=True).stdout.strip()
    hm.build()
    cam, traj, frames = wl.render_frames(dev, args.frames)
    imgs = [f[0].cpu().numpy() for f in frames]
    gt = _centres(traj)
    ok = True
    for mode in args.modes.split(","):
        wall0, est0, _ = _run(_make(mode, cam, None), imgs)
        dist.barrier()
        mesh.all_reduces = mesh.all_gathers = 0
        wall, est, state = _run(_make(mode, cam, mesh), imgs)
        reduces, gathers = mesh.all_reduces, mesh.all_gathers
        digests = [None] * mesh.world_size
        dist.all_gather_object(digests, _digest(state))
        ok &= len(set(digests)) == 1
        if mesh.rank == 0:
            gap = np.abs(est - est0).max(axis=(1, 2))
            rel_a = np.linalg.norm(np.diff(est0[:, :3, 3], axis=0), axis=1)
            rel_b = np.linalg.norm(np.diff(est[:, :3, 3], axis=0), axis=1)
            moving = rel_a > 1e-4
            per_frame = np.abs(rel_b - rel_a)[moving] <= 1e-5 + 1e-2 * np.abs(rel_a[moving])
            path_gap = abs(rel_b[moving].sum() - rel_a[moving].sum()) / rel_a[moving].sum()
            n = len(imgs)
            res = {"mode": mode, "card": card, "world_size": mesh.world_size,
                   "backend": dist.get_backend(), "frames": n,
                   "fps_sharded": n / wall, "fps_unsharded": n / wall0,
                   "all_reduces_per_frame": reduces / n, "all_gathers_per_frame": gathers / n,
                   "ranks_identical": len(set(digests)) == 1,
                   "ate_sharded": ate_rmse(est[:, :3, 3], gt, with_scale=True),
                   "ate_unsharded": ate_rmse(est0[:, :3, 3], gt, with_scale=True),
                   "max_abs_traj_diff": float(gap.max()),
                   "first_frame_over_1e-4": int(np.argmax(gap > 1e-4)) if (gap > 1e-4).any()
                   else None,
                   "max_abs_traj_diff_per_10_frames": [float(gap[i:i + 10].max())
                                                       for i in range(0, n, 10)],
                   "rel_translation_within_bounds": bool(per_frame.all()),
                   "path_length_rel_gap": float(path_gap)}
            print(json.dumps(res), flush=True)
        dist.barrier()
    flags = [None] * mesh.world_size
    dist.all_gather_object(flags, ok)
    dist.destroy_process_group()
    return 0 if flags[0] else 1


if __name__ == "__main__":
    sys.exit(main())
