"""Frame-by-frame A/B of the two packages' HybridOdometry on the corridor.

    python tools/hybrid_ab.py run --package jax   --frames 40 --out ab_jax.json
    python tools/hybrid_ab.py run --package torch --frames 40 --device cpu --out ab_cpu.json
    python tools/hybrid_ab.py run --package torch --frames 40 --device cuda --out ab_gpu.json
    python tools/hybrid_ab.py step --frames 40 --device cuda --out ab_step.json
    python tools/hybrid_ab.py init --frames 5 --threads 1
    python tools/hybrid_ab.py compare ab_jax.json ab_cpu.json [ab_gpu.json]

`run` writes the first N frames of the bench's corridor (data/corridor.py,
640x480) with the port's KITTI writer under libcml_tpu_torch/_build/kitti_ab
(rendered on the CPU so every run reads the same PNGs; `--render cuda`
renders them on the card, as the port's bench does, and `--seq-root` reads
another sequence; a sequence that already holds N frames is left as it
is), reads them through the chosen package's own KittiCapture, and drives its HybridOdometry with
bench.py's configuration (bench.py:71-77: DirectConfig(num_levels=4,
max_points=2048, points_per_kf=512, init_points=512, max_frames=7,
tracker_iters=10, ba_iters=4), ORB 512 per level x 3 levels, sequential).
Per frame it records: the returned state, kf and mode; the frame's live
camera-to-world pose in the map (deform chains resolved, as recorded at that
frame); the indirect keyframe frames; the map-point count; and, for each
mixed BA that completes, each window keyframe's pose change at the
write-back (_complete_mixed_window_ba -> _sync_kf_poses). At the end it adds
the final trajectory and its scale-aligned ATE over every 10-frame prefix.

`step` drives the port on the card and, before every frame, loads its
checkpoint (written beside `--out`) into a CPU instance that processes the
same frame: the frames where one step on the card leaves the same step on
the CPU from identical state, with the frame's scalar and PnP bundles.

`init` runs both packages' direct initializer on the first frames, on
the CPU, from the same pyramids: each package chained on its own state, one
port step from the JAX state, and one JAX step from its own state with each
inverse depth moved by one ulp, and that JAX chain.

`compare` prints, for each run after the first, the first frame whose live
pose leaves the first run's by more than 2e-3 (the hybrid parity test's
tolerance), the first frame where any other recorded quantity differs, and
both runs' prefix ATEs and jumps. Only the JAX runs import the JAX package.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
SEQ_ROOT = os.path.join(ROOT, "libcml_tpu_torch", "_build", "kitti_ab")
CFG_KW = dict(num_levels=4, max_points=2048, points_per_kf=512, init_points=512,
              max_frames=7, tracker_iters=10, ba_iters=4)
ORB = dict(orb_budget=512, orb_levels=3)
TOL = 2e-3


def ensure_frames(n: int, root: str = SEQ_ROOT, render: str = "cpu") -> str:
    """The sequence under `root`, written only when it holds fewer than `n`
    frames, so that a shorter run leaves a longer sequence as it is."""
    from libcml_tpu_torch.data import corridor

    seq_dir = os.path.join(root, "sequences", corridor.SEQ)
    try:
        with open(os.path.join(seq_dir, "times.txt")) as f:
            have = sum(1 for _ in f)
    except FileNotFoundError:
        have = 0
    if have >= n:
        return seq_dir
    return corridor.write_sequence(root, n, device=render)


def make_odometry(package: str, cam, device: str):
    if package == "jax":
        from libcml_tpu.models.direct.config import DirectConfig
        from libcml_tpu.runtime.hybrid import HybridOdometry

        return HybridOdometry(cam, DirectConfig(**CFG_KW), **ORB)
    from libcml_tpu_torch.models.direct.config import DirectConfig
    from libcml_tpu_torch.runtime.hybrid import HybridOdometry

    return HybridOdometry(cam, DirectConfig(**CFG_KW), device=device, **ORB)


def capture(package: str, seq_dir: str):
    if package == "jax":
        from libcml_tpu.data.kitti import KittiCapture
    else:
        from libcml_tpu_torch.data.kitti import KittiCapture
    return KittiCapture(seq_dir)


def _kf_poses(odo) -> dict[int, np.ndarray]:
    """Absolute map pose (w2c 4x4) of every window keyframe's map entry."""
    out = {}
    for fid, i in odo._fid2map.items():
        if odo.map.f_ref[i] < 0:
            out[int(fid)] = odo.map.f_pose[i].copy()
    return out


def _pose_delta(A: np.ndarray, B: np.ndarray) -> tuple[float, float]:
    """(camera-centre shift, rotation angle in rad) between two w2c poses."""
    cA = -A[:3, :3].T @ A[:3, 3]
    cB = -B[:3, :3].T @ B[:3, 3]
    dR = B[:3, :3] @ A[:3, :3].T
    ang = float(np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1)))
    return float(np.linalg.norm(cB - cA)), ang


def _frame_record(odo, out, i) -> dict:
    _, c2w = odo.map.trajectory_c2w()
    return {"frame": i, "state": out.get("state"), "kf": bool(out.get("kf", False)),
            "mode": out.get("mode"), "pose": c2w[-1][:3].tolist(),
            "ind_kfs": [int(k["frame"]) for k in odo._ind_kfs],
            "map_points": int(odo._pt_valid.sum())}


def _watch_bundles(odo) -> dict:
    """Keeps the last finalized frame's scalar bundle and PnP bundle."""
    seen = {}
    inner = odo._finalize_frame

    def fin(entry):
        out = inner(entry)
        sc = entry.get("scalars_np")
        seen["scalars"] = None if sc is None else np.asarray(sc).tolist()
        pnp = entry.get("pnp_np")
        seen["pnp"] = None if pnp is None else np.asarray(pnp[0]).tolist()
        return out

    odo._finalize_frame = fin
    return seen


def step(frames: int, device: str, ckpt: str) -> dict:
    """The port on `device`, and before each frame a CPU instance loaded from
    its checkpoint that processes the same frame: where one step on the
    device leaves the same step on the CPU, from identical state."""
    seq_dir = ensure_frames(frames)
    cap = capture("torch", seq_dir)
    cam = cap.calibration.pinhole
    odo = make_odometry("torch", cam, device)
    seen = _watch_bundles(odo)
    rows = []
    for i, frame in enumerate(cap.frames()):
        if i == frames:
            break
        odo.save_state(ckpt)
        cpu = make_odometry("torch", cam, "cpu")
        cpu.load_state(ckpt)
        seen_cpu = _watch_bundles(cpu)
        a = _frame_record(odo, odo.process(frame.image, i * 0.1), i)
        a.update(scalars=seen.get("scalars"), pnp=seen.get("pnp"))
        b = _frame_record(cpu, cpu.process(frame.image, i * 0.1), i)
        b.update(scalars=seen_cpu.get("scalars"), pnp=seen_cpu.get("pnp"))
        gap = float(np.abs(np.asarray(a["pose"]) - np.asarray(b["pose"])).max())
        sc_gap = (None if a["scalars"] is None or b["scalars"] is None else
                  float(np.nanmax(np.abs(np.asarray(a["scalars"]) - np.asarray(b["scalars"])))))
        rows.append({"device": a, "cpu": b, "pose_gap": gap, "scalars_gap": sc_gap,
                     "same": {k: a[k] == b[k] for k in ("state", "kf", "mode", "ind_kfs",
                                                        "map_points")}})
        print(f"step {i}: gap {gap:.3g} scalars {sc_gap} same {rows[-1]['same']}", flush=True)
    _, est = odo.trajectory_c2w()
    gt = cap.gt[:len(rows)]
    from libcml_tpu_torch.eval.trajectory import ate_rmse

    prefix = {str(k): float(ate_rmse(est[:k, :3, 3], gt[:k, :3, 3], with_scale=True))
              for k in range(10, len(rows) + 1, 10)}
    return {"package": "torch", "device": device, "frames": len(rows), "rows": rows,
            "ate_prefix": prefix, "final_c2w": est[:, :3].tolist()}


def run(package: str, frames: int, device: str, root: str = SEQ_ROOT,
        render: str = "cpu") -> dict:
    seq_dir = ensure_frames(frames, root, render)
    cap = capture(package, seq_dir)
    cam = cap.calibration.pinhole
    odo = make_odometry(package, cam, device)
    writebacks = []
    inner = odo._complete_mixed_window_ba

    def complete(mx, fetched):
        before = _kf_poses(odo)
        rolled = len(odo.sheet.stat("mixed_ba_rollback").series()[1])
        out = inner(mx, fetched)
        after = _kf_poses(odo)
        rolled_back = len(odo.sheet.stat("mixed_ba_rollback").series()[1]) > rolled
        moves = {fid: _pose_delta(before[fid], after[fid])
                 for fid in sorted(after) if fid in before}
        writebacks.append({"frame": int(odo.frame_idx), "rolled_back": rolled_back,
                           "kf_moves": {str(k): v for k, v in moves.items()}})
        return out

    odo._complete_mixed_window_ba = complete
    rows = []
    t0 = time.perf_counter()
    for i, frame in enumerate(cap.frames()):
        if i == frames:
            break
        rows.append(_frame_record(odo, odo.process(frame.image, i * 0.1), i))
        print(f"{package} frame {i}: {rows[-1]['state']} kf={rows[-1]['kf']} "
              f"mode={rows[-1]['mode']} map={rows[-1]['map_points']}", flush=True)
    wall = time.perf_counter() - t0
    _, est = odo.trajectory_c2w()
    gt = cap.gt[:len(rows)]
    prefix = {}
    from libcml_tpu_torch.eval.trajectory import ate_rmse

    for k in range(10, len(rows) + 1, 10):
        prefix[str(k)] = float(ate_rmse(est[:k, :3, 3], gt[:k, :3, 3], with_scale=True))
    return {"package": package, "device": device, "frames": len(rows), "wall_s": wall,
            "rows": rows, "mixed_writebacks": writebacks, "final_c2w": est[:, :3].tolist(),
            "ate_prefix": prefix}


def init_steps(frames: int = 5, threads: int = 1, root: str = SEQ_ROOT) -> list[dict]:
    """Both packages' direct initializer on the sequence's first `frames`
    frames, on the CPU: the decoded images, pyramids and first-frame points
    compared exactly, then for each later frame the pose gap (rotation and
    translation entries, max abs) of each package's own chained state, of
    one port step from the JAX state, and of one JAX step from its own state
    with every inverse depth moved by one ulp, and of the JAX chain
    started from the first frame's state so moved. The port runs on `threads`
    torch threads, whose count changes its sums' order."""
    import jax.numpy as jnp
    import torch
    from libcml_tpu.models.direct import initializer as jinit
    from libcml_tpu.models.direct.config import DirectConfig as JCfg
    from libcml_tpu.runtime import odometry as jodo
    from libcml_tpu_torch import convert
    from libcml_tpu_torch.models.direct import initializer as tinit
    from libcml_tpu_torch.models.direct.config import DirectConfig as TCfg
    from libcml_tpu_torch.runtime import odometry as todo

    torch.set_num_threads(threads)
    seq_dir = ensure_frames(frames, root)
    caps = capture("jax", seq_dir), capture("torch", seq_dir)
    imgs = [[np.asarray(f.image, np.float32) for _, f in zip(range(frames), c.frames())]
            for c in caps]
    jcam, tcam = (c.calibration.pinhole for c in caps)
    jc, tc = JCfg(**CFG_KW), TCfg(**CFG_KW)
    pj = [jodo._preprocess(jnp.asarray(im), jc.num_levels) for im in imgs[0]]
    pt = [todo._preprocess(torch.as_tensor(im), tc.num_levels) for im in imgs[1]]
    sj, st = jinit.set_first(pj[0], jcam, jc), tinit.set_first(pt[0], tcam, tc)
    rows = [{"frame": 0, "images_equal": all(np.array_equal(a, b) for a, b in zip(*imgs)),
             "pyramid_max_diff": max(float(np.abs(np.asarray(a[l]) - b[l].numpy()).max())
                                     for a, b in zip(pj, pt) for l in range(jc.num_levels)),
             "points_equal": bool(np.array_equal(np.asarray(sj.uv), st.uv.numpy())),
             "colors_max_diff": float(np.abs(np.asarray(sj.color) - st.color.numpy()).max())}]

    def gap(a, b):
        return [float(np.abs(np.asarray(x) - np.asarray(y)).max())
                for x, y in ((a.T.R, b.T.R), (a.T.t, b.T.t))]

    su = sj.replace(idepth=jnp.nextafter(sj.idepth, jnp.inf))
    for k in range(1, frames):
        rj = jodo._try_init(sj, pj[k], jcam, jc)
        ru = jodo._try_init(su, pj[k], jcam, jc)
        rt = tinit.try_initialize(st, pt[k], tcam, tc)
        one = tinit.try_initialize(convert.from_np(tinit.InitializerState, convert.to_np(sj)),
                                   pt[k], tcam, tc)
        ulp = jodo._try_init(sj.replace(idepth=jnp.nextafter(sj.idepth, jnp.inf)),
                             pj[k], jcam, jc)
        rows.append({"frame": k, "jax_t_norm": float(np.linalg.norm(np.asarray(rj.state.T.t))),
                     "chained": gap(rj.state, rt.state), "port_step_from_jax": gap(rj.state, one.state),
                     "jax_step_idepth_one_ulp": gap(rj.state, ulp.state),
                     "jax_chained_from_one_ulp": gap(rj.state, ru.state),
                     "snapped": [bool(rj.state.snapped), bool(rt.state.snapped)]})
        sj, st, su = rj.state, rt.state, ru.state
    return rows


def _jumps(run: dict) -> list[int]:
    """The frames the final trajectory reaches by a step over the bench's
    JUMP times its median step (bench.error_profile's jumps)."""
    from libcml_tpu_torch.bench import JUMP

    step = np.linalg.norm(np.diff(np.asarray(run["final_c2w"])[:, :3, 3], axis=0), axis=1)
    return [int(j + 1) for j in np.flatnonzero(step > JUMP * np.median(step))]


def compare(paths: list[str]) -> dict:
    runs = []
    for p in paths:
        with open(p) as f:
            runs.append(json.load(f))
    ref = runs[0]
    report = {"reference": f"{ref['package']}/{ref['device']}",
              "reference_ate_prefix": ref["ate_prefix"], "reference_jumps": _jumps(ref),
              "runs": []}
    for r in runs[1:]:
        first_pose = first_other = None
        gaps = []
        for a, b in zip(ref["rows"], r["rows"]):
            gap = float(np.abs(np.asarray(a["pose"]) - np.asarray(b["pose"])).max())
            gaps.append(gap)
            if first_pose is None and gap > TOL:
                first_pose = {"frame": a["frame"], "gap": gap}
            if first_other is None:
                diff = [k for k in ("state", "kf", "mode", "ind_kfs", "map_points")
                        if a[k] != b[k]]
                if diff:
                    first_other = {"frame": a["frame"], "differs": {
                        k: [a[k], b[k]] for k in diff}}
        n = min(len(ref["final_c2w"]), len(r["final_c2w"]))
        final_gap = np.abs(np.asarray(ref["final_c2w"][:n]) - np.asarray(r["final_c2w"][:n]))
        report["runs"].append({
            "run": f"{r['package']}/{r['device']}", "ate_prefix": r["ate_prefix"],
            "jumps": _jumps(r),
            "first_pose_gap_over_tol": first_pose, "first_other_difference": first_other,
            "live_pose_gap_per_frame": gaps,
            "final_pose_gap_per_frame": final_gap.max(axis=(1, 2)).tolist(),
            "mixed_writebacks": [(w["frame"], w["rolled_back"]) for w in r["mixed_writebacks"]],
            "reference_mixed_writebacks": [(w["frame"], w["rolled_back"])
                                           for w in ref["mixed_writebacks"]]})
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("hybrid_ab")
    sub = ap.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("run")
    r.add_argument("--package", choices=["jax", "torch"], required=True)
    r.add_argument("--frames", type=int, default=40)
    r.add_argument("--device", default="cpu")
    r.add_argument("--out", required=True)
    r.add_argument("--seq-root", default=SEQ_ROOT,
                   help="where the KITTI layout is written and read")
    r.add_argument("--render", default="cpu",
                   help="the device that renders the missing frames (cpu or cuda)")
    s = sub.add_parser("step")
    s.add_argument("--frames", type=int, default=40)
    s.add_argument("--device", default="cuda")
    s.add_argument("--out", required=True)
    n = sub.add_parser("init")
    n.add_argument("--frames", type=int, default=5)
    n.add_argument("--threads", type=int, default=1)
    c = sub.add_parser("compare")
    c.add_argument("paths", nargs="+")
    args = ap.parse_args(argv)
    if args.cmd == "step":
        # the per-frame checkpoint lies beside the output, one per run
        res = step(args.frames, args.device, os.path.splitext(args.out)[0] + ".ckpt")
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(res, f)
        print(json.dumps({"ate_prefix": res["ate_prefix"]}))
    elif args.cmd == "run":
        if args.package == "torch":
            import torch

            torch.manual_seed(0)
        res = run(args.package, args.frames, args.device if args.package == "torch" else "cpu",
                  args.seq_root, args.render)
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(res, f)
        print(json.dumps({"package": res["package"], "device": res["device"],
                          "wall_s": res["wall_s"], "ate_prefix": res["ate_prefix"],
                          "mixed_writebacks": res["mixed_writebacks"]}))
    elif args.cmd == "init":
        for row in init_steps(args.frames, args.threads):
            print(json.dumps(row))
    else:
        rep = compare(args.paths)
        print(json.dumps({k: v for k, v in rep.items()}, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
