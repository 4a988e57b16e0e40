"""Stage times of the tracer's kernel, and this tree's tracer kernel against
another tree's, on one card.

    python3 tools/trace_stages.py [--parent DIR ...] [--frames 60] [--reps 20] [--out FILE]
    python3 tools/trace_stages.py --trees --parent DIR [--frames 60]

Runs DirectOdometry on the smoke's frames (libcml_tpu_torch/workload.py:
640x480, bench.py's configuration) and captures every trace_immatures_rows
call (chip_smoke.TraceCapture). Then, for each build, this tree's kernel
(`tree`) and each other tree's (`--parent`, repeatable, a build named after
its directory: a parent commit unpacked with `git archive` into a git-ignored
directory, or a tree holding only libcml_tpu_torch/ops/trace_epipolar.py and
libcml_tpu_torch/csrc/trace_epipolar.cu; its wrapper is loaded from there
under another module name and launches the library built from its own
csrc/, as tools/ba_stages.py's Build loads the BA wrappers):

- bits: on every captured call, each build's new arena and probe rows
  against the first build's, bit for bit (a NaN by its bits);
- trajectory (with --parent): the same direct run with the first parent's
  kernel tracing, both trajectories bit for bit;
- stages: a throwaway copy of the build's csrc/ under
  libcml_tpu_torch/_build/trace_stages/, in which thread 0 of every block
  stamps clock64() and %globaltimer at each `// stage: NAME` mark of
  csrc/trace_epipolar.cu (tools/ba_stages.py's instrument and
  stage_report), on the captured call that sweeps the most points; a tree
  whose source carries no marks is timed but not staged;
- times: cold and warm device ms (chip_smoke.cuda_ms, median of 30) of that
  call, and of the launch floor (chip_smoke.launch_floor: an empty kernel
  through the same ctypes route), the builds and the floor in turns (in
  order, then in reverse).

One JSON line a build, then the times; all of it also in --out.

With --trees, only the whole packages are compared: the direct run and the
sequential HybridOdometry (workload.hybrid_odometry) in a fresh process of
each tree, this one and the first --parent, each importing its own
libcml_tpu_torch and building its own kernels; one JSON line a mode with
each tree's ATE, whether the trajectories (trajectory_c2w's estimates) are
bit-identical, and their largest difference. It exits 1 when the direct
trajectories differ: a change that leaves the direct path alone (as one
to a hybrid-only kernel does) must leave its bits alone.

Needs one CUDA card; no JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from libcml_tpu_torch import workload as wl  # noqa: E402
from libcml_tpu_torch.eval.trajectory import ate_rmse  # noqa: E402
from libcml_tpu_torch.models.direct import tracer  # noqa: E402
from libcml_tpu_torch.ops import kernel_build as kb  # noqa: E402
from libcml_tpu_torch.ops import trace_epipolar as te  # noqa: E402
from libcml_tpu_torch.runtime.odometry import DirectOdometry  # noqa: E402
from tools.ba_stages import Build, _load_module, instrument, stage_report  # noqa: E402


class TraceBuild(Build):
    """The tracer kernel of one tree: its wrapper module `bk`
    (ops/trace_epipolar.py; for another tree, loaded from its files with
    SOURCE pointed at its own csrc/)."""

    FIELDS = ("SOURCE",)

    def __init__(self, name: str, tree: Path | None = None):
        self.name = name
        if tree is None:
            self.bk, self.csrc = te, kb.CSRC
        else:
            self.csrc = tree / "libcml_tpu_torch" / "csrc"
            self.bk = _load_module(f"_trace_epipolar_{name}",
                                   tree / "libcml_tpu_torch" / "ops" / "trace_epipolar.py")
            self.bk.SOURCE = self.csrc / self.bk.SOURCE.name


def direct_run(cam, traj, imgs, build: TraceBuild) -> tuple[list, np.ndarray, float]:
    """A direct run with `build`'s kernel tracing: its captured tracer calls,
    its trajectory (camera-to-world) and its ATE."""
    shipped = tracer.trace_rows_cuda
    tracer.trace_rows_cuda = build.bk.trace_rows_cuda
    try:
        with cs.TraceCapture() as cap:
            cap.phase = "direct"
            odo = DirectOdometry(cam, wl.BENCH_CFG)
            for i, img in enumerate(imgs):
                odo.process(img, float(i))
            torch.cuda.synchronize()
            cap.phase = None
    finally:
        tracer.trace_rows_cuda = shipped
    est = odo.trajectory_c2w()[1]
    ate = ate_rmse(est[:, :3, 3], cs.gt_centres(traj[:len(imgs)]), with_scale=True)
    return cap.calls["direct"], est, float(ate)


# a whole tree's run, in its own process with its package first on the path
TREE_RUNNER = r"""
import sys, numpy as np, torch
sys.path.insert(0, sys.argv[1])
import libcml_tpu_torch
from libcml_tpu_torch import workload as wl
from libcml_tpu_torch.eval.trajectory import ate_rmse
from libcml_tpu_torch.runtime.odometry import DirectOdometry
assert libcml_tpu_torch.__file__.startswith(sys.argv[1]), libcml_tpu_torch.__file__
n, mode, out = int(sys.argv[2]), sys.argv[3], sys.argv[4]
cam, traj, frames = wl.render_frames(torch.device("cuda"), n)
odo = DirectOdometry(cam, wl.BENCH_CFG) if mode == "direct" else wl.hybrid_odometry(cam)
for i, f in enumerate(frames):
    odo.process(f[0].cpu().numpy(), float(i))
torch.cuda.synchronize()
_, est = odo.trajectory_c2w()
est = np.asarray(est, np.float64)
gt = np.asarray([np.linalg.inv(np.r_[np.c_[R, t], [[0, 0, 0, 1]]])[:3, 3] for R, t in traj])
np.savez(out, est=est, ate=ate_rmse(est[:, :3, 3], gt, with_scale=True))
"""


def tree_run(tree: Path, mode: str, frames: int, work: Path) -> dict:
    """`mode`'s ("direct" or "hybrid") trajectory and ATE from `tree`'s
    package, in a process of its own."""
    out = work / f"{len(list(work.iterdir()))}.npz"
    subprocess.run([sys.executable, "-c", TREE_RUNNER, str(tree), str(frames), mode, str(out)],
                   cwd=tree, env={**os.environ, "PYTHONPATH": str(tree)}, check=True)
    d = np.load(out)
    return {"est": d["est"], "ate": float(d["ate"])}


def compare_trees(parent: Path, frames: int, card: str) -> int:
    """--trees: this tree's direct and hybrid trajectories against `parent`'s."""
    root = Path(__file__).resolve().parents[1]
    same = {}
    with tempfile.TemporaryDirectory() as tmp:
        for mode in ("direct", "hybrid"):
            mine = tree_run(root, mode, frames, Path(tmp))
            other = tree_run(parent.resolve(), mode, frames, Path(tmp))
            shape_ok = mine["est"].shape == other["est"].shape
            same[mode] = shape_ok and mine["est"].tobytes() == other["est"].tobytes()
            print(json.dumps({"mode": mode, "frames": frames, "ate": mine["ate"],
                              "parent_ate": other["ate"], "bit_identical": same[mode],
                              "max_abs_diff": (float(np.abs(mine["est"] - other["est"]).max())
                                               if shape_ok else None), "card": card}),
                  flush=True)
    return 0 if same["direct"] else 1


def bits(x: torch.Tensor) -> np.ndarray:
    """A tensor's bytes, for a comparison that holds a NaN by its bits."""
    return x.detach().contiguous().cpu().numpy().view(np.uint8)


def outputs(build: TraceBuild, args) -> list[np.ndarray]:
    """The build's new arena (every field) and probe rows on a captured call."""
    probes = cs._trace_probes(args)
    got = build.bk.trace_rows_cuda(*args, probes=probes)
    torch.cuda.synchronize()
    return [bits(getattr(got, f.name)) for f in dataclasses.fields(got)] + [bits(probes)]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, action="append", default=[],
                    help="another tree (a git archive of a parent commit); repeatable")
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("--trees", action="store_true",
                    help="compare the whole packages' trajectories with the first --parent's")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("trace_stages: CUDA is not available", file=sys.stderr)
        return 1
    if a.trees:
        if not a.parent:
            ap.error("--trees needs --parent")
        return compare_trees(a.parent[0], a.frames, cs.nvidia_smi("name,power.limit"))
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    card = cs.nvidia_smi("name,power.limit")
    builds = [TraceBuild("tree")] + [TraceBuild(d.resolve().name, d.resolve())
                                     for d in a.parent]
    stage_dir = kb.BUILD_DIR / "trace_stages"
    copies = {b.name: instrument(b, stage_dir / b.name, prefix="trace_") for b in builds}
    # every kernel the direct run launches, built before it
    sources = [*kb.SOURCES, *(b.csrc / te.SOURCE.name for b in builds[1:]), cs.floor_source()]
    sources += [copy / te.SOURCE.name for copy, stages in copies.values() if stages]
    built = kb.build_many(sources, verbose=True)
    info = {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
            "frames": a.frames,
            "ptxas": {str(p.relative_to(kb.BUILD_DIR)): [
                ln.strip() for ln in log.splitlines()
                if "registers" in ln or "spill" in ln or "smem" in ln] for p, _, log in built}}
    print(json.dumps(info), flush=True)

    cam, traj, frames = wl.render_frames(dev, a.frames)
    imgs = [f[0].cpu().numpy() for f in frames]
    calls, est, ate = direct_run(cam, traj, imgs, builds[0])
    out = {**info, "direct": {"ate": ate, "calls": len(calls)}, "builds": {}}
    if a.parent:
        _, est_p, ate_p = direct_run(cam, traj, imgs, builds[1])
        out["direct"].update({"ate_parent_kernel": ate_p,
                              "trajectories_bit_identical": bool(np.array_equal(est, est_p)),
                              "max_trajectory_gap": float(np.abs(est - est_p).max())})
    print(json.dumps({"direct": out["direct"], "card": card}), flush=True)

    # bit for bit on every captured call, each build against the first
    first = [outputs(builds[0], args) for args in calls]
    for b in builds[1:]:
        same = [all(np.array_equal(x, y) for x, y in zip(outputs(b, args), ref))
                for args, ref in zip(calls, first)]
        out["builds"][b.name] = {"calls_bit_identical": int(sum(same)), "calls": len(same),
                                 "differing_calls": [k for k, s in enumerate(same) if not s]}

    args = max(calls, key=cs._swept_points)        # the call with the most work
    heaviest = {"swept_points": cs._swept_points(args),
                "traced_rows": sorted({f for f in args[1].tolist() if f >= 0}),
                "bound": cs.trace_bound(args)}
    out["heaviest_call"] = heaviest
    print(json.dumps({"heaviest_call": heaviest}), flush=True)
    for b in builds:
        copy, stages = copies[b.name]
        row = {"build": b.name, **out["builds"].get(b.name, {}),
               "stages": stage_report(b, copy, stages, {
                   "trace": (lambda b=b: b.bk.trace_rows_cuda(*args), te.SOURCE.name)}, a.reps)
               if stages else None, "card": card}
        print(json.dumps(row), flush=True)
        out["builds"][b.name] = row

    times = {n: {"cold": [], "warm": []} for n in [b.name for b in builds] + ["floor"]}
    for b in builds + builds[::-1]:
        def call(b=b):
            return b.bk.trace_rows_cuda(*args)

        times[b.name]["cold"].append(cs.cuda_ms(call))
        times[b.name]["warm"].append(cs.cuda_ms(call, cold=False))
        floor = cs.launch_floor()
        times["floor"]["cold"].append(floor["floor_ms"])
        times["floor"]["warm"].append(floor["floor_warm_ms"])
    out["ms"] = times
    print(json.dumps({"ms": times, "card": card}), flush=True)
    if a.out:
        a.out.parent.mkdir(parents=True, exist_ok=True)
        a.out.write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
