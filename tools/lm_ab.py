"""The LM kernels of this tree against another tree's, on one card.

    python3 tools/lm_ab.py [--parent DIR] [--frames 60] [--out FILE]

Captures every single-start `track_lm` launch of DirectOdometry on the
smoke's frames (libcml_tpu_torch/workload.py: 640x480, bench.py's
configuration) from the fifth on, and makes PnP problems at N 4096 and 1536
(30 % outliers, 3 % of the points behind the camera) from a seed. Then for
each build, this tree's kernels (`tree`) and those of another tree
(`--parent`: a parent commit unpacked with `git archive`, whose
csrc/track_lm.cu and pnp_lm.cu keep the same C interface; the wrappers
launch its library inside `with`), it holds every capture to the plain
forms with `track_lm.parity` / `pnp_lm.parity` on the card: the starts
whose levels take other steps than the plain form, those outside
PARITY_TOL / DECISION_TOL, and for each of those the decision values at
the first differing step in the plain form, the kernel and the plain form
in float64, and one step from the kernel's and from the plain form's state
there (lambda 1e-4) by the kernel, the plain form and the plain form in
float64.

The decision noise: from the plain form's state before the last step of
every level of every capture, one step (lambda 1e-4) by each build's
kernel, the plain form on the card and the plain form on the CPU, each
against the plain form in float64 from the same state: the error of |dx|
over tracker_converge_eps and of E_new - E over E (the values the
convergence and accept tests read), median, 90th percentile and largest.

Last, cold device ms (chip_smoke.cuda_ms, median of 30) of a `track`
capture, a 15-start battery about it and both PnP problems, the builds in
turns (each in order, then in reverse), with chip_smoke's bound of each
case from each build's own trace and the share of it the time reaches.
One JSON line a build, then the noise and the times; all of it also in
--out. Needs one CUDA card; no JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from libcml_tpu_torch import workload as wl  # noqa: E402
from libcml_tpu_torch.core.lie import SE3, se3_exp  # noqa: E402
from libcml_tpu_torch.models.direct import tracker  # noqa: E402
from libcml_tpu_torch.models.indirect import pnp as pnp_mod  # noqa: E402
from libcml_tpu_torch.ops import kernel_build as kb, pnp_lm, track_lm  # noqa: E402
from libcml_tpu_torch.runtime.odometry import DirectOdometry  # noqa: E402

WRAPPERS = (track_lm, pnp_lm)
SKIP = 4            # the first launches track against the initializer's few points


def capture_tracks(dev, frames: int):
    """(camera, every single-start track_lm argument tuple of the run)."""
    cam, _, imgs = wl.render_frames(dev, frames)
    saved, orig = [], tracker.track_lm_cuda

    def capture(*args):
        if args[7].shape[0] == 1:
            capture.k += 1
            if capture.k > SKIP:
                saved.append(cs._clone(args))
        return orig(*args)

    capture.k = 0
    tracker.track_lm_cuda = capture
    try:
        odo = DirectOdometry(cam, wl.BENCH_CFG)
        for i, (img, _) in enumerate(imgs):
            odo.process(img.cpu().numpy(), float(i))
        torch.cuda.synchronize()
    finally:
        tracker.track_lm_cuda = orig
    return cam, saved


def battery(args):
    """_frame_step's recovery battery about a single-start capture."""
    T0 = SE3(R=args[7][0], t=args[8][0])
    H = tracker.motion_hypotheses(T0, T0, T_extra=T0)
    B = H.t.shape[0]
    return (*(a[:2] for a in args[:6]), args[6], H.R.contiguous(), H.t.contiguous(),
            args[9][:1].expand(B, 2).contiguous(), args[10], args[11], False)


def pnp_problem(cam, dev, seed: int, n: int):
    """pnp_lm_cuda's arguments for N matches seen by `cam`: 30 % outliers,
    per-match sigma2 of three pyramid levels, 3 % behind the camera, 5 %
    invalid; 4 rounds of 10 steps."""
    rng = np.random.default_rng(seed)
    Xw = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n), rng.uniform(3, 8, n)], -1)
    Xw[rng.random(n) < 0.03, 2] *= -1.0
    T = se3_exp(torch.tensor([0.05, -0.02, 0.1, 0.01, -0.02, 0.015]))
    Xc = Xw @ T.R.double().numpy().T + T.t.double().numpy()
    uv = np.stack([cam.fx * Xc[:, 0] / Xc[:, 2] + cam.cx,
                   cam.fy * Xc[:, 1] / Xc[:, 2] + cam.cy], -1)
    uv += rng.normal(0, 0.5, uv.shape)
    bad = rng.random(n) < 0.3
    uv[bad] += rng.uniform(-30, 30, (bad.sum(), 2))
    valid = rng.random(n) > 0.05
    sigma2 = 1.2 ** (2.0 * rng.integers(0, 3, n))
    T0 = se3_exp(torch.tensor([0.03, -0.01, 0.05, 0.0, 0.0, 0.0]))

    def put(x, dtype=torch.float32):
        return torch.as_tensor(np.asarray(x)).to(dtype).to(dev).contiguous()

    return (put(Xw), put(uv), put(valid, torch.bool), put(sigma2), T0.R.to(dev).contiguous(),
            T0.t.to(dev).contiguous(), cam, 4, 10)


def as_f64(args):
    def conv(x):
        return x.double() if isinstance(x, torch.Tensor) and x.dtype == torch.float32 else x
    return tuple([conv(v) for v in a] if isinstance(a, list) else conv(a) for a in args)


class Build:
    """The LM kernels of one tree: inside `with`, the wrappers launch its
    libraries (each built from that tree's csrc/ by kernel_build)."""

    def __init__(self, name: str, tree: Path | None = None):
        self.name = name
        self.sources = [(tree / "libcml_tpu_torch/csrc" / w.SOURCE.name) if tree else w.SOURCE
                        for w in WRAPPERS]
        self._before = None

    def __enter__(self):
        self._before = [w.SOURCE for w in WRAPPERS]
        for w, src in zip(WRAPPERS, self.sources):
            w.SOURCE = src
        return self

    def __exit__(self, *exc):
        for w, src in zip(WRAPPERS, self._before):
            w.SOURCE = src


def tocpu(x):
    if isinstance(x, torch.Tensor):
        return x.cpu()
    if isinstance(x, (list, tuple)):
        return type(x)(tocpu(v) for v in x)
    return x


def level_args(args, levels, R, t, ab, iters: int):
    """track_lm's arguments for `levels` of a capture from (R, t, ab), at
    most `iters` steps a level."""
    cfg = dataclasses.replace(args[11], tracker_iters=iters)
    return (*([v[l] for l in levels] for v in args[:6]), args[6], R.float().contiguous(),
            t.float().contiguous(), ab.float().contiguous(), args[10], cfg, False)


def plain_state(args, level: int, step: int):
    """The plain form's (R, t, ab) after the levels before `level` and
    `step` steps of it."""
    R, t, ab = args[7], args[8], args[9]
    if level > 0:
        R, t, ab = tracker.track_levels_plain(
            *level_args(args, list(range(level)), R, t, ab, args[11].tracker_iters))[:3]
    if step > 0:
        R, t, ab = tracker.track_levels_plain(*level_args(args, [level], R, t, ab, step))[:3]
    return R, t, ab


def kernel_state(args, level: int, step: int):
    """The kernel's (R, t, ab) after the levels before `level` and `step`
    steps of it (a level's steps depend only on its start)."""
    R, t, ab = args[7], args[8], args[9]
    if level > 0:
        R, t, ab = track_lm.track_lm_cuda(
            *level_args(args, list(range(level)), R, t, ab, args[11].tracker_iters))[:3]
    if step > 0:
        R, t, ab = track_lm.track_lm_cuda(*level_args(args, [level], R, t, ab, step))[:3]
    return R, t, ab


def one_step(args, level: int, state, f64_too: bool = True) -> dict:
    """(E, E_new, |dx|) of one step (lambda 1e-4) at `level` from `state` by
    the kernel, the plain form on the card and on the CPU, and in float64."""
    a = level_args(args, [level], *state, 1)
    out = {"kernel": track_lm.track_lm_cuda(*a)[5][0, 0, 0].tolist(),
           "plain": tracker.track_levels_plain(*a)[5][0, 0, 0].tolist(),
           "plain_cpu": tracker.track_levels_plain(*tocpu(a))[5][0, 0, 0].tolist()}
    if f64_too:
        out["f64"] = tracker.track_levels_plain(*as_f64(a))[5][0, 0, 0].tolist()
    return out


def track_report(build: Build, cases, wants) -> dict:
    differ, outside = 0, []
    with build:
        for k, (args, want) in enumerate(zip(cases, wants)):
            got = track_lm.track_lm_cuda(*args)
            rep = track_lm.parity(got, want, args[11])
            differ += len(rep["diverged"])
            if rep["ok"]:
                continue
            row = {"case": k, "steps": got[4].cpu().tolist(),
                   "plain_steps": want[4].cpu().tolist(), "max_err": rep["max_err"],
                   "stats_err": rep["stats_err"]}
            ref = tracker.track_levels_plain(*as_f64(args))
            row["f64_steps"] = ref[4].cpu().tolist()
            d = rep["diverged"][0] if rep["diverged"] else {}
            if "level" in d:
                lv, j = d["level"], d["step"]
                at = (0, lv, j)
                row.update(decision=d["decision"], margin=d.get("margin"),
                           step_over_eps=d.get("step_over_eps"),
                           plain=want[5][at].tolist(), kernel=got[5][at].tolist(),
                           f64=ref[5][at].tolist(),
                           from_kernel_state=one_step(args, lv, kernel_state(args, lv, j)),
                           from_plain_state=one_step(args, lv, plain_state(args, lv, j)))
            outside.append(row)
    return {"cases": len(cases), "starts_taking_other_steps": differ,
            "outside_tolerance": len(outside), "outside": outside}


def _spread(x) -> list[float]:
    x = np.abs(np.asarray(x, dtype=np.float64))
    return [float(np.median(x)), float(np.quantile(x, 0.9)), float(x.max())]


def decision_noise(builds: list[Build], cases, wants) -> dict:
    """From the plain form's state before the last step of every level of
    every capture, the error against float64 of |dx| / eps and of (E_new -
    E) / E after one step, for each build's kernel, the plain form on the
    card and on the CPU: [median, 90th percentile, largest] of each."""
    err = {name: {"dx_over_eps": [], "dE_rel": []}
           for name in [b.name for b in builds] + ["plain", "plain_cpu"]}
    for args, want in zip(cases, wants):
        eps = args[11].tracker_converge_eps
        for lv in range(len(args[0])):
            steps = int(want[4][0, lv])
            if steps == 0:
                continue
            state = plain_state(args, lv, steps - 1)
            a = level_args(args, [lv], *state, 1)
            ref = tracker.track_levels_plain(*as_f64(a))[5][0, 0, 0].tolist()
            got = {"plain": tracker.track_levels_plain(*a)[5][0, 0, 0].tolist(),
                   "plain_cpu": tracker.track_levels_plain(*tocpu(a))[5][0, 0, 0].tolist()}
            for b in builds:
                with b:
                    got[b.name] = track_lm.track_lm_cuda(*a)[5][0, 0, 0].tolist()
            for name, (E, E_new, dx) in got.items():
                err[name]["dx_over_eps"].append((dx - ref[2]) / eps)
                err[name]["dE_rel"].append(((E_new - E) - (ref[1] - ref[0])) / ref[0])
    return {"states": len(err["plain"]["dE_rel"]),
            "errors": {name: {k: _spread(v) for k, v in e.items()} for name, e in err.items()}}


def pnp_report(build: Build, cases, wants) -> dict:
    rows = []
    with build:
        for name, args, want in zip(("N 4096", "N 1536"), cases, wants):
            got = pnp_lm.pnp_lm_cuda(*args)
            rep = pnp_lm.parity(got, want, *args[:4], args[6])
            rows.append({"case": name, "ok": rep["ok"], "max_err": rep["max_err"],
                         "first_step_differing": rep["first_step_differing"],
                         "classes_differing": len(rep["classes_differing"])})
    return {"cases": rows}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, help="another tree whose LM kernels to compare")
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--out", type=Path)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("lm_ab: CUDA is not available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = cs.nvidia_smi("name,power.limit")
    builds = [Build("tree")]
    if a.parent:
        builds.append(Build(f"parent {a.parent}", tree=a.parent.resolve()))
    t0 = time.perf_counter()
    built = kb.build_many([s for b in builds for s in b.sources], verbose=True)
    info = {"card": card, "build_s": time.perf_counter() - t0,
            "ptxas": {path.name: [ln.split(":", 1)[-1].strip() for ln in log.splitlines()
                                  if "registers" in ln or "spill" in ln]
                      for path, _, log in built},
            "cluster": {"track_lm": track_lm.cluster_info(), "pnp_lm": pnp_lm.cluster_info()}}
    print(json.dumps(info), flush=True)

    cam, tracks = capture_tracks(dev, a.frames)
    wants = [tracker.track_levels_plain(*args) for args in tracks]
    pnps = [pnp_problem(cam, dev, 7, 4096), pnp_problem(cam, dev, 8, 1536)]
    pnp_wants = [pnp_mod.pnp_lm_plain(*args) for args in pnps]
    out = {**info, "builds": []}
    for b in builds:
        row = {"build": b.name, "track": track_report(b, tracks, wants),
               "pnp": pnp_report(b, pnps, pnp_wants)}
        print(json.dumps(row), flush=True)
        out["builds"].append(row)
    out["decision_noise"] = decision_noise(builds, tracks, wants)
    print(json.dumps({"decision_noise": out["decision_noise"]}), flush=True)

    timed = [("track", tracks[0], track_lm.track_lm_cuda),
             ("battery", battery(tracks[0]), track_lm.track_lm_cuda),
             ("pnp N 4096", pnps[0], pnp_lm.pnp_lm_cuda),
             ("pnp N 1536", pnps[1], pnp_lm.pnp_lm_cuda)]
    times = {name: {b.name: [] for b in builds} for name, _, _ in timed}
    bounds = {name: {} for name, _, _ in timed}
    for b in builds + builds[::-1]:
        with b:
            for name, args, fn in timed:
                times[name][b.name].append(cs.cuda_ms(lambda: fn(*args)))
                if b.name not in bounds[name]:
                    got = fn(*args)
                    bound = (cs.track_bound(args, got) if fn is track_lm.track_lm_cuda
                             else cs.pnp_bound(args, got))
                    bounds[name][b.name] = {"bound_ms": bound[0], "bound_by": bound[1],
                                            **bound[2]}
    for name in times:
        for bname, ms in times[name].items():
            bounds[name][bname]["share"] = bounds[name][bname]["bound_ms"] / min(ms)
    out["cold_ms"], out["bounds"] = times, bounds
    print(json.dumps({"cold_ms": times, "bounds": bounds, "card": card}), flush=True)
    if a.out:
        a.out.write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
