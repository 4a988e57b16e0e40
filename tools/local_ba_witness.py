"""The local BA kernel, its plain form, planted faults of the kernel and the
JAX package against a float64 run, on the hybrid's real run_local_ba calls.

    python3 tools/local_ba_witness.py [--frames 60] [--save FILE]     (one CUDA card)
    JAX_PLATFORMS=cpu python3 tools/local_ba_witness.py --jax FILE    (the CPU)

On the card it runs the sequential HybridOdometry on the smoke's frames
(libcml_tpu_torch/workload.py: 640x480, bench.py's configuration; chip_smoke.py
phase 5's run) and keeps every run_local_ba call (chip_smoke.LocalBACapture).
It builds csrc/local_ba.cu and three copies of it, each with one fault
planted (in a temporary directory, beside copies of the headers it
includes): `never_accepts` (no step is ever taken), `no_huber` (every
weight 1 / sigma^2), `last_hcc_dropped` (the last frame slot's H_cc left
out of the reduced system). On every call each build runs once, and
ops/local_ba.py `parity` holds it to run_local_ba_plain beside `f64_run` (a
float64 run of the plain form), as chip_smoke.py phase 16 holds the kernel.
One JSON line a call: each build's verdict (`ok`), the measures beyond
PARITY_TOL of the plain form, its distance from float64 (`vs_f64`: T, the
points' excess over their bound, the free points' pixels), the measures
within F64_TOL, the observations pruned otherwise that nothing explains, and
whether the rule before F64_TOL (no further from float64 than the plain
form) would have passed it; then the largest reading of each build. A clean
kernel must pass on every call and every fault must fail on some.

With --save, the calls and the kernel's results go to an .npz; --jax reads
it on the CPU and runs each call through the JAX package's run_local_ba
(float32, jitted as libcml_tpu/runtime/hybrid.py jits it), the port's plain
form on the CPU and a float64 run on the CPU, and prints each one's (and
the card kernel's) distance from that float64 run (infinite or NaN where a
result is not finite: the JAX package takes a step whose candidate is NaN,
ROADMAP.md section 3). Only --jax imports JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import shutil
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from libcml_tpu_torch.core.camera import PinholeCamera  # noqa: E402
from libcml_tpu_torch.core.lie import SE3  # noqa: E402
from libcml_tpu_torch.models.indirect import indirect_ba as iba  # noqa: E402
from libcml_tpu_torch.ops import kernel_build as kb  # noqa: E402
from libcml_tpu_torch.ops import local_ba as lba  # noqa: E402

# each fault: the line of csrc/local_ba.cu it replaces, and what replaces it
FAULTS = {
    "never_accepts": ("const bool accept = fin && E_new < E;", "const bool accept = false;"),
    "no_huber": ("const double w = o.active ? hub / s2 : 0.0;",
                 "const double w = o.active ? 1.0 / s2 : 0.0; (void)hub;"),
    "last_hcc_dropped": ("const double hcc = fi == fj ?",
                         "const double hcc = fi == fj && fi != D / 6 - 1 ?"),
}
FIELDS = ("frame_valid", "frame_fixed", "Xw", "point_valid", "obs_frame", "obs_point",
          "obs_uv", "obs_valid", "obs_sigma2")


def plant(work: Path) -> dict[str, Path]:
    """A copy of csrc/ a fault, each with its line of local_ba.cu replaced."""
    out = {}
    for name, (old, new) in FAULTS.items():
        d = work / name
        shutil.copytree(kb.CSRC, d)
        src = d / lba.SOURCE.name
        text = src.read_text()
        if text.count(old) != 1:
            raise SystemExit(f"{name}: the line to replace is not in {lba.SOURCE} once")
        src.write_text(text.replace(old, new))
        out[name] = src
    return out


@contextlib.contextmanager
def source(path: Path):
    """local_ba_cuda launching the library built from `path`."""
    shipped = lba.SOURCE
    lba.SOURCE = path
    try:
        yield
    finally:
        lba.SOURCE = shipped


def _largest(acc: dict, dist: dict) -> None:
    """acc[m] = the larger of acc[m] and dist[m], a NaN read as infinite."""
    for m in lba.MEASURES:
        v = dist[m]
        acc[m] = max(acc.get(m, 0.0), float("inf") if v != v else v)


def reading(rep: dict) -> dict:
    """What a line prints of a parity report."""
    over = rep["over"]
    return {"ok": rep["ok"], "over": over,
            "vs_f64": {m: rep["kernel_vs_f64"][m] for m in lba.MEASURES},
            "within_f64": [m for m in lba.MEASURES if rep["within_f64"][m]],
            "unexplained_obs": len(rep["unexplained_obs"]),
            "rule_before_f64_tol": not rep["unexplained_obs"]
            and all(rep["nearer_f64"][m] for m in over)}


def card(frames: int, save: Path | None) -> int:
    import chip_smoke as cs
    from libcml_tpu_torch import workload as wl

    if not torch.cuda.is_available():
        print("local_ba_witness: CUDA is not available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    name = cs.nvidia_smi("name,power.limit")
    work = Path(tempfile.mkdtemp(prefix="local_ba_witness_"))
    try:
        builds = {"kernel": lba.SOURCE, **plant(work)}
        kb.build_many([*kb.SOURCES, *(builds[f] for f in FAULTS)])
        cam, _, imgs = wl.render_frames(dev, frames)
        with cs.LocalBACapture() as cap:
            cap.run = "hybrid"
            odo = wl.hybrid_odometry(cam)
            for i, (img, _) in enumerate(imgs):
                odo.process(img.cpu().numpy(), float(i))
            torch.cuda.synchronize()
        calls = cap.calls.get("hybrid", [])
        worst = {b: {} for b in builds}
        failed = {b: 0 for b in builds}
        saved = {}
        for k, (prob, cam_, args, kw) in enumerate(calls):
            iters = cs._stage_iters(args, kw)
            tr_p, mid_p = [], []
            want = iba.run_local_ba_plain(prob, cam_, *iters, trace=tr_p, mid=mid_p)
            ref = lba.f64_run(prob, cam_, *iters)
            row = {"call": k, "M": prob.T.t.shape[0], "N": prob.Xw.shape[0],
                   "K": prob.obs_frame.shape[0], "fixed_frames": int(prob.frame_fixed.sum()),
                   "plain_vs_f64": {m: lba._distances(want, ref["result"], prob, cam_)[m]
                                    for m in lba.MEASURES}}
            for b, path in builds.items():
                mid = torch.empty_like(prob.obs_valid)
                with source(path):
                    got = lba.local_ba_cuda(prob, cam_, *iters, obs_valid_mid=mid)
                torch.cuda.synchronize()
                rep = lba.parity(got, want, prob, cam_, ref, (mid, mid_p[0].obs_valid))
                row[b] = reading(rep)
                failed[b] += not rep["ok"]
                _largest(worst[b], rep["kernel_vs_f64"])
                if b == "kernel":
                    saved.update({f"c{k}_kernel_R": got.T.R, f"c{k}_kernel_t": got.T.t,
                                  f"c{k}_kernel_Xw": got.Xw})
            print(json.dumps({**row, "card": name}), flush=True)
            saved.update({f"c{k}_R": prob.T.R, f"c{k}_t": prob.T.t,
                          f"c{k}_iters": torch.tensor(iters),
                          f"c{k}_cam": torch.tensor([cam_.fx, cam_.fy, cam_.cx, cam_.cy,
                                                     cam_.width, cam_.height]),
                          **{f"c{k}_{f}": getattr(prob, f) for f in FIELDS}})
        print(json.dumps({"calls": len(calls), "largest_vs_f64": worst,
                          "calls_failed": failed, "f64_tol": lba.F64_TOL,
                          "parity_tol": lba.PARITY_TOL, "card": name}), flush=True)
        if save:
            save.parent.mkdir(parents=True, exist_ok=True)
            np.savez_compressed(save, n=len(calls),
                                **{k: v.detach().cpu().numpy() for k, v in saved.items()})
        clean = failed["kernel"] == 0 and calls
        caught = all(failed[b] for b in FAULTS)
        return 0 if clean and caught else 1
    finally:
        shutil.rmtree(work, ignore_errors=True)


def cpu(path: Path) -> int:
    import jax
    import jax.numpy as jnp

    import libcml_tpu.models.indirect.indirect_ba as jiba
    from libcml_tpu.core.camera import PinholeCamera as JCam
    from libcml_tpu.core.lie import SE3 as JSE3

    run_jax = jax.jit(jiba.run_local_ba, static_argnames=("stage1_iters", "stage2_iters"))
    d = np.load(path)
    worst = {}
    for k in range(int(d["n"])):
        g = lambda f: d[f"c{k}_{f}"]  # noqa: E731
        fx, fy, cx, cy, w, h = g("cam").tolist()
        cam = PinholeCamera.make(fx, fy, cx, cy, int(w), int(h))
        s1, s2 = (int(v) for v in g("iters"))
        prob = iba.IndirectBAProblem(T=SE3(R=torch.tensor(g("R")), t=torch.tensor(g("t"))),
                                     **{f: torch.tensor(g(f)) for f in FIELDS})
        ref = lba.f64_run(prob, cam, s1, s2)["result"]
        pj = jiba.IndirectBAProblem(T=JSE3(R=jnp.asarray(g("R")), t=jnp.asarray(g("t"))),
                                    **{f: jnp.asarray(g(f)) for f in FIELDS})
        oj = run_jax(pj, JCam.make(fx, fy, cx, cy, int(w), int(h)),
                     stage1_iters=s1, stage2_iters=s2)
        forms = {
            "jax": prob.replace(T=SE3(R=torch.tensor(np.asarray(oj.T.R)),
                                      t=torch.tensor(np.asarray(oj.T.t))),
                                Xw=torch.tensor(np.asarray(oj.Xw)),
                                obs_valid=torch.tensor(np.asarray(oj.obs_valid))),
            "plain_cpu": iba.run_local_ba_plain(prob, cam, s1, s2),
            # the card kernel's T and points, with the float64 run's obs_valid
            # (_distances reads the reference's)
            "card_kernel": prob.replace(T=SE3(R=torch.tensor(g("kernel_R")),
                                              t=torch.tensor(g("kernel_t"))),
                                        Xw=torch.tensor(g("kernel_Xw")))}
        row = {"call": k, "M": prob.T.t.shape[0], "N": prob.Xw.shape[0],
               "K": prob.obs_frame.shape[0]}
        for name, res in forms.items():
            dist = lba._distances(res, ref, prob, cam)
            row[name] = {m: dist[m] for m in lba.MEASURES}
            _largest(worst.setdefault(name, {}), dist)
        print(json.dumps(row), flush=True)
    print(json.dumps({"calls": int(d["n"]), "largest_vs_f64": worst,
                      "f64_tol": lba.F64_TOL}), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--save", type=Path, default=None)
    ap.add_argument("--jax", type=Path, default=None, help="an .npz that --save wrote")
    a = ap.parse_args()
    return cpu(a.jax) if a.jax else card(a.frames, a.save)


if __name__ == "__main__":
    sys.exit(main())
