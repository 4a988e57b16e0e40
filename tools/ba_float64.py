"""How far each float32 form of run_ba sits from a float64 run, on the windows
of a direct run, on one card.

    python3 tools/ba_float64.py [--parent DIR] [--frames 60]

Captures every `run_ba` call of DirectOdometry on the smoke's frames
(libcml_tpu_torch/workload.py: 640x480, bench.py's configuration), as
chip_smoke.py phase 14 does. For each window it runs `run_ba_plain` in
float64 on the card (the state and images in float64; the scale gauge's
nullspace built in the state's type) and, in float32, this tree's kernels
(`_run_ba_cuda`, one launch), another tree's (`--parent`: a git archive of a
parent commit, loaded as tools/ba_stages.py loads it), `run_ba_plain` on the
card and on the CPU (the float64 run is chip_smoke.run_ba_f64, the one phase
14 holds its cases to). One JSON line a window: each form's accept decisions
(A accept, r reject, a step a letter) and its distance from the float64 run
(chip_smoke.ba_parity's measures: E relative, T absolute, idepth over its
bound), and each float32 form's distance from the plain form on the card
(what phase 14 holds to bk.PARITY_TOL). Needs one CUDA card; no JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from libcml_tpu_torch import workload as wl  # noqa: E402
from libcml_tpu_torch.core.lie import SE3  # noqa: E402
from libcml_tpu_torch.models.direct import ba  # noqa: E402
from libcml_tpu_torch.runtime.odometry import DirectOdometry  # noqa: E402
from tools.ba_stages import Build  # noqa: E402


def to_state(x, fn):
    """A BAState (of any module's class) as this tree's, `fn` on every tensor."""
    out = {}
    for f in dataclasses.fields(x):
        v = getattr(x, f.name)
        out[f.name] = SE3(R=fn(v.R), t=fn(v.t)) if hasattr(v, "R") else fn(v)
    return ba.BAState(**out)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, default=None)
    ap.add_argument("--frames", type=int, default=60)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("ba_float64: CUDA is not available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = cs.nvidia_smi("name,power.limit")
    cam, _, imgs = wl.render_frames(dev, a.frames)
    with cs.BACapture(every=("run_ba",)) as cap:
        odo = DirectOdometry(cam, wl.BENCH_CFG)
        for i, (img, _) in enumerate(imgs):
            odo.process(img.cpu().numpy(), float(i))
        torch.cuda.synchronize()
    kernels = {"tree": ba}
    if a.parent:
        kernels["parent"] = Build("parent", a.parent.resolve()).ba
    cpu = lambda v: v.cpu()  # noqa: E731
    for k, (st, images, cam_, cfg) in enumerate(cap.calls["run_ba"]):
        runs = {}
        for name, mod in kernels.items():
            trace = torch.empty((cfg.ba_iters, 2), device=dev)
            out, E = mod._run_ba_cuda(st, images, cam_, cfg, None, trace=trace)
            runs[name] = (to_state(out, cpu), E.cpu(), (trace[:, 1] < trace[:, 0]).tolist())
        for name, (s, im) in (("plain", (st, images)),
                              ("plain_cpu", (to_state(st, cpu), images.cpu()))):
            trace = []
            out, E = ba.run_ba_plain(s, im, cam_, cfg, trace=trace)
            t = torch.stack(trace).cpu() if trace else torch.zeros((0, 2))
            runs[name] = (to_state(out, cpu), E.cpu(), (t[:, 1] < t[:, 0]).tolist())
        r64 = cs.run_ba_f64(st, images, cam_, cfg)
        f64 = (to_state(r64["state"], lambda v: v.float().cpu() if v.is_floating_point()
                        else v.cpu()), r64["E"].float().cpu())
        row = {"window": k, "frames": int(st.frame_valid.sum()), "card": card}
        for name, (s, E, dec) in runs.items():
            vs64 = cs.ba_parity(s, E, *f64)["max_err"]
            row[name] = {"decisions": "".join("A" if d else "r" for d in dec),
                         "T_from_f64": vs64["T"], "E_rel_from_f64": vs64["E_rel"],
                         "idepth_over_bound_from_f64": vs64["idepth_over_bound"]}
            if name != "plain":
                vsp = cs.ba_parity(s, E, *runs["plain"][:2])["max_err"]
                row[name]["T_from_plain"] = vsp["T"]
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
