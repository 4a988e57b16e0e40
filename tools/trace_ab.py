"""The tracer kernel against its plain form over whole direct runs, on one card.

    python3 tools/trace_ab.py [--frames 60]

Runs DirectOdometry on the smoke's frames (libcml_tpu_torch/workload.py:
640x480, bench.py's configuration) twice: as shipped (the tracer's kernel)
and with `odometry.trace_immatures_rows` pointed at the plain form, the
tracer of the port before its kernel. For each run it prints one JSON line:
over every trace_immatures_rows call, the arena entries where the kernel and
the plain form (both on the card, on the call's inputs) differ in any bit,
the points at a decision's edge and the largest interval gap of the points
that agree (trace_epipolar.parity); over every `_marg_pieces` call, the four
sums of the kernel and of the plain form against the plain form in float64
(each sum's largest error over its largest entry, the measure of
chip_smoke.py phase 14); and whether the two runs' trajectories are
bit-identical. A last line gives how often the card's own PyTorch ops round
as the kernel does (csrc/trace_epipolar.cu): einsum's and matmul's 3x3
products, a matrix times a vector, a division by a Python number, the sum
over 8 pattern pixels and the norm of a 2-vector, against the kernel's
orders emulated in float64. Needs one CUDA card; no JAX.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from libcml_tpu_torch import workload as wl  # noqa: E402
from libcml_tpu_torch.models.direct import ba, tracer  # noqa: E402
from libcml_tpu_torch.runtime import odometry  # noqa: E402
from libcml_tpu_torch.runtime.odometry import DirectOdometry  # noqa: E402

SUMS = ("H_pts", "b_pts", "H_corr", "b_corr")


def run(cam, imgs, plain: bool) -> dict:
    """A direct run with the kernel (or the plain form) tracing: its
    trajectory, its tracer calls' parity and its marginalizations' sums."""
    shipped = odometry.trace_immatures_rows
    if plain:
        odometry.trace_immatures_rows = tracer.trace_immatures_rows_plain
    try:
        with cs.BACapture(every=("_marg_pieces",)) as cap, cs.TraceCapture() as tcap:
            tcap.phase = "direct"
            odo = DirectOdometry(cam, wl.BENCH_CFG)
            for i, img in enumerate(imgs):
                odo.process(img, float(i))
            torch.cuda.synchronize()
            tcap.phase = None
    finally:
        odometry.trace_immatures_rows = shipped
    differ, edges, gap = 0, 0, 0.0
    for args in tcap.calls["direct"]:
        rep, got, want = cs.trace_parity(args)
        differ += sum(int((getattr(got, n) != getattr(want, n)).sum())
                      for n in ("rho_lo", "rho_hi", "n_ok", "n_fail", "valid"))
        edges += rep["differing"]
        gap = max(gap, rep["max_rho_steps_agreeing"])
    marg = []
    for st, images, cam_, cfg, slot in cap.calls["_marg_pieces"]:
        got = ba._marg_pieces(st, images, cam_, cfg, slot)
        want = ba._marg_pieces_plain(st, images, cam_, cfg, slot)
        w64 = ba._marg_pieces_plain(cs._state64(st), images.double(), cam_, cfg, slot)

        def rel(x, ref):
            return float((x.double() - ref.double()).abs().max() / ref.abs().max().clamp_min(1.0))

        marg.append({"slot": int(slot), **{n: {"kernel_vs_plain": rel(got[i], want[i]),
                                                "kernel_vs_f64": rel(got[i], w64[i]),
                                                "plain_vs_f64": rel(want[i], w64[i])}
                                            for i, n in enumerate(SUMS)}})
    return {"trace_calls": len(tcap.calls["direct"]), "entries_differing": differ,
            "edge_points": edges, "max_rho_steps_agreeing": gap, "marg": marg,
            "trajectory": odo.trajectory_c2w()[1]}


def rounding(dev) -> dict:
    """Share of each PyTorch op's results on the card that the kernel's
    order (emulated in float64, rounded once a step) reproduces bit for bit,
    on seeded random inputs."""
    g = torch.Generator(device=dev).manual_seed(0)

    def r(x):
        return x.to(torch.float32)

    def fma(a, b, c):
        return r(a.double() * b.double() + c.double())

    def add(a, b):
        return r(a.double() + b.double())

    def dot3(a, b):       # csrc/trace_epipolar.cu dot3
        return fma(a[..., 2], b[..., 2], fma(a[..., 1], b[..., 1], r(a[..., 0].double()
                                                                     * b[..., 0].double())))

    def mv3(a, b):        # csrc/trace_epipolar.cu mv3
        return add(fma(a[..., 1], b[..., 1], r(a[..., 0].double() * b[..., 0].double())),
                   r(a[..., 2].double() * b[..., 2].double()))

    def share(x, y):
        return float((x == y).float().mean())

    A = torch.randn(3, 3, 3, device=dev, generator=g)
    X = torch.randn(3, 64, 16, 8, 3, device=dev, generator=g) * 10
    M = torch.randn(3, 3, device=dev, generator=g)
    B = torch.randn(256, 3, 3, device=dev, generator=g)
    t = torch.randn(256, 3, device=dev, generator=g)
    Y = torch.rand(4096, 16, 8, device=dev, generator=g) * 30
    y = [Y[..., i] for i in range(8)]
    D = torch.randn(4096, 2, device=dev, generator=g) * 20
    u = torch.randn(4096, device=dev, generator=g) * 300
    fx = float(np.float32(519.73))
    einsum = torch.einsum("fij,fkspj->fkspi", A, X)
    return {
        "einsum_3x3": share(einsum, dot3(A[:, None, None, None], X[..., None, :])),
        "matmul_3x3": share(M @ B, dot3(M[None, :, None, :], B.transpose(-1, -2)[:, None])),
        "matvec_3": share((B.transpose(-1, -2) @ t[..., None])[..., 0],
                          mv3(B.transpose(-1, -2), t[:, None, :])),
        "div_by_number": share(u / fx, r(u.double() * r(torch.tensor(1.0 / fx)).item())),
        "sum_of_8": share(Y.sum(-1), add(add(add(y[0], y[4]), add(y[2], y[6])),
                                         add(add(y[1], y[5]), add(y[3], y[7])))),
        "norm_of_2": share(torch.linalg.norm(D, dim=-1),
                           torch.sqrt(add(r(D[:, 0].double() ** 2), r(D[:, 1].double() ** 2))))}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=60)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("trace_ab: CUDA is not available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = cs.nvidia_smi("name,power.limit")
    cam, _, frames = wl.render_frames(dev, a.frames)
    imgs = [f[0].cpu().numpy() for f in frames]
    runs = {}
    for name in ("kernel", "plain"):
        runs[name] = run(cam, imgs, plain=name == "plain")
        print(json.dumps({"run": name, "card": card,
                          **{k: v for k, v in runs[name].items() if k != "trajectory"}}),
              flush=True)
    print(json.dumps({"trajectories_bit_identical": bool(np.array_equal(
        runs["kernel"]["trajectory"], runs["plain"]["trajectory"])),
        "max_trajectory_gap": float(np.abs(runs["kernel"]["trajectory"]
                                           - runs["plain"]["trajectory"]).max()),
        "rounding_as_the_kernel": rounding(dev), "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
