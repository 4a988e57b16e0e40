"""Which rounding order the card's PyTorch products give a 3-term sum.

    python3 tools/rounding_probe.py

A kernel that repeats a plain PyTorch form to the bit must round each
3-term product sum as the card's library call does. This runs, on seeded
random inputs at the direct window's size (2,048 points), the two products
of runtime/odometry._window_points_in_frame, `einsum("pji,pj->pi", R_h, d)`
and `X @ R.T` with X (P, 3), and counts for every order of the three
products, fused or not, the results that differ from the library's (a
fused multiply-add emulated in float64 and rounded once). Prints, per
product, the orders with the fewest differences, and the kernel each
product ran (torch.profiler). Needs a CUDA card.
"""

from __future__ import annotations

import itertools
import json
import sys

import torch


def _f32(x):
    return x.to(torch.float32)


def _fma(a, b, c):
    return _f32(a.double() * b.double() + c.double())


def _add(a, b):
    return _f32(a.double() + b.double())


def orders(a: list, b: list) -> dict:
    """Every order of sum_k a[k] b[k] with its products rounded (or fused)."""
    p = [_f32(a[k].double() * b[k].double()) for k in range(3)]
    out = {}
    for x, y, z in itertools.permutations(range(3)):
        out[f"(p{x}+p{y})+p{z}"] = _add(_add(p[x], p[y]), p[z])
        out[f"fma{z}(fma{y}(p{x}))"] = _fma(a[z], b[z], _fma(a[y], b[y], p[x]))
        out[f"fma{z}(p{x}+p{y})"] = _fma(a[z], b[z], _add(p[x], p[y]))
        out[f"p{z}+fma{y}(p{x})"] = _add(p[z], _fma(a[y], b[y], p[x]))
    return out


def _kernels(fn) -> list[str]:
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name[:90] for e in prof.events() if e.device_type.name != "CPU"]


def main() -> int:
    if not torch.cuda.is_available():
        print("rounding_probe: CUDA is not available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    P = 2048
    T_R = torch.randn((7, 3, 3), generator=g).to(dev)
    R_h = T_R[torch.randint(0, 7, (P,), generator=g).to(dev)]
    d = (torch.randn((P, 3), generator=g) * 10).to(dev)
    X = torch.einsum("pji,pj->pi", R_h, d)
    R = T_R[3]
    M = X @ R.T
    cases = {
        "einsum(pji,pj->pi)": (X, lambda i: ([R_h[:, 0, i], R_h[:, 1, i], R_h[:, 2, i]],
                                             [d[:, 0], d[:, 1], d[:, 2]]),
                               lambda: torch.einsum("pji,pj->pi", R_h, d)),
        "(P,3) @ (3,3)^T": (M, lambda i: ([X[:, 0], X[:, 1], X[:, 2]],
                                          [R[i, k].expand(P) for k in range(3)]),
                            lambda: X @ R.T),
    }
    for name, (want, operands, call) in cases.items():
        miss: dict = {}
        for i in range(3):
            for k, v in orders(*operands(i)).items():
                miss[k] = miss.get(k, 0) + int((v != want[:, i]).sum())
        best = sorted(miss.items(), key=lambda kv: kv[1])[:4]
        print(json.dumps({"product": name, "results": 3 * P, "fewest_differing": best,
                          "kernels": _kernels(call)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
