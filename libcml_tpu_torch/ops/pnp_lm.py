"""Motion-only PnP as one CUDA kernel launch a solve.

  pnp_lm_cuda   hand-written sm_90a kernel (csrc/pnp_lm.cu): the whole of
                `solve_pnp` in one block (rounds x LM steps with the chi2
                Huber weight, the re-classification after each round, the
                covariance over the final inliers); no host read inside the
                solve. It replaces the JAX package's `solve_pnp` program
                (libcml_tpu/models/indirect/pnp.py:64, its nested lax.scan).

Its plain PyTorch form, the CPU path and the yardstick on the card, is
`models/indirect/pnp.pnp_lm_plain` (same arguments and outputs);
`pnp.solve_pnp` dispatches between the two by the tensors' device. The
kernel builds with nvcc on first use (ops/kernel_build.py).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from libcml_tpu_torch.core.camera import PinholeCamera
from libcml_tpu_torch.ops import kernel_build as kb
from libcml_tpu_torch.ops.kernel_build import KernelLaunchError

SOURCE = kb.CSRC / "pnp_lm.cu"

# How far the kernel may sit from its plain form on the same inputs. The
# two sum the normal equations and energies in other orders (and nvcc
# contracts into FMAs), so a step's accept test (E_new < E, energies equal
# to ~1e-6 relative near convergence) can go either way, and a match whose
# chi2 sits at 5.991 can be classified either way at poses 1e-6 apart. On
# the H100 (chip_smoke.py phase 13, PERF.md PR 7) the first differing accept
# sat within 1.9e-6 of E, no match was classified otherwise, and t stayed
# within 1.0e-5.
# PARITY_TOL bounds the outputs (abs for R, t; relative to the largest entry
# for cov; relative for chi2); a step's decision may differ only where
# |E_new - E| is within DECISION_TOL["E_rel"] of E, and a match's class only
# where the plain arithmetic at the kernel's own pose gives the kernel's
# class or its chi2 is within DECISION_TOL["chi2_rel"] of 5.991.
PARITY_TOL = {"R": 1e-4, "t": 1e-4, "cov_rel": 1e-3, "chi2_rel": 1e-3}
DECISION_TOL = {"E_rel": 1e-4, "chi2_rel": 1e-4}
CHI2_2D = 5.991

_VP, _INT = ctypes.c_void_p, ctypes.c_int
ARGTYPES = [_VP] * 6 + [_INT, _VP, _INT, _INT] + [_VP] * 7 + [_VP]


def pnp_lm_cuda(Xw: torch.Tensor, uv: torch.Tensor, valid: torch.Tensor,
                sigma2: torch.Tensor, R0: torch.Tensor, t0: torch.Tensor,
                cam: PinholeCamera, rounds: int, iters: int):
    """Launch the kernel on the current stream (one launch a solve). Xw (N,
    3), uv (N, 2), sigma2 (N,), R0 (3, 3), t0 (3,) float32 and valid (N,)
    bool, all contiguous on one CUDA device. Returns (R (3, 3), t (3,),
    inlier (N,) bool, num_inliers int64, cov (6, 6), chi2, trace (rounds,
    iters, 2): each step's E and E_new). Counts its launches in
    `pnp_lm_cuda.launches`."""
    dev = Xw.device
    N = Xw.shape[0]
    f32 = torch.float32
    kb.check_tensor("Xw", Xw, (N, 3), f32, dev)
    kb.check_tensor("uv", uv, (N, 2), f32, dev)
    kb.check_tensor("valid", valid, (N,), torch.bool, dev)
    kb.check_tensor("sigma2", sigma2, (N,), f32, dev)
    kb.check_tensor("R0", R0, (3, 3), f32, dev)
    kb.check_tensor("t0", t0, (3,), f32, dev)
    if dev.type != "cuda":
        raise ValueError(f"pnp_lm_cuda needs CUDA tensors, got {dev}")
    if rounds < 0 or iters < 0:
        raise ValueError(f"pnp_lm_cuda: rounds {rounds} and iters {iters} must be >= 0")
    lib = kb.load(SOURCE, "pnp_lm_launch", ARGTYPES)
    R = torch.empty((3, 3), dtype=f32, device=dev)
    t = torch.empty((3,), dtype=f32, device=dev)
    inlier = torch.empty((N,), dtype=torch.bool, device=dev)
    num_inliers = torch.empty((), dtype=torch.int64, device=dev)
    cov = torch.empty((6, 6), dtype=f32, device=dev)
    chi2 = torch.empty((), dtype=f32, device=dev)
    trace = torch.empty((rounds, iters, 2), dtype=f32, device=dev)
    intr = (ctypes.c_float * 4)(cam.fx, cam.fy, cam.cx, cam.cy)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.pnp_lm_launch(
            Xw.data_ptr(), uv.data_ptr(), valid.data_ptr(), sigma2.data_ptr(), R0.data_ptr(),
            t0.data_ptr(), N, intr, rounds, iters, R.data_ptr(), t.data_ptr(),
            inlier.data_ptr(), num_inliers.data_ptr(), cov.data_ptr(), chi2.data_ptr(),
            trace.data_ptr(), stream)
    if err != 0:
        raise KernelLaunchError(f"pnp_lm kernel launch failed: CUDA error {err}")
    pnp_lm_cuda.launches += 1
    return R, t, inlier, num_inliers, cov, chi2, trace


pnp_lm_cuda.launches = 0


def parity(got, want, Xw: torch.Tensor, uv: torch.Tensor, valid: torch.Tensor,
           sigma2: torch.Tensor, cam: PinholeCamera) -> dict:
    """The kernel's outputs `got` against the plain form's `want` on the same
    inputs (pnp_lm_cuda's and pnp_lm_plain's tuples): the largest errors, the
    first step whose accept decision differs with its margin (from the plain
    form's trace), and the matches classified otherwise with their chi2 at
    the kernel's pose in plain arithmetic. `ok` when the errors are within
    PARITY_TOL and every difference is allowed by DECISION_TOL."""
    g = [x.detach().cpu().numpy() for x in got]
    w = [x.detach().cpu().numpy() for x in want]
    c_scale = max(float(np.abs(w[4]).max()), 1e-30)
    err = {"R": float(np.abs(g[0] - w[0]).max()), "t": float(np.abs(g[1] - w[1]).max()),
           "cov_rel": float(np.abs(g[4] - w[4]).max()) / c_scale,
           "chi2_rel": abs(float(g[5]) - float(w[5])) / max(abs(float(w[5])), 1e-30)}
    acc_g = (g[6][..., 1] < g[6][..., 0]).reshape(-1)
    acc_w = (w[6][..., 1] < w[6][..., 0]).reshape(-1)
    step = None
    if not np.array_equal(acc_g, acc_w):
        j = int(np.argmax(acc_g != acc_w))
        E, E_new = (float(v) for v in w[6].reshape(-1, 2)[j])
        margin = abs(E_new - E) / max(abs(E), 1e-30)
        step = {"step": j, "margin": margin, "within": margin <= DECISION_TOL["E_rel"]}
    classes = []
    flip = np.flatnonzero(g[2] != w[2])
    if len(flip):
        from libcml_tpu_torch.core.lie import SE3
        from libcml_tpu_torch.models.indirect.pnp import _residuals

        # the plain classification at the kernel's final pose
        T = SE3(R=got[0].to(Xw.device), t=got[1].to(Xw.device))
        r, _, z_ok = _residuals(T, Xw, uv, cam)
        chi2 = (torch.sum(r * r, -1) * (1.0 / sigma2)).cpu().numpy()
        at_g = valid.cpu().numpy() & z_ok.cpu().numpy() & (chi2 < CHI2_2D)
        for n in flip.tolist():
            near = abs(chi2[n] - CHI2_2D) <= DECISION_TOL["chi2_rel"] * CHI2_2D
            classes.append({"match": n, "chi2_at_kernel_pose": float(chi2[n]),
                            "within": bool(at_g[n] == g[2][n] or near)})
    ok = (all(err[k] <= PARITY_TOL[k] for k in PARITY_TOL)
          and (step is None or step["within"]) and all(c["within"] for c in classes)
          and int(g[3]) == int(g[2].sum()))
    return {"ok": ok, "max_err": err, "first_step_differing": step,
            "classes_differing": classes}
