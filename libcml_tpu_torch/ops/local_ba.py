"""The indirect local BA's whole run on the card: one launch of a hand-written
sm_90a kernel.

  local_ba_cuda   hand-written sm_90a kernel (csrc/local_ba.cu): one
                  persistent cooperative launch runs run_local_ba's two LM
                  stages (ba_step's Schur-complemented reprojection system,
                  the dense solve by one warp, the points' back-substitution,
                  the accept test on ba_energy, lambda's schedule) and the
                  chi2 prune after each stage. It groups the observations by
                  point itself (no host read), sums each point's terms in
                  float64 and the point groups' partial systems in group
                  order, and keeps the cross blocks W in shared memory.

It replaces the JAX package's device program `run_local_ba`
(libcml_tpu/models/indirect/indirect_ba.py:188, its lax.scan stages over
`ba_step` :112). Its plain PyTorch form is `run_local_ba_plain` in
models/indirect/indirect_ba.py; `run_local_ba` there dispatches by the
problem's device. The kernel builds with nvcc on first use
(ops/kernel_build.py). The wrapper counts its launches in `.launches`.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from libcml_tpu_torch.core.camera import PinholeCamera
from libcml_tpu_torch.core.lie import SE3
from libcml_tpu_torch.ops import kernel_build as kb
from libcml_tpu_torch.ops.kernel_build import KernelLaunchError

SOURCE = kb.CSRC / "local_ba.cu"
MAX_FRAMES = 8              # csrc/local_ba.cu MAX_M: D = 6 M <= 48 for the warp's LU
GROUP_POINTS = 16           # csrc/local_ba.cu NPG
# The most points a call takes is the card's: local_ba_max_points (a block
# keeps its groups in shared memory, and every block is co-resident), 14,784
# on an H100 (132 SMs, 7 groups a block); runtime/hybrid.py MAP_CAP is 4,096.
TRACE_FIELDS = ("E", "E_new", "finite")   # a step's trace row
CHI2 = 5.991                # models/indirect/indirect_ba.py _CHI2_2D

# How far the kernel may sit from run_local_ba_plain on the same problem:
# the bounds of tests/test_torch_hybrid.py's local-BA parity test (the port
# against the JAX package). T (R and t) absolute; the points that keep two
# or more valid observations relative and absolute; the others (a free depth
# along the ray: only the 1e-8 guard holds it) by the pixel of each of their
# valid observations. The kernel sums per point in float64 where the plain
# form sums per observation in float32, and its 3x3 inverse and LU round
# otherwise, so a step's accept test, or a prune at chi2 ~ 5.991, may go the
# other way near its threshold; `parity` then asks a float64 run of the plain
# form how far the kernel sits from it (chip_smoke.py phase 16).
PARITY_TOL = {"T": 1e-4, "X_rel": 1e-4, "X_abs": 1e-4, "px": 1e-3}
# How far the kernel may sit from that float64 run where it lies beyond
# PARITY_TOL of the plain form, in `_distances`' units (T absolute, the
# points' excess over PARITY_TOL's point bound, the free points' pixels).
# With one fixed frame (every hybrid call) the plain float32 loop drifts from
# float64 by as much as the values compared, so "no further than the plain
# form" alone bounds nothing. The limits lie between the kernel's readings
# on phase 16's real calls (at most T 1.3e-3, points 28, pixels 4.1e-3) and
# those of the kernel with a fault planted on phase 5's calls (points 1,590
# and more on every call; T from 3.5e-3, pixels from 6.3e-3 on some):
# tools/local_ba_witness.py, PERF.md section 6.
F64_TOL = {"T": 5e-3, "X_scaled": 200.0, "px": 5e-2}
# A step's accept test E_new < E whose value (E_new - E) / E in the plain form
# lies within DECISION_TOL of 0 may go either way: the plain form sums its
# energies in float32 over K ~ 500-9,000 terms (a relative rounding of ~1e-6),
# the kernel in float64. `decisions` marks each differing step `within` it.
DECISION_TOL = 1e-5

_I, _F, _VP = ctypes.c_int, ctypes.c_float, ctypes.c_void_p


# csrc/local_ba.cu LocalArgs, field for field
class LocalArgs(ctypes.Structure):
    _fields_ = ([(n, _I) for n in ("M", "N", "K", "iters1", "iters2")]
                + [(n, _F) for n in ("fx", "fy", "cx", "cy")]
                + [(n, _VP) for n in (
                    "R", "t", "frame_valid", "frame_fixed", "Xw", "point_valid", "obs_frame",
                    "obs_point", "obs_uv", "obs_valid", "obs_sigma2", "R_out", "t_out",
                    "Xw_out", "obs_valid_out", "obs_valid_mid", "cnt", "off", "order", "rec",
                    "rval", "nxt", "part", "sys", "epart", "bad", "bar", "trace")])


def _lib() -> ctypes.CDLL:
    lib = kb.load(SOURCE, "local_ba_launch", [ctypes.POINTER(LocalArgs), _VP])
    size = lib.local_ba_args_size
    size.restype = _I
    if size() != ctypes.sizeof(LocalArgs):
        raise KernelLaunchError(f"local_ba_args_size: the kernel's LocalArgs is {size()} bytes, "
                                f"the wrapper's {ctypes.sizeof(LocalArgs)}")
    return lib


_MAX_POINTS: dict[torch.device, int] = {}


def max_points(dev: torch.device) -> int:
    """The most points (N) the kernel takes on CUDA device `dev`."""
    n = _MAX_POINTS.get(dev)
    if n is None:
        out = _I()
        with torch.cuda.device(dev):
            err = _lib().local_ba_max_points(ctypes.byref(out))
        if err != 0:
            raise KernelLaunchError(f"local_ba_max_points failed: CUDA error {err}")
        n = _MAX_POINTS[dev] = out.value
    return n


def _check(prob, dev: torch.device) -> tuple[int, int, int]:
    M, N, K = prob.T.t.shape[0], prob.Xw.shape[0], prob.obs_frame.shape[0]
    if not 1 <= M <= MAX_FRAMES:
        raise ValueError(f"the local BA kernel takes 1-{MAX_FRAMES} frame slots, got {M}")
    f32, b8, i32 = torch.float32, torch.bool, torch.int32
    kb.check_tensor("T.R", prob.T.R, (M, 3, 3), f32, dev)
    for name, shape, dtype in (("T.t", (M, 3), f32), ("frame_valid", (M,), b8),
                               ("frame_fixed", (M,), b8), ("Xw", (N, 3), f32),
                               ("point_valid", (N,), b8), ("obs_frame", (K,), i32),
                               ("obs_point", (K,), i32), ("obs_uv", (K, 2), f32),
                               ("obs_valid", (K,), b8), ("obs_sigma2", (K,), f32)):
        x = prob.T.t if name == "T.t" else getattr(prob, name)
        kb.check_tensor(name, x, shape, dtype, dev)
    if dev.type != "cuda":
        raise ValueError(f"the local BA kernel needs CUDA tensors, got {dev}")
    if N > max_points(dev):
        raise ValueError(f"the local BA kernel takes at most {max_points(dev)} points on "
                         f"{dev}, got {N}")
    return M, N, K


def _ptr(x: torch.Tensor | None) -> int | None:
    return None if x is None else x.data_ptr()


def local_ba_cuda(prob, cam: PinholeCamera, stage1_iters: int = 5, stage2_iters: int = 10,
                  trace: torch.Tensor | None = None, obs_valid_mid: torch.Tensor | None = None):
    """run_local_ba_plain in one launch: `prob` an IndirectBAProblem whose
    tensors are contiguous on one CUDA device (M <= 8 frame slots, N <=
    max_points(device) points; an observation whose frame or point index is
    out of range never counts and comes out invalid). Returns the problem with the result's T, Xw and
    obs_valid, in new tensors. With `trace` (a (stage1_iters + stage2_iters,
    3) float64 tensor on the card): each step's E, E_new and whether its
    candidate was finite (1.0 or 0.0); with `obs_valid_mid` (a (K,) bool
    tensor on the card): obs_valid after the first stage's prune."""
    dev = prob.Xw.device
    M, N, K = _check(prob, dev)
    if stage1_iters < 0 or stage2_iters < 0:
        raise ValueError("the stages' iterations must be >= 0")
    if trace is not None:
        kb.check_tensor("trace", trace, (stage1_iters + stage2_iters, len(TRACE_FIELDS)),
                        torch.float64, dev)
    if obs_valid_mid is not None:
        kb.check_tensor("obs_valid_mid", obs_valid_mid, (K,), torch.bool, dev)
    D = 6 * M
    G = -(-N // GROUP_POINTS)
    NT = D * (D + 1) // 2 + D
    f32 = dict(dtype=torch.float32, device=dev)
    R_out, t_out = torch.empty((M, 3, 3), **f32), torch.empty((M, 3), **f32)
    Xw_out = torch.empty((N, 3), **f32)
    ov_out = torch.empty((K,), dtype=torch.bool, device=dev)
    # one scratch buffer: the list records first (16 bytes each, aligned as
    # the allocation), then doubles (part, sys, epart), ints (cnt, off,
    # order, nxt, bad) and bytes (rval)
    n_dbl = G * NT + NT + 2 * G
    n_int = N + (N + 1) + 2 * K + 2 * G
    scratch = torch.empty(16 * K + 8 * n_dbl + 4 * n_int + K, dtype=torch.uint8, device=dev)
    a_rec = scratch.data_ptr()
    base = a_rec + 16 * K
    a = LocalArgs()
    a.M, a.N, a.K, a.iters1, a.iters2 = M, N, K, int(stage1_iters), int(stage2_iters)
    a.fx, a.fy, a.cx, a.cy = cam.fx, cam.fy, cam.cx, cam.cy
    a.R, a.t = prob.T.R.data_ptr(), prob.T.t.data_ptr()
    a.frame_valid, a.frame_fixed = prob.frame_valid.data_ptr(), prob.frame_fixed.data_ptr()
    a.Xw, a.point_valid = prob.Xw.data_ptr(), prob.point_valid.data_ptr()
    a.obs_frame, a.obs_point = prob.obs_frame.data_ptr(), prob.obs_point.data_ptr()
    a.obs_uv, a.obs_valid = prob.obs_uv.data_ptr(), prob.obs_valid.data_ptr()
    a.obs_sigma2 = prob.obs_sigma2.data_ptr()
    a.R_out, a.t_out, a.Xw_out = R_out.data_ptr(), t_out.data_ptr(), Xw_out.data_ptr()
    a.obs_valid_out, a.obs_valid_mid = ov_out.data_ptr(), _ptr(obs_valid_mid)
    a.rec = a_rec
    a.part = base
    a.sys = base + 8 * G * NT
    a.epart = a.sys + 8 * NT
    ints = base + 8 * n_dbl
    a.cnt = ints
    a.off = ints + 4 * N
    a.order = a.off + 4 * (N + 1)
    a.nxt = a.order + 4 * K
    a.bad = a.nxt + 4 * K
    a.rval = a.bad + 4 * 2 * G
    a.bar, a.trace = kb.grid_barrier(dev, "local_ba").data_ptr(), _ptr(trace)
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.local_ba_launch(ctypes.byref(a), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise KernelLaunchError(f"local_ba kernel launch failed: CUDA error {err}")
    local_ba_cuda.launches += 1
    return prob.replace(T=SE3(R=R_out, t=t_out), Xw=Xw_out, obs_valid=ov_out)


local_ba_cuda.launches = 0


# -- the comparison with the plain form -------------------------------------------------------


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def chi2_np(prob, cam: PinholeCamera, T=None, Xw=None) -> np.ndarray:
    """Each observation's un-robustified chi2 in float64 at the poses T (R,
    t as arrays; the problem's by default) and points Xw: the prune's value."""
    R = _np(prob.T.R if T is None else T[0]).astype(np.float64)
    t = _np(prob.T.t if T is None else T[1]).astype(np.float64)
    X = _np(prob.Xw if Xw is None else Xw).astype(np.float64)
    f, p = _np(prob.obs_frame).astype(np.int64), _np(prob.obs_point).astype(np.int64)
    Xc = np.einsum("kij,kj->ki", R[f], X[p]) + t[f]
    z = np.where(np.abs(Xc[:, 2]) < 1e-12, 1e-12, Xc[:, 2])
    uv = np.stack([cam.fx * Xc[:, 0] / z + cam.cx, cam.fy * Xc[:, 1] / z + cam.cy], -1)
    r = uv - _np(prob.obs_uv).astype(np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.sum(r * r, -1) / _np(prob.obs_sigma2).astype(np.float64)


def _distances(res, ref, prob, cam: PinholeCamera) -> dict:
    """How far the result `res` sits from `ref` (both IndirectBAProblems of
    the same input `prob`): T's largest entry difference, the largest
    relative-and-absolute excess of the points with two or more valid
    observations in `ref` (x / PARITY_TOL: 1 at the bound), and the largest
    pixel difference of the other points' valid observations."""
    ov = _np(ref.obs_valid)
    n_obs = np.bincount(_np(prob.obs_point)[ov], minlength=prob.Xw.shape[0])
    fixed = n_obs >= 2
    Xg, Xr = _np(res.Xw).astype(np.float64), _np(ref.Xw).astype(np.float64)
    dX = np.abs(Xg - Xr) / (PARITY_TOL["X_abs"] + PARITY_TOL["X_rel"] * np.abs(Xr))
    both = np.isfinite(Xg).all(1) & np.isfinite(Xr).all(1)
    out = {"T": max(float(np.abs(_np(res.T.R) - _np(ref.T.R)).max(initial=0.0)),
                    float(np.abs(_np(res.T.t) - _np(ref.T.t)).max(initial=0.0))),
           "X_scaled": float(dX[fixed].max(initial=0.0)),
           "X_abs": float(np.abs(Xg - Xr)[fixed].max(initial=0.0)),
           "fixed_points": int(fixed.sum()), "free_points": int((~fixed & (n_obs > 0)).sum())}
    if not np.isfinite(out["T"]) or not both[fixed].all():
        out["T"] = float("inf")
    # the pixels of the other points' valid observations, each at its own result
    f, p = _np(prob.obs_frame).astype(np.int64), _np(prob.obs_point).astype(np.int64)
    sel = ov & ~fixed[p]
    px = 0.0
    if sel.any():
        def pix(s):
            R, t = _np(s.T.R).astype(np.float64), _np(s.T.t).astype(np.float64)
            X = _np(s.Xw).astype(np.float64)
            Xc = np.einsum("kij,kj->ki", R[f[sel]], X[p[sel]]) + t[f[sel]]
            return np.stack([cam.fx * Xc[:, 0] / Xc[:, 2], cam.fy * Xc[:, 1] / Xc[:, 2]], -1)
        d = np.abs(pix(res) - pix(ref))
        px = float(np.nan_to_num(d, nan=np.inf).max())
    out["px"] = px
    return out


MEASURES = ("T", "X_scaled", "px")


def _over(d: dict) -> list[str]:
    """The measures of `d` (_distances') beyond PARITY_TOL."""
    bound = {"T": PARITY_TOL["T"], "X_scaled": 1.0, "px": PARITY_TOL["px"]}
    return [m for m in MEASURES if not d[m] <= bound[m]]


def f64_run(prob, cam: PinholeCamera, stage1_iters: int = 5, stage2_iters: int = 10) -> dict:
    """run_local_ba_plain on a float64 copy of `prob` (on its device): the
    result, each step's trace, and each prune's float64 chi2 (at the state
    after the first stage, then at the result)."""
    from libcml_tpu_torch.models.indirect.indirect_ba import run_local_ba_plain
    p64 = prob.replace(T=SE3(R=prob.T.R.double(), t=prob.T.t.double()), Xw=prob.Xw.double(),
                       obs_uv=prob.obs_uv.double(), obs_sigma2=prob.obs_sigma2.double())
    trace, mid = [], []
    out = run_local_ba_plain(p64, cam, stage1_iters, stage2_iters, trace=trace, mid=mid)
    return {"result": out, "trace": trace, "mid": mid[0],
            "chi2": (chi2_np(mid[0], cam), chi2_np(out, cam))}


def parity(got, want, prob, cam: PinholeCamera, f64: dict | None = None, mids=None) -> dict:
    """The kernel's result `got` against the plain form's `want` on the same
    problem `prob`: `ok` when obs_valid is equal apart from edge
    observations and T, the points and the free points' pixels lie within
    PARITY_TOL; or, beyond those bounds, with `f64` (f64_run's), when the
    kernel lies within F64_TOL of the float64 result in every measure and no
    further from it than the plain form in each measure beyond its bound. An
    observation whose validity differs at the prune that parted the
    forms (the first stage's where `mids`, the two forms' obs_valid after it,
    differ; else the last) is explained, with `f64`, when the float64 run
    takes the kernel's decision there (`f64_obs`: the kernel is the nearer)
    or when that run's chi2 there lies within CHI2_EDGE_REL of 5.991
    (`edge_obs`); without `f64` none is. Returns the measures, the
    observations and `ok`."""
    g_ov, w_ov = _np(got.obs_valid), _np(want.obs_valid)
    differ = np.flatnonzero(g_ov != w_ov)
    first = (np.zeros_like(g_ov) if mids is None else _np(mids[0]) != _np(mids[1]))
    edge, agree, unexplained = [], [], []
    for k in differ.tolist():
        stage = 1 if first[k] else 2
        mine = bool((_np(mids[0]) if stage == 1 else g_ov)[k])
        case = {"obs": k, "prune": stage, "kernel": mine, "plain": not mine}
        if f64 is not None:
            ref = f64["mid"] if stage == 1 else f64["result"]
            case.update(chi2_f64=float(f64["chi2"][stage - 1][k]),
                        f64=bool(_np(ref.obs_valid)[k]))
        if f64 is not None and case["f64"] == mine:
            agree.append(case)
        elif f64 is not None and abs(case["chi2_f64"] / CHI2 - 1.0) <= CHI2_EDGE_REL:
            edge.append(case)
        else:
            unexplained.append(case)
    d_plain = _distances(got, want, prob, cam)
    over = _over(d_plain)
    rep = {"obs_differing": int(differ.size), "edge_obs": edge, "f64_obs": agree,
           "unexplained_obs": unexplained, "vs_plain": d_plain, "over": over,
           "within": not over}
    ok = not unexplained and not over
    if f64 is not None:
        res64 = f64["result"]
        dk, dp = _distances(got, res64, prob, cam), _distances(want, res64, prob, cam)
        rep["kernel_vs_f64"], rep["plain_vs_f64"] = dk, dp
        rep["nearer_f64"] = {m: dk[m] <= dp[m] for m in MEASURES}
        rep["within_f64"] = {m: dk[m] <= F64_TOL[m] for m in MEASURES}
        ok = not unexplained and (not over or (all(rep["within_f64"].values())
                                               and all(rep["nearer_f64"][m] for m in over)))
    rep["ok"] = bool(ok)
    return rep


def decisions(trace_k: torch.Tensor, trace_p: list, f64: dict | None = None) -> list[dict]:
    """The steps whose accept decision differs between the kernel's trace
    (local_ba_cuda's) and the plain form's (run_local_ba_plain's list), each
    with both forms' (E_new - E) / E, whether the plain form's lies within
    DECISION_TOL of 0, and, with `f64`, the float64 run's."""
    tk = _np(trace_k).astype(np.float64)
    out = []
    for i, (E, E_new, fin) in enumerate(trace_p):
        E, E_new, fin = float(E), float(E_new), bool(fin)
        acc_p = fin and E_new < E
        acc_k = bool(tk[i, 2] and tk[i, 1] < tk[i, 0])
        if acc_k == acc_p:
            continue
        margin = (E_new - E) / max(abs(E), 1e-30)
        case = {"step": i, "kernel": acc_k, "plain": acc_p,
                "kernel_margin": float((tk[i, 1] - tk[i, 0]) / max(abs(tk[i, 0]), 1e-30)),
                "plain_margin": margin, "within": abs(margin) <= DECISION_TOL}
        if f64 is not None and i < len(f64["trace"]):
            E6, En6, _ = (float(v) for v in f64["trace"][i])
            case["f64_margin"] = (En6 - E6) / max(abs(E6), 1e-30)
        out.append(case)
    return out


def compare(prob, cam: PinholeCamera, iters: tuple[int, int] = (5, 10)) -> dict:
    """One traced launch of the kernel on the card problem `prob`, against
    run_local_ba_plain and f64_run on the same problem: `parity`'s report
    with the kernel's `launches` (1), its `trace` (numpy), the steps
    accepted otherwise (`decisions`), the two results (`got`, `want`) and the
    kernel's obs_valid after the first stage's prune (`mid`)."""
    from libcml_tpu_torch.models.indirect.indirect_ba import run_local_ba_plain
    dev, K = prob.Xw.device, prob.obs_frame.shape[0]
    trace = torch.empty((sum(iters), len(TRACE_FIELDS)), dtype=torch.float64, device=dev)
    mid = torch.empty((K,), dtype=torch.bool, device=dev)
    before = local_ba_cuda.launches
    got = local_ba_cuda(prob, cam, *iters, trace=trace, obs_valid_mid=mid)
    torch.cuda.synchronize(dev)
    launches = local_ba_cuda.launches - before
    tr_p, mid_p = [], []
    want = run_local_ba_plain(prob, cam, *iters, trace=tr_p, mid=mid_p)
    ref = f64_run(prob, cam, *iters)
    rep = parity(got, want, prob, cam, ref, (mid, mid_p[0].obs_valid))
    rep.update(launches=launches, trace=_np(trace), decisions=decisions(trace, tr_p, ref),
               steps_accepted={"kernel": sum(bool(f and En < E) for E, En, f in _np(trace)),
                               "plain": sum(bool(f) and float(En) < float(E)
                                            for E, En, f in tr_p)},
               got=got, want=want, mid=mid)
    return rep


# An observation whose validity differs between the kernel and the plain form
# is at the prune's edge when the float64 run's chi2 there lies within this
# fraction of 5.991: a rotation within PARITY_TOL["T"] moves a pixel by up to
# fx 1e-4 (0.05 px at fx 520), which moves a chi2 of 5.991 (a residual of 2.45
# sigma) by up to ~4 %; 1 % holds them to a quarter of that.
CHI2_EDGE_REL = 1e-2
