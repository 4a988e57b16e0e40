"""The window BA's LM loop on the card: the sweep, solve and run kernels.

  ba_sweep_cuda   hand-written sm_90a kernel (csrc/ba_sweep.cu): one
                  cooperative launch sweeps the (P, F) residual grid of a
                  BAState and reduces it to what the plain forms' linearize +
                  _assemble + _schur_terms give (the camera system H, b, the
                  lambda-damped Schur corrections H_corr, b_corr, returned as
                  the differences S = H - H_corr, s = b - b_corr; per point
                  H_rho_d, b_rho and the H_xr row), or only the photometric
                  energy, or update_residual_status' masks, or _marg_pieces'
                  contraction; never a Jacobian. Its group partials are
                  float64 (PERF.md: the sums of ~1e10 whose difference
                  H - H_corr along the scale direction is ~1e6), summed over
                  the groups by every block of the grid (phase D). With
                  `finish` the same launch ends total_energy (the prior and
                  affine terms) and, for run_ba, the accept test, lambda's
                  update and the state select. With the mixed BA's
                  reprojection factors (`ind`), a system or energy sweep
                  also sweeps them, into sums of their own (the additive
                  system, the second Schur pair and each factor point's
                  rows; the reprojection energy). `ba_finish_cuda` launches
                  the same kernel's FINISH mode on an energy reduced
                  elsewhere (an all-reduce), the reprojection energy added
                  last.
  ba_solve_cuda   hand-written sm_90a kernel (csrc/ba_solve.cu): the rest of
                  ba_step, from the reduced system to the candidate state (the
                  priors, the damped dense solve by one warp, the scale-gauge
                  projection, the pose / affine / delta update, and the
                  inverse-depth back-substitution over the card, the
                  factor points' too).
  ba_run_cuda     hand-written sm_90a kernel (csrc/ba_run.cu): a whole
                  run_ba, or run_ba_mixed with its factors, without a mesh
                  in one persistent cooperative launch, from the same device
                  functions (csrc/ba_common.cuh) in the same orders as the
                  split launches above, so both routes give the same bits.

They replace the JAX package's device programs for the window BA, `run_ba`'s
and `run_ba_mixed`'s `lax.scan`s (libcml_tpu/models/direct/ba.py:619, :651)
and the sweeps of `total_energy`, `update_residual_status` and
`_marg_pieces`. Their plain
PyTorch forms are those functions in models/direct/ba.py (`run_ba_plain`,
`ba_step_plain`, ...); the public names there dispatch by the tensors'
device. The kernels build with nvcc on first use (ops/kernel_build.py).
Each wrapper counts its launches in `.launches`.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from libcml_tpu_torch.core.camera import PinholeCamera
from libcml_tpu_torch.core.lie import SE3
from libcml_tpu_torch.models.direct.config import DirectConfig
from libcml_tpu_torch.ops import kernel_build as kb
from libcml_tpu_torch.ops.kernel_build import KernelLaunchError

SWEEP_SOURCE = kb.CSRC / "ba_sweep.cu"
SOLVE_SOURCE = kb.CSRC / "ba_solve.cu"
RUN_SOURCE = kb.CSRC / "ba_run.cu"
MAX_FRAMES = 8              # csrc/ba_common.cuh MAX_F
GROUP_POINTS = 16           # csrc/ba_common.cuh NPB
# The split launches take any number of points and reprojection factor
# points. The run kernel keeps every point group's rows (the state's and the
# factors') in the shared memory of a co-resident grid, so it takes at most
# ba_run_max_groups groups (run_max_groups); ba_run_cuda refuses more.

MODES = {"system": 0, "energy": 1, "status": 2, "marg": 3, "finish": 4}
FIN = {None: 0, "energy": 1, "accept": 2}

# How far run_ba on the kernels may sit from run_ba_plain on the same state
# (chip_smoke.py phase 14), the bounds of tests/test_torch_direct.py's
# run_ba parity test: E relative, T (R and t) absolute, idepth relative with
# an absolute floor. The kernels sum in another order (and the LU is not
# cuSOLVER's), so a step's accept test may go the other way near its
# threshold; DECISION_TOL says how near, as |E_new - E| / E, such a decision
# must sit. Its reading (chip_smoke.py phase 14's float64 witness, PERF.md):
# over the 76 captured steps of a run the accept test's value (E_new - E) / E
# in float32 sits up to 7.1e-5 from float64's from the same states in the
# plain form and 4.2e-5 on the kernels (each residual is a difference of
# ~100-grey-level values that is ~0.1), so a value within their sum, 1.1e-4,
# may go either way: DECISION_TOL is that sum at one significant digit,
# rounded down.
PARITY_TOL = {"E_rel": 1e-3, "T": 2e-4, "idepth_rel": 1e-2, "idepth_abs": 1e-3}
# run_ba_mixed on the kernels against run_ba_mixed_plain: the bounds of
# tests/test_torch_hybrid.py's run_ba_mixed parity test (the indirect
# inverse depths held like the photometric ones)
MIXED_PARITY_TOL = {"E_rel": 3e-3, "T": 5e-4, "idepth_rel": 1e-2, "idepth_abs": 1e-3}
DECISION_TOL = {"E_rel": 1e-4}

_VP, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _struct(name: str, ints: tuple, floats: tuple, ints2: tuple, ptrs: tuple,
            tail: tuple = ()):
    fields = ([(n, _I) for n in ints] + [(n, _F) for n in floats] + [(n, _I) for n in ints2]
              + [(n, _VP) for n in ptrs] + list(tail))
    return type(name, (ctypes.Structure,), {"_fields_": fields})


# csrc/ba_common.cuh Ind, field for field
IndArgs = _struct(
    "IndArgs", ("Q",), ("mixed_weight",), (),
    ("uv", "host", "idepth", "point_valid", "obs_uv", "obs_valid", "sigma2", "H", "b", "H_corr",
     "b_corr", "H_rho_d", "b_rho", "H_xr", "e", "partials"))
# csrc/ba_common.cuh Args, field for field
SweepArgs = _struct(
    "SweepArgs", ("mode", "fin", "P", "F", "img_h", "img_w", "slot_host", "init_lam"),
    ("fx", "fy", "cx", "cy", "huber_k", "half_k", "outlier", "rho_eps", "prior_a",
     "prior_b", "lam_init"), ("P_total", "Q"),
    ("uv", "host", "idepth", "idepth_fej", "color", "weight", "point_valid", "res_active",
     "R", "t", "R_fej", "t_fej", "ab", "ab_fej", "delta", "frame_valid", "images", "lam",
     "slot", "H", "b", "H_corr", "b_corr", "H_rho_d", "b_rho", "H_xr", "e_photo",
     "res_active_out", "point_valid_out", "partials", "bar", "H_m", "b_m", "e_in",
     "e_extra", "E", "lam_io", "src_R", "src_t", "src_ab", "src_delta", "src_idepth",
     "cand_idepth", "dst_R", "dst_t", "dst_ab", "dst_delta", "dst_idepth", "src_extra",
     "cand_extra", "dst_extra", "trace"), (("ind", IndArgs),))
# csrc/ba_common.cuh SolveArgs, field for field
SolveArgs = _struct(
    "SolveArgs", ("F", "P", "mesh"), ("prior_a", "prior_b", "idepth_min", "idepth_max"), ("Q",),
    ("H", "b", "Hi", "bi", "Hi_corr", "bi_corr", "H_m", "b_m", "R", "t",
     "ab", "delta", "frame_valid", "lam", "H_rho_d", "b_rho", "H_xr", "point_valid", "idepth",
     "R_out", "t_out", "ab_out", "delta_out", "idepth_out", "d_rho_out", "dx", "bar",
     "Hi_rho_d", "bi_rho", "Hi_xr", "ind_valid", "ind_idepth", "ind_idepth_out"))


# csrc/ba_run.cu RunArgs
class RunArgs(ctypes.Structure):
    _fields_ = [("init", SweepArgs), ("cur", SweepArgs), ("cand", SweepArgs),
                ("solve", SolveArgs), ("iters", _I), ("trace", _VP), ("flag", _VP)]


_BARRIERS: dict[torch.device, torch.Tensor] = {}


def _ptr(x: torch.Tensor | None) -> int | None:
    return None if x is None else x.data_ptr()


def _sweep_lib() -> ctypes.CDLL:
    lib = kb.load(SWEEP_SOURCE, "ba_sweep_launch", [ctypes.POINTER(SweepArgs), _VP])
    _check_size(lib, "ba_sweep_args_size", SweepArgs)
    lib.ba_sweep_plan.argtypes = [_I, _I, ctypes.POINTER(_I), ctypes.POINTER(ctypes.c_longlong)]
    lib.ba_sweep_plan.restype = _I
    return lib


def _solve_lib() -> ctypes.CDLL:
    lib = kb.load(SOLVE_SOURCE, "ba_solve_launch", [ctypes.POINTER(SolveArgs), _VP])
    _check_size(lib, "ba_solve_args_size", SolveArgs)
    return lib


def _run_lib() -> ctypes.CDLL:
    lib = kb.load(RUN_SOURCE, "ba_run_launch", [ctypes.POINTER(RunArgs), _VP])
    _check_size(lib, "ba_run_args_size", RunArgs)
    return lib


def _check_size(lib: ctypes.CDLL, symbol: str, args_type) -> None:
    """Raise unless the kernel's Args and its ctypes mirror have one size."""
    size = getattr(lib, symbol)
    size.restype = _I
    if size() != ctypes.sizeof(args_type):
        raise KernelLaunchError(f"{symbol}: the kernel's Args is {size()} bytes, the wrapper's "
                                f"{ctypes.sizeof(args_type)}")


def _barrier(dev: torch.device) -> torch.Tensor:
    """The BA kernels' grid barrier on `dev`: an arrival count (0 between
    launches) and a generation number. One a device: the BA kernels on one
    device run in stream order, never two at once on two streams (the port
    uses the current stream only)."""
    c = _BARRIERS.get(dev)
    if c is None:
        c = _BARRIERS[dev] = torch.zeros(2, dtype=torch.int32, device=dev)
    return c


def _check_state(state, images: torch.Tensor, cam: PinholeCamera, dev: torch.device) -> None:
    P, F = state.uv.shape[0], state.ab.shape[0]
    f32, b8 = torch.float32, torch.bool
    if not 1 <= F <= MAX_FRAMES:
        raise ValueError(f"the BA kernels take 1-{MAX_FRAMES} frame slots, got {F}")
    for name, shape, dtype in (("uv", (P, 2), f32), ("host", (P,), torch.int32),
                               ("idepth", (P,), f32), ("idepth_fej", (P,), f32),
                               ("color", (P, 8), f32), ("weight", (P, 8), f32),
                               ("point_valid", (P,), b8), ("res_active", (P, F), b8),
                               ("ab", (F, 2), f32), ("ab_fej", (F, 2), f32),
                               ("delta", (F, 8), f32), ("frame_valid", (F,), b8),
                               ("H_m", (8 * F, 8 * F), f32), ("b_m", (8 * F,), f32)):
        kb.check_tensor(name, getattr(state, name), shape, dtype, dev)
    for name in ("T", "T_fej"):
        T = getattr(state, name)
        kb.check_tensor(f"{name}.R", T.R, (F, 3, 3), f32, dev)
        kb.check_tensor(f"{name}.t", T.t, (F, 3), f32, dev)
    kb.check_tensor("images", images, (F, cam.height, cam.width, 3), f32, dev)
    if dev.type != "cuda":
        raise ValueError(f"the BA kernels need CUDA tensors, got {dev}")


def _check_ind(ind, F: int, dev: torch.device) -> None:
    """Raise unless `ind` (ba.IndirectFactors) is what the kernels take:
    every tensor contiguous on `dev`."""
    Q = ind.uv.shape[0]
    f32, b8 = torch.float32, torch.bool
    for name, shape, dtype in (("uv", (Q, 2), f32), ("host", (Q,), torch.int32),
                               ("idepth", (Q,), f32), ("point_valid", (Q,), b8),
                               ("obs_uv", (Q, F, 2), f32), ("obs_valid", (Q, F), b8),
                               ("sigma2", (Q, F), f32)):
        kb.check_tensor(f"ind.{name}", getattr(ind, name), shape, dtype, dev)


def _ind_fields(args, ind, cfg: DirectConfig, sysmode: bool, idepth=None) -> dict:
    """args.ind from the factors `ind` (their inverse depths `idepth`, or
    ind.idepth) with fresh outputs and scratch for a system (`sysmode`) or
    energy sweep; returns the outputs: the sums Hi, bi, Hi_corr, bi_corr
    (system; the split sweep adds the rows) or e_ind (energy)."""
    Q, F = ind.uv.shape[0], ind.obs_valid.shape[1]
    D, dev = 8 * F, ind.uv.device
    f32 = dict(dtype=torch.float32, device=dev)
    x = args.ind
    x.Q, x.mixed_weight = Q, cfg.mixed_weight
    x.uv, x.host, x.point_valid = _ptr(ind.uv), _ptr(ind.host), _ptr(ind.point_valid)
    x.idepth = _ptr(ind.idepth if idepth is None else idepth)
    x.obs_uv, x.obs_valid, x.sigma2 = _ptr(ind.obs_uv), _ptr(ind.obs_valid), _ptr(ind.sigma2)
    part = _partials(Q, F, sysmode, dev)
    x.partials = part.data_ptr()
    if sysmode:
        out = {"Hi": torch.empty((D, D), **f32), "bi": torch.empty((D,), **f32),
               "Hi_corr": torch.empty((D, D), **f32), "bi_corr": torch.empty((D,), **f32)}
        x.H, x.b, x.H_corr, x.b_corr = (_ptr(out[k]) for k in ("Hi", "bi", "Hi_corr", "bi_corr"))
    else:
        out = {"e_ind": torch.empty((), **f32)}
        x.e = out["e_ind"].data_ptr()
    out["_partials"] = part
    return out


@dataclasses.dataclass
class Finish:
    """What the sweep's energy block (or FINISH) does after the photometric
    sum: "energy" stores total_energy at the swept state in E (and with
    `init_lam`, lambda's first value in lam); "accept" compares it with E,
    keeps the lower in E, updates lam and writes dst = accept ? swept : src
    (R, t, ab, delta of the frames, idepth of every point, and `extra`: the
    mixed BA's indirect inverse depths as (src, cand, dst)); with `trace`
    (a (2,) float32 tensor) the step's E and E_new. `e_extra` (0-d): the
    reprojection energy, added last."""

    mode: str
    E: torch.Tensor
    lam: torch.Tensor | None = None
    init_lam: bool = False
    e_extra: torch.Tensor | None = None
    src: object = None
    cand_idepth: torch.Tensor | None = None
    dst: dict | None = None
    extra: tuple | None = None
    trace: torch.Tensor | None = None


def _finish_fields(args, fin: Finish | None, state, cfg: DirectConfig) -> None:
    args.fin = FIN[None if fin is None else fin.mode]
    args.H_m, args.b_m = _ptr(state.H_m), _ptr(state.b_m)
    args.prior_a, args.prior_b = cfg.ba_prior_a, cfg.ba_prior_b
    args.lam_init = cfg.ba_lambda_init
    if fin is None:
        return
    args.E, args.lam_io, args.init_lam = _ptr(fin.E), _ptr(fin.lam), int(fin.init_lam)
    args.e_extra = _ptr(fin.e_extra)
    if fin.mode == "accept":
        src, dst = fin.src, fin.dst
        args.P_total = src.idepth.shape[0]
        args.src_R, args.src_t, args.src_ab = _ptr(src.T.R), _ptr(src.T.t), _ptr(src.ab)
        args.src_delta, args.src_idepth = _ptr(src.delta), _ptr(src.idepth)
        args.cand_idepth, args.trace = _ptr(fin.cand_idepth), _ptr(fin.trace)
        args.dst_R, args.dst_t, args.dst_ab = _ptr(dst["R"]), _ptr(dst["t"]), _ptr(dst["ab"])
        args.dst_delta, args.dst_idepth = _ptr(dst["delta"]), _ptr(dst["idepth"])
        if fin.extra is not None:
            s, c, d = fin.extra
            args.Q = s.shape[0]
            args.src_extra, args.cand_extra, args.dst_extra = _ptr(s), _ptr(c), _ptr(d)


def _frame_fields(args, state) -> None:
    args.F = state.ab.shape[0]
    args.R, args.t, args.ab = _ptr(state.T.R), _ptr(state.T.t), _ptr(state.ab)
    args.delta, args.frame_valid = _ptr(state.delta), _ptr(state.frame_valid)


def _launch_sweep(args, dev: torch.device) -> None:
    lib = _sweep_lib()
    with torch.cuda.device(dev):
        err = lib.ba_sweep_launch(ctypes.byref(args), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise KernelLaunchError(f"ba_sweep kernel launch failed: CUDA error {err}")
    ba_sweep_cuda.launches += 1


def _sweep_args(state, images: torch.Tensor, cam: PinholeCamera, cfg: DirectConfig,
                mode: str, lam: torch.Tensor | None = None) -> SweepArgs:
    """A sweep's arguments over the rows of `state` in `mode` (outputs,
    scratch and finish unset)."""
    args = SweepArgs()
    args.mode = MODES[mode]
    args.P = args.P_total = state.uv.shape[0]
    args.img_h, args.img_w = cam.height, cam.width
    args.fx, args.fy, args.cx, args.cy = cam.fx, cam.fy, cam.cx, cam.cy
    k = cfg.huber_intensity
    args.huber_k, args.half_k = k, float(np.float32(0.5 * k))
    args.outlier = cfg.outlier_energy
    args.rho_eps = 1e-12 if mode == "marg" else 1e-10
    _frame_fields(args, state)
    args.uv, args.host, args.idepth = _ptr(state.uv), _ptr(state.host), _ptr(state.idepth)
    args.idepth_fej, args.color, args.weight = (_ptr(state.idepth_fej), _ptr(state.color),
                                                _ptr(state.weight))
    args.point_valid, args.res_active = _ptr(state.point_valid), _ptr(state.res_active)
    args.R_fej, args.t_fej, args.ab_fej = (_ptr(state.T_fej.R), _ptr(state.T_fej.t),
                                           _ptr(state.ab_fej))
    args.images = _ptr(images)
    args.lam = _ptr(lam)
    return args


def _partials(P: int, F: int, sysmode: bool, dev: torch.device) -> torch.Tensor:
    """Scratch for the point groups' partial sums of a sweep of P rows."""
    groups, part_bytes = ctypes.c_int(0), ctypes.c_longlong(0)
    _sweep_lib().ba_sweep_plan(P, F, ctypes.byref(groups), ctypes.byref(part_bytes))
    per_group = part_bytes.value if sysmode else 8
    return torch.empty(groups.value * per_group, dtype=torch.uint8, device=dev)


def ba_sweep_cuda(state, images: torch.Tensor, cam: PinholeCamera, cfg: DirectConfig,
                  mode: str, lam: torch.Tensor | None = None, slot=None,
                  finish: Finish | None = None, ind=None) -> dict:
    """One sweep over the point rows of `state` (a BAState, every tensor
    contiguous on one CUDA device; with a mesh, this rank's rows) and the
    window's level-0 gradient images (F, H, W, 3). `mode`: "system" (needs
    `lam`, a 0-d float32 device tensor), "energy", "status" or "marg" (needs
    `slot`, an int or a 0-d int64 device tensor). Returns a dict: e_photo
    (0-d) always; H, b (system: the differences H - H_corr, b - b_corr,
    each taken in double and rounded once), H_rho_d, b_rho, H_xr (system);
    H, b, H_corr, b_corr (marg); res_active, point_valid (status). With `finish`, the launch
    also ends total_energy at `state` (and run_ba's accept step). `ind`: the
    mixed BA's reprojection factors (ba.IndirectFactors, contiguous, every
    rank's whole; system and energy modes), swept too: the system mode adds
    their Hi, bi, Hi_corr, bi_corr (the additive system and the damped
    Schur pair, never mixed into H and b), Hi_rho_d, bi_rho and Hi_xr; the
    energy mode their energy e_ind, which `finish` adds last."""
    dev = state.uv.device
    _check_state(state, images, cam, dev)
    P, F = state.uv.shape[0], state.ab.shape[0]
    D = 8 * F
    if P == 0:
        raise ValueError("ba_sweep_cuda needs at least one point row")
    f32 = dict(dtype=torch.float32, device=dev)
    sysmode = mode in ("system", "marg")
    partials = _partials(P, F, sysmode, dev)
    out = {"e_photo": torch.empty((), **f32)}
    if sysmode:
        out.update(H=torch.empty((D, D), **f32), b=torch.empty((D,), **f32))
    if mode == "marg":
        out.update(H_corr=torch.empty((D, D), **f32), b_corr=torch.empty((D,), **f32))
    if mode == "system":
        if lam is None:
            raise ValueError("the system sweep needs lam")
        kb.check_tensor("lam", lam, (), torch.float32, dev)
        out.update(H_rho_d=torch.empty((P,), **f32), b_rho=torch.empty((P,), **f32),
                   H_xr=torch.empty((P, D), **f32))
    if mode == "status":
        out.update(res_active=torch.empty((P, F), dtype=torch.bool, device=dev),
                   point_valid=torch.empty((P,), dtype=torch.bool, device=dev))
    args = _sweep_args(state, images, cam, cfg, mode, lam)
    if ind is not None and ind.uv.shape[0] > 0:
        if mode not in ("system", "energy"):
            raise ValueError(f"the {mode} sweep takes no reprojection factors")
        _check_ind(ind, F, dev)
        out.update(_ind_fields(args, ind, cfg, mode == "system"))
        if mode == "system":   # the factors' rows, for the solve's back-substitution
            Q = ind.uv.shape[0]
            out.update(Hi_rho_d=torch.empty((Q,), **f32), bi_rho=torch.empty((Q,), **f32),
                       Hi_xr=torch.empty((Q, D), **f32))
            args.ind.H_rho_d, args.ind.b_rho, args.ind.H_xr = (
                _ptr(out[k]) for k in ("Hi_rho_d", "bi_rho", "Hi_xr"))
    if mode == "marg":
        if isinstance(slot, torch.Tensor):
            slot = slot.to(torch.int64).reshape(())
            kb.check_tensor("slot", slot, (), torch.int64, dev)
            args.slot = slot.data_ptr()
        else:
            args.slot_host = int(slot)
    args.H, args.b = _ptr(out.get("H")), _ptr(out.get("b"))
    args.H_corr, args.b_corr = _ptr(out.get("H_corr")), _ptr(out.get("b_corr"))
    args.H_rho_d, args.b_rho, args.H_xr = (_ptr(out.get("H_rho_d")), _ptr(out.get("b_rho")),
                                           _ptr(out.get("H_xr")))
    args.e_photo = _ptr(out["e_photo"])
    args.res_active_out = _ptr(out.get("res_active"))
    args.point_valid_out = _ptr(out.get("point_valid"))
    args.partials, args.bar = partials.data_ptr(), _barrier(dev).data_ptr()
    _finish_fields(args, finish, state, cfg)
    if "e_ind" in out:
        args.e_extra = out["e_ind"].data_ptr()
    _launch_sweep(args, dev)
    out.pop("_partials", None)
    return out


ba_sweep_cuda.launches = 0


def ba_finish_cuda(e_photo: torch.Tensor, state, cfg: DirectConfig, finish: Finish) -> None:
    """The sweep kernel's FINISH mode, one block: total_energy at `state`
    from a photometric energy `e_photo` (0-d, reduced elsewhere) and
    `finish`'s step (as ba_sweep_cuda's). Counted as a ba_sweep launch."""
    dev = state.uv.device
    kb.check_tensor("e_photo", e_photo, (), torch.float32, dev)
    args = SweepArgs()
    args.mode = MODES["finish"]
    _frame_fields(args, state)
    args.idepth = _ptr(state.idepth)
    args.e_in = e_photo.data_ptr()
    _finish_fields(args, finish, state, cfg)
    _launch_sweep(args, dev)


def _solve_args(system: dict, state, cfg: DirectConfig, lam: torch.Tensor, out: dict,
                dx: torch.Tensor) -> SolveArgs:
    """The solve's arguments from `system` (H, b: H - H_corr, b - b_corr) at `state`
    into `out`'s frames (R, t, ab, delta) and dx (rows unset)."""
    args = SolveArgs()
    args.F = state.ab.shape[0]
    args.prior_a, args.prior_b = cfg.ba_prior_a, cfg.ba_prior_b
    args.idepth_min, args.idepth_max = cfg.idepth_min, cfg.idepth_max
    args.H, args.b = _ptr(system["H"]), _ptr(system["b"])
    args.H_m, args.b_m = _ptr(state.H_m), _ptr(state.b_m)
    args.R, args.t, args.ab = _ptr(state.T.R), _ptr(state.T.t), _ptr(state.ab)
    args.delta, args.frame_valid = _ptr(state.delta), _ptr(state.frame_valid)
    args.lam = lam.data_ptr()
    args.R_out, args.t_out, args.ab_out = _ptr(out["R"]), _ptr(out["t"]), _ptr(out["ab"])
    args.delta_out, args.dx = _ptr(out["delta"]), dx.data_ptr()
    args.bar = _barrier(state.uv.device).data_ptr()
    return args


def _frames(F: int, dev: torch.device) -> dict:
    f32 = dict(dtype=torch.float32, device=dev)
    return {"R": torch.empty((F, 3, 3), **f32), "t": torch.empty((F, 3), **f32),
            "ab": torch.empty((F, 2), **f32), "delta": torch.empty((F, 8), **f32)}


def ba_solve_cuda(system: dict, state, cfg: DirectConfig, lam: torch.Tensor, rows,
                  mesh: bool = False, ind=None) -> dict:
    """The rest of ba_step on the card (one launch): `system` is the reduced
    sweep (H, b: H - H_corr, b - b_corr; with a mesh all-reduced) and its per-row
    H_rho_d, b_rho, H_xr for `rows` (the BAState whose point rows were
    swept); `state` the whole state. `ind`: the mixed BA's factors, whose
    terms the same sweep made (system's Hi, bi, Hi_corr, bi_corr, Hi_rho_d,
    bi_rho, Hi_xr; not all-reduced). Returns the candidate's R, t, ab, delta
    and either idepth (every row; no mesh) or d_rho (the rows; mesh), and,
    with `ind`, ind_idepth (the factors' candidate inverse depths, whole)."""
    dev = state.uv.device
    F, P = state.ab.shape[0], rows.uv.shape[0]
    D = 8 * F
    kb.check_tensor("lam", lam, (), torch.float32, dev)
    for name, shape in (("H", (D, D)), ("b", (D,)), ("H_rho_d", (P,)), ("b_rho", (P,)),
                        ("H_xr", (P, D))):
        kb.check_tensor(name, system[name], shape, torch.float32, dev)
    out = _frames(F, dev)
    out["d_rho" if mesh else "idepth"] = torch.empty((P,), dtype=torch.float32, device=dev)
    dx = torch.empty((D,), dtype=torch.float32, device=dev)
    args = _solve_args(system, state, cfg, lam, out, dx)
    args.P, args.mesh = P, int(mesh)
    if ind is not None and ind.uv.shape[0] > 0:
        Q = ind.uv.shape[0]
        _check_ind(ind, F, dev)
        for name, shape in (("Hi", (D, D)), ("bi", (D,)), ("Hi_corr", (D, D)), ("bi_corr", (D,)),
                            ("Hi_rho_d", (Q,)), ("bi_rho", (Q,)), ("Hi_xr", (Q, D))):
            kb.check_tensor(name, system[name], shape, torch.float32, dev)
            setattr(args, name, system[name].data_ptr())
        out["ind_idepth"] = torch.empty((Q,), dtype=torch.float32, device=dev)
        args.Q, args.ind_valid, args.ind_idepth = Q, _ptr(ind.point_valid), _ptr(ind.idepth)
        args.ind_idepth_out = _ptr(out["ind_idepth"])
    args.H_rho_d, args.b_rho, args.H_xr = (_ptr(system["H_rho_d"]), _ptr(system["b_rho"]),
                                           _ptr(system["H_xr"]))
    args.point_valid, args.idepth = _ptr(rows.point_valid), _ptr(rows.idepth)
    args.idepth_out, args.d_rho_out = _ptr(out.get("idepth")), _ptr(out.get("d_rho"))
    lib = _solve_lib()
    with torch.cuda.device(dev):
        err = lib.ba_solve_launch(ctypes.byref(args), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise KernelLaunchError(f"ba_solve kernel launch failed: CUDA error {err}")
    ba_solve_cuda.launches += 1
    return out


ba_solve_cuda.launches = 0


_RUN_MAX_GROUPS: dict[torch.device, int] = {}


def run_max_groups(dev: torch.device) -> int:
    """The most point groups (the state's and the factors', GROUP_POINTS
    points each) the run kernel takes on CUDA device `dev`."""
    n = _RUN_MAX_GROUPS.get(dev)
    if n is None:
        out = _I()
        with torch.cuda.device(dev):
            err = _run_lib().ba_run_max_groups(ctypes.byref(out))
        if err != 0:
            raise KernelLaunchError(f"ba_run_max_groups failed: CUDA error {err}")
        n = _RUN_MAX_GROUPS[dev] = out.value
    return n


def _check_run_groups(P: int, Q: int, dev: torch.device) -> None:
    """Raise unless the run kernel takes P points and Q factor points."""
    n = -(-P // GROUP_POINTS) + -(-Q // GROUP_POINTS)
    if n > run_max_groups(dev):
        raise ValueError(f"the run kernel takes at most {run_max_groups(dev)} point groups "
                         f"of {GROUP_POINTS} on {dev}, got {n} ({P} points, {Q} factor points)")


def ba_run_cuda(state, images: torch.Tensor, cam: PinholeCamera, cfg: DirectConfig,
                trace: torch.Tensor | None = None, ind=None) -> dict:
    """run_ba_plain's LM loop (cfg.ba_iters steps, no mesh) in one launch,
    or with `ind` (ba.IndirectFactors) run_ba_mixed_plain's: `state` a
    BAState, every tensor contiguous on one CUDA device, and the window's
    level-0 gradient images. Returns the result's R, t, ab, delta, idepth, E
    (0-d) and, with `ind`, idepth_i (the factors' inverse depths); with
    `trace` (a (ba_iters, 2) float32 tensor on the card), each step's (E,
    E_new) in it."""
    dev = state.uv.device
    _check_state(state, images, cam, dev)
    P, F = state.uv.shape[0], state.ab.shape[0]
    if ind is not None:
        _check_ind(ind, F, dev)
    D = 8 * F
    if P == 0:
        raise ValueError("ba_run_cuda needs at least one point row")
    _check_run_groups(P, 0 if ind is None else ind.uv.shape[0], dev)
    f32 = dict(dtype=torch.float32, device=dev)
    if trace is not None:
        kb.check_tensor("trace", trace, (cfg.ba_iters, 2), torch.float32, dev)
    out = {**_frames(F, dev), "idepth": torch.empty((P,), **f32), "E": torch.empty((), **f32)}
    cand = {**_frames(F, dev), "idepth": torch.empty((P,), **f32)}
    system = {"H": torch.empty((D, D), **f32), "b": torch.empty((D,), **f32)}
    lam, dx = torch.empty((), **f32), torch.empty((D,), **f32)
    flag = torch.empty((1,), dtype=torch.int32, device=dev)
    partials = _partials(P, F, True, dev)
    bar = _barrier(dev).data_ptr()
    held = state.replace(T=SE3(R=out["R"], t=out["t"]), ab=out["ab"], delta=out["delta"],
                         idepth=out["idepth"])
    trial = state.replace(T=SE3(R=cand["R"], t=cand["t"]), ab=cand["ab"], delta=cand["delta"],
                          idepth=cand["idepth"])
    r = RunArgs()
    r.init = _sweep_args(state, images, cam, cfg, "energy")
    _finish_fields(r.init, Finish("energy", E=out["E"], lam=lam, init_lam=True), state, cfg)
    r.cur = _sweep_args(held, images, cam, cfg, "system", lam)
    r.cur.H, r.cur.b = _ptr(system["H"]), _ptr(system["b"])
    r.cand = _sweep_args(trial, images, cam, cfg, "energy")
    _finish_fields(r.cand, Finish("accept", E=out["E"], lam=lam, src=held,
                                  cand_idepth=cand["idepth"], dst=out), trial, cfg)
    r.solve = _solve_args(system, held, cfg, lam, cand, dx)
    r.solve.P = P
    r.solve.point_valid, r.solve.idepth = _ptr(state.point_valid), _ptr(out["idepth"])
    r.solve.idepth_out = _ptr(cand["idepth"])
    for args in (r.init, r.cur, r.cand):
        args.partials, args.bar = partials.data_ptr(), bar
    if ind is not None and ind.uv.shape[0] > 0:
        # the held inverse depths in the output, the candidate's, cur's
        # sums, rows and partials (init's and cand's too) and the energy in
        # scratch
        Q = ind.uv.shape[0]
        out["idepth_i"], cand_i = torch.empty((Q,), **f32), torch.empty((Q,), **f32)
        sums = _ind_fields(r.cur, ind, cfg, True, out["idepth_i"])
        e_ind = torch.empty((), **f32)
        for args, idepth in ((r.init, ind.idepth), (r.cand, cand_i)):
            args.ind = r.cur.ind
            args.ind.idepth, args.ind.e, args.e_extra = _ptr(idepth), _ptr(e_ind), _ptr(e_ind)
        r.cand.src_extra, r.cand.cand_extra = _ptr(out["idepth_i"]), _ptr(cand_i)
        r.cand.dst_extra = _ptr(out["idepth_i"])
        r.solve.Q = Q
        r.solve.Hi, r.solve.bi, r.solve.Hi_corr, r.solve.bi_corr = (
            _ptr(sums[k]) for k in ("Hi", "bi", "Hi_corr", "bi_corr"))
        r.solve.ind_valid = _ptr(ind.point_valid)
        r.solve.ind_idepth, r.solve.ind_idepth_out = _ptr(out["idepth_i"]), _ptr(cand_i)
    elif ind is not None:
        out["idepth_i"] = ind.idepth.clone()
    r.iters, r.trace, r.flag = cfg.ba_iters, _ptr(trace), flag.data_ptr()
    lib = _run_lib()
    with torch.cuda.device(dev):
        err = lib.ba_run_launch(ctypes.byref(r), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise KernelLaunchError(f"ba_run kernel launch failed: CUDA error {err}")
    ba_run_cuda.launches += 1
    return out


ba_run_cuda.launches = 0
