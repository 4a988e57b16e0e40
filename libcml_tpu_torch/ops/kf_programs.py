"""The direct path's keyframe programs on the card: two hand-written kernels,
numpy models of their schedules, and the verdicts.

  kf_activate_cuda   csrc/kf_activate.cu, one launch: `_activate_and_clear`
                     (mature_mask, then add_points for every frame slot's
                     arena row) or `add_points` for one row of given
                     points. Every block runs each row's free-slot scan
                     over the arena's validity flags itself and writes its
                     own candidates' rows.
  kf_refresh_cuda    csrc/kf_refresh.cu, one cooperative launch of a stage
                     mask: A the tracker reference (the window's points
                     projected into the keyframe behind a 4x4-cell z-buffer,
                     or given points, sampled at every level), B the working
                     inverse-depth range (a median), C the candidate
                     selection (regional quantiles, each cell's first
                     maximum, a stable top k), D the seed of an arena row.
                     `refresh_cuda` is `_refresh_after_kf` (A B C D, one
                     launch); `tracker_ref_cuda`, `rho_range_cuda`,
                     `select_cuda`, `seed_cuda` are its pieces, one launch
                     of one stage each.

They replace the JAX package's jitted programs `_activate_and_clear` and
`_refresh_after_kf` (libcml_tpu/runtime/odometry.py:444, :461), which XLA
fuses. The plain PyTorch forms (runtime/odometry.py
`_activate_and_clear_plain`, `_refresh_after_kf_plain`; window.add_points_plain,
selector.select_points_plain, tracer.seed_immatures_plain,
tracker.make_tracker_ref_plain, odometry._working_rho_range_plain,
odometry._tracker_ref_in_frame_plain) run on the CPU; the public names
dispatch by device (`_on_card`): a CUDA tensor launches a kernel or
raises. The kernels build with nvcc on first use (ops/kernel_build.py).
Everything here takes and returns tensors (and duck-typed state objects),
so the model modules import it without a cycle.

The numpy models (`model_*`) follow each kernel's schedule step by step;
the CPU tests hold them to the plain forms. `activate_parity` and
`refresh_parity` are the verdicts on a call on the card.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from libcml_tpu_torch.ops import kernel_build as kb
from libcml_tpu_torch.ops.kernel_build import KernelLaunchError

ACTIVATE_SOURCE = kb.CSRC / "kf_activate.cu"
REFRESH_SOURCE = kb.CSRC / "kf_refresh.cu"
ACTIVATE_THREADS = 256         # csrc/kf_activate.cu THREADS: each block's scan threads
ACTIVATE_MAX_RUN = 32          # csrc/kf_activate.cu MAX_RUN: slots a scan thread holds
MAX_LEVELS = 8                 # csrc/kf_refresh.cu MAX_LEVELS
SMEM_WORDS = 16384             # csrc/kf_refresh.cu SMEM_WORDS: two region tables, or cells
REGION = 32                    # models/direct/selector._REGION
ST_REF, ST_RANGE, ST_SELECT, ST_SEED = 1, 2, 4, 8
ALL_STAGES = 15

# The verdict's tolerances on the tracker reference, the one output whose
# arithmetic the kernel does not repeat to the bit: its point transforms are
# fused chains as cuBLAS rounds the plain form's products (csrc/kf_refresh.cu),
# so a pixel may sit a few float32 ulps (6.1e-5 px at 640) from the plain
# form's. UV_TOL bounds that; EDGE_REL is how close (relative, in float64) a
# deciding value of the plain form must sit to its threshold (the bounds
# test, z, the z-buffer's 0.8 of the cell's maximum, a 4-pixel cell's edge)
# for a validity that differs to count as an edge point, not a fault.
UV_TOL = 1e-3
EDGE_REL = 1e-5


class _ActArgs(ctypes.Structure):
    """csrc/kf_activate.cu Args, field by field."""
    _fields_ = [(n, ctypes.c_int) for n in ("mode", "P", "F", "K", "R", "H", "W")] + [
        (n, ctypes.c_void_p) for n in ("imm_uv", "imm_lo", "imm_hi", "imm_nok", "imm_valid")] + [
        ("min_traces", ctypes.c_int), ("max_relwidth", ctypes.c_float)] + [
        (n, ctypes.c_void_p) for n in ("pt_uv", "pt_idepth", "pt_valid", "slot_ptr")] + [
        ("slot_val", ctypes.c_int)] + [
        (n, ctypes.c_void_p) for n in ("images", "frame_valid", "uv", "host", "idepth",
                                       "idepth_fej", "color", "weight", "point_valid",
                                       "res_active")] + [
        ("idepth_min", ctypes.c_float), ("c2", ctypes.c_float)] + [
        (n, ctypes.c_void_p) for n in ("o_uv", "o_host", "o_idepth", "o_idepth_fej", "o_color",
                                       "o_weight", "o_point_valid", "o_res_active",
                                       "o_imm_valid")]


_I8 = ctypes.c_int * MAX_LEVELS


class _RefArgs(ctypes.Structure):
    """csrc/kf_refresh.cu Args, field by field."""
    _fields_ = [(n, ctypes.c_int) for n in ("stages", "ref_points", "W", "H")] + [
        (n, ctypes.c_float) for n in ("fx", "fy", "cx", "cy", "ifx", "ify")] + [
        (n, ctypes.c_int) for n in ("P", "F", "slot")] + [
        (n, ctypes.c_void_p) for n in ("ba_uv", "ba_idepth", "ba_host", "ba_pv", "T_R", "T_t",
                                       "pt_uv", "pt_idepth", "pt_valid")] + [
        ("L", ctypes.c_int), ("pyr", ctypes.c_void_p * MAX_LEVELS), ("lh", _I8), ("lw", _I8),
        ("cam_w", _I8), ("cam_h", _I8)] + [
        (n, ctypes.c_float) for n in ("c2", "idepth_min", "idepth_max")] + [
        (n, ctypes.c_void_p) for n in ("r_uv", "r_color", "r_weight", "r_valid", "r_idepth")] + [
        ("Wc4", ctypes.c_int), ("Hc4", ctypes.c_int)] + [
        (n, ctypes.c_void_p) for n in ("cells", "s_uv", "s_rho", "s_cid", "s_ok", "rho_lo",
                                       "rho_hi")] + [
        ("q_lo", ctypes.c_int), ("q_hi", ctypes.c_int), ("q_w", ctypes.c_float),
        ("th_add", ctypes.c_float)] + [
        (n, ctypes.c_int) for n in ("border", "Hr", "Wr", "pot", "Hc", "Wc", "n_points", "k")] + [
        (n, ctypes.c_void_p) for n in ("q_region", "cell_best", "cell_arg", "sel_uv",
                                       "sel_valid", "sel_score")] + [
        (n, ctypes.c_int) for n in ("Fi", "Ki", "sh", "sw")] + [
        (n, ctypes.c_void_p) for n in ("seed_img", "seed_uv", "seed_valid", "seed_lo",
                                       "seed_hi", "im_uv", "im_color", "im_lo", "im_hi",
                                       "im_nok", "im_nfail", "im_valid", "o_uv", "o_color",
                                       "o_lo", "o_hi", "o_nok", "o_nfail", "o_valid", "bar")]


def _f32(x) -> float:
    return float(np.float32(x))


def _c(x: torch.Tensor, dtype: torch.dtype, name: str) -> torch.Tensor:
    """x as a contiguous `dtype` tensor (a copy only where it is not one)."""
    if x.dtype != dtype:
        raise TypeError(f"{name} has dtype {x.dtype}, expected {dtype}")
    return x.contiguous()


def _aligned(x: torch.Tensor, nbytes: int, name: str) -> torch.Tensor:
    """Raise unless `x` starts on an `nbytes` boundary (the kernels load
    pixels as float2 and colour rows as float4)."""
    if x.data_ptr() % nbytes:
        raise ValueError(f"{name} must be {nbytes}-byte aligned")
    return x


def _cuda(dev: torch.device, what: str) -> None:
    if dev.type != "cuda":
        raise ValueError(f"{what} needs CUDA tensors, got {dev}")


def _library(source, symbol: str, struct) -> ctypes.CDLL:
    lib = kb.load(source, symbol, [ctypes.c_void_p, ctypes.c_void_p])
    size_fn = getattr(lib, symbol.replace("_launch", "_args_size"))
    size_fn.restype = ctypes.c_int
    if size_fn() != ctypes.sizeof(struct):
        raise KernelLaunchError(f"{source.name}: Args is {size_fn()} bytes, the wrapper's "
                                f"structure {ctypes.sizeof(struct)}")
    return lib


# -- kf_activate -------------------------------------------------------------------------


def kf_activate_cuda(ba, images: torch.Tensor, cfg, arena=None, points=None):
    """One launch of csrc/kf_activate.cu on the current stream. `ba`: the
    window's BAState; `images` its (F, H, W, 3) slot images. Exactly one of
    `arena` (the ImmatureArena: every row r hosted in slot r, mature_mask's
    readiness and midpoint) and `points` ((uv (K, 2), idepth (K,), valid
    (K,), slot): add_points' row; `slot` an int or a 0-d integer tensor on
    the device). Returns ({BAState field: new tensor} for uv, host, idepth,
    idepth_fej, color, weight, point_valid, res_active; the arena's new
    validity, or None). Counts its launches in `kf_activate_cuda.launches`."""
    if (arena is None) == (points is None):
        raise ValueError("kf_activate_cuda takes an arena or points, not both")
    dev = ba.uv.device
    _cuda(dev, "kf_activate_cuda")
    P, F = ba.uv.shape[0], ba.ab.shape[0]
    H, W = images.shape[1], images.shape[2]
    if tuple(images.shape) != (F, H, W, 3) or H < 2 or W < 2:
        raise ValueError(f"kf_activate_cuda: images must be (F, H, W, 3), got "
                         f"{tuple(images.shape)}")
    if F > 32:
        raise ValueError(f"kf_activate_cuda takes at most 32 frame slots, got {F}")
    if P > ACTIVATE_THREADS * ACTIVATE_MAX_RUN:
        raise ValueError(f"kf_activate_cuda takes at most {ACTIVATE_THREADS * ACTIVATE_MAX_RUN} "
                         f"point slots, got {P}")
    ins = {"uv": _aligned(_c(ba.uv, torch.float32, "uv"), 8, "uv"),
           "host": _c(ba.host, torch.int32, "host"),
           "idepth": _c(ba.idepth, torch.float32, "idepth"),
           "idepth_fej": _c(ba.idepth_fej, torch.float32, "idepth_fej"),
           "color": _aligned(_c(ba.color, torch.float32, "color"), 16, "color"),
           "weight": _aligned(_c(ba.weight, torch.float32, "weight"), 16, "weight"),
           "point_valid": _c(ba.point_valid, torch.bool, "point_valid"),
           "res_active": _c(ba.res_active, torch.bool, "res_active")}
    for name, x in ins.items():
        if x.device != dev or x.shape[0] != P:
            raise ValueError(f"kf_activate_cuda: {name} must have {P} rows on {dev}")
    images = _c(images, torch.float32, "images")
    frame_valid = _c(ba.frame_valid, torch.bool, "frame_valid")
    a = _ActArgs(P=P, F=F, H=H, W=W, images=images.data_ptr(),
                 frame_valid=frame_valid.data_ptr(), idepth_min=_f32(cfg.idepth_min),
                 c2=_f32(cfg.gradient_weight_c2), min_traces=int(cfg.activate_min_traces),
                 max_relwidth=_f32(cfg.activate_max_relwidth))
    for name, x in ins.items():
        setattr(a, name, x.data_ptr())
    keep = [images, frame_valid, *ins.values()]
    imm_valid = None
    if arena is not None:
        R, K = arena.valid.shape
        fields = (_aligned(_c(arena.uv, torch.float32, "arena uv"), 8, "arena uv"),
                  _c(arena.rho_lo, torch.float32, "rho_lo"),
                  _c(arena.rho_hi, torch.float32, "rho_hi"),
                  _c(arena.n_ok, torch.int32, "n_ok"), _c(arena.valid, torch.bool, "valid"))
        if R != F:
            raise ValueError(f"kf_activate_cuda: the arena has {R} rows for {F} frame slots")
        a.mode = 0
        a.imm_uv, a.imm_lo, a.imm_hi, a.imm_nok, a.imm_valid = (x.data_ptr() for x in fields)
        imm_valid = torch.empty((R, K), dtype=torch.bool, device=dev)
        a.o_imm_valid = imm_valid.data_ptr()
        keep += fields
    else:
        uv, idepth, valid, slot = points
        K, R = uv.shape[0], 1
        pts = (_aligned(_c(uv, torch.float32, "uv").reshape(K, 2), 8, "uv"),
               _c(idepth, torch.float32, "idepth"),
               _c(valid, torch.bool, "valid"))
        a.mode = 1
        a.pt_uv, a.pt_idepth, a.pt_valid = (x.data_ptr() for x in pts)
        if isinstance(slot, torch.Tensor):
            s = slot.to(torch.int64).reshape(())
            if s.device != dev:
                raise ValueError(f"kf_activate_cuda: the slot is on {s.device}")
            a.slot_ptr = s.data_ptr()
            keep.append(s)
        else:
            a.slot_val = int(slot)
        keep += pts
    if K > P:
        raise ValueError(f"kf_activate_cuda: {K} candidates a row for {P} point slots")
    a.K, a.R = K, R
    out = {"uv": torch.empty_like(ins["uv"]), "host": torch.empty_like(ins["host"]),
           "idepth": torch.empty_like(ins["idepth"]),
           "idepth_fej": torch.empty_like(ins["idepth_fej"]),
           "color": torch.empty_like(ins["color"]), "weight": torch.empty_like(ins["weight"]),
           "point_valid": torch.empty_like(ins["point_valid"]),
           "res_active": torch.empty_like(ins["res_active"])}
    for name, x in out.items():
        setattr(a, "o_" + name, x.data_ptr())
    lib = _library(ACTIVATE_SOURCE, "kf_activate_launch", _ActArgs)
    with torch.cuda.device(dev):
        err = lib.kf_activate_launch(ctypes.byref(a), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise KernelLaunchError(f"kf_activate kernel launch failed: CUDA error {err}")
    kf_activate_cuda.launches += 1
    del keep
    return out, imm_valid


kf_activate_cuda.launches = 0


# -- kf_refresh --------------------------------------------------------------------------


def _quantile_rank(quantile: float) -> tuple[int, int, float]:
    """torch.quantile's rank of `quantile` among a region's 1,024 values
    (float32, as it computes it): its floor, ceiling and fraction."""
    rank = np.float32(quantile) * np.float32(REGION * REGION - 1)
    lo = int(rank)
    return lo, int(np.ceil(rank)), float(rank - np.float32(lo))


def select_geometry(H: int, W: int, n_points: int, quantile: float = 0.5) -> dict:
    """select_points' shapes for an (H, W) image and `n_points`: the regions,
    the cell side `pot`, the cells, k, and the regional quantile's rank."""
    pot = max(2, int(math.sqrt(H * W / (2.0 * n_points))))
    Hc, Wc = H // pot, W // pot
    q_lo, q_hi, q_w = _quantile_rank(quantile)
    return {"Hr": H // REGION, "Wr": W // REGION, "pot": pot, "Hc": Hc, "Wc": Wc,
            "k": min(n_points, Hc * Wc), "q_lo": q_lo, "q_hi": q_hi, "q_w": q_w}


def _refresh_args(cam=None, cfg=None) -> _RefArgs:
    """The launch's arguments with the camera and the config (for the
    stages that read them; zeros otherwise)."""
    a = _RefArgs(slot=-1)
    if cam is not None:
        a.W, a.H = cam.width, cam.height
        a.fx, a.fy, a.cx, a.cy = _f32(cam.fx), _f32(cam.fy), _f32(cam.cx), _f32(cam.cy)
        a.ifx = float(np.float32(1.0) / np.float32(cam.fx))
        a.ify = float(np.float32(1.0) / np.float32(cam.fy))
    if cfg is not None:
        a.c2, a.idepth_min = _f32(cfg.gradient_weight_c2), _f32(cfg.idepth_min)
        a.idepth_max = _f32(cfg.idepth_max)
    return a


def _set_window(a: _RefArgs, ba, slot: int, keep: list) -> None:
    P, F = ba.uv.shape[0], ba.ab.shape[0]
    xs = (_c(ba.uv, torch.float32, "uv"), _c(ba.idepth, torch.float32, "idepth"),
          _c(ba.host, torch.int32, "host"), _c(ba.point_valid, torch.bool, "point_valid"),
          _c(ba.T.R, torch.float32, "T.R"), _c(ba.T.t, torch.float32, "T.t"))
    a.P, a.F = P, F
    a.ba_uv, a.ba_idepth, a.ba_host, a.ba_pv, a.T_R, a.T_t = (x.data_ptr() for x in xs)
    keep += xs


def _set_pyramid(a: _RefArgs, pyr, cam, keep: list) -> None:
    L = len(pyr)
    if not 0 < L <= MAX_LEVELS:
        raise ValueError(f"kf_refresh_cuda takes 1-{MAX_LEVELS} pyramid levels, got {L}")
    a.L = L
    for l, G in enumerate(pyr):
        G = _c(G, torch.float32, f"pyramid level {l}")
        if G.ndim != 3 or G.shape[2] != 3 or G.shape[0] < 2 or G.shape[1] < 2:
            raise ValueError(f"kf_refresh_cuda: level {l} must be (H, W, 3), got {tuple(G.shape)}")
        a.pyr[l] = G.data_ptr()
        a.lh[l], a.lw[l] = G.shape[0], G.shape[1]
        a.cam_w[l], a.cam_h[l] = cam.width >> l, cam.height >> l
        keep.append(G)


def kf_refresh_cuda(a: _RefArgs, dev: torch.device, keep: list) -> None:
    """One cooperative launch of csrc/kf_refresh.cu with the filled
    arguments `a` (its stage mask among them) on the current stream;
    `keep` holds the tensors they point into until it is enqueued. Counts
    its launches in `kf_refresh_cuda.launches`."""
    keep.append(kb.grid_barrier(dev, "kf_refresh"))
    a.bar = keep[-1].data_ptr()
    lib = _library(REFRESH_SOURCE, "kf_refresh_launch", _RefArgs)
    with torch.cuda.device(dev):
        err = lib.kf_refresh_launch(ctypes.byref(a), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise KernelLaunchError(f"kf_refresh kernel launch failed: CUDA error {err}")
    kf_refresh_cuda.launches += 1


kf_refresh_cuda.launches = 0


def _ref_outputs(a: _RefArgs, L: int, P: int, dev, window: bool) -> dict:
    out = {"uv": torch.empty((L, P, 2), dtype=torch.float32, device=dev),
           "color": torch.empty((L, P, 1), dtype=torch.float32, device=dev),
           "weight": torch.empty((L, P, 1), dtype=torch.float32, device=dev),
           "valid": torch.empty((L, P), dtype=torch.bool, device=dev)}
    a.r_uv, a.r_color, a.r_weight, a.r_valid = (x.data_ptr() for x in out.values())
    if window:
        out["idepth"] = torch.empty(P, dtype=torch.float32, device=dev)
        a.r_idepth = out["idepth"].data_ptr()
    return out


def _ref_scratch(a: _RefArgs, cam, P: int, dev, keep: list) -> None:
    a.Wc4, a.Hc4 = (cam.width + 3) // 4, (cam.height + 3) // 4
    xs = (torch.empty(a.Wc4 * a.Hc4, dtype=torch.int32, device=dev),
          torch.empty((P, 2), dtype=torch.float32, device=dev),
          torch.empty(P, dtype=torch.float32, device=dev),
          torch.empty(P, dtype=torch.int32, device=dev),
          torch.empty(P, dtype=torch.uint8, device=dev))
    a.cells, a.s_uv, a.s_rho, a.s_cid, a.s_ok = (x.data_ptr() for x in xs)
    keep += xs


def _range_outputs(a: _RefArgs, dev) -> tuple[torch.Tensor, torch.Tensor]:
    lo = torch.empty((), dtype=torch.float32, device=dev)
    hi = torch.empty((), dtype=torch.float32, device=dev)
    a.rho_lo, a.rho_hi = lo.data_ptr(), hi.data_ptr()
    return lo, hi


def _set_select(a: _RefArgs, grad0: torch.Tensor, n_points: int, quantile: float,
                add_threshold: float, border: int, keep: list):
    H, W = grad0.shape[0], grad0.shape[1]
    if H < REGION or W < REGION:
        raise ValueError(f"select on the card needs a {REGION}x{REGION} region, got {H}x{W}")
    if n_points <= 0:
        raise ValueError(f"select needs a positive point budget, got {n_points}")
    g = select_geometry(H, W, n_points, quantile)
    if 2 * g["Hr"] * g["Wr"] > SMEM_WORDS or g["Hc"] * g["Wc"] > SMEM_WORDS:
        raise ValueError("select on the card: too many regions or cells for shared memory")
    if g["Hc"] < 1 or g["Wc"] < 1:
        raise ValueError(f"select on the card: no {g['pot']}-pixel cell in {H}x{W}")
    dev = grad0.device
    for k in ("q_lo", "q_hi", "q_w", "Hr", "Wr", "pot", "Hc", "Wc", "k"):
        setattr(a, k, g[k])
    a.th_add, a.border, a.n_points = _f32(add_threshold), int(border), int(n_points)
    scratch = (torch.empty(g["Hr"] * g["Wr"], dtype=torch.float32, device=dev),
               torch.empty(g["Hc"] * g["Wc"], dtype=torch.float32, device=dev),
               torch.empty(g["Hc"] * g["Wc"], dtype=torch.int32, device=dev))
    a.q_region, a.cell_best, a.cell_arg = (x.data_ptr() for x in scratch)
    out = (torch.empty((n_points, 2), dtype=torch.float32, device=dev),
           torch.empty(n_points, dtype=torch.bool, device=dev),
           torch.empty(n_points, dtype=torch.float32, device=dev))
    a.sel_uv, a.sel_valid, a.sel_score = (x.data_ptr() for x in out)
    keep += scratch
    return out


_ARENA_FIELDS = ("uv", "color", "rho_lo", "rho_hi", "n_ok", "n_fail", "valid")
_ARENA_TYPES = (torch.float32, torch.float32, torch.float32, torch.float32, torch.int32,
                torch.int32, torch.bool)


def _set_seed(a: _RefArgs, arena, slot: int, grad0: torch.Tensor, keep: list) -> dict:
    F, K = arena.valid.shape
    ins = [_c(getattr(arena, f), t, f"arena {f}") for f, t in zip(_ARENA_FIELDS, _ARENA_TYPES)]
    _aligned(ins[0], 8, "arena uv")        # copied as float2 and float4 rows
    _aligned(ins[1], 16, "arena color")
    g = _c(grad0, torch.float32, "seed image")
    if g.ndim != 3 or g.shape[2] != 3 or g.shape[0] < 2 or g.shape[1] < 2:
        raise ValueError(f"seed on the card: the image must be (H, W, 3), got {tuple(g.shape)}")
    a.Fi, a.Ki, a.sh, a.sw, a.slot = F, K, g.shape[0], g.shape[1], int(slot)
    a.seed_img = g.data_ptr()
    a.im_uv, a.im_color, a.im_lo, a.im_hi, a.im_nok, a.im_nfail, a.im_valid = (
        x.data_ptr() for x in ins)
    out = {f: torch.empty_like(x) for f, x in zip(_ARENA_FIELDS, ins)}
    a.o_uv, a.o_color, a.o_lo, a.o_hi, a.o_nok, a.o_nfail, a.o_valid = (
        x.data_ptr() for x in out.values())
    keep += [*ins, g]
    return out


def _scalar(x, dev) -> torch.Tensor:
    t = x if isinstance(x, torch.Tensor) else torch.tensor(float(x))
    t = t.to(device=dev, dtype=torch.float32).reshape(())
    return t


def refresh_cuda(ba, slot: int, kf_pyr, arena, cam, cfg):
    """`_refresh_after_kf` in one launch (stages A B C D): ({TrackerRef
    field: tensor}, {ImmatureArena field: tensor}). `slot` a Python int."""
    dev = ba.uv.device
    _cuda(dev, "refresh_cuda")
    slot = int(slot)
    if arena.valid.shape[1] != cfg.points_per_kf:
        raise ValueError(f"refresh_cuda: the arena holds {arena.valid.shape[1]} a row, the "
                         f"selection {cfg.points_per_kf}")
    keep: list = []
    a = _refresh_args(cam, cfg)
    a.stages = ALL_STAGES
    _set_window(a, ba, slot, keep)
    a.slot = slot
    _set_pyramid(a, kf_pyr, cam, keep)
    ref = _ref_outputs(a, len(kf_pyr), a.P, dev, window=True)
    _ref_scratch(a, cam, a.P, dev, keep)
    lo, hi = _range_outputs(a, dev)
    uv, valid, score = _set_select(a, kf_pyr[0], cfg.points_per_kf, 0.5, 7.0, 4, keep)
    new_arena = _set_seed(a, arena, slot, kf_pyr[0], keep)
    a.seed_uv, a.seed_valid, a.seed_lo, a.seed_hi = (uv.data_ptr(), valid.data_ptr(),
                                                     lo.data_ptr(), hi.data_ptr())
    keep += [uv, valid, score, lo, hi]
    kf_refresh_cuda(a, dev, keep)
    return ref, new_arena


def tracker_ref_cuda(kf_pyr, cam, cfg, ba=None, slot: int | None = None, points=None) -> dict:
    """Stage A alone: the tracker reference of the window's points in frame
    `slot` ({TrackerRef field: tensor}, with the points' inverse depth in
    the keyframe), or of given `points` (uv (P, 2), idepth (P,), valid (P,);
    the result's idepth is the given one)."""
    if (ba is None) == (points is None):
        raise ValueError("tracker_ref_cuda takes a window or points, not both")
    dev = kf_pyr[0].device
    _cuda(dev, "tracker_ref_cuda")
    keep: list = []
    a = _refresh_args(cam, cfg)
    a.stages = ST_REF
    _set_pyramid(a, kf_pyr, cam, keep)
    if ba is not None:
        _set_window(a, ba, int(slot), keep)
        a.slot = int(slot)
        if not 0 <= a.slot < a.F:
            raise ValueError(f"tracker_ref_cuda: slot {a.slot} outside the {a.F} frame slots")
        out = _ref_outputs(a, len(kf_pyr), a.P, dev, window=True)
        _ref_scratch(a, cam, a.P, dev, keep)
    else:
        uv, idepth, valid = points
        P = uv.shape[0]
        xs = (_c(uv, torch.float32, "uv").reshape(P, 2), _c(idepth, torch.float32, "idepth"),
              _c(valid, torch.bool, "valid"))
        a.ref_points, a.P = 1, P
        a.pt_uv, a.pt_idepth, a.pt_valid = (x.data_ptr() for x in xs)
        keep += xs
        out = _ref_outputs(a, len(kf_pyr), P, dev, window=False)
        out["idepth"] = idepth
    kf_refresh_cuda(a, dev, keep)
    return out


def rho_range_cuda(ba, cfg) -> tuple[torch.Tensor, torch.Tensor]:
    """Stage B alone: the working range (rho_lo, rho_hi), 0-d tensors."""
    dev = ba.uv.device
    _cuda(dev, "rho_range_cuda")
    keep: list = []
    a = _refresh_args(cfg=cfg)
    a.stages = ST_RANGE
    a.L, a.pyr[0] = 1, None
    _set_window(a, ba, 0, keep)
    lo, hi = _range_outputs(a, dev)
    kf_refresh_cuda(a, dev, keep)
    return lo, hi


def select_cuda(grad0: torch.Tensor, n_points: int, quantile: float = 0.5,
                add_threshold: float = 7.0, border: int = 4):
    """Stage C alone: select_points' (uv (n, 2), valid (n,), score (n,))."""
    dev = grad0.device
    _cuda(dev, "select_cuda")
    keep: list = []
    a = _refresh_args()
    a.stages = ST_SELECT
    g = _c(grad0, torch.float32, "grad0")
    if g.ndim != 3 or g.shape[2] != 3:
        raise ValueError(f"select_cuda: the image must be (H, W, 3), got {tuple(g.shape)}")
    a.L, a.pyr[0] = 1, g.data_ptr()
    a.lh[0], a.lw[0] = g.shape[0], g.shape[1]
    a.H, a.W = g.shape[0], g.shape[1]
    keep.append(g)
    out = _set_select(a, g, int(n_points), quantile, add_threshold, border, keep)
    kf_refresh_cuda(a, dev, keep)
    return out


def seed_cuda(arena, slot: int, grad0: torch.Tensor, uv: torch.Tensor, valid: torch.Tensor,
              rho_lo, rho_hi) -> dict:
    """Stage D alone: seed_immatures' new arena ({field: tensor})."""
    dev = grad0.device
    _cuda(dev, "seed_cuda")
    K = arena.valid.shape[1]
    if uv.shape[0] != K or valid.shape[0] != K:
        raise ValueError(f"seed_cuda: {uv.shape[0]} seeds for a row of {K}")
    keep: list = []
    a = _refresh_args()
    a.stages = ST_SEED
    a.L = 1
    out = _set_seed(a, arena, int(slot), grad0, keep)
    xs = (_c(uv, torch.float32, "uv").reshape(K, 2), _c(valid, torch.bool, "valid"),
          _scalar(rho_lo, dev), _scalar(rho_hi, dev))
    a.seed_uv, a.seed_valid, a.seed_lo, a.seed_hi = (x.data_ptr() for x in xs)
    keep += xs
    kf_refresh_cuda(a, dev, keep)
    return out


# -- numpy models of the schedules ---------------------------------------------------------


def model_free_slot_scan(point_valid: np.ndarray, K: int,
                         threads: int = ACTIVATE_THREADS) -> np.ndarray:
    """A block's scan of one row (csrc/kf_activate.cu): each of `threads`
    threads counts the free slots of its contiguous run (a bit mask), an
    exclusive sum over the threads gives its first position, and it lists
    its free slots from there while the position is under K. Returns the
    (min(K, free),) destination of each position."""
    P = point_valid.shape[0]
    run = -(-P // threads)
    free = ~point_valid.astype(bool)
    counts = np.array([int(free[t * run:(t + 1) * run].sum()) for t in range(threads)])
    start = np.concatenate([[0], np.cumsum(counts)[:-1]])
    dest = np.full(min(K, int(counts.sum())), -1, np.int64)
    for t in range(threads):
        pos = int(start[t])
        for s in range(t * run, min((t + 1) * run, P)):
            if pos >= K:
                break
            if free[s]:
                dest[pos] = s
                pos += 1
    return dest


def model_activate(point_valid: np.ndarray, ready: np.ndarray, shift: int = 0,
                   threads: int = ACTIVATE_THREADS) -> tuple[np.ndarray, np.ndarray]:
    """The kernel's R dependent scans and scatters on the validity flags:
    ready (R, K) -> (dest (R, K), -1 where nothing is written; the new
    flags). `shift` plants a slot fault: position i takes the (i +
    shift)-th free slot (the last one repeats)."""
    pv = point_valid.astype(bool).copy()
    R, K = ready.shape
    dest = np.full((R, K), -1, np.int64)
    for r in range(R):
        d = model_free_slot_scan(pv, K, threads)
        for i in range(d.shape[0]):
            if ready[r, i]:
                s = d[min(i + shift, d.shape[0] - 1)]
                dest[r, i] = s
        pv[dest[r][dest[r] >= 0]] = True
    return dest, pv


def model_select_ranks(keys: np.ndarray, r0: int, r1: int) -> tuple[np.uint32, np.uint32]:
    """csrc/kf_refresh.cu select_ranks: the keys at ranks r0 and r1 (r1 = r0
    or r0 + 1, both under the count) of unsigned `keys` as an ascending sort
    holds them. Four passes from the top 8-bit digit: a histogram of the
    digit over the keys that match the digits found so far, the bin whose
    running count passes the rank (the rank then counted inside it); after
    the last pass the bin holds the keys equal to the one found. The key at
    r1 is that key while its equal keys reach r1, else the least key above
    it."""
    k = np.asarray(keys, np.uint32).reshape(-1)
    prefix = mask = equal = 0
    r = int(r0)
    for shift in (24, 16, 8, 0):
        match = (k & np.uint32(mask)) == np.uint32(prefix)
        hist = np.bincount(((k[match] >> np.uint32(shift)) & np.uint32(0xFF)).astype(np.int64),
                           minlength=256)
        running = np.cumsum(hist)
        digit = int(np.argmax(running > r))
        before = int(running[digit] - hist[digit])
        prefix |= digit << shift
        mask |= 0xFF << shift
        equal = int(hist[digit])
        r -= before
    k1 = prefix if r + (int(r1) - int(r0)) < equal else int(k[k > np.uint32(prefix)].min())
    return np.uint32(prefix), np.uint32(k1)


def _lerp(lo: np.float32, hi: np.float32, w: np.float32) -> np.float32:
    """torch.lerp's two branches; with w 0 or 0.5 (the medians) the fused
    and the separate roundings agree."""
    with np.errstate(invalid="ignore", over="ignore"):
        if abs(w) < 0.5:
            return np.float32(lo + np.float32(w * np.float32(hi - lo)))
        return np.float32(hi - np.float32(np.float32(hi - lo) * np.float32(1 - w)))


def model_region_quantile(values: np.ndarray, quantile: float = 0.5) -> np.float32:
    """A region's quantile as csrc/kf_refresh.cu takes it: NaN if any value
    is, else the keys (the values' bits, >= +0) at torch.quantile's float32
    ranks by model_select_ranks, interpolated."""
    v = np.asarray(values, np.float32).reshape(-1)
    if np.isnan(v).any():
        return np.float32(np.nan)
    q_lo, q_hi, q_w = _quantile_rank(quantile)
    k0, k1 = model_select_ranks(v.view(np.uint32), q_lo, q_hi)
    f = np.array([k0, k1], np.uint32).view(np.float32)
    return _lerp(f[0], f[1], np.float32(q_w))


def _order_key(v: np.ndarray) -> np.ndarray:
    u = np.asarray(v, np.float32).view(np.uint32)
    return np.where(u & 0x80000000, ~u, u | 0x80000000).astype(np.uint32)


def _order_value(k: np.uint32) -> np.float32:
    k = np.uint32(k)
    u = (k & np.uint32(0x7FFFFFFF)) if k & np.uint32(0x80000000) else ~k
    return np.array([u], np.uint32).view(np.float32)[0]


def model_rho_range(idepth: np.ndarray, point_valid: np.ndarray, idepth_min: float,
                    idepth_max: float) -> tuple[np.float32, np.float32]:
    """Stage B: the valid, non-NaN inverse depths' order keys (the others
    left out: they sort after them) at torch.nanquantile's float32 ranks of
    0.5 by model_select_ranks, interpolated; 1.0 when none (or not
    finite)."""
    v = np.asarray(idepth, np.float32)
    ok = np.asarray(point_valid, bool) & ~np.isnan(v)
    m = int(ok.sum())
    med = np.float32(np.nan)
    if m > 0:
        rank = np.float32(0.5) * np.float32(m - 1)
        lo = int(rank)
        k0, k1 = model_select_ranks(_order_key(v[ok]), lo, int(np.ceil(rank)))
        med = _lerp(_order_value(k0), _order_value(k1), np.float32(rank - np.float32(lo)))
    if not np.isfinite(med):
        med = np.float32(1.0)
    with np.errstate(over="ignore"):
        return (np.maximum(np.float32(med / np.float32(8.0)), np.float32(idepth_min)),
                np.minimum(np.float32(med * np.float32(8.0)), np.float32(idepth_max)))


def model_zbuffer(rho: np.ndarray, ok: np.ndarray, cid: np.ndarray, n_cells: int) -> np.ndarray:
    """The z-buffer's two passes: pass 1 max-es every valid point's inverse
    depth bits into a zeroed table (a positive float orders as its bits,
    whatever the order of the atomics), pass 2 keeps a point whose inverse
    depth exceeds 0.8 of its cell's maximum. Returns the kept mask."""
    r = np.asarray(rho, np.float32)
    table = np.zeros(n_cells, np.uint32)
    bits = np.where(ok, r, np.float32(0)).astype(np.float32).view(np.uint32)
    np.maximum.at(table, cid, bits)
    cmax = table.view(np.float32)[cid]
    with np.errstate(invalid="ignore", over="ignore"):
        return np.asarray(ok, bool) & (r > np.float32(0.8) * cmax)


def model_rank_topk(best: np.ndarray, k: int, ties_to_highest: bool = False) -> np.ndarray:
    """Stage C's top k by rank: cell c's rank is the count of greater maxima
    plus the equal ones at a lower index (a higher one with
    `ties_to_highest`, the smoke's planted fault). Returns the (k,) cells
    in rank order."""
    b = np.asarray(best, np.float32)
    n = b.shape[0]
    idx = np.arange(n)
    lower = idx[None, :] > idx[:, None] if ties_to_highest else idx[None, :] < idx[:, None]
    rank = ((b[None, :] > b[:, None]) | ((b[None, :] == b[:, None]) & lower)).sum(1)
    out = np.full(k, -1, np.int64)
    sel = rank < k
    out[rank[sel]] = idx[sel]
    return out


def model_cell_argmax(score: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Each cell's (pot x pot flattened) first maximum as the kernel's warp
    takes it: each lane's first maximum over its pixels (lane, lane + 32,
    ...), then the largest value's least index over the lanes."""
    s = np.asarray(score, np.float32)
    C, n = s.shape
    best = np.full((C, 32), -1.0, np.float32)
    arg = np.full((C, 32), 0x7FFFFFFF, np.int64)
    for lane in range(min(32, n)):
        cols = s[:, lane::32]
        j = np.argmax(cols, axis=1)
        best[:, lane] = cols[np.arange(C), j]
        arg[:, lane] = lane + 32 * j
    key = np.where(best < 0, 0, best.view(np.uint32)).astype(np.uint64)
    kb = key.max(1)
    a = np.where(key == kb[:, None], arg, 0x7FFFFFFF).min(1)
    return kb.astype(np.uint32).view(np.float32), a


# -- verdicts ----------------------------------------------------------------------------


def _bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.dtype.is_floating_point:
        return bool(torch.equal(a.contiguous().view(torch.int32), b.contiguous().view(torch.int32)))
    return bool(torch.equal(a, b))


def _max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    if not a.dtype.is_floating_point:
        return float((a != b).sum())
    d = (a.double() - b.double()).abs()
    d = torch.where(torch.isnan(a) & torch.isnan(b), torch.zeros_like(d), d)
    return float(torch.nan_to_num(d, nan=math.inf).max()) if d.numel() else 0.0


def activate_parity(got: tuple, want: tuple) -> dict:
    """The activation's verdict: (window, immature) of the kernel against
    the plain form's; every output bit for bit."""
    (wk, ik), (wp, ip) = got, want
    fields = ("uv", "host", "idepth", "idepth_fej", "color", "weight", "point_valid",
              "res_active")
    rep = {"differing": [f for f in fields
                         if not _bits_equal(getattr(wk.ba, f), getattr(wp.ba, f))]}
    if ik is not None and not _bits_equal(ik.valid, ip.valid):
        rep["differing"].append("immature valid")
    rep["max_abs_err"] = max(_max_err(getattr(wk.ba, f), getattr(wp.ba, f)) for f in fields)
    rep["points_valid"] = int(wk.ba.point_valid.sum())
    rep["ok"] = not rep["differing"]
    return rep


def ref_margins(ba, slot: int, cam, L: int) -> torch.Tensor:
    """Per window point, the least relative distance (float64, from the
    plain form's float32 inputs) of a deciding value of the reference's
    validity from its threshold: the bounds at every level, z against 1e-4
    and 1e-6, a 4-pixel cell's edges, and the z-buffer's 0.8 of the cell's
    maximum (that maximum in float64 over the float64 points)."""
    d = torch.float64
    uv, rho = ba.uv.to(d), ba.idepth.to(d)
    x = (uv[:, 0] - cam.cx) / cam.fx
    y = (uv[:, 1] - cam.cy) / cam.fy
    depth = 1.0 / rho.clamp(min=1e-12)
    Xh = torch.stack([x, y, torch.ones_like(x)], -1) * depth[:, None]
    host = ba.host.long()
    Xw = torch.einsum("pji,pj->pi", ba.T.R.to(d)[host], Xh - ba.T.t.to(d)[host])
    Xl = Xw @ ba.T.R.to(d)[slot].T + ba.T.t.to(d)[slot]
    z = Xl[:, 2]
    u = cam.fx * Xl[:, 0] / z + cam.cx
    v = cam.fy * Xl[:, 1] / z + cam.cy
    scale = max(cam.width, cam.height)
    m = [((z - 1e-4).abs() / 1e-4), ((z - 1e-6).abs() / 1e-6)]
    for l in range(L):
        s = 0.5 ** l
        ul, vl = (u + 0.5) * s - 0.5, (v + 0.5) * s - 0.5
        for c, hi in ((ul, (cam.width >> l) - 4), (vl, (cam.height >> l) - 4)):
            m += [(c - 3).abs() / scale, (c - hi).abs() / scale]
    for c in (u, v):
        m.append((c - 4 * torch.round(c / 4)).abs() / scale)
    rho_l = 1.0 / z.clamp(min=1e-4)
    ok = ba.point_valid & (z > 1e-4) & (u >= 3) & (u <= cam.width - 4) & (v >= 3) & \
        (v <= cam.height - 4)
    Wc = (cam.width + 3) // 4
    cid = (torch.clamp(torch.nan_to_num(v).clamp(-2**31, 2**31 - 1).long() // 4, 0,
                       (cam.height + 3) // 4 - 1) * Wc
           + torch.clamp(torch.nan_to_num(u).clamp(-2**31, 2**31 - 1).long() // 4, 0, Wc - 1))
    cmax = torch.zeros(Wc * ((cam.height + 3) // 4), dtype=d, device=uv.device)
    cmax = cmax.scatter_reduce(0, cid, torch.where(ok, rho_l, torch.zeros_like(rho_l)), "amax")
    m.append((rho_l - 0.8 * cmax[cid]).abs() / rho_l.abs().clamp(min=1e-30))
    return torch.nan_to_num(torch.stack(m, 0).amin(0), nan=0.0)


def ref_parity(rk, rp, ba=None, slot: int | None = None, cam=None, pyr=None,
               cfg=None) -> dict:
    """The tracker reference's verdict, the kernel's `rk` against the plain
    form's `rp`: the pixels within UV_TOL and the inverse depths within
    1e-5 relative; the levels' pixels, colours and weights the plain form's
    bits when it samples `pyr` at the kernel's own level-0 pixels (with
    `cam`, `cfg`); the validity equal except at points whose deciding value
    sits within EDGE_REL of a threshold (ref_margins, with the window's
    `ba` and `slot`), which are counted as edge points."""
    du = (rk.uv.double() - rp.uv.double()).abs()
    du = torch.where(torch.isnan(rk.uv) & torch.isnan(rp.uv), torch.zeros_like(du), du)
    rep = {"max_uv_err": float(torch.nan_to_num(du, nan=math.inf).max()),
           "uv_bits_differing": int((rk.uv.view(torch.int32) != rp.uv.view(torch.int32)).sum())}
    di = (rk.idepth.double() - rp.idepth.double()).abs() / rp.idepth.double().abs().clamp(
        min=1e-30)
    di = torch.where(torch.isnan(rk.idepth) & torch.isnan(rp.idepth), torch.zeros_like(di), di)
    rep["max_idepth_rel"] = float(torch.nan_to_num(di, nan=math.inf).max())
    flips = rk.valid != rp.valid
    rep["valid_differing"] = int(flips.sum())
    rep["edge_points"] = beyond = 0
    if rep["valid_differing"]:
        pts = flips.any(0)
        if ba is None:
            beyond = int(pts.sum())
        else:
            marg = ref_margins(ba, slot, cam, rk.valid.shape[0])
            rep["edge_points"] = int((pts & (marg < EDGE_REL)).sum())
            beyond = int((pts & (marg >= EDGE_REL)).sum())
    rep["valid_beyond_edge"] = beyond
    samples_ok = True
    if pyr is not None:
        from libcml_tpu_torch.models.direct.tracker import make_tracker_ref_plain

        at = make_tracker_ref_plain(pyr, cam, rk.uv[0], rk.idepth,
                                    torch.ones_like(rk.valid[0]), cfg)
        samples_ok = all(_bits_equal(getattr(at, f), getattr(rk, f))
                         for f in ("uv", "color", "weight"))
        rep["samples_at_kernel_uv"] = samples_ok
    rep["ok"] = (rep["max_uv_err"] <= UV_TOL and rep["max_idepth_rel"] <= 1e-5 and beyond == 0
                 and samples_ok)
    return rep


def refresh_parity(got: tuple, want: tuple, ba=None, slot: int | None = None,
                   cam=None, pyr=None, cfg=None) -> dict:
    """The refresh's verdict: (TrackerRef, ImmatureArena) of the kernel
    against the plain form's: the arena (the selection, the range and the
    seeded colours) bit for bit, the reference by ref_parity."""
    (rk, ak), (rp, ap) = got, want
    rep = ref_parity(rk, rp, ba, slot, cam, pyr, cfg)
    rep["arena_differing"] = [f for f in _ARENA_FIELDS
                              if not _bits_equal(getattr(ak, f), getattr(ap, f))]
    rep["max_abs_err"] = max(rep["max_uv_err"], _max_err(ak.uv, ap.uv),
                             _max_err(ak.color, ap.color))
    rep["ok"] = rep["ok"] and not rep["arena_differing"]
    return rep
