"""Fused masked-Hamming match resolution: the CUDA kernel and its plain version.

The matcher's core primitive (models/indirect/matching._resolve_from_desc)
needs, for a masked (N, M) Hamming-distance matrix over 256-bit ORB
descriptors: the row best and second best (Lowe ratio), the best column per
row, and the best row per column (mutual cross-check). A masked entry counts
257 and ties go to the first occurrence.

  hamming_resolve_cuda   hand-written sm_90a kernel (csrc/hamming_match.cu),
                         the port of the TPU kernel `hamming_resolve_pallas`
                         (libcml_tpu/ops/pallas_match.py:107); one launch a
                         call, and only the entries that pass every mask are
                         computed; the (N, M) matrix never exists in memory.
  hamming_resolve_plain  the same outputs from the materialized matrix, in
                         plain PyTorch (the CPU path, and the yardstick the
                         kernel is held to on the card).
  hamming_resolve        dispatch by the tensors' device: the kernel for CUDA
                         tensors, the plain version for CPU tensors. Nothing
                         falls back: a kernel that fails to build or launch
                         raises.
  match_projection_cuda  the same kernel with match_projection's pair test
  match_epipolar_cuda    (or match_epipolar's) computed inside it, in double,
                         and matching._finish in its last block: one launch
                         a match, no (N, M) mask. Their plain forms are
                         matching.match_projection_plain and
                         match_epipolar_plain; `pair_parity` holds a call to
                         the mask mode fed the plain form's mask, allowing a
                         difference only where a pair's float64 value sits
                         within EDGE_REL of its limit (`projection_edges`,
                         `epipolar_edges`).

The kernel is compiled with nvcc on first use (ops/kernel_build.py).
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from libcml_tpu_torch.models.indirect.orb import hamming_matrix
from libcml_tpu_torch.ops import kernel_build as kb
from libcml_tpu_torch.ops.kernel_build import KernelLaunchError

MASKED = 257  # > the largest Hamming distance over 256 bits

SOURCE = kb.CSRC / "hamming_match.cu"


def build(verbose: bool = False):
    """Compile the kernel if its library is missing (kernel_build.build_many)."""
    return kb.build_many([SOURCE], verbose)[0]


# the kernel's work units (csrc/hamming_match.cu): rows per row group and the
# most columns per column chunk, with and without a pair mask
SPARSE_ROWS, DENSE_ROWS = 8, 32
SPARSE_CW, DENSE_CW = 2048, 512
# below this many entries one column chunk: splitting the columns adds the
# row merge's memory round trips to a call that is too small to fill the card
SPLIT_MIN_ENTRIES = 1 << 16
COL_INIT = MASKED << 32          # an untouched column key: (257, row 0)
# the kernel's modes (csrc/hamming_match.cu MODE_*); with a pair test
# computed in the kernel, the most columns per unit, the most rows per row
# group, the blocks an SM of one wave, and the fewest rows a row group takes
# while the wave has room (half a block's 8 warps: a live row's columns go
# to two warps or more)
MODE_DENSE, MODE_MASK, MODE_EPI, MODE_PROJ = 0, 1, 2, 3
PAIR_CW, PAIR_ROWS, PAIR_BLOCKS_PER_SM, PAIR_MIN_ROWS = 2048, 64, 3, 4
# hamming_pairs_launch's pointer table, in order
PRED_POINTERS = ("q", "qmask", "t", "tmask", "pair", "d1", "d2", "idx", "col_row", "row_part",
                 "col_best", "tickets", "uv_q", "uv_t", "Xw", "level_q", "level_t", "R1", "t1",
                 "R0", "t0", "F", "uv_p", "geom", "t_norm", "best", "ok", "num", "rec")
# csrc/hamming_match.cu epi_geometry's output: F (9), R_10 (9), t_10 (3), |t_10|
GEOM_LEN = 22
# A pair whose float64 test value lies within this relative distance of its
# limit may be decided either way by a float32 form (the plain forms compute
# in float32 through cuBLAS products, the kernel in double): d2 at the limit
# is ~1e3 px^2 for the projection window, whose float32 pixel sits up to
# ~3e-5 px from float64, a relative 1e-6; the epipolar value's float32
# cancellation reaches ~1e-5 relative on 640x480 pixels.
EDGE_REL = 1e-4


def _library() -> ctypes.CDLL:
    return kb.load(SOURCE, "hamming_resolve_launch",
                   [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 8)


def _pairs_library() -> ctypes.CDLL:
    return kb.load(SOURCE, "hamming_pairs_launch", [ctypes.c_void_p] * 4)


def plan(N: int, M: int, has_pair: bool, sms: int) -> tuple[int, int, int]:
    """(groups, chunks, cw): the kernel's grid of groups x chunks units. Row
    group g holds rows g, g + groups, ...; column chunk k holds columns
    [k cw, (k + 1) cw). From SPLIT_MIN_ENTRIES entries on, enough units to
    give each of `sms` SMs one (two without a pair mask, whose units are
    shorter), and no more chunks than one per 32 columns."""
    rows, max_cw = (SPARSE_ROWS, SPARSE_CW) if has_pair else (DENSE_ROWS, DENSE_CW)
    groups = -(-N // rows)
    want = (sms if has_pair else 2 * sms) if N * M >= SPLIT_MIN_ENTRIES else 1
    chunks = max(-(-M // max_cw), min(-(-want // groups), -(-M // 32)))
    cw = -(-M // chunks)
    return groups, -(-M // cw), cw


def pair_plan(N: int, M: int, sms: int) -> tuple[int, int, int]:
    """(groups, chunks, cw) of the pair-test modes: ceil(M / PAIR_CW) column
    chunks of near equal width (one at the hybrid's 1,536 corners), and per
    chunk as many row groups as one wave of PAIR_BLOCKS_PER_SM blocks an SM
    holds, at most ceil(N / PAIR_MIN_ROWS), never fewer than
    ceil(N / PAIR_ROWS). Row group g holds rows g + j groups, j < PAIR_ROWS."""
    chunks = -(-M // PAIR_CW)
    cw = -(-M // chunks)
    chunks = -(-M // cw)
    wave = max(1, PAIR_BLOCKS_PER_SM * sms // chunks)
    groups = max(-(-N // PAIR_ROWS), min(-(-N // PAIR_MIN_ROWS), wave))
    return groups, chunks, cw


# per (device, stream): column keys at COL_INIT and tickets at 0, which the
# kernel leaves so on exit
_SCRATCH: dict[tuple[int, int], tuple[torch.Tensor, torch.Tensor]] = {}


def _scratch(dev: torch.device, stream: int, M: int, n_tickets: int):
    key = (dev.index, stream)
    cols, tickets = _SCRATCH.get(key, (None, None))
    if cols is None or cols.numel() < M:
        cols = torch.full((M,), COL_INIT, dtype=torch.int64, device=dev)
    if tickets is None or tickets.numel() < n_tickets:
        tickets = torch.zeros(n_tickets, dtype=torch.int32, device=dev)
    _SCRATCH[key] = cols, tickets
    return cols, tickets


def hamming_resolve_cuda(desc_q: torch.Tensor, mask_q: torch.Tensor,
                         desc_t: torch.Tensor, mask_t: torch.Tensor,
                         pair_mask: torch.Tensor | None = None):
    """Launch the kernel on the current stream (one launch). Inputs: desc_q
    (N, 8) int32, mask_q (N,) bool, desc_t (M, 8) int32, mask_t (M,) bool,
    optional pair_mask (N, M) bool, all contiguous on one CUDA device, the
    descriptors 16-byte aligned. Returns int32 (d1 (N,), d2 (N,), idx (N,),
    col_row (M,)). Counts its launches in `hamming_resolve_cuda.launches`."""
    dev = desc_q.device
    if dev.type != "cuda":
        raise ValueError(f"hamming_resolve_cuda needs CUDA tensors, got {dev}")
    N, M = desc_q.shape[0], desc_t.shape[0]
    if N == 0 or M == 0:
        raise ValueError("hamming_resolve_cuda needs at least one query and one train row")
    kb.check_tensor("desc_q", desc_q, (N, 8), torch.int32, dev)
    kb.check_tensor("mask_q", mask_q, (N,), torch.bool, dev)
    kb.check_tensor("desc_t", desc_t, (M, 8), torch.int32, dev)
    kb.check_tensor("mask_t", mask_t, (M,), torch.bool, dev)
    if pair_mask is not None:
        kb.check_tensor("pair_mask", pair_mask, (N, M), torch.bool, dev)
    if desc_q.data_ptr() % 16 or desc_t.data_ptr() % 16:
        raise ValueError("descriptors must be 16-byte aligned")
    lib = _library()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    groups, chunks, cw = plan(N, M, pair_mask is not None, sms)
    stream = torch.cuda.current_stream(dev).cuda_stream
    col_best, tickets = _scratch(dev, stream, M, groups + chunks)
    d1 = torch.empty(N, dtype=torch.int32, device=dev)
    d2 = torch.empty(N, dtype=torch.int32, device=dev)
    idx = torch.empty(N, dtype=torch.int32, device=dev)
    col_row = torch.empty(M, dtype=torch.int32, device=dev)
    row_part = torch.empty((chunks, N, 2), dtype=torch.int32, device=dev) if chunks > 1 else None
    with torch.cuda.device(dev):
        err = lib.hamming_resolve_launch(
            desc_q.data_ptr(), mask_q.data_ptr(), desc_t.data_ptr(), mask_t.data_ptr(),
            None if pair_mask is None else pair_mask.data_ptr(), N, M, groups, chunks, cw,
            d1.data_ptr(), d2.data_ptr(), idx.data_ptr(), col_row.data_ptr(),
            None if row_part is None else row_part.data_ptr(), col_best.data_ptr(),
            tickets.data_ptr(), stream)
    if err != 0:
        _SCRATCH.pop((dev.index, stream), None)
        raise KernelLaunchError(f"hamming_resolve kernel launch failed: CUDA error {err}")
    hamming_resolve_cuda.launches += 1
    return d1, d2, idx, col_row


hamming_resolve_cuda.launches = 0


@dataclasses.dataclass
class PairMatch:
    """One predicate-mode launch's outputs: the resolution (d1, d2, idx,
    col_row int32, as hamming_resolve's), matching._finish's (best int64,
    ok bool, num int64 0-d), and the projected pixels (MODE_PROJ) or the
    geometry and |t_10| (MODE_EPI from poses)."""

    d1: torch.Tensor
    d2: torch.Tensor
    idx: torch.Tensor
    col_row: torch.Tensor
    best: torch.Tensor
    ok: torch.Tensor
    num: torch.Tensor
    uv_p: torch.Tensor | None = None
    geom: torch.Tensor | None = None
    t_norm: torch.Tensor | None = None


def _pairs_launch(lib, mode: int, dev: torch.device, N: int, M: int, ptrs: dict, floats,
                  ints, out: PairMatch) -> None:
    """One launch of hamming_pairs_launch on the current stream."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    groups, chunks, cw = pair_plan(N, M, sms)
    stream = torch.cuda.current_stream(dev).cuda_stream
    col_best, tickets = _scratch(dev, stream, M, groups + chunks + 1)
    row_part = torch.empty((chunks, N, 2), dtype=torch.int32, device=dev) if chunks > 1 else None
    rec = torch.empty((N, 2), dtype=torch.int32, device=dev)
    ptrs = dict(ptrs, d1=out.d1, d2=out.d2, idx=out.idx, col_row=out.col_row, row_part=row_part,
                col_best=col_best, tickets=tickets, best=out.best, ok=out.ok, num=out.num, rec=rec)
    table = (ctypes.c_void_p * len(PRED_POINTERS))(
        *(None if ptrs.get(k) is None else ptrs[k].data_ptr() for k in PRED_POINTERS))
    f = (ctypes.c_double * 6)(*floats)
    i = (ctypes.c_int * 9)(mode, N, M, groups, chunks, cw, *ints)
    with torch.cuda.device(dev):
        err = lib.hamming_pairs_launch(ctypes.addressof(table), ctypes.addressof(f),
                                       ctypes.addressof(i), stream)
    if err != 0:
        _SCRATCH.pop((dev.index, stream), None)
        raise KernelLaunchError(f"hamming pair-test kernel launch failed: CUDA error {err}")


def _pair_outputs(N: int, M: int, dev: torch.device) -> PairMatch:
    i32 = dict(dtype=torch.int32, device=dev)
    return PairMatch(d1=torch.empty(N, **i32), d2=torch.empty(N, **i32),
                     idx=torch.empty(N, **i32), col_row=torch.empty(M, **i32),
                     best=torch.empty(N, dtype=torch.int64, device=dev),
                     ok=torch.empty(N, dtype=torch.bool, device=dev),
                     num=torch.empty((), dtype=torch.int64, device=dev))


def _check_common(dq, mq, dt, mt, dev):
    N, M = dq.shape[0], dt.shape[0]
    if N == 0 or M == 0:
        raise ValueError("a pair-test match needs at least one query and one train row")
    kb.check_tensor("desc_q", dq, (N, 8), torch.int32, dev)
    kb.check_tensor("mask_q", mq, (N,), torch.bool, dev)
    kb.check_tensor("desc_t", dt, (M, 8), torch.int32, dev)
    kb.check_tensor("mask_t", mt, (M,), torch.bool, dev)
    if dq.data_ptr() % 16 or dt.data_ptr() % 16:
        raise ValueError("descriptors must be 16-byte aligned")
    return N, M


def match_projection_cuda(Xw, desc_p, valid_p, level_p, R, t, cam, desc_f, uv_f, level_f,
                          valid_f, radius: float = 15.0, max_dist: int = 100,
                          ratio: float = 0.9) -> PairMatch:
    """matching.match_projection as one launch: the points Xw (P, 3) at pose
    (R (3, 3), t (3,)) projected and tested against the corners uv_f (F, 2)
    inside the kernel (levels int32), resolved and finished there. All
    contiguous float32 / int32 / bool tensors on one CUDA device. Counts its
    launches in `match_projection_cuda.launches`."""
    lib = _pairs_library()
    dev = Xw.device
    if dev.type != "cuda":
        raise ValueError(f"match_projection_cuda needs CUDA tensors, got {dev}")
    N, M = _check_common(desc_p, valid_p, desc_f, valid_f, dev)
    kb.check_tensor("Xw", Xw, (N, 3), torch.float32, dev)
    kb.check_tensor("level_p", level_p, (N,), torch.int32, dev)
    kb.check_tensor("uv_f", uv_f, (M, 2), torch.float32, dev)
    kb.check_tensor("level_f", level_f, (M,), torch.int32, dev)
    kb.check_tensor("R", R, (3, 3), torch.float32, dev)
    kb.check_tensor("t", t, (3,), torch.float32, dev)
    out = _pair_outputs(N, M, dev)
    out.uv_p = torch.empty((N, 2), dtype=torch.float32, device=dev)
    _pairs_launch(lib, MODE_PROJ, dev, N, M,
                  dict(q=desc_p, qmask=valid_p, t=desc_f, tmask=valid_f, uv_t=uv_f, Xw=Xw,
                       level_q=level_p, level_t=level_f, R1=R, t1=t, uv_p=out.uv_p),
                  (cam.fx, cam.fy, cam.cx, cam.cy, radius, ratio),
                  (cam.width, cam.height, max_dist), out)
    match_projection_cuda.launches += 1
    return out


match_projection_cuda.launches = 0


def match_epipolar_cuda(desc_q, uv_q, valid_q, desc_t, uv_t, valid_t, F=None, poses=None,
                        cam=None, epi_tol: float = 3.84, max_dist: int = 50,
                        ratio: float = 0.8) -> PairMatch:
    """matching.match_epipolar as one launch: the epipolar band of F (3, 3)
    float32, or of the two poses `poses` = (R_new, t_new, R_0, t_0) with
    `cam`'s intrinsics (then the kernel makes T_10 and F itself and writes
    them to `geom`, with |t_10| to `t_norm`), tested inside the kernel,
    resolved and finished there. Counts its launches in
    `match_epipolar_cuda.launches`."""
    lib = _pairs_library()
    dev = desc_q.device
    if dev.type != "cuda":
        raise ValueError(f"match_epipolar_cuda needs CUDA tensors, got {dev}")
    if (F is None) == (poses is None) or (poses is not None and cam is None):
        raise ValueError("match_epipolar_cuda takes F, or the two poses and the camera")
    N, M = _check_common(desc_q, valid_q, desc_t, valid_t, dev)
    kb.check_tensor("uv_q", uv_q, (N, 2), torch.float32, dev)
    kb.check_tensor("uv_t", uv_t, (M, 2), torch.float32, dev)
    out = _pair_outputs(N, M, dev)
    ptrs = dict(q=desc_q, qmask=valid_q, t=desc_t, tmask=valid_t, uv_q=uv_q, uv_t=uv_t)
    if F is not None:
        kb.check_tensor("F", F, (3, 3), torch.float32, dev)
        ptrs["F"] = F
    else:
        for name, x, shape in zip(("R_new", "t_new", "R_0", "t_0"), poses,
                                  ((3, 3), (3,), (3, 3), (3,))):
            kb.check_tensor(name, x, shape, torch.float32, dev)
        out.geom = torch.empty(GEOM_LEN, dtype=torch.float64, device=dev)
        out.t_norm = torch.empty((), dtype=torch.float32, device=dev)
        ptrs.update(R1=poses[0], t1=poses[1], R0=poses[2], t0=poses[3], geom=out.geom,
                    t_norm=out.t_norm)
    fx, fy, cx, cy = (cam.fx, cam.fy, cam.cx, cam.cy) if cam is not None else (1.0,) * 4
    _pairs_launch(lib, MODE_EPI, dev, N, M, ptrs, (fx, fy, cx, cy, epi_tol, ratio),
                  (0, 0, max_dist), out)
    match_epipolar_cuda.launches += 1
    return out


match_epipolar_cuda.launches = 0


def _on(x, dev, dtype=None) -> torch.Tensor:
    """A tensor or array as a tensor on `dev` (of `dtype`, if given)."""
    return torch.as_tensor(x if torch.is_tensor(x) else np.asarray(x)).to(dev, dtype)


def _edge_summary(sel: torch.Tensor, pairs: torch.Tensor, rows: torch.Tensor,
                  live: torch.Tensor, N: int) -> dict:
    """The rows and columns a float32 form may resolve otherwise, from the
    pair tests of the rows `sel` (the valid ones): rows with an edge pair or
    at a visibility edge (`erows`), and the columns an edge pair or such a
    row's live pairs reach (`reach`); `live` scattered to (N, M)."""
    erows = rows.clone()
    erows[sel] |= pairs.any(1)
    reach = pairs.any(0) | (live & rows[sel][:, None]).any(0)
    full = torch.zeros((N, live.shape[1]), dtype=torch.bool, device=live.device)
    full[sel] = live
    return {"erows": erows.cpu().numpy(), "reach": reach.cpu().numpy(),
            "n_pairs": int(pairs.sum()), "live": full, "rows": rows}


def projection_edges(Xw, valid_p, level_p, R, t, cam, uv_f, level_f, valid_f,
                     radius: float) -> dict:
    """Where float32 and float64 may decide match_projection's tests
    otherwise, in float64 torch on the inputs' device from the float32
    inputs (tensors or arrays): the pairs (of valid points and corners)
    whose squared distance lies within EDGE_REL of r^2, and the points whose
    visibility test (z > 1e-6, 2 px inside the frame) lies within EDGE_REL
    (of the frame's size) of a limit. Returns _edge_summary's dict with the
    float64 pair test `live` (P, F), visibility `vis` and pixels `uv`."""
    dev = Xw.device if torch.is_tensor(Xw) else torch.device("cpu")
    f64 = torch.float64
    Xc = _on(Xw, dev, f64) @ _on(R, dev, f64).T + _on(t, dev, f64)
    z = Xc[:, 2]
    iz = 1.0 / torch.where(z.abs() < 1e-12, torch.full_like(z, 1e-12), z)
    u = cam.fx * Xc[:, 0] * iz + cam.cx
    v = cam.fy * Xc[:, 1] * iz + cam.cy
    vp, vf = _on(valid_p, dev, torch.bool), _on(valid_f, dev, torch.bool)
    lo, hi_u, hi_v = 2.0, cam.width - 3.0, cam.height - 3.0
    vis = vp & (z > 1e-6) & (u >= lo) & (u <= hi_u) & (v >= lo) & (v <= hi_v)
    tol = EDGE_REL * max(cam.width, cam.height)
    rows = vp & (((u - lo).abs() <= tol) | ((u - hi_u).abs() <= tol) | ((v - lo).abs() <= tol)
                 | ((v - hi_v).abs() <= tol) | ((z - 1e-6).abs() <= EDGE_REL * 1e-6))
    lp, lf = _on(level_p, dev), _on(level_f, dev)
    sel = torch.nonzero(vp).squeeze(1)            # only a valid point's pairs can be live
    r = torch.full(sel.shape, radius, dtype=torch.float32, device=dev) * \
        torch.pow(torch.tensor(1.5, dtype=torch.float32, device=dev), lp[sel].float())
    lim = (r * r).double()[:, None]
    uf = _on(uv_f, dev, f64)
    d2 = (u[sel, None] - uf[None, :, 0]) ** 2 + (v[sel, None] - uf[None, :, 1]) ** 2
    lev_ok = (lp[sel, None] - lf[None, :]).abs() <= 1
    act = vf[None, :] & lev_ok
    pairs = act & ((d2 - lim).abs() <= EDGE_REL * lim)
    live = vis[sel, None] & act & (d2 <= lim)
    out = _edge_summary(sel, pairs, rows, live, len(vp))
    out.update(vis=vis, uv=torch.stack([u, v], -1))
    return out


def epipolar_edges(uv_q, valid_q, uv_t, valid_t, F, epi_tol: float = 3.84) -> dict:
    """As projection_edges for match_epipolar: the pairs whose float64
    (l . x)^2 / max(l0^2 + l1^2, 1e-9) lies within EDGE_REL of epi_tol
    (float32's value), from F given in float64."""
    dev = uv_q.device if torch.is_tensor(uv_q) else torch.device("cpu")
    f64 = torch.float64
    Fd = _on(F, dev, f64)
    uq, ut = _on(uv_q, dev, f64), _on(uv_t, dev, f64)
    vq, vt = _on(valid_q, dev, torch.bool), _on(valid_t, dev, torch.bool)
    sel = torch.nonzero(vq).squeeze(1)
    xq = torch.cat([uq[sel], torch.ones_like(uq[sel, :1])], -1)
    xt = torch.cat([ut, torch.ones_like(ut[:, :1])], -1)
    lines = xq @ Fd.T
    den = torch.clamp(lines[:, 0] ** 2 + lines[:, 1] ** 2, min=1e-9)
    d2 = (lines @ xt.T) ** 2 / den[:, None]
    tol = float(np.float32(epi_tol))
    act = vt[None, :].expand(len(sel), -1)
    pairs = act & ((d2 - tol).abs() <= EDGE_REL * tol)
    out = _edge_summary(sel, pairs, torch.zeros_like(vq), act & (d2 <= tol), len(vq))
    out["vis"] = vq
    return out


def pair_parity(got: PairMatch, want: tuple, edges: dict) -> dict:
    """A predicate-mode call held to the mask mode fed the plain form's mask:
    `want` = (d1, d2, idx, col_row, best, ok) of that mode and
    matching._finish. Rows that touch an edge pair or sit at a visibility
    edge, and the columns those reach (`edges`, from projection_edges or
    epipolar_edges), may differ; everything else must be equal bit for bit,
    and ok equal except on rows whose column is such a column. Returns the
    verdict and its readings."""
    g = [np.asarray(x.cpu()) for x in (got.d1, got.d2, got.idx, got.col_row, got.best, got.ok)]
    w = [np.asarray(x.cpu() if torch.is_tensor(x) else x) for x in want]
    erows, reach = edges["erows"], edges["reach"]
    row_diff = (g[0] != w[0]) | (g[1] != w[1]) | (g[2] != w[2])
    col_diff = g[3] != w[3]
    ok_diff = g[5] != w[5]
    bad_rows = row_diff & ~erows
    bad_cols = col_diff & ~reach
    bad_ok = ok_diff & ~(erows | reach[g[2]] | reach[w[2]])
    num_g, num_w = int(got.num), int(np.sum(w[5]))
    return {"ok": bool(not bad_rows.any() and not bad_cols.any() and not bad_ok.any()
                       and np.array_equal(g[4], g[2].astype(np.int64))
                       and num_g == int(g[5].sum())),
            "edge_pairs": edges["n_pairs"], "edge_rows": int(erows.sum()),
            "edge_cols": int(reach.sum()), "rows_differing": int(row_diff.sum()),
            "cols_differing": int(col_diff.sum()), "ok_differing": int(ok_diff.sum()),
            "rows_beyond_edge": int(bad_rows.sum()), "cols_beyond_edge": int(bad_cols.sum()),
            "ok_beyond_edge": int(bad_ok.sum()), "num": num_g, "num_plain": num_w,
            # the largest best-distance difference on the rows held
            "max_abs_err": int(np.abs(g[0].astype(np.int64) - w[0])[~erows].max(initial=0))}


def resolve_matrix(D: torch.Tensor, mask_q: torch.Tensor, mask_t: torch.Tensor,
                   pair_mask: torch.Tensor | None = None):
    """(d1, d2, idx, col_row) int32 from a materialized (N, M) distance
    matrix: masked entries count 257, argmin takes the first occurrence, d2
    is the row minimum with the best column itself masked."""
    mask = mask_q[:, None] & mask_t[None, :]
    if pair_mask is not None:
        mask = mask & pair_mask
    big = torch.full((), MASKED, dtype=torch.int32, device=D.device)
    Dm = torch.where(mask, D.to(torch.int32), big)
    idx = torch.argmin(Dm, dim=1)
    d1 = torch.gather(Dm, 1, idx[:, None])[:, 0]
    cols = torch.arange(Dm.shape[1], device=D.device)
    d2 = torch.amin(torch.where(cols[None, :] == idx[:, None], big, Dm), dim=1)
    col_row = torch.argmin(Dm, dim=0)
    return d1, d2, idx.to(torch.int32), col_row.to(torch.int32)


def hamming_resolve_plain(desc_q: torch.Tensor, mask_q: torch.Tensor,
                          desc_t: torch.Tensor, mask_t: torch.Tensor,
                          pair_mask: torch.Tensor | None = None):
    """Plain PyTorch version of the kernel (same signature and outputs)."""
    return resolve_matrix(hamming_matrix(desc_q, desc_t), mask_q, mask_t, pair_mask)


def hamming_resolve(desc_q, mask_q, desc_t, mask_t, pair_mask=None):
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    if desc_q.is_cuda:
        return hamming_resolve_cuda(desc_q.contiguous(), mask_q.contiguous(),
                                    desc_t.contiguous(), mask_t.contiguous(),
                                    None if pair_mask is None else pair_mask.contiguous())
    if desc_q.device.type == "cpu":
        return hamming_resolve_plain(desc_q, mask_q, desc_t, mask_t, pair_mask)
    raise ValueError(f"hamming_resolve: unsupported device {desc_q.device}")
