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

The kernel is compiled with nvcc on first use (ops/kernel_build.py).
"""

from __future__ import annotations

import ctypes

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


def _library() -> ctypes.CDLL:
    return kb.load(SOURCE, "hamming_resolve_launch",
                   [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 8)


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
