"""Keyframe-window arena management for the direct pipeline.

PyTorch port of libcml_tpu/models/direct/window.py (the reference's window
bookkeeping: DSOBundleAdjustment addNewFrame/addPoints/
flagFramesForMarginalization). Keyframes live in F fixed slots, points in a
P-slot arena; insertion scatters into free slots found by sorting validity
masks (deterministic, static shapes).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from libcml_tpu_torch.core.lie import SE3
from libcml_tpu_torch.models.direct.ba import BAState, _onehot, empty_state
from libcml_tpu_torch.models.direct.config import DirectConfig
from libcml_tpu_torch.models.direct.residuals import pattern_uv
from libcml_tpu_torch.ops.image import bilinear
from libcml_tpu_torch.ops.kf_programs import kf_activate_cuda


@dataclasses.dataclass
class Window:
    """BA state + the per-slot image data the solver samples from."""

    ba: BAState
    images: torch.Tensor    # (F, H, W, 3) level-0 gradient image per slot
    frame_id: torch.Tensor  # (F,) int32 global frame index, -1 when free

    def replace(self, **kw) -> "Window":
        return dataclasses.replace(self, **kw)


def empty_window(cfg: DirectConfig, height: int, width: int,
                 device: str | torch.device = "cpu") -> Window:
    return Window(
        ba=empty_state(cfg, device),
        images=torch.zeros((cfg.max_frames, height, width, 3), dtype=torch.float32,
                           device=device),
        frame_id=torch.full((cfg.max_frames,), -1, dtype=torch.int32, device=device),
    )


def free_frame_slot(window: Window) -> torch.Tensor:
    """Index of a free keyframe slot (lowest index first). Callers must
    marginalize first when the window is full."""
    return torch.argmin(window.ba.frame_valid.int())


def _set_rows(onehot: torch.Tensor, old: torch.Tensor, new: torch.Tensor) -> torch.Tensor:
    return torch.where(onehot.reshape((-1,) + (1,) * (old.ndim - 1)), new, old)


def add_keyframe(
    window: Window,
    grad0: torch.Tensor,
    T: SE3,
    ab: torch.Tensor,
    frame_id,
) -> tuple[Window, torch.Tensor]:
    """Insert a keyframe into a free slot: pose becomes the FEJ point,
    existing points get residuals toward the new slot."""
    ba = window.ba
    slot = free_frame_slot(window)
    onehot = torch.arange(ba.num_frames, device=ba.ab.device) == slot
    ba = ba.replace(
        T=SE3(R=_set_rows(onehot, ba.T.R, T.R), t=_set_rows(onehot, ba.T.t, T.t)),
        T_fej=SE3(R=_set_rows(onehot, ba.T_fej.R, T.R),
                  t=_set_rows(onehot, ba.T_fej.t, T.t)),
        ab=_set_rows(onehot, ba.ab, ab),
        ab_fej=_set_rows(onehot, ba.ab_fej, ab),
        delta=torch.where(onehot[:, None], torch.zeros_like(ba.delta), ba.delta),
        frame_valid=ba.frame_valid | onehot,
        res_active=ba.res_active | (onehot[None, :] & ba.point_valid[:, None]),
    )
    fid = torch.as_tensor(frame_id, dtype=torch.int32).to(onehot.device)
    return (
        window.replace(
            ba=ba,
            images=_set_rows(onehot, window.images, grad0[None]),
            frame_id=torch.where(onehot, fid, window.frame_id),
        ),
        slot,
    )


def add_points(
    window: Window,
    slot,
    uv: torch.Tensor,       # (K, 2) level-0 pixels in the host frame
    idepth: torch.Tensor,   # (K,)
    valid: torch.Tensor,    # (K,)
    cfg: DirectConfig,
) -> Window:
    """Activate K new points hosted in `slot` (an int or a 0-d tensor),
    scattered into free point slots: one launch of the hand-written kernel
    (ops/kf_programs.kf_activate_cuda) for CUDA tensors, add_points_plain
    for CPU tensors; any other device raises."""
    if uv.is_cuda:
        new, _ = kf_activate_cuda(window.ba, window.images, cfg,
                                  points=(uv, idepth, valid, slot))
        return window.replace(ba=window.ba.replace(**new))
    if uv.device.type == "cpu":
        return add_points_plain(window, slot, uv, idepth, valid, cfg)
    raise ValueError(f"add_points: unsupported device {uv.device}")


def add_points_plain(
    window: Window,
    slot,
    uv: torch.Tensor,
    idepth: torch.Tensor,
    valid: torch.Tensor,
    cfg: DirectConfig,
) -> Window:
    """add_points in plain PyTorch: the K new points go to free point slots
    (deterministic: position i to the i-th lowest free index, written only
    where the candidate is valid). Each new point gets residuals to every
    other valid frame."""
    ba = window.ba
    K = uv.shape[0]
    dev = uv.device

    # K lowest free slots; a stable sort of the validity puts free first
    order = torch.argsort(ba.point_valid.to(torch.uint8), stable=True)
    dest = order[:K]
    # with fewer than K free slots the tail of dest points at occupied slots;
    # those writes are masked out
    free_ok = ~ba.point_valid[dest]
    write = valid & free_ok

    grad_host = window.images[slot]                    # (H, W, 3)
    sample = bilinear(grad_host, pattern_uv(uv))       # (K, 8, 3)
    color = sample[..., 0]
    gsq = sample[..., 1] ** 2 + sample[..., 2] ** 2
    weight = torch.sqrt(cfg.gradient_weight_c2 / (cfg.gradient_weight_c2 + gsq))

    ar_F = torch.arange(ba.num_frames, device=dev)
    res_row = (ba.frame_valid[None, :] & (ar_F[None, :] != slot)).expand(K, ba.num_frames)

    def scatter(arr, new):
        out = arr.clone()
        out[dest] = torch.where(write.reshape((-1,) + (1,) * (new.ndim - 1)),
                                new.to(arr.dtype), arr[dest])
        return out

    rho = torch.clamp(idepth, min=cfg.idepth_min)
    host = torch.as_tensor(slot).to(device=dev, dtype=torch.int32).expand(K)
    pv = ba.point_valid.clone()
    pv[dest] = ba.point_valid[dest] | write
    ba = ba.replace(
        uv=scatter(ba.uv, uv),
        host=scatter(ba.host, host),
        idepth=scatter(ba.idepth, rho),
        idepth_fej=scatter(ba.idepth_fej, rho),
        color=scatter(ba.color, color),
        weight=scatter(ba.weight, weight),
        point_valid=pv,
        res_active=scatter(ba.res_active, res_row),
    )
    return window.replace(ba=ba)


def choose_marginalization_slot(window: Window, latest_slot=None) -> torch.Tensor:
    """Pick the keyframe to marginalize when the window is over budget
    (reference: flagFramesForMarginalization — always keep the two newest
    keyframes; drop nearly-dead frames first, oldest first; otherwise drop
    the SPATIALLY REDUNDANT frame, the smallest nearest-neighbour distance
    between keyframe positions)."""
    ba = window.ba
    F = ba.num_frames
    dev = ba.ab.device
    fv = ba.frame_valid
    ar = torch.arange(F, device=dev)
    minus1 = torch.full_like(window.frame_id, -1)
    fid = torch.where(fv, window.frame_id, minus1)

    newest = torch.argmax(fid)
    fid2 = torch.where(ar == newest, minus1, fid)
    second = torch.argmax(fid2)
    eligible = fv & (ar != newest) & (ar != second)

    hosted = _onehot(ba.host, F) * ba.point_valid[:, None].float()
    counts = torch.sum(hosted, dim=0)                   # (F,)
    dead = eligible & (counts < 8.0)

    t = ba.T.t
    d = torch.linalg.norm(t[:, None, :] - t[None, :, :], dim=-1)
    off = fv[None, :] & (ar[:, None] != ar[None, :])
    nn = torch.amin(torch.where(off, d, torch.full_like(d, math.inf)), dim=1)

    score = torch.where(dead, -1e6 - fid.float(), nn)
    score = torch.where(eligible, score, torch.full_like(score, math.inf))
    return torch.argmin(score)


def num_valid_frames(window: Window) -> torch.Tensor:
    return torch.sum(window.ba.frame_valid)
