"""FAST corner detection as a dense vectorized stencil.

PyTorch port of libcml_tpu/models/indirect/fast.py (the reference's FAST
detector, src/cml/features/corner/FAST.h:17). The 16 Bresenham-circle
samples are 16 shifted copies of the image (torch.roll), the "9 contiguous
brighter/darker" predicate is a circular sliding-window sum over the
16-lane axis, and non-max suppression is a 3x3 max-pool compare.
"""

from __future__ import annotations

import torch
import torch.nn.functional as Fnn

from libcml_tpu_torch.models.direct.selector import topk_stable

# Bresenham circle of radius 3, clockwise from 12 o'clock (dy, dx)
_CIRCLE = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
)


def _circle_stack(img: torch.Tensor) -> torch.Tensor:
    """(H, W) -> (H, W, 16) circle samples via rolls (borders masked later)."""
    return torch.stack(
        [torch.roll(img, (-dy, -dx), dims=(0, 1)) for dy, dx in _CIRCLE], dim=-1)


def _arc_reaches(flags: torch.Tensor, arc: int) -> torch.Tensor:
    """flags (H, W, 16) bool -> (H, W) bool: any `arc` contiguous true lanes
    on the circular 16-lane axis."""
    f = torch.cat([flags, flags[..., : arc - 1]], dim=-1).to(torch.int32)
    c = torch.cumsum(f, dim=-1)
    c = torch.cat([torch.zeros_like(c[..., :1]), c], dim=-1)
    win = c[..., arc:] - c[..., :-arc]
    return torch.any(win == arc, dim=-1)


def fast_score_map(img: torch.Tensor, threshold: float, arc: int = 9) -> torch.Tensor:
    """Dense FAST-N response map (H, W) float32; 0 where not a corner.
    Score = max over (brighter, darker) of the summed |I_circle - I_center|
    minus threshold over the qualifying lanes."""
    circ = _circle_stack(img)
    center = img[..., None]
    t = float(threshold)

    brighter = circ > center + t
    darker = circ < center - t
    is_b = _arc_reaches(brighter, arc)
    is_d = _arc_reaches(darker, arc)

    zero = torch.zeros((), dtype=img.dtype, device=img.device)
    sb = torch.sum(torch.where(brighter, circ - center - t, zero), dim=-1)
    sd = torch.sum(torch.where(darker, center - circ - t, zero), dim=-1)
    score = torch.maximum(torch.where(is_b, sb, zero), torch.where(is_d, sd, zero))

    # kill the 3-pixel border (rolled samples wrap around)
    H, W = img.shape
    yy = torch.arange(H, device=img.device)[:, None]
    xx = torch.arange(W, device=img.device)[None, :]
    inside = (yy >= 3) & (yy < H - 3) & (xx >= 3) & (xx < W - 3)
    return torch.where(inside, score, zero)


def _maxpool3(x: torch.Tensor) -> torch.Tensor:
    """3x3 max over a SAME window (padding -inf), as lax.reduce_window."""
    return Fnn.max_pool2d(x[None, None], 3, stride=1, padding=1)[0, 0]


def fast_detect(img: torch.Tensor, threshold: float, max_corners: int, arc: int = 9):
    """Detect up to max_corners FAST corners with 3x3 NMS + global top-k.
    Returns (uv (K, 2) float32, score (K,), valid (K,) bool)."""
    score = fast_score_map(img, threshold, arc)
    is_max = (score >= _maxpool3(score)) & (score > 0.0)
    flat = torch.where(is_max, score, torch.zeros_like(score)).reshape(-1)
    top, idx = topk_stable(flat, max_corners)
    W = img.shape[1]
    uv = torch.stack([(idx % W).float(), (idx // W).float()], dim=-1)
    return uv, top, top > 0.0
