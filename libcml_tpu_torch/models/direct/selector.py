"""Gradient-based pixel selection for direct points.

PyTorch port of libcml_tpu/models/direct/selector.py (the reference's
PixelSelector, src/cml/features/corner/PixelSelector.h:26). One fixed-shape
pass: (1) a regional threshold from per-32x32-block gradient quantiles
(smoothed over the block grid), (2) a per-cell argmax over small `pot x pot`
cells, (3) a global top-k to fill the fixed point budget.

`lax.top_k` puts the lowest index first among equal values and `torch.topk`
does not, so the top-k here is a stable descending sort, sliced.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as Fnn

from libcml_tpu_torch.ops.image import gradient_squared_norm
from libcml_tpu_torch.ops.kf_programs import select_cuda

_REGION = 32  # histogram-threshold block size (matches reference regions)


def topk_stable(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last axis with lax.top_k's tie order (lowest index
    first among equal values)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _regional_threshold(g2: torch.Tensor, quantile: float, add: float) -> torch.Tensor:
    """Per-region gradient-magnitude threshold, smoothed 3x3 over regions.
    Returns a per-pixel threshold map (H, W) (on squared magnitudes)."""
    H, W = g2.shape
    Hr, Wr = H // _REGION, W // _REGION
    g = torch.sqrt(g2[: Hr * _REGION, : Wr * _REGION])
    blocks = g.reshape(Hr, _REGION, Wr, _REGION).permute(0, 2, 1, 3).reshape(Hr, Wr, -1)
    q = torch.quantile(blocks, quantile, dim=-1)
    th = q + add
    thp = Fnn.pad(th[None, None], (1, 1, 1, 1), mode="replicate")[0, 0]
    sm = sum(
        thp[di : di + Hr, dj : dj + Wr] for di in range(3) for dj in range(3)
    ) / 9.0
    th2 = sm**2
    per_pix = torch.repeat_interleave(torch.repeat_interleave(th2, _REGION, dim=0),
                                      _REGION, dim=1)
    out = torch.full((H, W), math.inf, dtype=g2.dtype, device=g2.device)
    out[: Hr * _REGION, : Wr * _REGION] = per_pix
    # pixels outside full regions: reuse the largest region threshold
    return torch.where(torch.isinf(out), torch.max(th2), out)


def select_points(
    grad0: torch.Tensor,
    n_points: int,
    quantile: float = 0.5,
    add_threshold: float = 7.0,
    border: int = 4,
):
    """Select up to n_points high-gradient, spatially spread pixels.

    grad0: (H, W, 3) gradient image at level 0.
    Returns (uv (n, 2) float32, valid (n,) bool, score (n,) float32): one
    launch of the hand-written kernel (ops/kf_programs.select_cuda) for a
    CUDA image, select_points_plain for a CPU one; any other device
    raises."""
    if grad0.is_cuda:
        return select_cuda(grad0, n_points, quantile, add_threshold, border)
    if grad0.device.type == "cpu":
        return select_points_plain(grad0, n_points, quantile, add_threshold, border)
    raise ValueError(f"select_points: unsupported device {grad0.device}")


def select_points_plain(
    grad0: torch.Tensor,
    n_points: int,
    quantile: float = 0.5,
    add_threshold: float = 7.0,
    border: int = 4,
):
    """select_points in plain PyTorch."""
    H, W = grad0.shape[0], grad0.shape[1]
    dev = grad0.device
    g2 = gradient_squared_norm(grad0)
    th = _regional_threshold(g2, quantile, add_threshold)

    yy = torch.arange(H, device=dev)[:, None]
    xx = torch.arange(W, device=dev)[None, :]
    ok = (
        (g2 > th)
        & (xx >= border) & (xx < W - border)
        & (yy >= border) & (yy < H - border)
    )
    score = torch.where(ok, g2, torch.zeros_like(g2))

    # cell size: ~2x budget worth of cells so top-k has slack
    pot = max(2, int(math.sqrt(H * W / (2.0 * n_points))))
    Hc, Wc = H // pot, W // pot
    cells = (
        score[: Hc * pot, : Wc * pot]
        .reshape(Hc, pot, Wc, pot)
        .permute(0, 2, 1, 3)
        .reshape(Hc * Wc, pot * pot)
    )
    cell_best = torch.amax(cells, dim=-1)
    cell_arg = torch.argmax(cells, dim=-1)       # first maximum, as jnp.argmax

    k = min(n_points, Hc * Wc)
    top_score, top_cell = topk_stable(cell_best, k)
    cy = top_cell // Wc
    cx = top_cell % Wc
    off = cell_arg[top_cell]
    oy = off // pot
    ox = off % pot
    uv = torch.stack([(cx * pot + ox).float(), (cy * pot + oy).float()], dim=-1)
    valid = top_score > 0.0
    if k < n_points:  # pad to the static budget
        pad = n_points - k
        uv = torch.cat([uv, torch.zeros((pad, 2), dtype=torch.float32, device=dev)])
        valid = torch.cat([valid, torch.zeros((pad,), dtype=torch.bool, device=dev)])
        top_score = torch.cat([top_score, torch.zeros((pad,), dtype=top_score.dtype,
                                                      device=dev)])
    return uv, valid, top_score
