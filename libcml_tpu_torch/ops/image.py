"""Image operations: bilinear sampling, pyramids, gradients, rectification.

PyTorch port of libcml_tpu/ops/image.py (the reference's Array2D image layer,
src/cml/image/Array2D.h:22-444, and the photometric correction path,
src/cml/image/LookupTable.h:8). Plain tensor code on (H, W) float32 images
(or (H, W, C)); samplers are gather-based and batched over arbitrary point
dims. Pyramids are tuples of per-level tensors.
"""

from __future__ import annotations

import torch


def bilinear(img: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Bilinear sample img at uv.

    img: (H, W) or (H, W, C); uv: (..., 2) in pixel coords (x, y).
    Out-of-bounds coordinates are clamped exactly as in the JAX package: the
    base pixel to [0, W-2] x [0, H-2] and the fractions to [0, 1] (callers
    mask with `in_bounds`). A NaN coordinate samples pixel 0 with NaN
    weights (the gather index must stay in range on the device).
    Returns (...,) or (..., C).
    """
    H, W = img.shape[0], img.shape[1]
    x = uv[..., 0]
    y = uv[..., 1]
    x0f = torch.nan_to_num(torch.clamp(torch.floor(x), 0, W - 2), nan=0.0)
    y0f = torch.nan_to_num(torch.clamp(torch.floor(y), 0, H - 2), nan=0.0)
    x0 = x0f.long()
    y0 = y0f.long()
    dx = torch.clamp(x - x0f, 0.0, 1.0)
    dy = torch.clamp(y - y0f, 0.0, 1.0)
    if img.ndim == 3:
        dx = dx[..., None]
        dy = dy[..., None]
    v00 = img[y0, x0]
    v01 = img[y0, x0 + 1]
    v10 = img[y0 + 1, x0]
    v11 = img[y0 + 1, x0 + 1]
    top = v00 * (1.0 - dx) + v01 * dx
    bot = v10 * (1.0 - dx) + v11 * dx
    return top * (1.0 - dy) + bot * dy


def bilinear_stack(imgs: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Bilinear sample a stack of images, each at its own points.

    imgs: (F, H, W, C); uv: (P, F, ..., 2), slice uv[:, f] sampling imgs[f].
    The same arithmetic and clamps as `bilinear` (it equals stacking
    bilinear(imgs[f], uv[:, f]) over f) in one gather. Returns (P, F, ..., C).
    """
    F, H, W = imgs.shape[0], imgs.shape[1], imgs.shape[2]
    x = uv[..., 0]
    y = uv[..., 1]
    x0f = torch.nan_to_num(torch.clamp(torch.floor(x), 0, W - 2), nan=0.0)
    y0f = torch.nan_to_num(torch.clamp(torch.floor(y), 0, H - 2), nan=0.0)
    x0 = x0f.long()
    y0 = y0f.long()
    dx = torch.clamp(x - x0f, 0.0, 1.0)[..., None]
    dy = torch.clamp(y - y0f, 0.0, 1.0)[..., None]
    f = torch.arange(F, device=imgs.device).reshape((1, F) + (1,) * (x.ndim - 2))
    v00 = imgs[f, y0, x0]
    v01 = imgs[f, y0, x0 + 1]
    v10 = imgs[f, y0 + 1, x0]
    v11 = imgs[f, y0 + 1, x0 + 1]
    top = v00 * (1.0 - dx) + v01 * dx
    bot = v10 * (1.0 - dx) + v11 * dx
    return top * (1.0 - dy) + bot * dy


def gradient_image(img: torch.Tensor) -> torch.Tensor:
    """(H, W) -> (H, W, 3) of [value, dI/dx, dI/dy] with central differences,
    one-sided at borders (reference: Array2D::gradientImage, Array2D.h:369)."""
    gx = 0.5 * (torch.roll(img, -1, dims=1) - torch.roll(img, 1, dims=1))
    gy = 0.5 * (torch.roll(img, -1, dims=0) - torch.roll(img, 1, dims=0))
    gx[:, 0] = img[:, 1] - img[:, 0]
    gx[:, -1] = img[:, -1] - img[:, -2]
    gy[0, :] = img[1, :] - img[0, :]
    gy[-1, :] = img[-1, :] - img[-2, :]
    return torch.stack([img, gx, gy], dim=-1)


def reduce_by_two(img: torch.Tensor) -> torch.Tensor:
    """2x2-mean downsample, cropping odd trailing row/col
    (reference: Array2D::reduceByTwo)."""
    H, W = img.shape[0] & ~1, img.shape[1] & ~1
    x = img[:H, :W]
    return x.reshape(H // 2, 2, W // 2, 2).mean(dim=(1, 3))


def build_pyramid(img: torch.Tensor, num_levels: int) -> tuple[torch.Tensor, ...]:
    """Gray image -> tuple of num_levels images, level 0 = full resolution."""
    levels = [img]
    for _ in range(num_levels - 1):
        levels.append(reduce_by_two(levels[-1]))
    return tuple(levels)


def build_gradient_pyramid(img: torch.Tensor, num_levels: int) -> tuple[torch.Tensor, ...]:
    """Gray image -> tuple of (H_l, W_l, 3) [value, gx, gy] tensors."""
    return tuple(gradient_image(l) for l in build_pyramid(img, num_levels))


def remap_image(raw: torch.Tensor, remap: torch.Tensor) -> torch.Tensor:
    """Rectify: sample `raw` at the precomputed source grid `remap` (H, W, 2)
    (reference: InternalCalibration.h:342 undistort-map application)."""
    return bilinear(raw, remap)


def apply_photometric(
    raw: torch.Tensor,
    gamma: torch.Tensor | None = None,
    vignette: torch.Tensor | None = None,
) -> torch.Tensor:
    """Invert camera response and vignette to get irradiance-linear intensity
    (TUM-mono photometric calibration; reference: GrayLookupTable +
    TUMCapture.cpp:19-131 vignette divide)."""
    out = raw
    if gamma is not None:
        idx = torch.clamp(out, 0.0, 255.0)
        i0f = torch.floor(idx)
        frac = idx - i0f
        i0 = torch.clamp(i0f.long(), 0, 254)
        out = gamma[i0] * (1.0 - frac) + gamma[i0 + 1] * frac
    if vignette is not None:
        out = out / torch.clamp(vignette, min=1e-3)
    return out


def gradient_squared_norm(grad: torch.Tensor) -> torch.Tensor:
    """(H, W, 3) gradient image -> (H, W) squared gradient magnitude."""
    return grad[..., 1] ** 2 + grad[..., 2] ** 2
