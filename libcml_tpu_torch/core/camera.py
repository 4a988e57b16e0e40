"""Camera intrinsics, distortion models, and undistortion maps.

PyTorch port of libcml_tpu/core/camera.py (the reference's calibration
stack, src/cml/map/InternalCalibration.h:19-342). `PinholeCamera` is tensor
code; the distortion models, `Calibration` and `build_remap` are host numpy
code used once per sequence, copied as they are.

All SLAM math runs in an ideal pinhole space. Pinhole intrinsics follow the
DSO per-level convention
    fx_l = fx * 2^-l,   cx_l = (cx + 0.5) * 2^-l - 0.5
so that pixel centers stay aligned across pyramid levels. The intrinsics are
kept as Python floats holding float32 values, so an eager op never waits on
the device for them and the arithmetic matches the JAX package's f32
0-d arrays.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def _f32(x) -> float:
    return float(np.float32(x))


@dataclasses.dataclass(frozen=True)
class PinholeCamera:
    """Ideal pinhole intrinsics (float32 values as Python floats)."""

    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int

    def replace(self, **kw) -> "PinholeCamera":
        return dataclasses.replace(self, **kw)

    @classmethod
    def make(cls, fx, fy, cx, cy, width, height) -> "PinholeCamera":
        return cls(fx=_f32(fx), fy=_f32(fy), cx=_f32(cx), cy=_f32(cy),
                   width=int(width), height=int(height))

    def level(self, l: int) -> "PinholeCamera":
        """Intrinsics for pyramid level l (DSO half-pixel convention), in f32
        arithmetic as the JAX package computes them."""
        s = np.float32(0.5**l)
        h = np.float32(0.5)
        return PinholeCamera(
            fx=float(np.float32(self.fx) * s),
            fy=float(np.float32(self.fy) * s),
            cx=float((np.float32(self.cx) + h) * s - h),
            cy=float((np.float32(self.cy) + h) * s - h),
            width=self.width >> l,
            height=self.height >> l,
        )

    def K(self, device: str | torch.device = "cpu") -> torch.Tensor:
        return torch.tensor(
            [[self.fx, 0.0, self.cx], [0.0, self.fy, self.cy], [0.0, 0.0, 1.0]],
            dtype=torch.float32, device=device)

    def project(self, xyz: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Camera-frame points (..., 3) -> pixel (..., 2), valid mask.
        Points behind the camera are flagged invalid."""
        z = xyz[..., 2]
        inv_z = 1.0 / torch.where(torch.abs(z) < 1e-12,
                                  torch.full_like(z, 1e-12), z)
        u = self.fx * xyz[..., 0] * inv_z + self.cx
        v = self.fy * xyz[..., 1] * inv_z + self.cy
        valid = z > 1e-6
        return torch.stack([u, v], dim=-1), valid

    def unproject(self, uv: torch.Tensor, idepth: torch.Tensor) -> torch.Tensor:
        """Pixel (..., 2) + inverse depth (...,) -> camera-frame point (..., 3)."""
        x = (uv[..., 0] - self.cx) / self.fx
        y = (uv[..., 1] - self.cy) / self.fy
        depth = 1.0 / torch.clamp(idepth, min=1e-12)
        return torch.stack([x, y, torch.ones_like(x)], dim=-1) * depth[..., None]

    def normalized(self, uv: torch.Tensor) -> torch.Tensor:
        """Pixel (..., 2) -> normalized image coords (..., 2)."""
        return torch.stack(
            [(uv[..., 0] - self.cx) / self.fx, (uv[..., 1] - self.cy) / self.fy],
            dim=-1,
        )

    def in_bounds(self, uv: torch.Tensor, border: float = 0.0) -> torch.Tensor:
        u, v = uv[..., 0], uv[..., 1]
        return (
            (u >= border)
            & (u <= self.width - 1 - border)
            & (v >= border)
            & (v <= self.height - 1 - border)
        )


# ---------------------------------------------------------------------------
# Distortion models (forward = ideal -> distorted), host numpy, used only to
# build remap grids at sequence-load time.
# ---------------------------------------------------------------------------


def radtan_distort(xn: np.ndarray, k1, k2, p1, p2) -> np.ndarray:
    """Radial-tangential (OpenCV) model on normalized coords (..., 2).
    Reference: RadtanUndistorter, InternalCalibration.h:145."""
    x, y = xn[..., 0], xn[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + k1 * r2 + k2 * r2 * r2
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return np.stack([xd, yd], axis=-1)


def fov_distort(xn: np.ndarray, omega: float) -> np.ndarray:
    """FOV (Devernay-Faugeras) model, used by TUM-mono.
    Reference: FOVUndistorter, InternalCalibration.h:206."""
    x, y = xn[..., 0], xn[..., 1]
    r = np.sqrt(x * x + y * y)
    if abs(omega) < 1e-9:
        return xn.copy()
    factor = np.where(
        r < 1e-9,
        omega / (2.0 * np.tan(omega / 2.0)),
        np.arctan(2.0 * r * np.tan(omega / 2.0)) / (omega * np.maximum(r, 1e-12)),
    )
    return xn * factor[..., None]


def equidistant_distort(xn: np.ndarray, k1, k2, k3, k4) -> np.ndarray:
    """Kannala-Brandt equidistant fisheye (EuRoC-style).
    Reference: FishEye10_5_5 family, InternalCalibration.h:250."""
    x, y = xn[..., 0], xn[..., 1]
    r = np.sqrt(x * x + y * y)
    theta = np.arctan(r)
    t2 = theta * theta
    theta_d = theta * (1 + k1 * t2 + k2 * t2**2 + k3 * t2**3 + k4 * t2**4)
    scale = np.where(r < 1e-9, 1.0, theta_d / np.maximum(r, 1e-12))
    return xn * scale[..., None]


def invert_distortion(distort_fn, xn_d: np.ndarray, iters: int = 25) -> np.ndarray:
    """Numerically invert a forward distortion model on normalized coords by
    fixed-point iteration (a contraction for the mild distortions real
    lenses have)."""
    x = np.array(xn_d, np.float64, copy=True)
    for _ in range(iters):
        x += xn_d - distort_fn(x)
    return x


@dataclasses.dataclass
class Calibration:
    """Full per-sequence calibration: output pinhole model + optional remap
    grid from output (rectified) pixels to input (distorted) pixels, plus the
    photometric response inverse-LUT and vignette (host arrays; the runtime
    moves them to its device once).

    remap:   (H, W, 2) float32 source coords in the raw image, or None.
    gamma:   (256,) float32 inverse response LUT, or None.
    vignette:(H_in, W_in) float32 attenuation map, or None.
    """

    pinhole: PinholeCamera
    remap: np.ndarray | None = None
    gamma: np.ndarray | None = None
    vignette: np.ndarray | None = None

    @classmethod
    def ideal(cls, fx, fy, cx, cy, width, height) -> "Calibration":
        return cls(pinhole=PinholeCamera.make(fx, fy, cx, cy, width, height))


def build_remap(
    out_cam: PinholeCamera,
    in_K: np.ndarray,
    distort_fn,
) -> np.ndarray:
    """Precompute the (H, W, 2) rectification grid: for every output pixel,
    the distorted source pixel to sample (reference: computeUndistortMap,
    InternalCalibration.h:342)."""
    H, W = out_cam.height, out_cam.width
    u, v = np.meshgrid(np.arange(W, dtype=np.float64), np.arange(H, dtype=np.float64))
    xn = np.stack(
        [
            (u - float(out_cam.cx)) / float(out_cam.fx),
            (v - float(out_cam.cy)) / float(out_cam.fy),
        ],
        axis=-1,
    )
    xd = distort_fn(xn)
    src_u = in_K[0, 0] * xd[..., 0] + in_K[0, 2]
    src_v = in_K[1, 1] * xd[..., 1] + in_K[1, 2]
    return np.stack([src_u, src_v], axis=-1).astype(np.float32)
