"""Self-calibration: photometric response and lens distortion estimated
from tracked correspondences.

PyTorch port of libcml_tpu/models/calib.py (reference: the Calib SLAM
variant, src/cml/slam/calib/Calib.{h,cpp}: Calib.h:5,28-56 optimizes a
per-pixel distortion map and a gamma LUT from tracked points).

The lens is a low-order radial-tangential model (k1, k2, p1, p2) fit by
batched Gauss-Newton, every residual a point reprojection; the response is
g(x) = x + sum_k c_k b_k(x) with smooth polynomial basis functions, fit from
intensity pairs of the same scene point under a known exposure ratio
(I2 = g^-1(e g(I1))). float32 throughout, as the JAX package computes it.
"""

from __future__ import annotations

import numpy as np
import torch

from libcml_tpu_torch.core.camera import PinholeCamera, build_remap


# ---------------------------------------------------------------------------
# Photometric response (gamma LUT)
# ---------------------------------------------------------------------------


def _response_basis(x: torch.Tensor, n_basis: int = 4) -> torch.Tensor:
    """Smooth perturbation basis on [0, 1] vanishing at both ends:
    b_k(x) = x^(k+1) (1 - x). Returns (..., n_basis)."""
    return torch.stack([x ** (k + 1) * (1.0 - x) for k in range(n_basis)], dim=-1)


def apply_response(coeffs: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """g(x): normalized intensity -> normalized irradiance, x in [0, 1]."""
    return x + _response_basis(x, coeffs.shape[0]) @ coeffs


def calibrate_response(i1: torch.Tensor, i2: torch.Tensor, exposure_ratio: torch.Tensor,
                       valid: torch.Tensor, n_basis: int = 4, iters: int = 20) -> torch.Tensor:
    """Fit response coefficients from intensity pairs (i1, i2) in [0, 255] of
    the same points under exposure ratio e = t2 / t1, minimizing
    r = g(i2/255) - e g(i1/255) with Huber weights (20 Gauss-Newton steps).
    Returns (n_basis,) coefficients; response_lut() makes the LUT."""
    x1 = i1.float() / 255.0
    x2 = i2.float() / 255.0
    e = exposure_ratio.float()
    w0 = valid.float()
    B1 = _response_basis(x1, n_basis)             # (N, K)
    B2 = _response_basis(x2, n_basis)
    J = B2 - e[:, None] * B1                      # (N, K)
    eye = torch.eye(n_basis, dtype=torch.float32, device=x1.device)
    c = torch.zeros((n_basis,), dtype=torch.float32, device=x1.device)
    for _ in range(iters):
        r = (x2 + B2 @ c) - e * (x1 + B1 @ c)
        hub = torch.where(torch.abs(r) > 0.02, 0.02 / torch.clamp(torch.abs(r), min=1e-9),
                          torch.ones_like(r))
        w = w0 * hub
        H = J.T @ (w[:, None] * J) + 1e-6 * eye
        b = J.T @ (w * r)
        c = c - torch.linalg.solve_ex(H, b)[0]
    return c


def response_lut(coeffs: torch.Tensor) -> np.ndarray:
    """(256,) float32 inverse-response LUT in irradiance units (scaled back
    to ~[0, 255]): a drop-in for Calibration.gamma."""
    x = torch.linspace(0.0, 1.0, 256, dtype=torch.float32, device=coeffs.device)
    return (apply_response(coeffs, x) * 255.0).cpu().numpy().astype(np.float32)


# ---------------------------------------------------------------------------
# Lens distortion
# ---------------------------------------------------------------------------


def _distort_jacobian(xn: torch.Tensor, cam: PinholeCamera) -> torch.Tensor:
    """d(u, v)/d(k1, k2, p1, p2) of the radtan projection, (2N, 4) with rows
    [u0, v0, u1, v1, ...]. The model is linear in its parameters, so the
    Jacobian does not depend on them."""
    x, y = xn[:, 0], xn[:, 1]
    r2 = x * x + y * y
    fx, fy = float(cam.fx), float(cam.fy)
    du = torch.stack([fx * (x * r2), fx * (x * (r2 * r2)), fx * (2 * x * y),
                      fx * (r2 + 2 * x * x)], dim=-1)
    dv = torch.stack([fy * (y * r2), fy * (y * (r2 * r2)), fy * (r2 + 2 * y * y),
                      fy * (2 * x * y)], dim=-1)
    return torch.stack([du, dv], dim=1).reshape(-1, 4)


def _radtan_project(params: torch.Tensor, xn: torch.Tensor, cam: PinholeCamera) -> torch.Tensor:
    k1, k2, p1, p2 = params[0], params[1], params[2], params[3]
    x, y = xn[:, 0], xn[:, 1]
    r2 = x * x + y * y
    rad = 1.0 + k1 * r2 + k2 * r2 * r2
    xd = x * rad + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    yd = y * rad + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
    return torch.stack([float(cam.fx) * xd + float(cam.cx),
                        float(cam.fy) * yd + float(cam.cy)], dim=-1)


def calibrate_distortion(Xc: torch.Tensor, uv_obs: torch.Tensor, valid: torch.Tensor,
                         cam: PinholeCamera, iters: int = 15,
                         radial_only: bool = False) -> torch.Tensor:
    """Fit radial-tangential distortion [k1, k2, p1, p2] mapping the ideal
    projection of camera-frame points Xc (N, 3) onto their OBSERVED raw
    pixels uv_obs (N, 2): batched Gauss-Newton with a Huber weight on the
    pixel residual norm. `radial_only` pins p1, p2 (weakly observable from
    SLAM geometry) with a stiff prior."""
    dev = Xc.device
    xn = Xc[:, :2] / torch.clamp(Xc[:, 2:3], min=1e-6)
    # clip invalid rows into a sane range: their weight is zero, but inf/nan
    # Jacobian entries (r^6 growth) would still poison H via inf * 0 = nan
    xn = torch.clamp(torch.nan_to_num(xn, nan=0.0, posinf=0.0, neginf=0.0), -3.0, 3.0)
    w0 = valid.float() * (Xc[:, 2] > 1e-4).float()
    J = _distort_jacobian(xn, cam)                                 # (2N, 4)
    eye = torch.eye(4, dtype=torch.float32, device=dev)
    pin = torch.tensor([0.0, 0.0, 1e12, 1e12], dtype=torch.float32, device=dev)
    p = torch.zeros((4,), dtype=torch.float32, device=dev)
    for _ in range(iters):
        res = _radtan_project(p, xn, cam) - uv_obs                 # (N, 2)
        rn = torch.linalg.norm(res, dim=-1)
        hub = torch.where(rn > 3.0, 3.0 / torch.clamp(rn, min=1e-9), torch.ones_like(rn))
        r = res.reshape(-1)
        w = torch.repeat_interleave(w0 * hub, 2)
        H = J.T @ (w[:, None] * J) + 1e-8 * eye
        b = J.T @ (w * r)
        if radial_only:
            H = H + torch.diag(pin)
        p = p - torch.linalg.solve_ex(H, b)[0]
    return p


def distortion_map(params, cam: PinholeCamera) -> np.ndarray:
    """The fitted model as the reference's per-pixel map (Calib.h:28-55
    persists this): (H, W, 2) raw source pixel for every ideal pixel, a
    drop-in for Calibration.remap."""
    k1, k2, p1, p2 = [float(v) for v in np.asarray(params)]

    def distort(xn):
        x, y = xn[..., 0], xn[..., 1]
        r2 = x * x + y * y
        rad = 1.0 + k1 * r2 + k2 * r2 * r2
        xd = x * rad + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
        yd = y * rad + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
        return np.stack([xd, yd], -1)

    K = np.array([[float(cam.fx), 0, float(cam.cx)],
                  [0, float(cam.fy), float(cam.cy)], [0, 0, 1]])
    return build_remap(cam, K, distort)
