"""Synthetic piecewise-planar scene renderer for pipeline tests and benches.

The reference has no test fixtures at all (SURVEY.md §4); this module is the
"tiny synthetic scene" golden-data generator the rebuilt test pyramid is based
on. A scene is a set of textured infinite planes in world space; rendering a
view is an exact per-pixel ray/plane intersection with a z-buffer over planes,
which yields photometrically consistent images from any pose PLUS ground-truth
inverse-depth maps — everything the direct pipeline (initializer, tracker,
tracer, photometric BA) needs for closed-loop accuracy tests.

Conventions: poses are world-to-camera SE3 (X_cam = R X_w + t), matching the
SLAM state. Textures are band-limited random fields so image gradients are
informative and bilinear interpolation is well-behaved.
"""

from __future__ import annotations

import numpy as np
import torch

from libcml_tpu_torch.core.camera import PinholeCamera


def make_texture(rng: np.random.Generator, size: int = 256, cutoff: float = 0.08) -> np.ndarray:
    """Band-limited PERIODIC random texture in [20, 235], (size, size) float32.

    Synthesized in the Fourier domain (1/f amplitude, hard low-pass at
    `cutoff` cycles/texture-pixel) so the texture is (a) smooth — features
    span >= 1/cutoff texture pixels, keeping rendered images well below the
    pixel Nyquist rate so bilinear resampling of two views of the same
    surface stays photometrically consistent — and (b) exactly periodic, so
    wrap-around texture addressing has NO seam. A seam is a step edge the
    pixel selector loves (maximal gradient) and bilinear interpolation
    reconstructs worst; with seams, ground-truth poses are not stationary
    points of the photometric energy and every Gauss-Newton consumer
    (tracker, initializer, photometric BA) converges to a biased optimum on
    data no real (lens-blurred) camera would ever produce."""
    spec = rng.standard_normal((size, size)) + 1j * rng.standard_normal((size, size))
    fy = np.fft.fftfreq(size)[:, None]
    fx = np.fft.fftfreq(size)[None, :]
    f = np.sqrt(fx * fx + fy * fy)
    amp = np.where(f < 1e-9, 0.0, 1.0 / np.maximum(f, 1.0 / size)) * (f < cutoff)
    tex = np.real(np.fft.ifft2(spec * amp))
    tex = (tex - tex.min()) / (tex.max() - tex.min() + 1e-12)
    return (20.0 + 215.0 * tex).astype(np.float32)


class Plane:
    """Textured infinite plane n·X = d (world frame), with an in-plane texture
    chart given by origin p0 and orthonormal basis (e1, e2)."""

    def __init__(self, n, d, texture, tex_scale=50.0):
        self.n = np.asarray(n, dtype=np.float64)
        self.n /= np.linalg.norm(self.n)
        self.d = float(d)
        self.texture = texture
        self.tex_scale = tex_scale  # texture pixels per world unit
        # build chart basis
        a = np.array([1.0, 0, 0]) if abs(self.n[0]) < 0.9 else np.array([0, 1.0, 0])
        self.e1 = np.cross(self.n, a)
        self.e1 /= np.linalg.norm(self.e1)
        self.e2 = np.cross(self.n, self.e1)
        self.p0 = self.n * self.d  # closest point to origin

    def sample(self, Xw: np.ndarray) -> np.ndarray:
        """Texture value at world points (..., 3). The texture is exactly
        periodic (make_texture), so wrap-around addressing is seamless:
        neighbours wrap with period W/H."""
        rel = Xw - self.p0
        u = (rel @ self.e1) * self.tex_scale
        v = (rel @ self.e2) * self.tex_scale
        T = self.texture
        H, W = T.shape
        u = np.mod(u, W)
        v = np.mod(v, H)
        x0 = np.floor(u).astype(int) % W
        y0 = np.floor(v).astype(int) % H
        x1 = (x0 + 1) % W
        y1 = (y0 + 1) % H
        fx = u - np.floor(u)
        fy = v - np.floor(v)
        return (
            T[y0, x0] * (1 - fy) * (1 - fx)
            + T[y0, x1] * (1 - fy) * fx
            + T[y1, x0] * fy * (1 - fx)
            + T[y1, x1] * fy * fx
        ).astype(np.float32)


class VolumetricTexture:
    """Smooth world-space intensity field: a sum of random 3D cosines.

    Using ONE C-infinity function of world position for ALL surfaces removes
    intensity edges at plane crease boundaries entirely: per-plane texture
    charts jump across plane intersections, those step edges are exactly
    where the pixel selector samples (maximal gradient) and where bilinear
    interpolation reconstructs worst, so with chart textures the ground-truth
    pose is not a stationary point of the photometric energy and direct-
    method convergence tests chase a biased optimum. A volumetric field is
    photometrically consistent from every view by construction."""

    def __init__(self, rng: np.random.Generator, n_waves: int = 48,
                 period_range: tuple[float, float] = (0.2, 1.0),
                 contrast: float = 14.0):
        dirs = rng.standard_normal((n_waves, 3))
        dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
        periods = np.exp(rng.uniform(np.log(period_range[0]),
                                     np.log(period_range[1]), n_waves))
        self.omega = dirs * (2.0 * np.pi / periods)[:, None]   # (K, 3)
        self.phase = rng.uniform(0, 2 * np.pi, n_waves)
        # ~1/f amplitude so coarse structure dominates but fine detail exists
        self.amp = periods / periods.sum()
        self.contrast = contrast

    def sample(self, Xw: np.ndarray) -> np.ndarray:
        """Intensity at world points (..., 3), in (17.5, 237.5).

        tanh squash instead of hard clipping: keeps the field C-infinity
        (a hard clip creates flat plateaus with zero gradient and kinks that
        alias) while boosting contrast enough that image gradients match
        real textured footage (tens of intensity levels per pixel)."""
        ph = Xw @ self.omega.T + self.phase            # (..., K)
        val = np.cos(ph) @ self.amp                    # (...,) std ~0.07-0.1
        return (127.5 + 110.0 * np.tanh(self.contrast * val)).astype(np.float32)


class SyntheticScene:
    """A set of planes + a camera; renders (image, idepth) from w2c poses.

    If `tex3d` is given, intensity comes from the volumetric field (smooth
    everywhere, no edges at plane boundaries); otherwise from each plane's
    own texture chart."""

    def __init__(self, planes: list[Plane], cam: PinholeCamera,
                 tex3d: VolumetricTexture | None = None,
                 undistort_xn=None):
        self.planes = planes
        self.cam = cam
        self.tex3d = tex3d
        # optional lens model: maps recorded (distorted) normalized coords to
        # true viewing directions, turning this into a distorting camera —
        # used to synthesize raw footage for rectification tests
        self.undistort_xn = undistort_xn

    @classmethod
    def default(cls, cam: PinholeCamera, seed: int = 0) -> "SyntheticScene":
        """A frontal wall at z=6 plus two slanted side walls and a floor —
        enough depth diversity for initializer/BA observability — shaded by
        one smooth volumetric texture (no intensity edges at the creases)."""
        rng = np.random.default_rng(seed)
        planes = [
            Plane([0, 0, -1.0], -6.0, make_texture(rng), tex_scale=40.0),
            Plane([-0.45, 0, -1.0], -4.0, make_texture(rng), tex_scale=45.0),
            Plane([0.45, 0, -1.0], -4.0, make_texture(rng), tex_scale=45.0),
            Plane([0, -1.0, -0.15], -2.5, make_texture(rng), tex_scale=35.0),
        ]
        return cls(planes, cam, tex3d=VolumetricTexture(rng))

    def render(self, R_w2c: np.ndarray, t_w2c: np.ndarray, supersample: int = 2):
        """Render the scene from a world-to-camera pose.

        Returns (image (H, W) float32 in ~[0,255], idepth (H, W) float32).
        Pixels hitting no plane get idepth 0 and a mid-gray value.

        `supersample` renders on an s x s sub-pixel grid and box-filters,
        modelling sensor integration: without it, point-sampled renders of
        the same surface from two poses disagree under bilinear interpolation
        (aliasing), breaking the photometric-consistency assumption every
        direct-method test relies on. Inverse depth stays point-sampled at
        the pixel center (depth of the surface, not an average)."""
        if supersample > 1:
            img_hi, _ = self._render_grid(R_w2c, t_w2c, supersample)
            s = supersample
            H, W = self.cam.height, self.cam.width
            img = img_hi.reshape(H, s, W, s).mean(axis=(1, 3)).astype(np.float32)
            _, idepth = self._render_grid(R_w2c, t_w2c, 1)
            return img, idepth
        return self._render_grid(R_w2c, t_w2c, 1)

    def _render_grid(self, R_w2c: np.ndarray, t_w2c: np.ndarray, s: int):
        """Point-sampled render on an (H*s, W*s) grid; sub-pixel centers are
        placed so that the s x s box filter is centred on each pixel."""
        cam = self.cam
        H, W = cam.height * s, cam.width * s
        u = (np.arange(W, dtype=np.float64) + 0.5) / s - 0.5
        v = (np.arange(H, dtype=np.float64) + 0.5) / s - 0.5
        u, v = np.meshgrid(u, v)
        # unit-z ray directions in camera frame
        x = (u - float(cam.cx)) / float(cam.fx)
        y = (v - float(cam.cy)) / float(cam.fy)
        if self.undistort_xn is not None:
            # distorting lens: the recorded pixel's TRUE viewing direction is
            # the undistorted normalized coordinate
            xn = self.undistort_xn(np.stack([x, y], axis=-1))
            x, y = xn[..., 0], xn[..., 1]
        rays = np.stack([x, y, np.ones_like(x)], axis=-1)  # (H, W, 3)
        R = np.asarray(R_w2c, dtype=np.float64)
        t = np.asarray(t_w2c, dtype=np.float64)
        # world-frame ray dirs and camera center
        dirs_w = rays @ R  # R^T applied to each ray
        C_w = -R.T @ t
        best_z = np.full((H, W), np.inf)
        img = np.full((H, W), 127.0, dtype=np.float32)
        for pl in self.planes:
            denom = dirs_w @ pl.n
            num = pl.d - C_w @ pl.n
            with np.errstate(divide="ignore", invalid="ignore"):
                lam = num / denom  # camera z-depth (rays have unit z in cam frame)
            valid = (denom != 0) & (lam > 0.05) & (lam < best_z)
            if not np.any(valid):
                continue
            Xw = C_w + dirs_w * lam[..., None]
            if self.tex3d is not None:
                vals = self.tex3d.sample(Xw[valid])
            else:
                vals = pl.sample(Xw[valid])
            img[valid] = vals
            best_z[valid] = lam[valid]
        idepth = np.where(np.isfinite(best_z), 1.0 / np.maximum(best_z, 1e-6), 0.0)
        return img, idepth.astype(np.float32)


    def render_device(self, R_w2c: np.ndarray, t_w2c: np.ndarray,
                      device: str | torch.device, supersample: int = 2):
        """`render` evaluated on `device` in float64 (same rays, z-buffer,
        volumetric shading and box filter; the numpy renderer takes seconds
        per VGA frame, this a few milliseconds on a GPU). Volumetric-texture
        scenes without a lens model only. Returns (image, idepth) as (H, W)
        float32 tensors on `device`."""
        if self.tex3d is None or self.undistort_xn is not None:
            raise ValueError("render_device supports volumetric, undistorted scenes")
        img_hi, _ = self._render_grid_device(R_w2c, t_w2c, supersample, device)
        H, W = self.cam.height, self.cam.width
        s = supersample
        img = img_hi.reshape(H, s, W, s).mean(dim=(1, 3))
        _, idepth = self._render_grid_device(R_w2c, t_w2c, 1, device)
        return img.float(), idepth.float()

    def _render_grid_device(self, R_w2c, t_w2c, s: int, device):
        cam = self.cam
        f64 = dict(dtype=torch.float64, device=device)
        H, W = cam.height * s, cam.width * s
        u = (torch.arange(W, **f64) + 0.5) / s - 0.5
        v = (torch.arange(H, **f64) + 0.5) / s - 0.5
        v, u = torch.meshgrid(v, u, indexing="ij")
        x = (u - float(cam.cx)) / float(cam.fx)
        y = (v - float(cam.cy)) / float(cam.fy)
        rays = torch.stack([x, y, torch.ones_like(x)], dim=-1)
        R = torch.as_tensor(np.asarray(R_w2c, np.float64)).to(device)
        t = torch.as_tensor(np.asarray(t_w2c, np.float64)).to(device)
        dirs_w = rays @ R
        C_w = -R.T @ t
        best_z = torch.full((H, W), float("inf"), **f64)
        img = torch.full((H, W), 127.0, **f64)
        omega = torch.as_tensor(self.tex3d.omega).to(device)
        phase = torch.as_tensor(self.tex3d.phase).to(device)
        amp = torch.as_tensor(self.tex3d.amp).to(device)
        for pl in self.planes:
            n = torch.as_tensor(pl.n).to(device)
            denom = dirs_w @ n
            lam = (pl.d - C_w @ n) / denom
            valid = (denom != 0) & (lam > 0.05) & (lam < best_z)
            Xw = C_w + dirs_w * torch.where(valid, lam, torch.zeros_like(lam))[..., None]
            val = torch.cos(Xw @ omega.T + phase) @ amp
            shade = 127.5 + 110.0 * torch.tanh(self.tex3d.contrast * val)
            img = torch.where(valid, shade.float().double(), img)
            best_z = torch.where(valid, lam, best_z)
        idepth = torch.where(torch.isfinite(best_z), 1.0 / torch.clamp(best_z, min=1e-6),
                             torch.zeros_like(best_z))
        return img, idepth


def forward_trajectory(n_frames: int, step: float = 0.12, yaw_rate: float = 0.004):
    """KITTI-like forward motion with a slow yaw. Returns list of (R, t) w2c.

    Camera moves along +z in world; w2c pose for camera at world position p
    with rotation Rc (c2w) is R = Rc^T, t = -Rc^T p."""
    poses = []
    for i in range(n_frames):
        yaw = yaw_rate * i
        cy, sy = np.cos(yaw), np.sin(yaw)
        Rc = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])  # c2w
        p = np.array([0.25 * np.sin(0.05 * i), 0.02 * np.sin(0.08 * i), step * i])
        R = Rc.T
        t = -Rc.T @ p
        poses.append((R, t))
    return poses
