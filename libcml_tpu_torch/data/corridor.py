"""The synthetic corridor sequence of bench.py, rendered by the port.

The port's own copy of what bench.py takes from benchmarks/ (which imports
the JAX package): the snaking trajectory (benchmarks/export_kitti.py:36),
the long textured corridor (benchmarks/long_synthetic.py:76, seed 11, extent
48 as export_kitti.py:61-67 sets it), the renderer (export_kitti.py:90-138:
float32 ray/plane z-buffer, volumetric texture, 2x2 supersampling, uint8
quantization on the device), and the KITTI-layout writer
(export_kitti.py:161-191): `calib.txt` P0-P3 with the corner-origin +0.5,
`times.txt` at 10 Hz, `poses/<seq>.txt` as camera-to-world 3x4 rows, and
`image_0/%06d.png`, encoded with the standard library's zlib.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from libcml_tpu_torch._device import resolve_device
from libcml_tpu_torch.core.camera import PinholeCamera
from libcml_tpu_torch.data.synthetic import (
    Plane,
    SyntheticScene,
    VolumetricTexture,
    make_texture,
)
from libcml_tpu_torch.native.io import write_png_gray

WIDTH, HEIGHT, FX = 640, 480, 520.0
EXTENT = 48.0          # 500 frames x 0.08 m end ~8 m short of the end wall
SEQ = "04"


def snake_trajectory(n_frames: int, step: float = 0.08,
                     amp_deg: float = 15.0, period: int = 150):
    """Forward motion with sinusoidal yaw (snaking down the corridor); the
    zero-mean yaw keeps the lateral excursion bounded (~1 m against walls at
    +-3 m) for any length. Returns [(R, t)] world-to-camera poses."""
    poses = []
    pos = np.zeros(3)
    for i in range(n_frames):
        yaw = np.radians(amp_deg) * np.sin(2 * np.pi * i / period)
        cy, sy = np.cos(yaw), np.sin(yaw)
        Rc = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])   # c2w
        fwd = Rc @ np.array([0.0, 0.0, 1.0])
        if i > 0:
            pos = pos + step * fwd
        pos_i = pos + np.array(
            [0.02 * np.sin(0.11 * i), 0.01 * np.sin(0.07 * i), 0.0])
        poses.append((Rc.T, -Rc.T @ pos_i))
    return poses


def scene_for(cam: PinholeCamera, extent: float = 40.0) -> SyntheticScene:
    """A long textured corridor: end wall, side walls, floor and ceiling,
    shaded by one volumetric texture."""
    rng = np.random.default_rng(11)
    planes = [
        Plane([0, 0, -1.0], -extent, make_texture(rng), tex_scale=40.0),  # end
        Plane([-1.0, 0, -0.02], -3.0, make_texture(rng), tex_scale=45.0),  # right
        Plane([1.0, 0, -0.02], -3.0, make_texture(rng), tex_scale=45.0),   # left
        Plane([0, -1.0, 0.0], -2.0, make_texture(rng), tex_scale=35.0),    # floor
        Plane([0, 1.0, 0.0], -2.0, make_texture(rng), tex_scale=35.0),     # ceiling
    ]
    return SyntheticScene(planes, cam, tex3d=VolumetricTexture(rng))


def corridor_camera(width: int = WIDTH, height: int = HEIGHT, fx: float = FX) -> PinholeCamera:
    """The corridor's pinhole camera, principal point at the centre in the
    pixel-index convention (export_kitti.py:156-159)."""
    return PinholeCamera.make(fx, fx, width / 2 - 0.5, height / 2 - 0.5, width, height)


def make_renderer(scene: SyntheticScene, cam: PinholeCamera, device: torch.device,
                  supersample: int = 2):
    """render(R, t) -> (H, W) uint8 tensor on `device`: the corridor's frame
    at a world-to-camera pose, in float32 as export_kitti.make_device_renderer
    computes it (rays in float64, then float32 throughout)."""
    s = supersample
    H, W = cam.height * s, cam.width * s
    u = (np.arange(W, dtype=np.float64) + 0.5) / s - 0.5
    v = (np.arange(H, dtype=np.float64) + 0.5) / s - 0.5
    u, v = np.meshgrid(u, v)
    x = (u - float(cam.cx)) / float(cam.fx)
    y = (v - float(cam.cy)) / float(cam.fy)

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32)).to(device)

    rays = f32(np.stack([x, y, np.ones_like(x)], -1))
    n = f32(np.stack([pl.n for pl in scene.planes]))
    d = f32(np.array([pl.d for pl in scene.planes]))
    tex = scene.tex3d
    omega, phase, amp = f32(tex.omega), f32(tex.phase), f32(tex.amp)
    contrast = float(tex.contrast)

    def render(R, t) -> torch.Tensor:
        R, t = f32(R), f32(t)
        dirs_w = torch.einsum("hwj,ji->hwi", rays, R)          # rays @ R
        C_w = -R.T @ t
        denom = torch.einsum("hwi,ki->hwk", dirs_w, n)          # (H, W, K)
        num = d - C_w @ n.T
        lam = num / torch.where(torch.abs(denom) < 1e-12, torch.inf, denom)
        lam = torch.where(lam > 0.05, lam, torch.inf)
        best = torch.amin(lam, dim=-1)                          # (H, W)
        hit = torch.isfinite(best)
        Xw = C_w + dirs_w * torch.where(hit, best, 0.0)[..., None]
        ph = torch.einsum("hwi,ki->hwk", Xw, omega) + phase
        val = torch.cos(ph) @ amp
        img_hi = 127.5 + 110.0 * torch.tanh(contrast * val)
        img_hi = torch.where(hit, img_hi, 127.0)
        img = img_hi.reshape(cam.height, s, cam.width, s).mean(dim=(1, 3))
        return torch.clamp(torch.round(img), 0, 255).to(torch.uint8)

    return render


def write_sequence(out: str, n_frames: int, width: int = WIDTH, height: int = HEIGHT,
                   fx: float = FX, seq: str = SEQ,
                   device: str | torch.device | None = None) -> str:
    """Write the corridor's first `n_frames` frames as a KITTI layout under
    `out` (sequences/<seq>/{image_0, times.txt, calib.txt}, poses/<seq>.txt),
    rendering only the images that are missing, on `device` (the card unless
    the caller names the CPU). Returns the sequence directory."""
    dev = resolve_device(device)
    cam = corridor_camera(width, height, fx)
    poses = snake_trajectory(n_frames)
    seq_dir = os.path.join(out, "sequences", seq)
    img_dir = os.path.join(seq_dir, "image_0")
    poses_dir = os.path.join(out, "poses")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(poses_dir, exist_ok=True)

    with open(os.path.join(seq_dir, "times.txt"), "w") as f:
        for i in range(n_frames):
            f.write(f"{i * 0.1:.6e}\n")
    # KITTI's corner-origin convention: the loader subtracts the 0.5 again
    cx, cy = float(cam.cx), float(cam.cy)
    P = (f"{fx:.12e} 0.000000000000e+00 {cx + 0.5:.12e} 0.000000000000e+00 "
         f"0.000000000000e+00 {fx:.12e} {cy + 0.5:.12e} 0.000000000000e+00 "
         f"0.000000000000e+00 0.000000000000e+00 1.000000000000e+00 "
         f"0.000000000000e+00")
    with open(os.path.join(seq_dir, "calib.txt"), "w") as f:
        for name in ("P0", "P1", "P2", "P3"):
            f.write(f"{name}: {P}\n")
    with open(os.path.join(poses_dir, f"{seq}.txt"), "w") as f:
        for R, t in poses:
            M = np.eye(4)
            M[:3, :3], M[:3, 3] = R, t
            c2w = np.linalg.inv(M)[:3, :4]
            f.write(" ".join(f"{v:.9e}" for v in c2w.reshape(-1)) + "\n")

    todo = [(i, R, t) for i, (R, t) in enumerate(poses)
            if not os.path.exists(os.path.join(img_dir, f"{i:06d}.png"))]
    if todo:
        render = make_renderer(scene_for(cam, extent=EXTENT), cam, dev)
        for i, R, t in todo:
            path = os.path.join(img_dir, f"{i:06d}.png")
            tmp = f"{path}.{os.getpid()}.tmp"
            write_png_gray(tmp, render(R, t).cpu().numpy())
            os.replace(tmp, path)   # a cut run never leaves a partial frame
    return seq_dir
