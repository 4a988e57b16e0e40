"""Inverse-depth priors for the direct initializer.

PyTorch port of libcml_tpu/models/direct/prior.py (reference: the NN prior
hooks src/cml/nn/Precomputed.h:8-21, which loads
`<image>.idepth.midas_large.png` renders next to the dataset images and seeds
DSOInitializer through Hybrid.cpp:469-473; src/cml/nn/Midas.cpp, the
in-process variant).

A prior is a callable `(image, frame_index, path) -> (H, W) float32 inverse
depth or None`; DirectOdometry passes what it returns to
set_first(prior_idepth=...). DirectOdometry calls it with `path=None`, as the
JAX package does (runtime/odometry.py:842 there), so a prior that needs the
image's path (PrecomputedDepthPrior) returns None inside a run; call it
directly with a path to read a render.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from libcml_tpu_torch._device import resolve_device
from libcml_tpu_torch.native.io import read_image_gray


class PrecomputedDepthPrior:
    """Pre-rendered inverse-depth maps stored next to the dataset images:
    `<image>.idepth.npy`, or `<image>.idepth.<model>.png` (uint16, times
    `scale`), decoded by the port's own PNG decoder (native/io.py)."""

    def __init__(self, model: str = "midas_large", scale: float = 1.0 / 6553.5):
        self.model = model
        self.scale = scale   # uint16 -> inverse depth units

    def __call__(self, image, frame_index: int, path: str | None = None):
        if not path:
            return None
        base = os.path.splitext(path)[0]
        npy = base + ".idepth.npy"
        if os.path.isfile(npy):
            return np.load(npy).astype(np.float32)
        png = f"{base}.idepth.{self.model}.png"
        if os.path.isfile(png):
            # the decoder maps 16-bit samples onto [0, 255] (x 255/65535, and
            # 65535 = 255 x 257): x 257 and rounding gives the stored integers
            raw = np.rint(read_image_gray(png).astype(np.float64) * 257.0)
            return raw.astype(np.float32) * self.scale
        return None


class TorchDepthPrior:
    """An in-process monocular depth module (the reference's Midas.cpp
    analogue): wraps any torch model mapping a (1, 1, H, W) image in [0, 1]
    to a relative inverse-depth map, run on `device` (the card unless the
    caller names the CPU), and rescales its output to [0.1, 2]."""

    def __init__(self, model: torch.nn.Module, device: str | torch.device | None = None):
        self.device = resolve_device(device)
        self.model = model.eval().to(self.device)

    def __call__(self, image, frame_index: int, path: str | None = None):
        with torch.no_grad():
            x = torch.as_tensor(np.asarray(image, np.float32) / 255.0)[None, None]
            out = self.model(x.to(self.device))
        d = np.asarray(out.squeeze().cpu().numpy(), np.float32)
        # relative depth models are scale-free (the initializer renormalizes
        # the scale anyway): map the 5th..95th percentiles onto a usable range
        lo, hi = np.percentile(d, [5, 95])
        return np.clip((d - lo) / max(hi - lo, 1e-6), 0.05, 1.0) * 2.0
