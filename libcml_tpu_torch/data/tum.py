"""TUM-monoVO sequence loader with photometric calibration.

Port of libcml_tpu/data/tum.py (reference: src/cml/capture/TUMCapture.cpp:
19-131 — images/ frames or images.zip, times.txt with exposures, camera.txt
FOV-model intrinsics, pcalib.txt inverse response, vignette.png). The
calibration carries host arrays; the odometry moves them to its device and
applies the photometric correction and the FOV rectification there
(ops.image.apply_photometric / remap_image)."""

from __future__ import annotations

import os

import numpy as np

from libcml_tpu_torch.core.camera import (
    Calibration,
    PinholeCamera,
    build_remap,
    fov_distort,
)
from libcml_tpu_torch.data.capture import AbstractCapture, CaptureFrame
from libcml_tpu_torch.native.io import decode_gray, read_image_gray


def looks_like_tum(path: str) -> bool:
    return os.path.isfile(os.path.join(path, "times.txt")) and (
        os.path.isdir(os.path.join(path, "images"))
        or os.path.isfile(os.path.join(path, "images.zip"))
    ) and os.path.isfile(os.path.join(path, "camera.txt"))


class TumMonoCapture(AbstractCapture):
    def __init__(self, path: str):
        self.path = path
        self.img_dir = os.path.join(path, "images")
        self._zip = None
        if os.path.isdir(self.img_dir):
            self.files = sorted(
                f for f in os.listdir(self.img_dir)
                if f.endswith((".png", ".jpg"))
            )
        else:
            # zipped sequence: read members directly, no extraction
            # (reference: TUMCapture zip path + ZipCaptureHelper.h)
            import zipfile

            self._zip = zipfile.ZipFile(os.path.join(path, "images.zip"))
            self.files = sorted(
                n for n in self._zip.namelist()
                if n.endswith((".png", ".jpg")) and not n.startswith("__")
            )

        # times.txt: "id timestamp exposure_ms"
        rows = np.loadtxt(os.path.join(path, "times.txt"), dtype=np.float64,
                          usecols=(1, 2), ndmin=2)
        self.times = rows[:, 0]
        self.exposures = rows[:, 1] if rows.shape[1] > 1 else np.ones(len(rows))

        # camera.txt: "fx fy cx cy omega / W H / out-model / out W H" — the
        # DSO convention with normalized intrinsics (TUMCapture.cpp:40+)
        with open(os.path.join(path, "camera.txt")) as f:
            lines = [l.strip() for l in f if l.strip()]
        p = [float(v) for v in lines[0].split()]
        in_w, in_h = (int(v) for v in lines[1].split()[:2])
        fx, fy, cx, cy = p[0] * in_w, p[1] * in_h, p[2] * in_w - 0.5, p[3] * in_h - 0.5
        omega = p[4] if len(p) > 4 else 0.0
        out_w, out_h = in_w, in_h
        if len(lines) >= 4:
            out_w, out_h = (int(v) for v in lines[3].split()[:2])

        # output pinhole: crop-style rectification keeping the focal scale
        out_cam = PinholeCamera.make(
            fx * out_w / in_w, fy * out_h / in_h,
            out_w / 2.0 - 0.5, out_h / 2.0 - 0.5, out_w, out_h,
        )
        in_K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])
        remap = None
        if abs(omega) > 1e-9:
            remap = build_remap(out_cam, in_K, lambda xn: fov_distort(xn, omega))

        # photometric calibration (pcalib + vignette), optional
        gamma = None
        pcalib = os.path.join(path, "pcalib.txt")
        if os.path.isfile(pcalib):
            g = np.loadtxt(pcalib).reshape(-1)
            if len(g) >= 256:
                gamma = g[:256].astype(np.float32)
        vignette = None
        vfile = os.path.join(path, "vignette.png")
        if os.path.isfile(vfile):
            v = read_image_gray(vfile)
            vignette = (v / max(v.max(), 1e-6)).astype(np.float32)

        self.calibration = Calibration(pinhole=out_cam, remap=remap, gamma=gamma,
                                       vignette=vignette)

    def __len__(self) -> int:
        return len(self.files)

    def _load(self, index: int) -> CaptureFrame:
        if self._zip is not None:
            img = decode_gray(self._zip.read(self.files[index]))
        else:
            img = read_image_gray(os.path.join(self.img_dir, self.files[index]))
        return CaptureFrame(
            index=index,
            timestamp=float(self.times[index]) if index < len(self.times) else float(index),
            image=img,
            exposure=float(self.exposures[index]) if index < len(self.exposures) else 1.0,
        )
