"""KITTI odometry sequence loader.

Port of libcml_tpu/data/kitti.py (reference:
src/cml/capture/KittyCapture.cpp:28-118 — image_0 gray frames, times.txt,
calib.txt P0 intrinsics, poses/NN.txt groundtruth). Images are read by the
port's native decoder (libcml_tpu_torch/native). KITTI sequences are
pre-rectified, so the calibration is an ideal pinhole (no remap grid).
"""

from __future__ import annotations

import os

import numpy as np

from libcml_tpu_torch.core.camera import Calibration
from libcml_tpu_torch.data.capture import AbstractCapture, CaptureFrame
from libcml_tpu_torch.native.io import read_image_gray


def looks_like_kitti(path: str) -> bool:
    return os.path.isfile(os.path.join(path, "calib.txt")) and (
        os.path.isdir(os.path.join(path, "image_0"))
        or os.path.isdir(os.path.join(path, "image_2"))
    )


class KittiCapture(AbstractCapture):
    def __init__(self, path: str):
        self.path = path
        img_dir = "image_0" if os.path.isdir(os.path.join(path, "image_0")) else "image_2"
        self.img_dir = os.path.join(path, img_dir)
        self.files = sorted(
            f for f in os.listdir(self.img_dir) if f.endswith((".png", ".pgm", ".jpg"))
        )

        # calib.txt: "P0: fx 0 cx tx 0 fy cy ty 0 0 1 tz" (KittyCapture.cpp:61+)
        with open(os.path.join(path, "calib.txt")) as f:
            line = next(
                l for l in f
                if l.startswith("P0:") or l.startswith("P2:") or l.startswith("P0 ")
            )
        vals = [float(v) for v in line.split(":", 1)[1].split()]
        # KITTI files use the corner-origin pixel convention; internally
        # pixels are addressed by index, so shift the principal point by half
        # a pixel exactly as the reference does (KittyCapture.cpp:98-101)
        fx, cx, fy, cy = vals[0], vals[2] - 0.5, vals[5], vals[6] - 0.5

        first = read_image_gray(os.path.join(self.img_dir, self.files[0]))
        H, W = first.shape
        self.calibration = Calibration.ideal(fx, fy, cx, cy, W, H)
        self._first_img = first

        times_file = os.path.join(path, "times.txt")
        if os.path.isfile(times_file):
            self.times = np.loadtxt(times_file).reshape(-1)
        else:
            self.times = np.arange(len(self.files), dtype=np.float64) * 0.1

        # groundtruth: poses/<seq>.txt next to sequences/, or poses.txt inside
        self.gt = None
        seq = os.path.basename(os.path.normpath(path))
        for cand in (
            os.path.join(path, "poses.txt"),
            os.path.join(path, "..", "..", "poses", f"{seq}.txt"),
        ):
            if os.path.isfile(cand):
                M = np.loadtxt(cand).reshape(-1, 3, 4)
                self.gt = np.tile(np.eye(4), (len(M), 1, 1))
                self.gt[:, :3, :4] = M  # KITTI poses are cam-to-world
                break

    def __len__(self) -> int:
        return len(self.files)

    def _load(self, index: int) -> CaptureFrame:
        if index == 0 and self._first_img is not None:
            img = self._first_img
        else:
            img = read_image_gray(os.path.join(self.img_dir, self.files[index]))
        gt = self.gt[index] if self.gt is not None and index < len(self.gt) else None
        return CaptureFrame(
            index=index,
            timestamp=float(self.times[index]) if index < len(self.times) else index * 0.1,
            image=img,
            gt_pose_c2w=gt,
        )
