"""ETH3D SLAM-benchmark sequence loader.

Port of libcml_tpu/data/eth3d.py (reference: src/cml/capture/Eth3DCapture.cpp
— rgb/ frames listed in rgb.txt, calibration.txt "fx fy cx cy",
groundtruth.txt TUM-format poses)."""

from __future__ import annotations

import os

import numpy as np

from libcml_tpu_torch.core.camera import Calibration
from libcml_tpu_torch.data.capture import AbstractCapture, CaptureFrame
from libcml_tpu_torch.data.euroc import quat_to_R
from libcml_tpu_torch.native.io import read_image_gray


def looks_like_eth3d(path: str) -> bool:
    return os.path.isfile(os.path.join(path, "rgb.txt")) and os.path.isfile(
        os.path.join(path, "calibration.txt")
    )


class Eth3DCapture(AbstractCapture):
    def __init__(self, path: str):
        self.path = path
        rows = []
        with open(os.path.join(path, "rgb.txt")) as f:
            for line in f:
                if line.startswith("#") or not line.strip():
                    continue
                ts, rel = line.split()[:2]
                rows.append((float(ts), rel))
        self.rows = rows

        fx, fy, cx, cy = np.loadtxt(os.path.join(path, "calibration.txt"))[:4]
        first = read_image_gray(os.path.join(path, rows[0][1]))
        H, W = first.shape
        self.calibration = Calibration.ideal(fx, fy, cx, cy, W, H)
        self._first = first

        self.gt_ts, self.gt = None, None
        gt_file = os.path.join(path, "groundtruth.txt")
        if os.path.isfile(gt_file):
            data = np.loadtxt(gt_file, comments="#").reshape(-1, 8)
            self.gt_ts = data[:, 0]
            self.gt = np.tile(np.eye(4), (len(data), 1, 1))
            for i, row in enumerate(data):
                _, tx, ty, tz, qx, qy, qz, qw = row
                self.gt[i, :3, :3] = quat_to_R(qw, qx, qy, qz)
                self.gt[i, :3, 3] = (tx, ty, tz)

    def __len__(self) -> int:
        return len(self.rows)

    def _load(self, index: int) -> CaptureFrame:
        ts, rel = self.rows[index]
        img = (
            self._first if index == 0
            else read_image_gray(os.path.join(self.path, rel))
        )
        gt = None
        if self.gt_ts is not None:
            i = int(np.searchsorted(self.gt_ts, ts))
            i = min(max(i, 0), len(self.gt_ts) - 1)
            if abs(self.gt_ts[i] - ts) < 0.05:
                gt = self.gt[i]
        return CaptureFrame(index=index, timestamp=ts, image=img, gt_pose_c2w=gt)
