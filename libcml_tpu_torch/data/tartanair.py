"""TartanAir dataset loader.

Port of libcml_tpu/data/tartanair.py (reference:
src/cml/capture/TartanairCapture.cpp — image_left/ frames, pose_left.txt NED
xyz+quat groundtruth, fixed pinhole intrinsics fx=fy=320, cx=320, cy=240 at
640x480)."""

from __future__ import annotations

import os

import numpy as np

from libcml_tpu_torch.core.camera import Calibration
from libcml_tpu_torch.data.capture import AbstractCapture, CaptureFrame
from libcml_tpu_torch.data.euroc import quat_to_R
from libcml_tpu_torch.native.io import read_image_gray

# NED (TartanAir world) -> EDN (camera-style) axis shuffle
_NED2CAM = np.array([[0, 1, 0], [0, 0, 1], [1, 0, 0]], np.float64)


def looks_like_tartanair(path: str) -> bool:
    return os.path.isdir(os.path.join(path, "image_left")) and os.path.isfile(
        os.path.join(path, "pose_left.txt")
    )


class TartanAirCapture(AbstractCapture):
    def __init__(self, path: str):
        self.path = path
        self.img_dir = os.path.join(path, "image_left")
        self.files = sorted(
            f for f in os.listdir(self.img_dir) if f.endswith((".png", ".jpg"))
        )
        first = read_image_gray(os.path.join(self.img_dir, self.files[0]))
        H, W = first.shape
        # TartanAir publishes fixed intrinsics for 640x480; scale if resized
        sx, sy = W / 640.0, H / 480.0
        self.calibration = Calibration.ideal(
            320.0 * sx, 320.0 * sy, 320.0 * sx, 240.0 * sy, W, H
        )
        self._first = first

        # pose_left.txt: x y z qx qy qz qw (NED), camera-to-world
        poses = np.loadtxt(os.path.join(path, "pose_left.txt")).reshape(-1, 7)
        self.gt = np.tile(np.eye(4), (len(poses), 1, 1))
        for i, p in enumerate(poses):
            x, y, z, qx, qy, qz, qw = p
            R_ned = quat_to_R(qw, qx, qy, qz)
            self.gt[i, :3, :3] = _NED2CAM @ R_ned @ _NED2CAM.T
            self.gt[i, :3, 3] = _NED2CAM @ np.array([x, y, z])

    def __len__(self) -> int:
        return len(self.files)

    def _load(self, index: int) -> CaptureFrame:
        img = (
            self._first if index == 0
            else read_image_gray(os.path.join(self.img_dir, self.files[index]))
        )
        gt = self.gt[index] if index < len(self.gt) else None
        return CaptureFrame(
            index=index, timestamp=index / 10.0, image=img, gt_pose_c2w=gt
        )
