"""EuRoC MAV dataset loader (ASL format).

Port of libcml_tpu/data/euroc.py (reference: src/cml/capture/EurocCapture.cpp
— mav0/cam0/data images + data.csv timestamps, sensor.yaml intrinsics and
distortion, state_groundtruth_estimate0/data.csv poses). sensor.yaml is read
with the port's YAML reader (runtime/config.parse_yaml). The camera is
radtan- or equidistant-distorted; a remap grid is prebuilt and the
rectification runs on the device (ops.image.remap_image)."""

from __future__ import annotations

import os

import numpy as np

from libcml_tpu_torch.core.camera import (
    Calibration,
    PinholeCamera,
    build_remap,
    equidistant_distort,
    radtan_distort,
)
from libcml_tpu_torch.data.capture import AbstractCapture, CaptureFrame
from libcml_tpu_torch.native.io import read_image_gray
from libcml_tpu_torch.runtime.config import parse_yaml


def looks_like_euroc(path: str) -> bool:
    return os.path.isdir(os.path.join(path, "mav0", "cam0", "data"))


def quat_to_R(w, x, y, z):
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


class EurocCapture(AbstractCapture):
    def __init__(self, path: str):
        self.path = path
        cam_dir = os.path.join(path, "mav0", "cam0")
        self.img_dir = os.path.join(cam_dir, "data")

        rows = []
        with open(os.path.join(cam_dir, "data.csv")) as f:
            for line in f:
                if line.startswith("#") or not line.strip():
                    continue
                ts, name = line.strip().split(",")[:2]
                rows.append((int(ts), name))
        rows.sort()
        self.timestamps = np.array([r[0] for r in rows], np.int64)
        self.files = [r[1] for r in rows]

        # sensor.yaml: intrinsics [fu fv cu cv], distortion model + coeffs
        with open(os.path.join(cam_dir, "sensor.yaml")) as f:
            sensor = parse_yaml(f.read())
        fu, fv, cu, cv = sensor["intrinsics"]
        W, H = sensor["resolution"]
        model = sensor.get("distortion_model", "radial-tangential")
        coeffs = sensor.get("distortion_coefficients", [0, 0, 0, 0])
        in_K = np.array([[fu, 0, cu], [0, fv, cv], [0, 0, 1.0]])

        out_cam = PinholeCamera.make(fu, fv, cu, cv, W, H)
        if model in ("radial-tangential", "radtan"):
            k1, k2, p1, p2 = coeffs[:4]
            dist = lambda xn: radtan_distort(xn, k1, k2, p1, p2)
        else:  # equidistant / kannala-brandt
            k1, k2, k3, k4 = (coeffs + [0, 0, 0, 0])[:4]
            dist = lambda xn: equidistant_distort(xn, k1, k2, k3, k4)
        self.calibration = Calibration(pinhole=out_cam,
                                       remap=build_remap(out_cam, in_K, dist))

        # groundtruth (timestamp-matched)
        self.gt_ts = None
        gt_csv = os.path.join(
            path, "mav0", "state_groundtruth_estimate0", "data.csv"
        )
        if os.path.isfile(gt_csv):
            data = np.loadtxt(gt_csv, delimiter=",", comments="#",
                              usecols=range(8))
            self.gt_ts = data[:, 0].astype(np.int64)
            self.gt_t = data[:, 1:4]
            self.gt_q = data[:, 4:8]  # w x y z

    def __len__(self) -> int:
        return len(self.files)

    def _gt_for(self, ts: int):
        if self.gt_ts is None:
            return None
        i = int(np.searchsorted(self.gt_ts, ts))
        i = min(max(i, 0), len(self.gt_ts) - 1)
        if abs(int(self.gt_ts[i]) - ts) > 25_000_000:  # >25 ms gap
            return None
        M = np.eye(4)
        M[:3, :3] = quat_to_R(*self.gt_q[i])
        M[:3, 3] = self.gt_t[i]
        return M  # body-to-world; adequate for ATE up to the fixed extrinsic

    def _load(self, index: int) -> CaptureFrame:
        raw = read_image_gray(os.path.join(self.img_dir, self.files[index]))
        ts = int(self.timestamps[index])
        return CaptureFrame(
            index=index,
            timestamp=ts * 1e-9,
            image=raw,
            gt_pose_c2w=self._gt_for(ts),
        )
