"""RobotCar, Stereopolis-zip and video captures.

Port of libcml_tpu/data/misc.py (reference: src/cml/capture/
RobotCarCapture.cpp — mono image stream + timestamp file;
ZipStereopolisCapture.h + ZipCaptureHelper.h — zip archive of frames, XML
calibration, mask png; VideoCapture.cpp — FFmpeg decode, build-gated the
same way this one is gated on imageio)."""

from __future__ import annotations

import os
import re
import zipfile

import numpy as np

from libcml_tpu_torch.core.camera import Calibration
from libcml_tpu_torch.data.capture import AbstractCapture, CaptureFrame
from libcml_tpu_torch.native.io import decode_gray, read_image_gray

# ---------------------------------------------------------------------------
# RobotCar
# ---------------------------------------------------------------------------


def looks_like_robotcar(path: str) -> bool:
    return os.path.isdir(os.path.join(path, "mono_left")) or (
        os.path.isfile(os.path.join(path, "mono_left.timestamps"))
    )


class RobotCarCapture(AbstractCapture):
    """Oxford RobotCar mono stream: mono_left/ images named <ts>.png plus a
    mono_left.timestamps file; intrinsics from the published defaults."""

    def __init__(self, path: str, camera: str = "mono_left"):
        self.img_dir = os.path.join(path, camera)
        ts_file = os.path.join(path, f"{camera}.timestamps")
        if os.path.isfile(ts_file):
            rows = np.loadtxt(ts_file, dtype=np.int64).reshape(-1, 2)
            self.timestamps = rows[:, 0]
            self.files = [f"{t}.png" for t in self.timestamps]
        else:
            self.files = sorted(
                f for f in os.listdir(self.img_dir) if f.endswith(".png")
            )
            self.timestamps = np.array(
                [int(os.path.splitext(f)[0]) for f in self.files], np.int64
            )
        first = read_image_gray(os.path.join(self.img_dir, self.files[0]))
        H, W = first.shape
        # published RobotCar mono intrinsics (Grasshopper2, approximately)
        self.calibration = Calibration.ideal(
            400.0 * W / 1024.0, 400.0 * H / 1024.0, W / 2 - 0.5, H / 2 - 0.5,
            W, H,
        )
        self._first = first

    def __len__(self) -> int:
        return len(self.files)

    def _load(self, index: int) -> CaptureFrame:
        img = (
            self._first if index == 0
            else read_image_gray(os.path.join(self.img_dir, self.files[index]))
        )
        return CaptureFrame(
            index=index,
            timestamp=int(self.timestamps[index]) * 1e-6,
            image=img,
        )


# ---------------------------------------------------------------------------
# Stereopolis (zip archive + XML calibration + optional mask)
# ---------------------------------------------------------------------------


def looks_like_stereopolis(path: str) -> bool:
    return path.endswith(".zip") and zipfile.is_zipfile(path)


class ZipStereopolisCapture(AbstractCapture):
    """Frames inside a zip; calibration from an XML entry with
    <focal>/<ppx>/<ppy> (or defaults); an optional mask.png entry zeroes
    ignored regions (reference: ZipStereopolisCapture.h)."""

    def __init__(self, path: str):
        self.zf = zipfile.ZipFile(path)
        names = self.zf.namelist()
        self.frames_names = sorted(
            n for n in names
            if n.lower().endswith((".png", ".jpg", ".tif", ".tiff"))
            and "mask" not in n.lower()
        )
        if not self.frames_names:
            raise ValueError("no images in archive")

        first = self._decode(self.frames_names[0])
        H, W = first.shape
        fx = fy = 0.5 * (W + H)
        cx, cy = W / 2 - 0.5, H / 2 - 0.5
        xmls = [n for n in names if n.lower().endswith(".xml")]
        if xmls:
            text = self.zf.read(xmls[0]).decode("utf-8", "ignore")

            def grab(tag, default):
                m = re.search(rf"<{tag}>\s*([-0-9.eE]+)\s*</{tag}>", text)
                return float(m.group(1)) if m else default
            fx = fy = grab("focal", fx)
            cx = grab("ppx", cx)
            cy = grab("ppy", cy)
        self.calibration = Calibration.ideal(fx, fy, cx, cy, W, H)

        self.mask = None
        masks = [n for n in names if "mask" in n.lower()
                 and n.lower().endswith(".png")]
        if masks:
            self.mask = self._decode(masks[0]) > 127
        self._first = first

    def _decode(self, name: str) -> np.ndarray:
        return decode_gray(self.zf.read(name))

    def __len__(self) -> int:
        return len(self.frames_names)

    def _load(self, index: int) -> CaptureFrame:
        img = self._first if index == 0 else self._decode(self.frames_names[index])
        if self.mask is not None:
            img = np.where(self.mask, img, 0.0)
        return CaptureFrame(index=index, timestamp=index / 10.0, image=img)


# ---------------------------------------------------------------------------
# Video (gated on imageio availability, like the reference's FFmpeg gate)
# ---------------------------------------------------------------------------


def looks_like_video(path: str) -> bool:
    return os.path.isfile(path) and path.lower().endswith(
        (".mp4", ".avi", ".mov", ".mkv", ".webm")
    )


class VideoCapture(AbstractCapture):
    def __init__(self, path: str, fov_deg: float = 60.0):
        try:
            import imageio.v3 as iio
        except ImportError as e:
            raise NotImplementedError(
                "video capture needs imageio (the reference gates its "
                "VideoCapture on FFmpeg the same way)"
            ) from e
        self.path = path
        self._frames = iio.imread(path)  # (N, H, W[, C])
        if self._frames.ndim == 4:
            self._frames = self._frames.mean(axis=-1)
        N, H, W = self._frames.shape
        f = 0.5 * W / np.tan(np.deg2rad(fov_deg) / 2)
        self.calibration = Calibration.ideal(f, f, W / 2 - 0.5, H / 2 - 0.5, W, H)

    def __len__(self) -> int:
        return len(self._frames)

    def _load(self, index: int) -> CaptureFrame:
        return CaptureFrame(
            index=index, timestamp=index / 30.0,
            image=self._frames[index].astype(np.float32),
        )
