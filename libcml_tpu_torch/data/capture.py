"""Capture layer: frame streams from datasets, with background prefetch.

Port of libcml_tpu/data/capture.py (reference:
src/cml/capture/AbstractCapture.h:15-140 — play/next/remaining + threaded
prefetch base; CaptureImage.h:20 per-frame bundle). One prefetch thread
decodes frames (numpy only: it never touches torch or the card) into a
bounded queue while the device runs the previous ones. Unlike the
reference (libcml_tpu/data/capture.py:70), a frame that fails to load
raises in the consumer instead of ending the stream.
"""

from __future__ import annotations

import os
import queue
import threading
from dataclasses import dataclass
from typing import Iterator

import numpy as np

from libcml_tpu_torch.core.camera import Calibration


@dataclass
class CaptureFrame:
    """One frame of input: grayscale image + metadata (the reference's
    CaptureImage minus the pyramid, which is built on the device)."""

    index: int
    timestamp: float
    image: np.ndarray                    # (H, W) float32, ~[0, 255]
    exposure: float = 1.0
    gt_pose_c2w: np.ndarray | None = None  # (4, 4) if groundtruth exists


class AbstractCapture:
    """Sequential frame source. Subclasses implement __len__ and _load(i)."""

    calibration: Calibration

    def __len__(self) -> int:  # pragma: no cover - interface
        raise NotImplementedError

    def _load(self, index: int) -> CaptureFrame:  # pragma: no cover
        raise NotImplementedError

    def frames(self, prefetch: int = 4) -> Iterator[CaptureFrame]:
        """Iterate frames with a background prefetch thread (bounded queue,
        reference: AbstractCapture.h:83-140). An exception raised by `_load`
        is raised here, after the frames loaded before it, so a decode or IO
        error does not end the stream as if the data had run out."""
        q: queue.Queue = queue.Queue(maxsize=prefetch)
        stop = threading.Event()

        def worker():
            end = None      # the end marker: None after the last frame
            try:
                for i in range(len(self)):
                    if stop.is_set():
                        return
                    item = self._load(i)
                    # bounded put that observes `stop`: a plain blocking
                    # put leaks the thread forever when the consumer
                    # abandons the generator with the queue full
                    while not stop.is_set():
                        try:
                            q.put(item, timeout=0.2)
                            break
                        except queue.Full:
                            pass
                    if stop.is_set():
                        return
            except Exception as exc:
                end = _LoadFailure(exc)
            finally:
                while True:
                    try:
                        q.put(end, timeout=0.2)
                        break
                    except queue.Full:
                        if stop.is_set():
                            break

        t = threading.Thread(target=worker, name="capture-prefetch", daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, _LoadFailure):
                    raise item.exc
                yield item
        finally:
            stop.set()
            # unblock a worker waiting on a full queue
            try:
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass


@dataclass
class _LoadFailure:
    """The prefetch worker's end marker when `_load` raised: the consumer
    re-raises `exc`."""

    exc: Exception


def load_dataset(path: str) -> AbstractCapture:
    """Auto-detect the dataset type by directory signature and return the
    right capture (reference: loadDataset try-in-order, modslam.cpp:53-127)."""
    from libcml_tpu_torch.data.eth3d import Eth3DCapture, looks_like_eth3d
    from libcml_tpu_torch.data.euroc import EurocCapture, looks_like_euroc
    from libcml_tpu_torch.data.kitti import KittiCapture, looks_like_kitti
    from libcml_tpu_torch.data.misc import (
        RobotCarCapture,
        VideoCapture,
        ZipStereopolisCapture,
        looks_like_robotcar,
        looks_like_stereopolis,
        looks_like_video,
    )
    from libcml_tpu_torch.data.tartanair import TartanAirCapture, looks_like_tartanair
    from libcml_tpu_torch.data.tum import TumMonoCapture, looks_like_tum

    if not os.path.exists(path):
        raise FileNotFoundError(path)
    # try-in-order, mirroring the reference's detection sequence
    if looks_like_video(path):
        return VideoCapture(path)
    if looks_like_stereopolis(path):
        return ZipStereopolisCapture(path)
    if looks_like_tum(path):
        return TumMonoCapture(path)
    if looks_like_kitti(path):
        return KittiCapture(path)
    if looks_like_euroc(path):
        return EurocCapture(path)
    if looks_like_tartanair(path):
        return TartanAirCapture(path)
    if looks_like_eth3d(path):
        return Eth3DCapture(path)
    if looks_like_robotcar(path):
        return RobotCarCapture(path)
    raise ValueError(f"unrecognized dataset layout at {path}")
