"""Pose plausibility checking against recent motion statistics.

Copied from libcml_tpu/runtime/checker.py (the reference's CameraChecker
(reference: src/cml/robust/CameraChecker.h:10 — a candidate pose is
rejected when its implied frame-to-frame motion is wildly inconsistent
with the recent motion history). Host-side scalar logic: it gates pose
TAKEOVERS (PnP fallback, relocalization) so a single bad solve cannot
teleport the trajectory.
"""

from __future__ import annotations

from collections import deque

import numpy as np
import torch

from libcml_tpu_torch.core.lie import SE3


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _motion_of(T_prev: SE3, T_new: SE3) -> tuple[float, float]:
    """(translation magnitude, rotation angle rad) of T_new relative to
    T_prev (both world-to-camera)."""
    rel_R = _host(T_new.R) @ _host(T_prev.R).T
    ang = float(np.arccos(np.clip((np.trace(rel_R) - 1.0) / 2.0, -1.0, 1.0)))
    dt = float(np.linalg.norm(_host(T_new.t) - rel_R @ _host(T_prev.t)))
    return dt, ang


class CameraChecker:
    """Sliding statistics of frame-to-frame motion + plausibility test."""

    def __init__(self, window: int = 12, trans_factor: float = 6.0,
                 rot_factor: float = 6.0, trans_floor: float = 0.05,
                 rot_floor: float = 0.1):
        self._trans: deque[float] = deque(maxlen=window)
        self._rot: deque[float] = deque(maxlen=window)
        self.trans_factor = trans_factor
        self.rot_factor = rot_factor
        self.trans_floor = trans_floor
        self.rot_floor = rot_floor

    def push(self, T_prev: SE3, T_new: SE3) -> None:
        dt, ang = _motion_of(T_prev, T_new)
        if np.isfinite(dt) and np.isfinite(ang):
            self._trans.append(dt)
            self._rot.append(ang)

    def plausible(self, T_prev: SE3, T_new: SE3) -> bool:
        """Is the step T_prev -> T_new consistent with recent motion?
        With no history everything is plausible (bootstrap)."""
        dt, ang = _motion_of(T_prev, T_new)
        if not (np.isfinite(dt) and np.isfinite(ang)):
            return False
        if not self._trans:
            return True
        t_med = float(np.median(self._trans))
        r_med = float(np.median(self._rot))
        return (
            dt <= self.trans_factor * t_med + self.trans_floor
            and ang <= self.rot_factor * r_med + self.rot_floor
        )

    def push_values(self, dt: float, ang: float) -> None:
        """Host-scalar variant of push: the motion magnitudes were computed
        on the device inside the frame/PnP programs and ride their result
        bundles, so no pose is fetched for them."""
        if np.isfinite(dt) and np.isfinite(ang):
            self._trans.append(float(dt))
            self._rot.append(float(ang))

    def plausible_values(self, dt: float, ang: float) -> bool:
        """Host-scalar variant of plausible (same rule, no fetches)."""
        if not (np.isfinite(dt) and np.isfinite(ang)):
            return False
        if not self._trans:
            return True
        t_med = float(np.median(self._trans))
        r_med = float(np.median(self._rot))
        return (
            dt <= self.trans_factor * t_med + self.trans_floor
            and ang <= self.rot_factor * r_med + self.rot_floor
        )

