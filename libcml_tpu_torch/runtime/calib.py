"""Calib SLAM: the self-calibrating variant of the hybrid.

PyTorch port of libcml_tpu/runtime/calib.py (reference: Calib SLAM,
src/cml/slam/calib/Calib.{h,cpp}: Calib.h:5 runs on top of Hybrid, :28-56
optimizes a distortion map and a gamma LUT from tracked points and persists
them, :121-161 export).

Run it on RAW (unrectified, response-uncorrected) frames with a pinhole
guess. While the hybrid tracks, it harvests
  - geometric correspondences: the indirect map points of every indirect
    keyframe in its camera frame against their OBSERVED corner pixels, for
    the radtan distortion fit (models/calib.calibrate_distortion);
  - photometric pairs: the tracker reference's point intensities against
    the new frame's at their tracked positions, with the exposure ratio,
    for the response fit (models/calib.calibrate_response).
finalize() fits both and returns a Calibration (remap and gamma) that
rectifies later runs; save() writes it to a .npz file.
"""

from __future__ import annotations

import numpy as np
import torch

from libcml_tpu_torch.core.camera import Calibration, PinholeCamera
from libcml_tpu_torch.models import calib as calib_mod
from libcml_tpu_torch.ops.image import bilinear
from libcml_tpu_torch.runtime.hybrid import HybridOdometry
from libcml_tpu_torch.runtime.odometry import host_fetch

HARVEST = 64    # keyframes' (and frames') harvests kept, the newest


class CalibSlam(HybridOdometry):
    """Hybrid SLAM with self-calibration harvesting."""

    # raw distorted frames: the Hartley-Sturm correction would project the
    # distortion signal onto the pinhole epipolar constraint and bias the fit
    optimal_triangulation = False

    def __init__(self, cam: PinholeCamera, *args, **kw):
        super().__init__(cam, *args, **kw)
        # geometric correspondences (camera-frame point, observed pixel)
        self._geo_Xc: list[np.ndarray] = []
        self._geo_uv: list[np.ndarray] = []
        # photometric pairs (I_ref, I_new, exposure ratio, valid)
        self._pho: list[tuple[np.ndarray, np.ndarray, float, np.ndarray]] = []
        self._prev_exposure = 1.0

    def process(self, image, timestamp, gt_pose_c2w=None, exposure: float = 1.0):
        out = super().process(image, timestamp, gt_pose_c2w, exposure=exposure)
        # photometric pairs: the reference points' colours against the new
        # frame sampled at their tracked positions, when the ratio is known
        if (out.get("ok") and self._tracker_ref is not None and exposure > 0
                and self._prev_exposure > 0):
            ref = self._tracker_ref
            T_rel = self._T_curr.compose(self._kf_T.inverse())
            X = self.cam.unproject(ref.uv[0], ref.idepth)
            uv_j, z_ok = self.cam.project(T_rel.apply(X))
            img = torch.as_tensor(np.asarray(image, np.float32)).to(self.device)
            I_new = bilinear(img, uv_j)
            ok = ref.valid[0] & z_ok & self.cam.in_bounds(uv_j, border=2.0)
            i_ref, i_new, ok = host_fetch([ref.color[0][:, 0], I_new, ok])
            self._pho.append((i_ref, i_new, exposure / self._prev_exposure, ok))
            self._pho = self._pho[-HARVEST:]
        self._prev_exposure = exposure
        return out

    def _on_indirect_kf(self, k: dict) -> None:
        # the keyframe's observations: map points in its camera frame against
        # the corner pixels that observed them
        super()._on_indirect_kf(k)
        if not len(k["obs_point"]):
            return
        Xw = self._pt_Xw[k["obs_point"]]
        Xc = Xw @ k["T_R"].T + k["T_t"]
        self._geo_Xc.append(Xc.astype(np.float32))
        self._geo_uv.append(k["obs_uv"])
        self._geo_Xc = self._geo_Xc[-HARVEST:]
        self._geo_uv = self._geo_uv[-HARVEST:]

    # -- calibration outputs --------------------------------------------------

    def fit_distortion(self) -> np.ndarray | None:
        """[k1, k2, p1, p2] from the harvested correspondences, or None."""
        if not self._geo_Xc:
            return None
        Xc = np.concatenate(self._geo_Xc)
        uv = np.concatenate(self._geo_uv)
        ok = np.isfinite(Xc).all(1) & np.isfinite(uv).all(1) & (Xc[:, 2] > 0.1)
        # hard pre-filter: points far outside the field of view or with huge
        # identity-model residuals have Jacobians (r^6 terms) that overflow
        # f32, which the Huber weight cannot tame
        with np.errstate(invalid="ignore", divide="ignore"):
            xn = Xc[:, :2] / np.maximum(Xc[:, 2:3], 1e-6)
            ok &= (np.abs(xn) < 2.0).all(1)
            pred_u = float(self.cam.fx) * xn[:, 0] + float(self.cam.cx)
            pred_v = float(self.cam.fy) * xn[:, 1] + float(self.cam.cy)
            r0 = np.hypot(pred_u - uv[:, 0], pred_v - uv[:, 1])
            ok &= np.nan_to_num(r0, nan=np.inf) < 30.0
        if ok.sum() < 50:
            return None
        dev = self.device
        p = calib_mod.calibrate_distortion(
            torch.as_tensor(Xc).to(dev), torch.as_tensor(uv).to(dev),
            torch.as_tensor(ok).to(dev), self.cam, radial_only=True)
        return p.cpu().numpy()

    def fit_response(self) -> np.ndarray | None:
        """(256,) inverse-response LUT from the exposure pairs, or None when
        no exposure change was seen."""
        pairs = [p for p in self._pho if abs(p[2] - 1.0) > 1e-3]
        if len(pairs) < 4:
            return None
        dev = self.device
        i1 = np.concatenate([p[0] for p in pairs])
        i2 = np.concatenate([p[1] for p in pairs])
        e = np.concatenate([np.full(len(p[0]), p[2], np.float32) for p in pairs])
        ok = np.concatenate([p[3] for p in pairs])
        c = calib_mod.calibrate_response(*(torch.as_tensor(a).to(dev) for a in (i1, i2, e, ok)))
        return calib_mod.response_lut(c)

    def finalize(self) -> Calibration:
        """Fit everything harvested: a Calibration with the remap and the
        gamma LUT (the pinhole unchanged)."""
        params = self.fit_distortion()
        remap = None if params is None else calib_mod.distortion_map(params, self.cam)
        return Calibration(pinhole=self.cam, remap=remap, gamma=self.fit_response())

    def save(self, path: str) -> None:
        """Write the fitted calibration as .npz (reference: Calib.h:28-56
        exports the distortion map and the LUT)."""
        cal = self.finalize()
        np.savez(
            path,
            remap=cal.remap if cal.remap is not None else np.zeros(0),
            gamma=cal.gamma if cal.gamma is not None else np.zeros(0),
            fx=float(self.cam.fx), fy=float(self.cam.fy),
            cx=float(self.cam.cx), cy=float(self.cam.cy),
            width=self.cam.width, height=self.cam.height,
        )
