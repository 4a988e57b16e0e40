"""The full-width workload that chip_smoke.py and profile_slice.py both drive.

One synthetic sequence at 640x480 (fx = fy = 520, cx, cy at the centre, as
benchmarks/export_kitti.py:144-159 sets them), DirectOdometry with
bench.py's configuration, the hybrid's per-frame tracking programs
(ORB 512 per level x 3 levels, a MAP_CAP-slot map built from frame 0's
corners), bench.py's sequential HybridOdometry, and the blackout-and-return
relocalization run. Keeping it in one place means the profile describes the
smoke's workload and nothing else.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from libcml_tpu_torch.core.camera import PinholeCamera
from libcml_tpu_torch.core.lie import SE3
from libcml_tpu_torch.data.synthetic import SyntheticScene, forward_trajectory
from libcml_tpu_torch.models.direct.config import DirectConfig
from libcml_tpu_torch.models.indirect.matching import projection_pair_mask
from libcml_tpu_torch.models.indirect.orb import OrbFeatures
from libcml_tpu_torch.runtime import hybrid

# bench.py:71-73, verbatim
BENCH_CFG = DirectConfig(num_levels=4, max_points=2048, points_per_kf=512,
                         init_points=512, max_frames=7, tracker_iters=10, ba_iters=4)
W, H, FX = 640, 480, 520.0
# 0.05 m a frame keeps 60 frames in front of the scene's side walls, which
# meet at z = 4 - 0.45 |x|: at 0.08 m the camera reaches them near frame 49,
# and both packages lose tracking there
STEP = 0.05
ORB_BUDGET, ORB_LEVELS = 512, 3

HybridMap = tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def render_frames(dev: torch.device, n: int):
    """(camera, [(R, t)] world-to-camera poses, [(image, inverse depth)] on
    `dev`) for the first `n` frames of the sequence."""
    cam = PinholeCamera.make(FX, FX, W / 2 - 0.5, H / 2 - 0.5, W, H)
    scene = SyntheticScene.default(cam, seed=3)
    traj = forward_trajectory(n, step=STEP, yaw_rate=0.003)
    frames = [scene.render_device(R, t, dev) for R, t in traj]
    return cam, traj, frames


def se3(R, t, dev: torch.device) -> SE3:
    return SE3(R=torch.as_tensor(np.asarray(R, np.float32)).to(dev),
               t=torch.as_tensor(np.asarray(t, np.float32)).to(dev))


def extract(frame) -> OrbFeatures:
    """ORB features of one rendered frame at the hybrid's budget."""
    return hybrid._extract(frame[0], ORB_BUDGET, ORB_LEVELS)


def build_map(cam: PinholeCamera, traj, frames, dev: torch.device) -> tuple[HybridMap, int]:
    """World points, descriptors, validity and levels of frame 0's valid ORB
    corners (renderer inverse depth, ground-truth pose), padded to MAP_CAP;
    and the number of valid points."""
    f0 = extract(frames[0])
    uv = f0.uv
    ui = torch.round(uv).long()
    ui[:, 0].clamp_(0, W - 1)
    ui[:, 1].clamp_(0, H - 1)
    rho = frames[0][1][ui[:, 1], ui[:, 0]]
    ok = f0.valid & (rho > 0)
    Xc = cam.unproject(uv, torch.clamp(rho, min=1e-6))
    T0 = se3(*traj[0], dev)
    Xw = (Xc - T0.t) @ T0.R                               # R^T (Xc - t)
    P, n = hybrid.MAP_CAP, uv.shape[0]

    def pad(x, fill):
        return torch.cat([x, torch.full((P - n,) + x.shape[1:], fill, dtype=x.dtype,
                                        device=dev)])

    return (pad(Xw, 0.0), pad(f0.desc, 0), pad(ok, False), pad(f0.level, 0)), int(ok.sum())


def projection_match_inputs(map_: HybridMap, cam: PinholeCamera, traj, f: OrbFeatures,
                            i: int, dev: torch.device):
    """The Hamming resolution's inputs (desc_q, mask_q, desc_t, mask_t,
    pair_mask) in track_frame's first program on frame `i`: the map against
    frame i's corners at the constant-velocity pose, match_projection's
    default radius."""
    Xw, desc, valid, level = map_
    T_pred = hybrid.predict_pose(se3(*traj[i - 1], dev), se3(*traj[max(i - 2, 0)], dev))
    vis, pair, _ = projection_pair_mask(Xw, valid, level, T_pred, cam, f.uv, f.level,
                                        radius=15.0)
    return desc, vis, f.desc, f.valid, pair


def hybrid_odometry(cam: PinholeCamera, cfg: DirectConfig = BENCH_CFG,
                    dev: torch.device | str | None = None, mesh=None) -> hybrid.HybridOdometry:
    """bench.py's sequential hybrid (bench.py:74-77): HybridOdometry with
    `cfg` and ORB 512 per level x 3 levels, on the card unless `dev` says
    otherwise; its window BA point-sharded over `mesh` when one is given."""
    return hybrid.HybridOdometry(cam, cfg, orb_budget=ORB_BUDGET, orb_levels=ORB_LEVELS,
                                 device=dev, mesh=mesh)


# the relocalization run (tests/test_recovery.py:13-28): LOST after two
# failed frames, a restart only after three frames of grace
RELOC_CFG = dataclasses.replace(BENCH_CFG, max_track_fails=2, lost_grace_frames=3)
# frames tracked, viewpoint revisited, black frames. The reference test
# tracks 14 frames and revisits viewpoint 8 at 160x120; at 640x480 with
# bench.py's configuration the first indirect keyframe comes at frame 8 and
# holds no map point (its triangulation has no earlier keyframe), so
# viewpoint 8 retrieves a keyframe with nothing to hand to EPnP. Viewpoint
# 20 of 24 tracked frames is the same test one stored keyframe later.
RELOC_SEEN, RELOC_VIEW, RELOC_BLACK = 24, 20, 4


def relocalization_frames(frames) -> list[tuple[int, np.ndarray]]:
    """tests/test_recovery.py:75-114 on this sequence: (viewpoint index or
    -1 for black, image) for RELOC_SEEN tracked frames, RELOC_BLACK black
    frames, then viewpoint RELOC_VIEW three times."""
    imgs = [f[0].cpu().numpy() for f in frames[:RELOC_SEEN]]
    black = np.zeros_like(imgs[0])
    return ([(i, img) for i, img in enumerate(imgs)] + [(-1, black)] * RELOC_BLACK
            + [(RELOC_VIEW, imgs[RELOC_VIEW])] * 3)


def track_frame(map_: HybridMap, cam: PinholeCamera, traj, f: OrbFeatures, i: int,
                dev: torch.device):
    """The hybrid's two tracking programs on frame `i`, with the ground-truth
    poses of frames i-1 and i-2 as the motion model: _project_match_pnp, then
    _local_map_pass2 at its pose. Returns (PnP result, pass-1 bundle, pass-2
    bundle), the bundles still on the device."""
    Xw, desc, valid, level = map_
    _, res, bundle, _ = hybrid._project_match_pnp(
        Xw, desc, valid, level, se3(*traj[i - 1], dev), se3(*traj[max(i - 2, 0)], dev),
        cam, f.desc, f.uv, f.level, f.angle, f.valid)
    _, bundle2 = hybrid._local_map_pass2(Xw, desc, valid, level, res.T, cam,
                                         f.desc, f.uv, f.level, f.valid)
    return res, bundle, bundle2
