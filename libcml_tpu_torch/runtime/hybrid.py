"""MOD-SLAM hybrid odometry: the per-frame indirect tracking programs.

PyTorch port of the module-level programs of libcml_tpu/runtime/hybrid.py
that run on every frame of the hybrid (the reference's
indirect/Tracking.cpp:82 indirectTrackWithCMLGraph + :413
indirectTrackLocalMap, with the IndirectCameraOptimizer):

  _extract            ORB extraction over an image pyramid,
  _project_match_pnp  constant-velocity prediction -> project the map ->
                      radius/level-masked Hamming match -> motion-only PnP,
  _local_map_pass2    re-projection of the map at the refined pose,
                      match, PnP inlier count.

Both match programs resolve their matches through the hand-written CUDA
kernel on the card (models/indirect/matching._resolve_from_desc). The
`HybridOdometry` class that drives them is not ported yet.
"""

from __future__ import annotations

import torch

from libcml_tpu_torch.core.camera import PinholeCamera
from libcml_tpu_torch.core.lie import SE3
from libcml_tpu_torch.models.indirect.matching import match_projection
from libcml_tpu_torch.models.indirect.orb import extract_orb
from libcml_tpu_torch.models.indirect.pnp import solve_pnp
from libcml_tpu_torch.ops.image import build_pyramid

# arena capacities (static shapes; reference budgets: 625-2000 ORB corners,
# the map a recycling arena)
MAP_CAP = 4096
KF_RING = 6          # local-BA keyframe count (covisibility-selected)
KF_HISTORY = 48      # indirect keyframes kept for covisibility selection
OBS_PER_KF = 1024


def _extract(img: torch.Tensor, budget: int, levels: int):
    return extract_orb(build_pyramid(img, levels), budget_per_level=budget)


def _sigma2(feats_level: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per-match measurement variance 1.2^(2 * level) (px^2)."""
    return 1.2 ** (2.0 * feats_level[idx].float())


def _all_finite(T: SE3) -> torch.Tensor:
    return torch.all(torch.isfinite(T.t)) & torch.all(torch.isfinite(T.R))


def predict_pose(T_curr: SE3, T_prev: SE3) -> SE3:
    """Constant-velocity prediction of the next frame's pose."""
    return T_curr.compose(T_prev.inverse()).compose(T_curr)


def _local_map_pass2(Xw, desc_p, valid_p, level_p, T_refined: SE3, cam: PinholeCamera,
                     feats_desc, feats_uv, feats_level, feats_valid):
    """SECOND local-map tracking pass (reference: indirect/Tracking.cpp:413-632
    indirectTrackLocalMap): re-project the map at the REFINED pose with a
    tighter radius, match, and re-run motion-only PnP; its inlier count is
    the tracking-quality statistic the decisions consume.
    Returns (match validity (P,), bundle [num_matches, num_inliers, finite])."""
    m, _ = match_projection(
        Xw, desc_p, valid_p, level_p, T_refined, cam,
        feats_desc, feats_uv, feats_level, feats_valid,
        radius=9.0,   # tighter radius than pass 1: the pose is refined
    )
    uv_obs = feats_uv[m.idx]
    res = solve_pnp(Xw, uv_obs, m.valid, T_refined, cam,
                    sigma2=_sigma2(feats_level, m.idx))
    bundle = torch.stack([m.num.float(), res.num_inliers.float(),
                          _all_finite(res.T).float()])
    return m.valid, bundle


def _project_match_pnp(Xw, desc_p, valid_p, level_p, T_curr: SE3, T_prev: SE3,
                       cam: PinholeCamera, feats_desc, feats_uv, feats_level,
                       feats_angle, feats_valid):
    """Constant-velocity pose prediction -> project map -> radius/level-masked
    Hamming match -> motion-only PnP with covariance (the reference's
    indirectTrackWithCMLGraph + IndirectCameraOptimizer, fused).

    Returns (MatchResult, PnPResult, bundle, use_seed) with bundle =
    [num_matches, num_inliers, finite, R(9), t(3), cov_rot(3), motion_dt,
    motion_ang] and use_seed = the inlier/finite gate for ORB-first seeding
    of the direct spine."""
    T_pred = predict_pose(T_curr, T_prev)
    m, _ = match_projection(
        Xw, desc_p, valid_p, level_p, T_pred, cam,
        feats_desc, feats_uv, feats_level, feats_valid,
    )
    uv_obs = feats_uv[m.idx]
    res = solve_pnp(Xw, uv_obs, m.valid, T_pred, cam, sigma2=_sigma2(feats_level, m.idx))
    finite = _all_finite(res.T)
    cov_rot = torch.diagonal(res.cov)[3:6]
    rel_R = res.T.R @ T_curr.R.T
    ang = torch.arccos(torch.clamp((torch.trace(rel_R) - 1.0) / 2.0, -1.0, 1.0))
    dt = torch.linalg.norm(res.T.t - rel_R @ T_curr.t)
    f = torch.float32
    bundle = torch.cat([
        torch.stack([m.num.to(f), res.num_inliers.to(f), finite.to(f)]),
        res.T.R.reshape(-1).to(f),
        res.T.t.reshape(-1).to(f),
        cov_rot.to(f),
        torch.stack([dt, ang]).to(f),
    ])
    use_seed = (res.num_inliers >= 12) & finite
    return m, res, bundle, use_seed
