"""MOD-SLAM hybrid odometry: a direct (DSO-style) spine plus an indirect
(ORB-style) map, with a per-frame uncertainty-based choice between them.

PyTorch port of libcml_tpu/runtime/hybrid.py in its sequential mode (the
reference's Hybrid orchestrator, src/cml/slam/modslam/Hybrid.cpp:167
processFrame; indirect/Tracking.cpp:82 indirectTrackWithCMLGraph and :413
indirectTrackLocalMap; indirect/Mapping.cpp indirectMap; Research.cpp's
decisions; Relocalization.cpp).

  - The direct pipeline (DirectOdometry) stays the spine.
  - The indirect map is a fixed-capacity arena of MAP_CAP world points on
    the host (slot generations detect recycled slots, SlamMap ids give the
    points their lasting identity), mirrored to the device when it changes.
  - Per frame: ORB extraction, the projection match + motion-only PnP
    (_project_match_pnp, whose pose can seed the direct tracker through a
    device-side gate), the mode decision, a CameraChecker-gated PnP takeover
    when direct tracking fails, and a second local-map pass at the refined
    pose whose result lands in the NEXT frame's finalize (as in the
    reference). Each frame's scalars come to the host in one transfer.
  - Per indirect keyframe, in order: epipolar matching + optimal
    triangulation against the previous indirect keyframe, the map's
    projection match, search-and-fuse, the observation ring, the
    relocalization store, the BA decision, the mixed photometric +
    reprojection BA (with its photometric rollback guard), redundant
    keyframe culling, and the covisibility-selected local reprojection BA.
  - On LOST: BoW retrieval, descriptor matching, VFC, EPnP RANSAC, and a
    restart anchored at the recovered pose that keeps the map.
  - While the direct initializer has not converged: the ORB two-view
    bootstrap.

The keyframe postprocess is three ticks (the match and bookkeeping, the
mixed BA with keyframe culling, the local BA), each consuming the device
results of the one before. Sequentially they all run inside the keyframe's
own frame; with `staged_indpost` the first runs there and the two BA ticks
ride later frames' bundle transfers, TICK_LAG frames after their dispatch;
the pipelined mode (`pipelined=True`, the direct spine's lag-1 finalize)
stages all three.

Every Hamming match on these paths resolves through the hand-written CUDA
kernel on the card (models/indirect/matching._resolve_from_desc). A run
saves and resumes its full state (save_state / load_state), in-flight frames
and tick included.
"""

from __future__ import annotations

from collections import Counter

import numpy as np
import torch

from libcml_tpu_torch.core.camera import PinholeCamera
from libcml_tpu_torch.core.lie import SE3
from libcml_tpu_torch.models.direct import ba as ba_mod
from libcml_tpu_torch.models.direct import window as win_mod
from libcml_tpu_torch.models.direct.config import DirectConfig
from libcml_tpu_torch.models.direct.selector import select_points
from libcml_tpu_torch.models.direct.tracer import seed_immatures
from libcml_tpu_torch.models.hybrid.decision import (
    BundleAdjustmentDecision,
    DecisionConfig,
    Mode,
    PoseEstimationDecision,
)
from libcml_tpu_torch.models.indirect import indirect_ba as iba
from libcml_tpu_torch.models.indirect.bow import KeyframeDatabase, default_vocabulary
from libcml_tpu_torch.models.indirect.epnp import epnp_ransac
from libcml_tpu_torch.models.indirect.matching import (
    match_descriptors,
    match_epipolar,
    match_projection,
    match_window,
    orientation_check,
    vfc_filter,
)
from libcml_tpu_torch.models.indirect.orb import extract_orb
from libcml_tpu_torch.models.indirect.pnp import solve_pnp, triangulate_linear
from libcml_tpu_torch.models.indirect.triangulation import fundamental, optimal_correct
from libcml_tpu_torch.models.indirect.twoview import two_view_init
from libcml_tpu_torch.ops.image import build_pyramid
from libcml_tpu_torch.runtime.checker import CameraChecker
from libcml_tpu_torch.runtime.odometry import (
    DirectOdometry,
    HostCopy,
    _preprocess,
    _working_rho_range,
    host_fetch,
)
from libcml_tpu_torch.utils import logging as log

# arena capacities (static shapes; reference budgets: 625-2000 ORB corners,
# the map a recycling arena)
MAP_CAP = 4096
KF_RING = 6          # local-BA keyframe count (covisibility-selected)
KF_HISTORY = 48      # indirect keyframes kept for covisibility selection
OBS_PER_KF = 1024
# the map arena's host arrays (HybridOdometry attributes)
HYBRID_ARENA = ("_pt_Xw", "_pt_desc", "_pt_level", "_pt_valid", "_pt_last_seen", "_pt_gen",
                "_pt_mapid")


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


# ---------------------------------------------------------------------------
# Device programs (the six Hamming call sites: _local_map_pass2,
# _project_match_pnp, _epipolar_triangulate, _map_projection_match, and
# match_window / match_descriptors in the bootstrap and relocalization)
# ---------------------------------------------------------------------------


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


def _epipolar_triangulate(desc0, uv0, valid0, angle0, desc1, uv1, valid1, angle1,
                          T_new: SE3, T0: SE3, cam: PinholeCamera, optimal: bool = True):
    """Epipolar-constrained matching between two keyframes, then (optimal)
    triangulation (the reference's trackForTriangulation + createNewPoints,
    indirect/Mapping.cpp:139-239). `optimal` applies the Hartley-Sturm
    correction before the DLT (reference: Triangulation.h:141).
    Returns (MatchResult, X0 (N, 3) in keyframe-0 coordinates, ok (N,),
    the baseline norm)."""
    T_10 = T_new.compose(T0.inverse())
    t_norm = torch.linalg.norm(T_10.t)
    F = fundamental(T_10, cam)
    m = match_epipolar(desc0, uv0, valid0, desc1, uv1, valid1, F)
    ok = orientation_check(angle0, angle1, m.idx, m.valid)
    if optimal:
        uv0c, uv1c = optimal_correct(uv0, uv1[m.idx], F)
    else:
        uv0c, uv1c = uv0, uv1[m.idx]
    X0, tri_ok = triangulate_linear(uv0c, uv1c, T_10, cam)
    # parallax + depth sanity (the reference prunes low-parallax points)
    depth_ok = (X0[:, 2] > 1e-3) & (X0[:, 2] < 1e4)
    return m, X0, ok & tri_ok & depth_ok, t_norm


def _map_projection_match(Xw, desc_p, valid_p, level_p, T: SE3, cam: PinholeCamera, feats):
    """The keyframe postprocess's projection match of the whole map at the
    keyframe's pose (match_projection's default radius)."""
    m, _ = match_projection(Xw, desc_p, valid_p, level_p, T, cam,
                            feats.desc, feats.uv, feats.level, feats.valid)
    return m


def _mixed_ba_dispatch(ba, images, cam: PinholeCamera, cfg: DirectConfig,
                       ind: ba_mod.IndirectFactors, kf_slot: int):
    """The mixed-BA device half: joint photometric + reprojection solve,
    re-anchored linearization point, refined host-frame points, the
    promoted keyframe's pose, and the window's PHOTOMETRIC energy before and
    after (the caller rolls the solve back when it traded too much
    photometric energy for reprojection energy: a photometrically degraded
    window is the tracking reference and collapses tracking)."""
    E_photo0 = ba_mod.total_energy(ba, images, cam, cfg)
    new_ba, new_ind, E = ba_mod.run_ba_mixed(ba, images, cam, cfg, ind)
    new_ba = ba_mod.relinearize(new_ba)
    E_photo1 = ba_mod.total_energy(new_ba, images, cam, cfg)
    Xh = cam.unproject(new_ind.uv, new_ind.idepth)
    return new_ba, new_ind.point_valid, E, Xh, new_ba.T.index(kf_slot), E_photo0, E_photo1


def _t(x: np.ndarray, dev: torch.device) -> torch.Tensor:
    """Host array -> tensor on `dev` (uint32 words as int32 bit patterns)."""
    a = np.asarray(x)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.as_tensor(a).to(dev)


class HybridOdometry(DirectOdometry):
    """MOD-SLAM: the DirectOdometry spine + indirect map, tracking, local BA
    and relocalization."""

    # Hartley-Sturm correction before the keyframe triangulation (CalibSlam
    # turns it off: on raw distorted frames it would bias the distortion fit)
    optimal_triangulation = True

    def __init__(self, cam: PinholeCamera, cfg: DirectConfig | None = None,
                 dcfg: DecisionConfig | None = None, orb_budget: int = 512,
                 orb_levels: int = 3, enable_indirect: bool = True,
                 staged_indpost: bool = False, **kw):
        super().__init__(cam, cfg, **kw)
        # stage the keyframe postprocess's BA ticks over later frames; the
        # pipelined mode stages all three ticks (the JAX package's gate at
        # runtime/hybrid.py:817 completes them at once when only pipelined is
        # set, against its own comment at :257-258; not copied)
        self.staged_indpost = staged_indpost or self.pipelined
        self.dcfg = dcfg or DecisionConfig()
        self.orb_budget = orb_budget
        self.orb_levels = orb_levels
        self.enable_indirect = enable_indirect

        self.pose_decision = PoseEstimationDecision(self.dcfg)
        self.ba_decision = BundleAdjustmentDecision(self.dcfg)
        # pose-takeover sanity gate (reference: robust/CameraChecker.h:10)
        self.checker = CameraChecker()

        # indirect map arena (host SoA; device mirror rebuilt on change)
        self._pt_Xw = np.zeros((MAP_CAP, 3), np.float32)
        self._pt_desc = np.zeros((MAP_CAP, 8), np.int32)      # 32-bit words
        self._pt_level = np.zeros((MAP_CAP,), np.int32)
        self._pt_valid = np.zeros((MAP_CAP,), bool)
        self._pt_last_seen = np.zeros((MAP_CAP,), np.int64)
        # slot generation: bumped whenever a slot is (re)assigned, so stored
        # observations detect that "their" point was recycled
        self._pt_gen = np.zeros((MAP_CAP,), np.int64)
        # SlamMap point id per slot (the arena recycles, the map only grows)
        self._pt_mapid = np.full((MAP_CAP,), -1, np.int64)
        self._map_dev = None

        # indirect keyframe ring for local BA
        self._ind_kfs: list[dict] = []
        self._last_kf_feats = None
        self._last_kf_T: SE3 | None = None
        self._last_kf_idx = -1
        self._ref_kf_tracked = 1

        # relocalization: BoW retrieval + per-keyframe feature store with
        # feature -> map-slot association; the inverted-file adds are
        # deferred to the first query (_drain_kfdb)
        self._kfdb: KeyframeDatabase | None = None
        self._kfdb_pending: list[int] = []
        self._kf_store: dict[int, dict] = {}

        self.mode_history: list[str] = []
        self._last_mode: str = Mode.DIRECT   # latest finalized mode (gates the
                                             # next frame's PnP seeding)
        self._pending_extras: dict | None = None
        self._indpost: dict | None = None    # in-flight staged postprocess tick
        self._pass2: dict | None = None      # second local-map pass dispatched
                                             # at the refined pose, consumed in
                                             # the NEXT frame's finalize
        self._last_pass2: tuple | None = None   # (matches, inliers, fidx)
        self._reloc_restart = False

    # -- map arena ----------------------------------------------------------

    def _map_device(self):
        if self._map_dev is None:
            dev = self.device
            self._map_dev = tuple(_t(a, dev) for a in (self._pt_Xw, self._pt_desc,
                                                       self._pt_valid, self._pt_level))
        return self._map_dev

    def _add_map_points(self, Xw: np.ndarray, desc: np.ndarray, level: np.ndarray,
                        ok: np.ndarray):
        """Insert accepted points into the arena. Returns (slots, src): the
        arena rows written and the rows of `Xw` they came from (both None when
        nothing was inserted)."""
        idx = np.flatnonzero(ok)
        if idx.size == 0:
            return None, None
        # recycle: invalid slots first, then the longest-unseen (the
        # reference recycles destroyed MapPoints, Map.h:244)
        free = np.flatnonzero(~self._pt_valid)
        if free.size < idx.size:
            stale = np.argsort(self._pt_last_seen)[: idx.size - free.size]
            free = np.concatenate([free, stale])
        free = free[: idx.size]
        self._pt_Xw[free] = Xw[idx]
        self._pt_desc[free] = desc[idx]
        self._pt_level[free] = level[idx]
        self._pt_valid[free] = True
        self._pt_last_seen[free] = self.frame_idx
        self._pt_gen[free] += 1
        # register in the system-of-record map (reference: Map::createMapPoint)
        self._pt_mapid[free] = self.map.add_points(
            Xw[idx], groups=self.map.groups.point_group("INDIRECTGROUP"))
        self._map_dev = None
        return free, idx

    def _cull_map_points(self, max_age: int = 30):
        """Drop points unmatched for max_age frames (reference: point
        culling, indirect/Mapping.cpp:97)."""
        stale = self._pt_valid & (self.frame_idx - self._pt_last_seen > max_age)
        if stale.any():
            self._pt_valid[stale] = False
            self._map_dev = None

    # -- per frame ----------------------------------------------------------

    def process(self, image, timestamp, gt_pose_c2w=None, exposure: float | None = None):
        out = super().process(image, timestamp, gt_pose_c2w, exposure=exposure)
        # ORB two-view bootstrap when the DSO initializer has not converged
        # after a while (reference: RobustRaulmurInitializer::track)
        k = self.frame_idx - self._anchor_kf
        if self.enable_indirect and self.state == "INIT" and k >= 15 and k % 5 == 0:
            img = torch.as_tensor(np.asarray(image, np.float32)).to(self.device)
            if self._twoview_bootstrap(img, timestamp):
                out = {"state": self.state, "twoview_init": True}
        return out

    def _twoview_bootstrap(self, img: torch.Tensor, timestamp) -> bool:
        dev = self.device
        f0 = _extract(self._first_pyr[0][..., 0], self.orb_budget, self.orb_levels)
        f1 = _extract(img, self.orb_budget, self.orb_levels)
        m = match_window(f0.desc, f0.uv, f0.valid, f1.desc, f1.uv, f1.valid)
        if int(m.num) < 40:
            return False
        gen = torch.Generator(device=dev).manual_seed(self.frame_idx)
        uv1m = f1.uv[m.idx]
        res = two_view_init(f0.uv, uv1m, m.valid, self.cam, generator=gen)
        if not bool(res.ok):
            return False
        inl, X0 = res.inlier.cpu().numpy(), res.X0.cpu().numpy()
        ok = inl & np.isfinite(X0).all(1) & (X0[:, 2] > 1e-3)
        if ok.sum() < 30:
            return False

        # refine the pair with a small reprojection BA (frame 0 fixed): the
        # minimal-solver pose from forward-motion narrow-FOV geometry is off
        # in translation direction; joint point + pose refinement fixes it
        N = X0.shape[0]
        ok_t = _t(ok, dev)
        eye = torch.eye(3, dtype=torch.float32, device=dev)
        prob = iba.IndirectBAProblem(
            T=SE3(R=torch.stack([eye, res.T_10.R]),
                  t=torch.stack([torch.zeros(3, device=dev), res.T_10.t])),
            frame_valid=torch.ones((2,), dtype=torch.bool, device=dev),
            frame_fixed=_t(np.array([True, False]), dev),
            Xw=_t(X0, dev), point_valid=ok_t,
            obs_frame=torch.cat([torch.zeros(N, dtype=torch.int32, device=dev),
                                 torch.ones(N, dtype=torch.int32, device=dev)]),
            obs_point=torch.arange(N, dtype=torch.int32, device=dev).repeat(2),
            obs_uv=torch.cat([f0.uv, uv1m]), obs_valid=ok_t.repeat(2),
            obs_sigma2=torch.ones((2 * N,), dtype=torch.float32, device=dev),
        )
        out = iba.run_local_ba(prob, self.cam)
        X0 = out.Xw.cpu().numpy()
        T_ref = out.T.index(1)
        if not np.isfinite(T_ref.t.cpu().numpy()).all():
            return False
        ok = ok & np.isfinite(X0).all(1) & (X0[:, 2] > 1e-3)
        if ok.sum() < 30:
            return False
        log.important("two-view bootstrap at frame %d (%d points)", self.frame_idx,
                      int(ok.sum()))
        # median-depth normalization (the monocular gauge, as normalize_scale)
        scale = 1.0 / max(float(np.median(X0[ok, 2])), 1e-6)
        idepth0 = 1.0 / np.maximum(X0[:, 2] * scale, 1e-4)
        T_rel = SE3(R=T_ref.R, t=T_ref.t * scale)
        self._promote_two_view(img, timestamp, T_rel, f0.uv, _t(idepth0, dev), _t(ok, dev))
        return True

    def _promote_two_view(self, img, timestamp, T_rel: SE3, uv0, idepth0, ok):
        """Build the window from a two-view bootstrap (the direct path's
        _promote_initialization with external points)."""
        cfg, cam, dev = self.cfg, self.cam, self.device
        anchor = self._restart_anchor
        pyr = _preprocess(img, cfg.num_levels)
        zero_ab = torch.zeros(2, dtype=torch.float32, device=dev)
        window = win_mod.empty_window(cfg, cam.height, cam.width, dev)
        window, slot0 = win_mod.add_keyframe(window, self._first_pyr[0], anchor, zero_ab,
                                             self._anchor_kf)
        window = window.replace(ba=ba_mod.anchor_first_frame(window.ba, 0, cfg))
        window, slot1 = win_mod.add_keyframe(window, pyr[0], T_rel.compose(anchor), zero_ab,
                                             self.frame_idx)
        window = win_mod.add_points(window, slot0, uv0, idepth0, ok, cfg)
        new_ba, _ = ba_mod.run_ba(window.ba, window.images, cam, cfg)
        new_ba = ba_mod.update_residual_status(new_ba, window.images, cam, cfg)
        self._window = window.replace(ba=new_ba)

        self._kf_slot = int(slot1)
        self._kf_id = self.frame_idx
        self._kf_pyr = pyr
        self._kf_grad0_prev = self._first_pyr[0]
        self._kf_ab = zero_ab
        self._record(timestamp, self._kf_id, SE3.identity(device=dev))
        self._sync_kf_poses()
        self._set_abs_pose(self._kf_id, self._kf_T, keyframe=True)
        self._rebuild_tracker_ref()
        rho_lo, rho_hi = _working_rho_range(self._window.ba, cfg)
        uv, valid, _ = select_points(pyr[0], cfg.points_per_kf)
        self._immature = seed_immatures(self._immature, self._kf_slot, pyr[0], uv, valid,
                                        rho_lo, rho_hi)
        self._push_recent_row(self._kf_slot)
        self._win_count = 2
        self._pending_marg = None
        self._T_prev = self._kf_T
        self._T_curr = self._kf_T
        self._frames_since_kf = 0
        self.state = "TRACKING"

    def _track_frame(self, pyr, img, timestamp, T_seed=None, use_seed=None):
        """ORB extraction and the projection match + PnP program; the PnP pose
        seeds the direct tracker when the last mode was INDIRECT, gated on the
        device by its inlier/finite test (reference:
        trackWithOrbAndDsoRefinement, Hybrid.cpp:330). The scalar decisions
        run in _finalize_frame."""
        if not self.enable_indirect:
            return super()._track_frame(pyr, img, timestamp)
        with self.sheet.timer("time_orb").frame(self.frame_idx):
            feats = _extract(img, self.orb_budget, self.orb_levels)
        self._pending_extras = {"feats": feats}
        if int(self._pt_valid.sum()) >= self.dcfg.min_orb_matches:
            Xw, desc, valid, level = self._map_device()
            with self.sheet.timer("time_pnp").frame(self.frame_idx):
                m, pnp, bundle, seed_gate = _project_match_pnp(
                    Xw, desc, valid, level, self._T_curr, self._T_prev, self.cam,
                    feats.desc, feats.uv, feats.level, feats.angle, feats.valid)
            self._pending_extras.update(pnp_bundle=bundle, pnp_mvalid=m.valid, pnp_T=pnp.T)
            if self._last_mode == Mode.INDIRECT:
                T_seed, use_seed = pnp.T, seed_gate
        return super()._track_frame(pyr, img, timestamp, T_seed=T_seed, use_seed=use_seed)

    def _entry_extras(self) -> dict:
        extras = self._pending_extras or {}
        self._pending_extras = None
        return extras

    def _stage_bundle(self, entry: dict):
        # an indirect frame's bundle is staged by _prepack_next, together
        # with the second pass and the staged tick it is fetched with
        if "feats" not in entry:
            super()._stage_bundle(entry)

    def _finalize_frame(self, entry: dict) -> dict:
        """The hybrid's scalar tail: one host transfer of the frame's
        scalars, PnP bundle, the previous frame's second pass and the staged
        postprocess tick's results -> mode decision -> PnP takeover ->
        checker / decision pushes -> the indirect keyframe postprocess
        (reference: Hybrid.cpp:167 processFrame's tail + indirectPostprocess,
        Hybrid.cpp:286). In pipelined mode the transfer was started at the
        end of the previous finalize (_prepack_next) and is long done."""
        fidx, timestamp = entry["frame_idx"], entry["ts"]
        feats = entry.get("feats")
        if feats is not None and "scalars_np" not in entry:
            want, layout = self._bundle_want(entry)
            pre = entry.pop("_prepack", None)
            if pre is None or not pre.same(want):
                pre = HostCopy(want)
            p2 = self._pass2
            with self.sheet.timer("time_bundle_fetch").frame(fidx):
                got = pre.result()
            has_pnp, n_ip, has_p2 = layout
            entry["scalars_np"] = got[0]
            k = 1
            if has_pnp:
                entry["pnp_np"] = (got[1], got[2])
                k = 3
            if n_ip is not None:
                self._tick_indpost(got[k:k + n_ip])
                k += n_ip
            if has_p2:
                self._consume_pass2(p2, got[k], got[k + 1])
        out = super()._finalize_frame(entry)
        if feats is None:
            return out

        pnp_ok = False
        pnp_motion = None
        orb_cov = None
        n_matches = 0
        if "pnp_np" in entry:
            b, m_valid = entry["pnp_np"]
            n_matches = int(b[0])
            if int(b[1]) >= 12 and b[2] > 0.5:
                pnp_ok = True
                pnp_motion = (float(b[18]), float(b[19]))
                orb_cov = np.asarray(b[15:18])
                self._pt_last_seen[m_valid] = fidx

        mode = self.pose_decision.decide(n_matches)
        self.mode_history.append(mode)
        self._last_mode = mode
        if out.get("restarted") or out.get("relocalized") or out["state"] != "TRACKING":
            # the failure path reset the spine; no indirect postprocessing
            out["mode"] = mode
            return out
        if (mode == Mode.INDIRECT and pnp_ok and not out["ok"]
                and self.checker.plausible_values(*pnp_motion)):
            # direct refinement failed; the PnP pose stands on its own when
            # it is motion-plausible (CameraChecker). The in-flight frames
            # land first: their prediction chain rode the failed pose
            self._flush_pending()
            pnp_T = entry["pnp_T"]
            self._T_curr = pnp_T
            self._T_prev = pnp_T
            self._record(timestamp, self._kf_id, pnp_T.compose(self._kf_T.inverse()),
                         frame_idx=fidx, gt=entry.get("gt"))
            out["ok"] = True
            self._track_fails = 0
        if out.get("ok"):
            mo = out.get("motion")
            if mo is not None:
                self.checker.push_values(*mo)
            else:
                self.checker.push(self._T_prev, self._T_curr)

        self.pose_decision.push(orb_cov, out.get("cov_rot_diag"))
        out["mode"] = mode
        out["orb_matches"] = n_matches

        # indirect keyframe decision (reference: indirectNeedNewKeyFrame's
        # tracked-vs-reference ratio): the spine's keyframes carry the
        # indirect postprocess; when matches collapse between them, an
        # INDIRECT-ONLY keyframe (no photometric-window event). The tracked
        # count prefers the second local-map pass when a recent one landed.
        n_kf_signal = n_matches
        if self._last_pass2 is not None and fidx - self._last_pass2[2] <= 2:
            n_kf_signal = max(n_matches, self._last_pass2[0])
        if out.get("kf"):
            with self.sheet.timer("time_ind_post").frame(fidx):
                self._indirect_postprocess(feats, timestamp, frame_idx=fidx)
        elif (out.get("ok") and self._last_kf_feats is not None
              and self.dcfg.force_kf_match_ratio > 0
              and n_kf_signal < self.dcfg.force_kf_match_ratio * max(self._ref_kf_tracked, 1)
              and fidx - self._last_kf_idx >= 3):
            with self.sheet.timer("time_ind_post").frame(fidx):
                self._indirect_postprocess(feats, timestamp, T_pose=entry["T_world"],
                                           frame_idx=fidx)
        # the SECOND local-map pass at this frame's refined pose (consumed in
        # the next frame's finalize, before its keyframe rule)
        if (out.get("ok") and out["state"] == "TRACKING"
                and int(self._pt_valid.sum()) >= self.dcfg.min_orb_matches):
            Xw, desc, valid, level = self._map_device()
            mv2, b2 = _local_map_pass2(Xw, desc, valid, level, entry["T_world"], self.cam,
                                       feats.desc, feats.uv, feats.level, feats.valid)
            self._pass2 = {"mvalid": mv2, "bundle": b2, "frame_idx": fidx}
        self._cull_map_points()
        self._prepack_next()
        return out

    def _bundle_want(self, entry: dict, at_frame: int | None = None):
        """The tensors one frame's finalize reads, in transfer order: its
        scalars, its PnP bundle and match validity, the staged tick's
        results, the second pass's; and the layout (PnP present, number of
        tick tensors or None, second pass present)."""
        want = [entry["scalars"]]
        has_pnp = "pnp_bundle" in entry
        if has_pnp:
            want += [entry["pnp_bundle"], entry["pnp_mvalid"]]
        ip = self._indpost_fetch_refs(at_frame=at_frame)
        if ip is not None:
            want += ip
        p2 = self._pass2
        if p2:
            want += [p2["mvalid"], p2["bundle"]]
        return want, (has_pnp, None if ip is None else len(ip), bool(p2))

    def _prepack_next(self):
        """Start the transfer of the NEXT pending frame's bundle now, while
        its device work is queued ahead of the next frame's dispatches."""
        if not self._pending:
            return
        nxt = self._pending[0]
        if "feats" not in nxt or "scalars_np" in nxt:
            return
        want, _ = self._bundle_want(nxt, at_frame=self.frame_idx + 1)
        nxt["_prepack"] = HostCopy(want)

    def _consume_pass2(self, p2: dict, mvalid: np.ndarray, b: np.ndarray):
        """Land a completed second local-map pass: refresh the points'
        last-seen stamps and record the inlier statistic the keyframe rule
        reads (reference: Tracking.cpp:600-632)."""
        self._pass2 = None
        n2, inl2 = int(b[0]), int(b[1])
        fidx = p2["frame_idx"]
        if b[2] > 0.5:
            self._pt_last_seen[mvalid] = fidx
            self._last_pass2 = (n2, inl2, fidx)
            self.sheet.push("pass2_matches", fidx, float(n2))
            self.sheet.push("pass2_inliers", fidx, float(inl2))

    # -- keyframe postprocess ------------------------------------------------

    def _indirect_postprocess(self, feats, timestamp, T_pose: SE3 | None = None,
                              frame_idx: int | None = None):
        """Keyframe indirect mapping, dispatch half (reference: indirectMap,
        indirect/Mapping.cpp:19 + bundleAdjustmentDecision): triangulation
        against the previous indirect keyframe and the map's projection
        match. Three ticks follow (_tick_indpost): the host bookkeeping and
        the BA decision (_indpost_match), the mixed BA and keyframe culling
        (_indpost_ba), the local BA (_indpost_local). Sequentially they all
        run now; staged, the first runs now and the BA ticks later; pipelined,
        all three later. `T_pose` is the pose of an INDIRECT-ONLY keyframe
        (a frame that is not a direct-window keyframe)."""
        if frame_idx is None:
            frame_idx = self.frame_idx
        self._complete_indpost()   # the previous event's ticks land first
        T_new = T_pose if T_pose is not None else self._kf_T
        tri = []
        if self._last_kf_feats is not None:
            f0, T0 = self._last_kf_feats, self._last_kf_T
            m0, X0, ok, t_norm = _epipolar_triangulate(
                f0.desc, f0.uv, f0.valid, f0.angle,
                feats.desc, feats.uv, feats.valid, feats.angle,
                T_new, T0, self.cam, optimal=self.optimal_triangulation)
            tri = [t_norm, X0, ok, f0.desc, f0.level, T0.R, T0.t, m0.idx, m0.dist]
        Xw_d, desc_d, valid_d, level_d = self._map_device()
        m = _map_projection_match(Xw_d, desc_d, valid_d, level_d, T_new, self.cam, feats)
        self._indpost = {
            "phase": "match", "tick_born": self.frame_idx, "feats": feats,
            "frame_idx": frame_idx, "timestamp": timestamp,
            "kf_id": self._kf_id if T_pose is None else -1, "T_new_dev": T_new,
            "fetch_refs": [m.valid, m.idx, m.dist, m.num, feats.desc, feats.uv,
                           feats.level, feats.valid, T_new.R, T_new.t, *tri],
            "has_tri": bool(tri),
        }
        if not self.staged_indpost:
            self._complete_indpost()
        elif not self.pipelined:
            # staged sequential: the bookkeeping tick lands now (the next
            # frame's PnP needs the fresh map); the BA ticks stay staged
            self._tick_indpost()

    def _make_keyframe(self, *a, **kw):
        """A direct keyframe changes the window: the in-flight ticks (a mixed
        BA swapped the window optimistically) land first."""
        self._complete_indpost()
        super()._make_keyframe(*a, **kw)

    def _flush_pending(self) -> list[dict]:
        outs = super()._flush_pending()
        self._complete_indpost()
        return outs

    # -- staged postprocess ticks --------------------------------------------

    # frames a staged tick's device work gets before its results are read
    # with a frame's bundle (a freshly dispatched BA would block that read)
    TICK_LAG = 2

    def _indpost_fetch_refs(self, at_frame: int | None = None):
        """The tensors the in-flight tick reads, or None when there is no
        tick or its work is younger than TICK_LAG frames (`at_frame`: as of
        that frame; the bundle prepack runs one frame early)."""
        st = self._indpost
        if st is None:
            return None
        fidx = self.frame_idx if at_frame is None else at_frame
        if fidx - st.get("tick_born", -10) < self.TICK_LAG:
            return None
        return self._indpost_refs_raw(st)

    @staticmethod
    def _indpost_refs_raw(st: dict) -> list:
        if st["phase"] == "match":
            return st["fetch_refs"]
        if st["phase"] == "ba":
            return st.get("mx_refs") or []
        return st.get("lb_refs") or []

    def _tick_indpost(self, fetched: list | None = None):
        """Advance the in-flight postprocess by one tick. `fetched` is the
        tick's results when they came with a frame's bundle; None reads them
        now (a forced completion, which skips the TICK_LAG wait)."""
        st = self._indpost
        if st is None:
            return
        if fetched is None:
            fetched = host_fetch(self._indpost_refs_raw(st))
        # stamped with the frame the tick runs in (the event's own frame is
        # st["frame_idx"]), so the sheet shows where the ticks landed
        with self.sheet.timer("time_ind_tick").frame(self.frame_idx):
            if st["phase"] == "match":
                self._indpost_match(st, fetched)
            elif st["phase"] == "ba":
                self._indpost_ba(st, fetched)
            else:
                self._indpost_local(st, fetched)
        if self._indpost is st:
            # the next tick's work was dispatched just now
            st["tick_born"] = self.frame_idx

    def _complete_indpost(self):
        while self._indpost is not None:
            self._tick_indpost()

    def _indpost_match(self, st: dict, fetched: list):
        """Tick 1: point insertion, search-and-fuse, descriptor refresh, the
        observation ring, the relocalization store, covisibility, the BA
        decision, and the mixed BA's dispatch when it is chosen."""
        feats = st["feats"]
        frame_idx = st["frame_idx"]
        mv, midx, mdist, m_num, fdesc, fuv, flevel, fvalid, Tn_R, Tn_t = fetched[:10]

        if st["has_tri"]:
            t_norm, X0, ok_np, d0, l0, R0, t0, m0_idx, m0_dist = fetched[10:]
            if float(t_norm) > 1e-4:
                Xw = (X0 - t0) @ R0                      # X_w = R0^T (X0 - t0)
                slots, src = self._add_map_points(Xw, d0, l0, ok_np)
                if slots is not None:
                    # the creating keyframe OBSERVES its new points: the
                    # epipolar match pairs source feature src[i] with corner
                    # m0_idx[src[i]] (the projection match ran on the map
                    # before the insertion)
                    mv[slots] = True
                    midx[slots] = m0_idx[src]
                    mdist[slots] = m0_dist[src]
                    m_num = int(m_num) + slots.size

        # search-and-fuse: two map points matched to the SAME corner are
        # duplicates — keep the smaller Hamming distance, retire the other
        # (reference: indirect/Mapping.cpp:391 searchAndFuse)
        matched = np.flatnonzero(mv)
        if matched.size:
            order = matched[np.argsort(mdist[matched], kind="stable")]
            seen_feat: set[int] = set()
            fuse = []
            for p in order:
                f = int(midx[p])
                if f in seen_feat:
                    fuse.append(p)
                else:
                    seen_feat.add(f)
            if fuse:
                fuse = np.asarray(fuse)
                self._pt_valid[fuse] = False
                mv[fuse] = False
                self._map_dev = None

        # descriptor refresh: a point's descriptor follows its NEWEST
        # observation (reference: MapPoint descriptor update)
        pt_idx = np.flatnonzero(mv)[:OBS_PER_KF]
        if pt_idx.size:
            self._pt_desc[pt_idx] = fdesc[midx[pt_idx]]
            self._pt_level[pt_idx] = flevel[midx[pt_idx]]
            self._map_dev = None
        lv_obs = flevel[midx[pt_idx]]
        k = {
            "frame": frame_idx,
            # indirect-only keyframes have no window slot: kf_id -1 keeps the
            # mixed BA and the pose refresh from binding this entry to a slot
            "kf_id": st["kf_id"],
            "T_R": Tn_R,
            "T_t": Tn_t,
            "obs_point": pt_idx,
            "obs_gen": self._pt_gen[pt_idx].copy(),
            "obs_mapid": self._pt_mapid[pt_idx].copy(),
            "obs_uv": fuv[midx[pt_idx]].astype(np.float32),
            "obs_sigma2": (1.2 ** (2.0 * lv_obs)).astype(np.float32),
        }
        self._ind_kfs.append(k)
        self._ind_kfs = self._ind_kfs[-KF_HISTORY:]
        # covisibility in the system-of-record map (reference:
        # processIndirectCovisiblity, Map.cpp:449)
        mf = self._fid2map.get(frame_idx)
        if mf is not None:
            mids = self._pt_mapid[pt_idx]
            self.map.add_observations(mf, mids[mids >= 0])
        self._ref_kf_tracked = max(int(m_num), 1)
        self._last_kf_feats = feats
        self._last_kf_T = st["T_new_dev"]
        self._last_kf_idx = frame_idx
        self._add_reloc_keyframe(midx, pt_idx, fdesc, fvalid, fuv, kf_id=frame_idx)
        self._on_indirect_kf(k)

        st["ba_mode"] = self.ba_decision.decide(
            num_indirect_points=int(self._pt_valid.sum()),
            num_tracked=int(m_num),
            num_robust=int(np.sum(mdist < 50)),
            saturated_ratio=self.stats[-1].get("saturated", 0.0) if self.stats else 0.0,
        )
        # the mixed BA when the decision distrusts the photometric window
        # (reference: bundleAdjustmentDecision -> BAINDIRECT)
        st["mx"] = st["mx_refs"] = None
        if self.cfg.mixed_ba and (self.cfg.mixed_always or st["ba_mode"] == Mode.INDIRECT):
            with self.sheet.timer("time_mixed_ba").frame(frame_idx):
                st["mx"], st["mx_refs"] = self._dispatch_mixed_window_ba()
        st["phase"] = "ba"

    def _on_indirect_kf(self, k: dict) -> None:
        """Subclass hook: a new indirect keyframe's observation record just
        landed (CalibSlam harvests its correspondences here)."""

    def _indpost_ba(self, st: dict, fetched: list):
        """Tick 2: complete the mixed BA (write-back or rollback), cull
        redundant keyframes, dispatch the local BA: points are always
        refined; the ring's POSES move only when the BA decision picked the
        indirect backend."""
        if st["mx"] is not None:
            with self.sheet.timer("time_mixed_ba").frame(st["frame_idx"]):
                self._complete_mixed_window_ba(st["mx"], fetched)
        self._cull_redundant_keyframes()
        st["lb"] = st["lb_refs"] = None
        if len(self._ind_kfs) >= 3:
            with self.sheet.timer("time_local_ba").frame(st["frame_idx"]):
                st["lb"], st["lb_refs"] = self._dispatch_indirect_local_ba(
                    move_poses=(st["ba_mode"] == Mode.INDIRECT))
        st["phase"] = "local"

    def _indpost_local(self, st: dict, fetched: list):
        """Tick 3: the local BA's write-back; the event is done."""
        if st["lb"] is not None:
            with self.sheet.timer("time_local_ba").frame(st["frame_idx"]):
                self._complete_indirect_local_ba(st["lb"], fetched)
        self._indpost = None

    # -- checkpoint / resume -------------------------------------------------

    def _ckpt_extra(self) -> dict:
        """The indirect state, as the JAX package's _ckpt_extra keeps it,
        plus what this port's next frames read besides: the last finalized
        mode, the decisions' and the checker's windows, the second local-map
        pass in flight (dispatched at this frame, consumed in the next one's
        finalize), and a staged postprocess tick in flight (the JAX package
        completes it before saving, which changes the run that saved). The
        tick's references into live state (the local BA's ring entries, the
        mixed BA's window swap) are saved as what they point at."""
        extra = super()._ckpt_extra()
        extra.update({
            "pt_arrays": {k: getattr(self, k).copy() for k in HYBRID_ARENA},
            "ind_kfs": self._ind_kfs,
            "kf_store": self._kf_store,
            "last_kf": (None if self._last_kf_feats is None else
                        (self._last_kf_feats, self._last_kf_T, self._last_kf_idx)),
            "ref_kf_tracked": self._ref_kf_tracked,
            "mode_history": self.mode_history,
            "last_mode": self._last_mode,
            "pass2": self._pass2,
            "last_pass2": self._last_pass2,
            "decisions": (self.pose_decision, self.ba_decision, self.checker),
            "indpost": self._indpost_for_ckpt(),
        })
        return extra

    def _indpost_for_ckpt(self) -> dict | None:
        st = self._indpost
        if st is None:
            return None
        st = dict(st)
        if st.get("mx") is not None:
            st["mx"] = {**st["mx"], "window_swapped": self._window.ba is st["mx"]["new_ba"]}
        if st.get("lb") is not None:
            pos = {id(k): i for i, k in enumerate(self._ind_kfs)}
            st["lb"] = {**st["lb"], "kfs": [pos.get(id(k), k) for k in st["lb"]["kfs"]]}
        return st

    def _indpost_from_ckpt(self, st: dict | None) -> dict | None:
        if st is None:
            return None
        if st.get("mx") is not None:
            mx = dict(st["mx"])
            if mx.pop("window_swapped"):
                mx["new_ba"] = self._window.ba
            st["mx"] = mx
        if st.get("lb") is not None:
            st["lb"]["kfs"] = [self._ind_kfs[k] if isinstance(k, int) else k
                               for k in st["lb"]["kfs"]]
        return st

    def _ckpt_restore_extra(self, extra: dict) -> None:
        super()._ckpt_restore_extra(extra)
        for k, v in extra["pt_arrays"].items():
            setattr(self, k, v)
        self._ind_kfs = extra["ind_kfs"]
        self._kf_store = extra["kf_store"]
        if extra["last_kf"] is not None:
            self._last_kf_feats, self._last_kf_T, self._last_kf_idx = extra["last_kf"]
        self._ref_kf_tracked = extra["ref_kf_tracked"]
        self.mode_history = extra["mode_history"]
        self._last_mode = extra["last_mode"]
        self._pass2 = extra["pass2"]
        self._last_pass2 = extra["last_pass2"]
        self.pose_decision, self.ba_decision, self.checker = extra["decisions"]
        self._indpost = self._indpost_from_ckpt(extra.get("indpost"))
        self._map_dev = None
        # the BoW retrieval index is rebuilt from the keyframe store with the
        # port's vocabulary; its adds wait for the first query, as they do
        # in an uninterrupted run
        self._kfdb = KeyframeDatabase(default_vocabulary()) if self._kf_store else None
        self._kfdb_pending = list(self._kf_store)

    # -- relocalization ------------------------------------------------------

    def _add_reloc_keyframe(self, match_idx: np.ndarray, pt_idx: np.ndarray,
                            fdesc: np.ndarray, fvalid: np.ndarray, fuv: np.ndarray,
                            kf_id: int):
        """Store this keyframe for BoW relocalization: its features and the
        feature -> map-slot association (reference:
        Relocalization::addKeyFrame). The inverted-file add waits for the
        first query (_drain_kfdb)."""
        if self._kfdb is None:
            self._kfdb = KeyframeDatabase(default_vocabulary())
        self._kfdb_pending.append(kf_id)
        n = fdesc.shape[0]
        feat2slot = np.full((n,), -1, np.int64)
        feat2gen = np.zeros((n,), np.int64)
        fidx = match_idx[pt_idx]
        feat2slot[fidx] = pt_idx
        feat2gen[fidx] = self._pt_gen[pt_idx]
        self._kf_store[kf_id] = {"desc": fdesc, "uv": fuv, "valid": fvalid,
                                 "feat2slot": feat2slot, "feat2gen": feat2gen}

    def _drain_kfdb(self):
        """Index the keyframes whose BoW add was deferred."""
        if not self._kfdb_pending:
            return
        if self._kfdb is None:
            self._kfdb = KeyframeDatabase(default_vocabulary())
        dev = self.device
        for kf_id in self._kfdb_pending:
            st = self._kf_store.get(kf_id)
            if st is not None:
                self._kfdb.add(kf_id, _t(st["desc"], dev), _t(st["valid"], dev))
        self._kfdb_pending.clear()

    def _attempt_relocalization(self, pyr, timestamp) -> bool:
        """BoW candidate retrieval -> descriptor matching -> VFC -> EPnP
        RANSAC absolute pose -> restart the window anchored at the recovered
        pose, keeping the indirect map (reference: Relocalization candidates
        + EPnP.h:129; the failure loop of Hybrid.cpp:214-222)."""
        self._complete_indpost()   # settle the keyframe store first
        if not self._kf_store:
            return False
        self._drain_kfdb()
        if self._kfdb is None:
            return False
        dev = self.device
        feats = _extract(pyr[0][..., 0], self.orb_budget, self.orb_levels)
        for kf_id, score in self._kfdb.query(feats.desc, feats.valid, max_results=3):
            st = self._kf_store.get(kf_id)
            if st is None:
                continue
            m = match_descriptors(feats.desc, feats.valid, _t(st["desc"], dev),
                                  _t(st["valid"], dev))
            # VFC on the match displacement field (reference: VFC.h:124):
            # descriptor-only matches carry gross outliers
            if "uv" in st and int(m.num) >= 24:
                m.valid = vfc_filter(feats.uv, _t(st["uv"], dev)[m.idx], m.valid)
            mi, mv = host_fetch([m.idx, m.valid])
            slots = st["feat2slot"][mi]
            safe = np.maximum(slots, 0)
            sel = (mv & (slots >= 0) & self._pt_valid[safe]
                   & (self._pt_gen[safe] == st["feat2gen"][mi]))
            log.info("relocalization candidate %d (score %.3f): %d matches, %d after VFC, "
                     "%d on live map points", kf_id, score, int(m.num), int(mv.sum()),
                     int(sel.sum()))
            if sel.sum() < 16:
                continue
            Xw = np.zeros((len(mi), 3), np.float32)
            Xw[sel] = self._pt_Xw[slots[sel]]
            gen = torch.Generator(device=dev).manual_seed(self.frame_idx)
            res = epnp_ransac(_t(Xw, dev), feats.uv, _t(sel, dev), self.cam, generator=gen)
            log.info("relocalization candidate %d: EPnP %d inliers", kf_id,
                     int(res.num_inliers))
            if bool(res.ok) and np.isfinite(res.T.t.cpu().numpy()).all():
                self._reloc_restart = True
                self._restart_segment(pyr, timestamp, res.T)
                return True
        return False

    def _restart_segment(self, pyr, timestamp, anchor: SE3):
        """Restart the direct spine. The indirect map survives only a restart
        anchored by relocalization (same world frame); a blind restart breaks
        the world frame, so the map, ring and retrieval index restart too
        (reference: Map reset on restart, AbstractSlam.cpp:98-104)."""
        keep_map = self._reloc_restart
        self._reloc_restart = False
        # the in-flight tick and second pass refer to the state torn down here
        self._indpost = None
        self._pass2 = None
        self._last_pass2 = None
        super()._restart_segment(pyr, timestamp, anchor)
        self._ind_kfs = []
        self._last_kf_feats = None
        self._last_kf_T = None
        self._ref_kf_tracked = 1
        if not keep_map:
            self._pt_valid[:] = False
            self._map_dev = None
            self._kf_store.clear()
            self._kfdb_pending.clear()
            if self._kfdb is not None:
                self._kfdb = KeyframeDatabase(self._kfdb.voc)

    # -- mixed BA --------------------------------------------------------------

    def _build_mixed_factors(self):
        """Fixed-capacity reprojection factors linking the indirect map to the
        window's keyframe slots: every map point with >= 3 live observations
        among the window's keyframes is anchored (corner pixel + inverse
        depth) in its oldest observing slot, its other observations within a
        5 sigma gate become residual targets, and it needs two of them.
        Returns (IndirectFactors, host slots (Q,), map slots (Q,)) or Nones."""
        F = self._window.ba.num_frames
        fids, fvalid, R, t = self._window_host()
        slot_of = {int(fids[s]): s for s in range(F) if fvalid[s] and fids[s] >= 0}
        obs: dict[int, list] = {}
        for k in self._ind_kfs:
            s = slot_of.get(int(k["kf_id"]))
            if s is None:
                continue
            live = (self._pt_gen[k["obs_point"]] == k["obs_gen"]) & self._pt_valid[k["obs_point"]]
            for p, uv, s2 in zip(k["obs_point"][live], k["obs_uv"][live],
                                 k["obs_sigma2"][live]):
                obs.setdefault(int(p), []).append((s, uv, float(s2)))
        items = [(p, o) for p, o in obs.items() if len(o) >= 3]
        if len(items) < 24:
            return None, None, None
        Q = self.cfg.mixed_points
        items = items[:Q]

        uv_a = np.zeros((Q, 2), np.float32)
        host = np.zeros((Q,), np.int32)
        rho = np.ones((Q,), np.float32)
        pvalid = np.zeros((Q,), bool)
        obs_uv = np.zeros((Q, F, 2), np.float32)
        obs_valid = np.zeros((Q, F), bool)
        sigma2 = np.ones((Q, F), np.float32)
        map_slots = np.full((Q,), -1, np.int64)
        gate_px = 5.0   # drop gross outlier matches before the solve
        fx, fy, cx, cy = self.cam.fx, self.cam.fy, self.cam.cx, self.cam.cy
        for qi, (p, o) in enumerate(items):
            hs, huv, _ = o[0]       # the oldest observation anchors the point
            Xh = R[hs] @ self._pt_Xw[p] + t[hs]
            if Xh[2] <= 0.05:
                continue
            uv_a[qi] = huv
            host[qi] = hs
            rho[qi] = 1.0 / Xh[2]
            for s, uv, s2 in o[1:]:
                Xs = R[s] @ self._pt_Xw[p] + t[s]
                if Xs[2] <= 0.05:
                    continue
                pu = fx * Xs[0] / Xs[2] + cx
                pv = fy * Xs[1] / Xs[2] + cy
                if (pu - uv[0]) ** 2 + (pv - uv[1]) ** 2 > gate_px ** 2 * s2:
                    continue
                obs_uv[qi, s] = uv
                obs_valid[qi, s] = True
                sigma2[qi, s] = s2
            # one non-anchor observation barely constrains the idepth
            pvalid[qi] = obs_valid[qi].sum() >= 2
            map_slots[qi] = p if pvalid[qi] else -1

        if pvalid.sum() < 24:
            return None, None, None
        dev = self.device
        ind = ba_mod.IndirectFactors(
            uv=_t(uv_a, dev), host=_t(host, dev), idepth=_t(rho, dev),
            point_valid=_t(pvalid, dev), obs_uv=_t(obs_uv, dev),
            obs_valid=_t(obs_valid, dev), sigma2=_t(sigma2, dev))
        return ind, host, map_slots

    def _dispatch_mixed_window_ba(self):
        """MOD-SLAM mixed BA (reference: addIndirectToProblem,
        DSOBundleAdjustment.cpp:2674-2700): the joint solve's state replaces
        the window at once; _complete_mixed_window_ba validates its energy
        and rolls it back when it diverged. Returns (state, refs to fetch)
        or (None, None)."""
        ind, host, map_slots = self._build_mixed_factors()
        if ind is None:
            return None, None
        w = self._window
        new_ba, piv, E, Xh_dev, kf_T, Ep0, Ep1 = _mixed_ba_dispatch(
            w.ba, w.images, self.cam, self.cfg, ind, self._kf_slot)
        self._window = w.replace(ba=new_ba)
        # the promoted keyframe's pose may have moved: refresh the handle and
        # the tracker reference
        self._kf_T = kf_T
        self._rebuild_tracker_ref()
        mx = {"w_old": w, "new_ba": new_ba, "host": host, "map_slots": map_slots}
        refs = [E, piv, new_ba.T.R, new_ba.T.t, new_ba.frame_valid, Xh_dev, Ep0, Ep1]
        return mx, refs

    def _complete_mixed_window_ba(self, mx: dict, fetched: list):
        """Energy validation (with the photometric rollback guard), host
        cache refresh, map-point writeback, keyframe-ring pose refresh."""
        E_np, piv, R, t, fvalid, Xh, Ep0, Ep1 = fetched
        # reject a diverged (non-finite) solve, or one that traded away too
        # much photometric energy: the tracking reference is built from this
        # window
        if not np.isfinite(E_np) or not np.isfinite(Ep1) \
                or Ep1 > self.cfg.mixed_photo_guard * max(float(Ep0), 1e-6):
            self.sheet.push("mixed_ba_rollback", self.frame_idx, 1.0)
            if self._window.ba is mx["new_ba"]:
                self._window = self._window.replace(ba=mx["w_old"].ba)
                self._kf_T = mx["w_old"].ba.T.index(self._kf_slot)
                self._rebuild_tracker_ref()
            return
        fids = self._window.frame_id.cpu().numpy()
        self._win_host = (fids, fvalid, R, t)
        self._win_host_ref = mx["new_ba"]
        self._sync_kf_poses()
        # tracking continuity snaps to the refreshed keyframe pose (pipelined
        # frames already extend past it)
        if not self._pending:
            self._T_curr = self._kf_T

        # refined points back to the world: X_w = R_h^T (unproject - t_h)
        host, map_slots = mx["host"], mx["map_slots"]
        ok = piv & (map_slots >= 0)
        if ok.any():
            hs = host[ok]
            Xw = np.einsum("qji,qj->qi", R[hs], Xh[ok] - t[hs])
            self._pt_Xw[map_slots[ok]] = Xw.astype(np.float32)
            mids = self._pt_mapid[map_slots[ok]]
            self.map.p_xyz[mids[mids >= 0]] = Xw[mids >= 0]
            self._map_dev = None
        # the ring's poses follow the window, so the next local BA starts
        # consistent
        slot_of = {int(fids[s]): s for s in range(len(fids)) if fvalid[s] and fids[s] >= 0}
        for k in self._ind_kfs:
            s = slot_of.get(int(k["kf_id"]))
            if s is not None:
                k["T_R"], k["T_t"] = R[s], t[s]

    # -- local BA ----------------------------------------------------------------

    def _cull_redundant_keyframes(self):
        """Redundancy-based keyframe culling (reference:
        indirect/Mapping.cpp:97): drop a keyframe when >= 90 % of its points
        are seen by >= 3 other keyframes (the two newest always stay)."""
        if len(self._ind_kfs) < 6:
            return
        counts: Counter = Counter()
        id_sets = []
        for k in self._ind_kfs:
            ids = set(k["obs_mapid"][k["obs_mapid"] >= 0].tolist())
            id_sets.append(ids)
            counts.update(ids)
        kept = []
        for k, ids in zip(self._ind_kfs[:-2], id_sets[:-2]):
            redundant = sum(1 for i in ids if counts[i] >= 4) / len(ids) if ids else 1.0
            if redundant >= 0.9:
                for i in ids:
                    counts[i] -= 1
                self._kf_store.pop(k["frame"], None)
                if k["frame"] in self._kfdb_pending:
                    self._kfdb_pending.remove(k["frame"])
                if self._kfdb is not None:
                    self._kfdb.remove(k["frame"])
            else:
                kept.append(k)
        self._ind_kfs = kept + self._ind_kfs[-2:]

    def _select_local_keyframes(self) -> list[dict]:
        """The newest indirect keyframe plus the KF_RING-1 keyframes sharing
        the most map points with it (at least 10), in frame order (reference:
        indirectUpdateLocalKeyFrames, Tracking.cpp:527)."""
        if not self._ind_kfs:
            return []
        newest = self._ind_kfs[-1]
        ref_ids = set(newest["obs_mapid"][newest["obs_mapid"] >= 0].tolist())
        scored = []
        for k in self._ind_kfs[:-1]:
            ids = k["obs_mapid"][k["obs_mapid"] >= 0]
            shared = len(ref_ids.intersection(ids.tolist()))
            if shared >= 10:
                scored.append((shared, k))
        scored.sort(key=lambda x: -x[0])
        sel = [k for _, k in scored[: KF_RING - 1]] + [newest]
        sel.sort(key=lambda k: k["frame"])   # chronological: frame 0 is fixed
        return sel

    def _dispatch_indirect_local_ba(self, move_poses: bool = False):
        """Assemble the local BA problem from the covisibility-selected
        keyframes and solve it (reference:
        IndirectBundleAdjustment::localOptimize). Observations whose slot was
        recycled (generation mismatch) or whose point died are dropped.
        Returns (state, refs to fetch) or (None, None)."""
        kfs = self._select_local_keyframes()
        if len(kfs) < 3:
            return None, None
        live = [(self._pt_gen[k["obs_point"]] == k["obs_gen"]) & self._pt_valid[k["obs_point"]]
                for k in kfs]
        used_pts = np.unique(np.concatenate([k["obs_point"][lv] for k, lv in zip(kfs, live)]))
        if used_pts.size < 10:
            return None, None
        N = int(used_pts.size)
        remap = -np.ones(MAP_CAP, np.int64)
        remap[used_pts] = np.arange(N)
        obs_f = np.concatenate([np.full(int(lv.sum()), fi, np.int32)
                                for fi, lv in enumerate(live)])
        obs_p = np.concatenate([remap[k["obs_point"][lv]] for k, lv in zip(kfs, live)])
        obs_uv = np.concatenate([k["obs_uv"][lv] for k, lv in zip(kfs, live)])
        obs_s2 = np.concatenate([k["obs_sigma2"][lv] for k, lv in zip(kfs, live)])
        M = len(kfs)
        dev = self.device
        prob = iba.IndirectBAProblem(
            T=SE3(R=_t(np.stack([k["T_R"] for k in kfs]).astype(np.float32), dev),
                  t=_t(np.stack([k["T_t"] for k in kfs]).astype(np.float32), dev)),
            frame_valid=torch.ones((M,), dtype=torch.bool, device=dev),
            frame_fixed=_t(np.arange(M) == 0, dev),
            Xw=_t(self._pt_Xw[used_pts], dev),
            point_valid=_t(self._pt_valid[used_pts], dev),
            obs_frame=_t(obs_f, dev),
            obs_point=_t(obs_p.astype(np.int32), dev),
            obs_uv=_t(obs_uv.astype(np.float32), dev),
            obs_valid=torch.ones((len(obs_f),), dtype=torch.bool, device=dev),
            obs_sigma2=_t(obs_s2.astype(np.float32), dev),
        )
        out = iba.run_local_ba(prob, self.cam)
        lb = {"used_pts": used_pts, "kfs": kfs, "move_poses": move_poses}
        return lb, [out.Xw, out.T.R, out.T.t]

    def _complete_indirect_local_ba(self, lb: dict, fetched: list):
        """Write the optimized points back into the arena and, with
        move_poses, the poses into the keyframe ring (the exported trajectory
        stays anchored to the photometric window)."""
        Xw_new, R_new, t_new = fetched
        used_pts, kfs = lb["used_pts"], lb["kfs"]
        if not np.isfinite(Xw_new).all():
            return
        self._pt_Xw[used_pts] = Xw_new
        mids = self._pt_mapid[used_pts]
        self.map.p_xyz[mids[mids >= 0]] = Xw_new[mids >= 0]
        self._map_dev = None
        if lb["move_poses"]:
            for fi, k in enumerate(kfs):
                k["T_R"], k["T_t"] = R_new[fi], t_new[fi]
