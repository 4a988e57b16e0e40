"""Direct (DSO-style) visual odometry runtime: the per-frame driver loop.

PyTorch port of libcml_tpu/runtime/odometry.py, sequential and pipelined
(the reference's Hybrid direct path + AbstractSlam run loop:
src/cml/slam/modslam/Hybrid.cpp:90 run, :167 processFrame,
direct/Mapping.cpp:47 directMap, direct/Tracking.cpp:4 directNeedNewKeyFrame).

All dense math — pyramid, point selection, tracking, tracing, windowed
photometric BA, marginalization pieces — runs as tensor code on the
runtime's device over fixed-capacity arenas; the host owns the scalar state
machine (init/track/keyframe decisions), the f64 marginalization algebra and
trajectory bookkeeping. The JAX package's per-frame `lax.cond`s (recovery
battery, pose-gated tracing) are host branches here: the frame step reads
one small bundle of scalars from the device per frame. In pipelined mode
that bundle's copy starts when the frame is dispatched and the state
machine reads it one frame later; a keyframe tracks the frame in flight
again against its fresh reference (_retrack_step).

Non-keyframe poses are stored RELATIVE to their reference keyframe and
composed with the keyframe's final optimized pose at export (the one-anchor
form of the reference's deform graph, Frame.cpp:51-92).
"""

from __future__ import annotations

import copy
import dataclasses
import pickle

import numpy as np
import torch

from libcml_tpu_torch._device import resolve_device
from libcml_tpu_torch.core.camera import Calibration, PinholeCamera
from libcml_tpu_torch.core.lie import SE3, se3_select
from libcml_tpu_torch.map.map import SlamMap
from libcml_tpu_torch.models.direct import ba as ba_mod
from libcml_tpu_torch.models.direct import window as win_mod
from libcml_tpu_torch.models.direct.config import DirectConfig
from libcml_tpu_torch.models.direct.initializer import (
    normalize_scale,
    set_first,
    try_initialize,
)
from libcml_tpu_torch.models.direct.selector import select_points, select_points_plain
from libcml_tpu_torch.models.direct.tracer import (
    ImmatureArena,
    empty_immatures,
    mature_mask,
    seed_immatures,
    seed_immatures_plain,
    trace_immatures_rows,
)
from libcml_tpu_torch.models.direct.tracker import (
    TrackerRef,
    make_tracker_ref_plain,
    motion_hypotheses,
    track,
    track_multi,
)
from libcml_tpu_torch.ops.image import (
    apply_photometric,
    build_gradient_pyramid,
    remap_image,
)
from libcml_tpu_torch.ops.kf_programs import (
    kf_activate_cuda,
    refresh_cuda,
    rho_range_cuda,
    tracker_ref_cuda,
)
from libcml_tpu_torch.parallel import sharding
from libcml_tpu_torch.runtime.stats import StatsSheet
from libcml_tpu_torch.utils import logging as log


def _rss_mb() -> float:
    """Current process resident-set size in MB (Linux /proc; 0 elsewhere)."""
    try:
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
        import resource

        return pages * resource.getpagesize() / 1e6
    except (OSError, ValueError, IndexError):
        return 0.0


class HostCopy:
    """A device-to-host copy of several tensors (None allowed) in ONE
    transfer, started now and read later: their bytes are packed into one
    flat uint8 tensor on the device and copied without blocking into pinned
    host memory behind a CUDA event; `result()` waits on the event and splits
    the buffer into numpy arrays. This is the pipelined modes' lag: a frame's
    bundle is queued at dispatch and read one frame later, when it is long
    done. On the CPU the copy is immediate."""

    def __init__(self, tensors):
        self.refs = list(tensors)
        live = [t for t in self.refs if t is not None]
        self._event = None
        if not live:
            self._buf = None
            return
        flat = torch.cat([t.detach().contiguous().reshape(-1).view(torch.uint8)
                          for t in live])
        if flat.is_cuda:
            self._buf = torch.empty(flat.shape, dtype=torch.uint8, pin_memory=True)
            self._buf.copy_(flat, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._buf = flat.clone()

    def result(self) -> list:
        if self._event is not None:
            self._event.synchronize()
        flat = None if self._buf is None else self._buf.numpy()
        out, off = [], 0
        for t in self.refs:
            if t is None:
                out.append(None)
                continue
            nbytes = t.numel() * t.element_size()
            np_dtype = torch.empty(0, dtype=t.dtype).numpy().dtype
            out.append(flat[off:off + nbytes].view(np_dtype).reshape(tuple(t.shape)).copy())
            off += nbytes
        return out

    def same(self, tensors) -> bool:
        """Whether this copy was taken of exactly these tensor objects."""
        tensors = list(tensors)
        return len(tensors) == len(self.refs) and all(a is b for a, b in zip(tensors, self.refs))


def host_fetch(tensors) -> list:
    """numpy copies of `tensors` (a sequence of tensors or None) in ONE
    device-to-host transfer (HostCopy, read at once)."""
    return HostCopy(tensors).result()


class OnDevice:
    """A device tensor's value in a checkpoint: a numpy array that
    `to_device` turns back into a tensor on the loading instance's device."""

    __slots__ = ("array",)

    def __init__(self, array: np.ndarray):
        self.array = array


def _map_tree(obj, leaf):
    """`obj` with `leaf` applied to every tensor and OnDevice inside its
    dicts, lists, tuples and dataclasses (copied, never changed in place)."""
    if isinstance(obj, (torch.Tensor, OnDevice)):
        return leaf(obj)
    if isinstance(obj, dict):
        return {k: _map_tree(v, leaf) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)) and not hasattr(obj, "_fields"):
        return type(obj)(_map_tree(v, leaf) for v in obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        out = copy.copy(obj)
        for f in dataclasses.fields(obj):
            object.__setattr__(out, f.name, _map_tree(getattr(obj, f.name), leaf))
        return out
    return obj


def to_host(obj):
    """Every tensor in `obj` as an OnDevice numpy array (one device-to-host
    copy each)."""
    return _map_tree(obj, lambda t: OnDevice(t.detach().cpu().numpy()))


def to_device(obj, device: torch.device):
    """Every OnDevice array (and tensor) in `obj` as a tensor on `device`."""
    return _map_tree(obj, lambda a: torch.as_tensor(
        a.array if isinstance(a, OnDevice) else a).to(device))


# ---------------------------------------------------------------------------
# Device programs
# ---------------------------------------------------------------------------


def _preprocess(image: torch.Tensor, num_levels: int):
    return build_gradient_pyramid(image, num_levels)


def _preprocess_rect(image: torch.Tensor, remap, gamma, vignette, num_levels: int):
    """Photometric correction (response inversion + vignette divide, in RAW
    pixel space), geometric rectification through the remap grid, then the
    gradient pyramid (reference: TUMCapture.cpp:19-131 +
    InternalCalibration.h:342)."""
    img = apply_photometric(image, gamma, vignette)
    if remap is not None:
        img = remap_image(img, remap)
    return img, build_gradient_pyramid(img, num_levels)


def _frame_step(
    grad_pyr,
    cam: PinholeCamera,
    ref,
    immature: ImmatureArena,
    ba_T: SE3,
    ba_frame_valid: torch.Tensor,
    kf_T: SE3,
    T_curr: SE3,
    T_prev: SE3,
    T_seed: SE3 | None,
    use_seed: torch.Tensor | None,
    recent_rows: torch.Tensor,
    ab_init: torch.Tensor,
    cfg: DirectConfig,
):
    """The per-frame fast path: motion-model prediction, single track,
    suspect test + conditional multi-hypothesis battery, pose-ok gating,
    world-pose composition, and immature tracing.

    `T_seed` (the hybrid's PnP pose) joins the recovery battery where the
    device scalar `use_seed` is true (a torch.where selection, no host read);
    otherwise the battery gets the motion-model prediction twice.

    Returns (immature', T_world, T_rel, ab, scalars (27,) on the device):
        scalars = [num_valid, saturated, flow, energy, ok, suspect,
                   cov_rot_diag x3, kf_score, n_ref, T_rel.R (9),
                   T_rel.t (3), ab (2), motion_dt, motion_ang]
    """
    T_delta = T_curr.compose(T_prev.inverse())
    T_pred_world = T_delta.compose(T_curr)
    T_init = T_pred_world.compose(kf_T.inverse())
    T_zero = T_curr.compose(kf_T.inverse())
    # an external seed (the hybrid's PnP pose) joins the recovery battery
    T_seed_rel = T_init if T_seed is None else se3_select(
        use_seed, T_seed.compose(kf_T.inverse()), T_init)
    ab0 = ab_init

    res0 = track(grad_pyr, cam, ref, T_init, ab0, cfg)
    finite0 = torch.all(torch.isfinite(res0.T_ji.t))
    suspect_t = (
        (res0.num_valid < 24)
        | (res0.saturated >= 0.5 * cfg.fail_saturated)
        | ~finite0
    )
    suspect = bool(suspect_t)          # host branch (one read per frame)
    res = track_multi(
        grad_pyr, cam, ref,
        motion_hypotheses(T_init, T_zero, T_extra=T_seed_rel), ab0, cfg,
    ) if suspect else res0

    finite = torch.all(torch.isfinite(res.T_ji.t)) & torch.all(torch.isfinite(res.T_ji.R))
    pose_ok_t = (res.num_valid >= 24) & finite & (res.saturated < cfg.fail_saturated)
    T_world = se3_select(
        pose_ok_t,
        res.T_ji.compose(kf_T).normalized(),
        T_pred_world.normalized(),
    )
    T_rel = T_world.compose(kf_T.inverse())

    pose_ok = bool(pose_ok_t)
    if pose_ok:
        immature = trace_immatures_rows(immature, recent_rows, ba_T, ba_frame_valid,
                                        grad_pyr[0], T_world, cam, cfg)

    scalars = _scalar_bundle(res, pose_ok_t, suspect_t, T_world, T_rel, T_curr, ref, cam, cfg)
    return immature, T_world, T_rel, res.ab, scalars


def _scalar_bundle(res, pose_ok_t, suspect_t, T_world: SE3, T_rel: SE3, T_from: SE3, ref,
                   cam: PinholeCamera, cfg: DirectConfig) -> torch.Tensor:
    """A tracked frame's (27,) scalar bundle (see _frame_step); the motion
    magnitudes are measured from `T_from`."""
    cov_rot = torch.diagonal(res.cov_pose)[3:6]
    # resolution-normalized keyframe score (reference:
    # direct/Tracking.cpp:28-41; a is log-scale so |a| == |log ratio|)
    flow_t = torch.sqrt(torch.clamp(res.flow ** 2 - res.flow_no_trans ** 2, min=0.0))
    wh = float(cam.width + cam.height)
    kf_score = ((cfg.kf_shift_weight_t * flow_t + cfg.kf_shift_weight_rt * res.flow) / wh
                + cfg.kf_affine_weight * torch.abs(res.ab[0]))
    n_ref = torch.sum(ref.valid[0]).float()
    mo_R = T_world.R @ T_from.R.T
    mo_ang = torch.arccos(torch.clamp((torch.trace(mo_R) - 1.0) / 2.0, -1.0, 1.0))
    mo_dt = torch.linalg.norm(T_world.t - mo_R @ T_from.t)
    f = torch.float32
    return torch.cat([
        torch.stack([res.num_valid.to(f), res.saturated.to(f), res.flow.to(f),
                     res.energy.to(f), pose_ok_t.to(f), suspect_t.to(f)]),
        cov_rot.to(f),
        torch.stack([kf_score.to(f), n_ref]),
        T_rel.R.reshape(-1).to(f),
        T_rel.t.reshape(-1).to(f),
        res.ab.reshape(-1).to(f),
        torch.stack([mo_dt, mo_ang]).to(f),
    ])


def _retrack_step(grad_pyr, cam: PinholeCamera, ref, kf_T: SE3, T_world_prev: SE3,
                  ab_init: torch.Tensor, ab_shift: torch.Tensor, cfg: DirectConfig):
    """Re-track ONE in-flight pipelined frame against a just-created
    keyframe's fresh reference. At lag 1 a frame dispatched before the
    keyframe event tracked the OLD reference; tracking it again against the
    new one (its first-dispatch world pose as the start) makes the pipelined
    mode tracking-equivalent to the sequential one. Its immature trace from
    the first dispatch stands and is not repeated. The same suspect test and
    recovery battery as _frame_step guard it. Returns (T_world, T_rel, ab,
    scalars) in _frame_step's bundle layout."""
    T_init = T_world_prev.compose(kf_T.inverse())
    ab_init = ab_init - ab_shift        # rebase ab onto the NEW reference frame
    res0 = track(grad_pyr, cam, ref, T_init, ab_init, cfg)
    finite0 = torch.all(torch.isfinite(res0.T_ji.t))
    suspect_t = (
        (res0.num_valid < 24)
        | (res0.saturated >= 0.5 * cfg.fail_saturated)
        | ~finite0
    )
    res = track_multi(grad_pyr, cam, ref, motion_hypotheses(T_init, T_init), ab_init,
                      cfg) if bool(suspect_t) else res0
    finite = torch.all(torch.isfinite(res.T_ji.t)) & torch.all(torch.isfinite(res.T_ji.R))
    pose_ok_t = (res.num_valid >= 24) & finite & (res.saturated < cfg.fail_saturated)
    T_world = se3_select(
        pose_ok_t,
        res.T_ji.compose(kf_T).normalized(),
        T_world_prev.normalized(),
    )
    T_rel = T_world.compose(kf_T.inverse())
    scalars = _scalar_bundle(res, pose_ok_t, suspect_t, T_world, T_rel, kf_T, ref, cam, cfg)
    return T_world, T_rel, res.ab, scalars


def _window_points_in_frame(window: win_mod.Window, slot, cam: PinholeCamera,
                            cfg: DirectConfig):
    """Warp every valid window point into frame `slot`: the tracker's
    semi-dense reference set (replaces makeCoarseDepthL0, reference
    DSOTracker.cpp:494, with a point-set view), with a 4x4-cell z-buffer
    keeping only points within 25% depth of the nearest in their cell."""
    ba = window.ba
    T_l = ba.T.index(slot)
    X_h = cam.unproject(ba.uv, ba.idepth)
    host = ba.host.long()
    R_h = ba.T.R[host]
    t_h = ba.T.t[host]
    X_w = torch.einsum("pji,pj->pi", R_h, X_h - t_h)   # R_h^T (X_h - t_h)
    X_l = X_w @ T_l.R.T + T_l.t
    uv_l, z_ok = cam.project(X_l)
    ok = ba.point_valid & z_ok & cam.in_bounds(uv_l, border=3.0) & (X_l[..., 2] > 1e-4)
    rho_l = 1.0 / torch.clamp(X_l[..., 2], min=1e-4)

    cell = 4
    Wc = (cam.width + cell - 1) // cell
    Hc = (cam.height + cell - 1) // cell
    # f32 -> int32 truncates toward zero, as XLA's convert does (NaN -> 0)
    ui = torch.nan_to_num(uv_l, nan=0.0).to(torch.int32)
    cx = torch.clamp(torch.div(ui[:, 0], cell, rounding_mode="floor"), 0, Wc - 1)
    cy = torch.clamp(torch.div(ui[:, 1], cell, rounding_mode="floor"), 0, Hc - 1)
    cid = (cy * Wc + cx).long()
    rho_for_max = torch.where(ok, rho_l, torch.zeros_like(rho_l))
    cell_max_rho = torch.zeros((Wc * Hc,), dtype=rho_l.dtype, device=rho_l.device)
    cell_max_rho = cell_max_rho.scatter_reduce(0, cid, rho_for_max, reduce="amax",
                                               include_self=True)
    ok = ok & (rho_l > 0.8 * cell_max_rho[cid])
    return uv_l, rho_l, ok


def _tracker_ref_in_frame(window: win_mod.Window, slot: int, kf_pyr, cam: PinholeCamera,
                          cfg: DirectConfig) -> TrackerRef:
    """The tracker reference of the window's points in keyframe `slot`
    (_window_points_in_frame, then make_tracker_ref): one launch of the
    hand-written kernel (ops/kf_programs.tracker_ref_cuda) for CUDA
    tensors, _tracker_ref_in_frame_plain for CPU tensors; any other device
    raises."""
    if window.ba.uv.is_cuda:
        return TrackerRef(**tracker_ref_cuda(kf_pyr, cam, cfg, ba=window.ba, slot=int(slot)))
    if window.ba.uv.device.type == "cpu":
        return _tracker_ref_in_frame_plain(window, slot, kf_pyr, cam, cfg)
    raise ValueError(f"_tracker_ref_in_frame: unsupported device {window.ba.uv.device}")


def _tracker_ref_in_frame_plain(window: win_mod.Window, slot, kf_pyr, cam: PinholeCamera,
                                cfg: DirectConfig) -> TrackerRef:
    uv_l, rho_l, ok = _window_points_in_frame(window, slot, cam, cfg)
    return make_tracker_ref_plain(kf_pyr, cam, uv_l, rho_l, ok, cfg)


def _working_rho_range(ba: ba_mod.BAState, cfg: DirectConfig):
    """Median-centred inverse-depth working range [med/8, med*8] of the
    window's valid points (1.0 when there are none): one launch of the
    hand-written kernel (ops/kf_programs.rho_range_cuda) for CUDA tensors,
    _working_rho_range_plain for CPU tensors; any other device raises."""
    if ba.uv.is_cuda:
        return rho_range_cuda(ba, cfg)
    if ba.uv.device.type == "cpu":
        return _working_rho_range_plain(ba, cfg)
    raise ValueError(f"_working_rho_range: unsupported device {ba.uv.device}")


def _working_rho_range_plain(ba: ba_mod.BAState, cfg: DirectConfig):
    """_working_rho_range in plain PyTorch."""
    rho_valid = torch.where(ba.point_valid, ba.idepth, torch.full_like(ba.idepth, torch.nan))
    rho_med = torch.nanquantile(rho_valid, 0.5)
    rho_med = torch.where(torch.isfinite(rho_med), rho_med, torch.ones_like(rho_med))
    rho_lo = torch.clamp(rho_med / 8.0, min=cfg.idepth_min)
    rho_hi = torch.clamp(rho_med * 8.0, max=cfg.idepth_max)
    return rho_lo, rho_hi


def _kf_insert_and_ba(window: win_mod.Window, grad0, T_new: SE3, ab_kf, ab_rel,
                      frame_id, cam: PinholeCamera, cfg: DirectConfig,
                      mesh: sharding.Mesh | None = None):
    """Insert keyframe + run windowed photometric BA + outlier ejection.
    Returns the window, the slot, the BA energy, and the new keyframe's
    OPTIMIZED pose and absolute (a, b)."""
    ab_new = ab_kf + ab_rel       # promoted frame's ab vs the OLD reference
    window, slot = win_mod.add_keyframe(window, grad0, T_new, ab_new, frame_id)
    # fresh Jacobians once per keyframe event (prior shifted exactly)
    window = window.replace(ba=ba_mod.relinearize(window.ba))
    new_ba, energy = ba_mod.run_ba(window.ba, window.images, cam, cfg, mesh)
    new_ba = ba_mod.update_residual_status(new_ba, window.images, cam, cfg, mesh)
    return window.replace(ba=new_ba), slot, energy, new_ba.T.index(slot), ab_new


def _activate_and_clear(window: win_mod.Window, immature: ImmatureArena,
                        cfg: DirectConfig):
    """Activate every matured immature candidate into the BA arena and clear
    them (reference: DSOTracer::activatePoints, DSOTracer.cpp:59): one
    launch of the hand-written kernel (ops/kf_programs.kf_activate_cuda) for
    CUDA tensors, _activate_and_clear_plain for CPU tensors; any other
    device raises."""
    if window.ba.uv.is_cuda:
        new, valid = kf_activate_cuda(window.ba, window.images, cfg, arena=immature)
        return window.replace(ba=window.ba.replace(**new)), immature.replace(valid=valid)
    if window.ba.uv.device.type == "cpu":
        return _activate_and_clear_plain(window, immature, cfg)
    raise ValueError(f"_activate_and_clear: unsupported device {window.ba.uv.device}")


def _activate_and_clear_plain(window: win_mod.Window, immature: ImmatureArena,
                              cfg: DirectConfig):
    """_activate_and_clear in plain PyTorch: mature_mask, then add_points a
    frame slot."""
    ready, rho_mid = mature_mask(immature, cfg)
    for f in range(cfg.max_frames):
        window = win_mod.add_points_plain(window, f, immature.uv[f], rho_mid[f], ready[f], cfg)
    return window, immature.replace(valid=immature.valid & ~ready)


def _refresh_after_kf(window: win_mod.Window, slot, kf_pyr,
                      immature: ImmatureArena, cam: PinholeCamera, cfg: DirectConfig):
    """Post-keyframe refresh: rebuild the tracker reference from the window
    points projected into the new keyframe, and seed fresh immature
    candidates on it (makeCoarseDepthL0 + makeNewTraces): one launch of the
    hand-written kernel (ops/kf_programs.refresh_cuda) for CUDA tensors,
    _refresh_after_kf_plain for CPU tensors; any other device raises."""
    if window.ba.uv.is_cuda:
        ref, arena = refresh_cuda(window.ba, int(slot), kf_pyr, immature, cam, cfg)
        return TrackerRef(**ref), ImmatureArena(**arena)
    if window.ba.uv.device.type == "cpu":
        return _refresh_after_kf_plain(window, slot, kf_pyr, immature, cam, cfg)
    raise ValueError(f"_refresh_after_kf: unsupported device {window.ba.uv.device}")


def _refresh_after_kf_plain(window: win_mod.Window, slot, kf_pyr,
                            immature: ImmatureArena, cam: PinholeCamera, cfg: DirectConfig):
    """_refresh_after_kf in plain PyTorch."""
    ref = _tracker_ref_in_frame_plain(window, slot, kf_pyr, cam, cfg)
    rho_lo, rho_hi = _working_rho_range_plain(window.ba, cfg)
    uv, valid, _ = select_points_plain(kf_pyr[0], cfg.points_per_kf)
    immature = seed_immatures_plain(immature, slot, kf_pyr[0], uv, valid, rho_lo, rho_hi)
    return ref, immature


def _marg_finish(window: win_mod.Window, immature: ImmatureArena,
                 packed, hosted, slot: int, cfg: DirectConfig):
    """Apply a completed asynchronous marginalization: the new prior + state
    drops (ba._marg_apply), the window frame-id slot, and the marginalized
    host's immature candidates."""
    new_ba = ba_mod._marg_apply(window.ba, packed, hosted, slot)
    F = new_ba.num_frames
    ar = torch.arange(F, device=packed.device)
    window = window.replace(
        ba=new_ba,
        frame_id=torch.where(ar == slot, torch.full_like(window.frame_id, -1),
                             window.frame_id),
    )
    immature = immature.replace(valid=immature.valid & (ar != slot)[:, None])
    return window, immature


def _marginalize(window: win_mod.Window, latest_slot, cam: PinholeCamera,
                 cfg: DirectConfig):
    """Synchronous marginalization: slot choice on the device, prior algebra
    in f64 on the host (ba.marginalize_frame_f64)."""
    slot = int(win_mod.choose_marginalization_slot(window, latest_slot))
    new_ba = ba_mod.marginalize_frame_f64(window.ba, window.images, cam, cfg, slot)
    ar = torch.arange(new_ba.num_frames, device=window.frame_id.device)
    return (
        window.replace(
            ba=new_ba,
            frame_id=torch.where(ar == slot, torch.full_like(window.frame_id, -1),
                                 window.frame_id),
        ),
        slot,
    )


# ---------------------------------------------------------------------------
# Host state machine
# ---------------------------------------------------------------------------


class DirectOdometry:
    """Monocular direct odometry over a frame stream.

    Usage:
        odo = DirectOdometry(cam, cfg)            # on the CUDA card
        odo = DirectOdometry(cam, cfg, device="cpu")
        odo = DirectOdometry(cam, cfg, mesh=make_mesh())   # point-sharded BA
        for ts, img in frames: odo.process(img, ts)
        poses = odo.trajectory_c2w()

    With a mesh (parallel/sharding.py) every rank runs this same loop on the
    same frames; the window BA, the outlier pass and the marginalization's
    point sums split the point rows over the ranks, and the state stays
    identical on every rank.
    """

    def __init__(self, cam: PinholeCamera | Calibration,
                 cfg: DirectConfig | None = None, depth_prior=None,
                 pipelined: bool = False, mesh=None,
                 device: str | torch.device | None = None):
        self.device = resolve_device(device)
        dev = self.device
        if mesh is not None:
            if not isinstance(mesh, sharding.Mesh):
                raise TypeError(f"mesh must be a parallel.sharding.Mesh, not {type(mesh)}")
            mesh.check_device(dev)
        self.mesh = mesh
        # a full Calibration carries the rectification remap + photometric
        # response/vignette, applied on the device to every incoming frame
        if isinstance(cam, Calibration):
            self.calib: Calibration | None = cam
            self._calib_dev = tuple(
                None if a is None else torch.as_tensor(a, dtype=torch.float32).to(dev)
                for a in (cam.remap, cam.gamma, cam.vignette))
            cam = cam.pinhole
        else:
            self.calib = None
            self._calib_dev = (None, None, None)
        self.cam = cam
        self.cfg = cfg or DirectConfig()
        # optional inverse-depth prior for initialization (models/direct/prior.py;
        # reference: Hybrid.cpp:469-473): (image, frame_idx, path) -> (H, W) | None
        self.depth_prior = depth_prior
        # pipelined mode: a frame's scalar bundle is read one frame late (a
        # HostCopy started at dispatch), so the card has the next frame queued
        # before the host waits; process() then reports the PREVIOUS frame
        self.pipelined = pipelined
        self._pending: list[dict] = []
        self._pending_marg = None     # in-flight async marginalization
        self._win_count = 0           # host mirror of window occupancy
        self._n_ref = 1
        # the R most-recently-seeded immature rows — the only rows the
        # per-frame tracer sweeps (see trace_immatures_rows)
        self._recent_rows = torch.full(
            (min(self.cfg.trace_recent_rows, self.cfg.max_frames),), -1,
            dtype=torch.int32, device=dev)
        self.state = "INIT_FIRST"
        self.frame_idx = -1

        self._init_state = None
        self._window: win_mod.Window | None = None
        self._tracker_ref = None
        self._immature = empty_immatures(self.cfg.max_frames, self.cfg.points_per_kf, dev)

        self._kf_pyr = None
        self._kf_grad0_prev = None
        self._kf_slot = None
        self._kf_id = None
        self._kf_T = SE3.identity(device=dev)
        self._kf_ab = torch.zeros(2, dtype=torch.float32, device=dev)

        self._T_prev = SE3.identity(device=dev)
        self._T_curr = SE3.identity(device=dev)

        # system-of-record map (reference: Map.h:31)
        self.map = SlamMap()
        self._fid2map: dict[int, int] = {}
        self._cur_gt: np.ndarray | None = None
        self.stats: list[dict] = []
        self.sheet = StatsSheet()
        self._track_fails = 0
        self.segments = 0
        self.stopped = False
        self._anchor_kf = 0
        self._restart_anchor = SE3.identity(device=dev)

    # -- helpers ------------------------------------------------------------

    _GT_UNSET = object()

    def _record(self, ts: float, kf_id: int, T_rel,
                frame_idx: int | None = None, gt=_GT_UNSET):
        """Record a frame's pose in the map, relative to keyframe `kf_id`
        (an SE3 or a host (R, t) pair). Re-recording a frame updates its map
        entry in place."""
        if frame_idx is None:
            frame_idx = self.frame_idx
        gt_c2w = self._cur_gt if gt is self._GT_UNSET else gt
        if isinstance(T_rel, tuple):
            R_np, t_np = T_rel
        else:
            R_np, t_np = T_rel.R.cpu().numpy(), T_rel.t.cpu().numpy()
        M = np.eye(4)
        M[:3, :3] = R_np
        M[:3, 3] = t_np
        ref = self._fid2map.get(kf_id, -1)
        existing = self._fid2map.get(frame_idx)
        if existing is not None:
            self.map.set_pose(existing, M, ref)
        else:
            self._fid2map[frame_idx] = self.map.add_frame(ts, M, ref_frame=ref,
                                                          gt_c2w=gt_c2w)

    def _set_abs_pose(self, frame_idx: int, T: SE3, keyframe: bool = False):
        """Write an ABSOLUTE pose for a frame's map entry (keyframes and
        segment anchors — the roots of deform chains)."""
        i = self._fid2map.get(frame_idx)
        if i is None:
            return
        M = np.eye(4)
        M[:3, :3] = T.R.cpu().numpy()
        M[:3, 3] = T.t.cpu().numpy()
        self.map.set_pose(i, M, -1)
        if keyframe:
            self.map.set_keyframe(i)

    def _window_host(self):
        """Host copy of the window's (frame_id, frame_valid, R, t), cached
        per BA-state object."""
        ba = self._window.ba
        if getattr(self, "_win_host_ref", None) is not ba:
            self._win_host = tuple(x.cpu().numpy() for x in (
                self._window.frame_id, ba.frame_valid, ba.T.R, ba.T.t))
            self._win_host_ref = ba
        return self._win_host

    def _sync_kf_poses(self):
        """Pull optimized keyframe poses out of the window into the map."""
        fids, valid, R, t = self._window_host()
        kf_bit = self.map.groups.frame_group("DIRECTKEYFRAME")
        for s in range(len(fids)):
            if valid[s] and fids[s] >= 0:
                i = self._fid2map.get(int(fids[s]))
                if i is None:
                    continue
                M = np.eye(4)
                M[:3, :3] = R[s]
                M[:3, 3] = t[s]
                self.map.set_pose(i, M, -1)
                self.map.set_keyframe(i)
                self.map.f_group[i] |= np.uint32(kf_bit)
        self._kf_T = self._window.ba.T.index(int(self._kf_slot))

    # -- main entry ----------------------------------------------------------

    def process(self, image, timestamp: float,
                gt_pose_c2w: np.ndarray | None = None,
                exposure: float | None = None) -> dict:
        """Feed one grayscale frame (H, W) in ~[0, 255]. Returns a stats
        dict. `gt_pose_c2w` (4, 4), when available, is stored in the map and
        feeds the live ATE/RPE."""
        self.frame_idx += 1
        log.set_frame(self.frame_idx)
        if self.cfg.memory_limit_mb > 0 and self.frame_idx % 10 == 0:
            rss = _rss_mb()
            self.sheet.push("memory_mb", self.frame_idx, rss)
            if rss > self.cfg.memory_limit_mb:
                log.important("memory limit exceeded (%.0f MB > %d MB): stopping",
                              rss, self.cfg.memory_limit_mb)
                self._flush_pending()
                self.stopped = True
                return {"state": "STOPPED", "memory_mb": rss}
        self._cur_gt = gt_pose_c2w
        self._cur_exposure = exposure
        img = torch.as_tensor(np.asarray(image, np.float32)).to(self.device)
        with self.sheet.timer("time_preprocess").frame(self.frame_idx):
            remap, gamma, vignette = self._calib_dev
            if remap is not None or gamma is not None or vignette is not None:
                img, pyr = _preprocess_rect(img, remap, gamma, vignette,
                                            self.cfg.num_levels)
            else:
                pyr = _preprocess(img, self.cfg.num_levels)

        if self.stopped:
            return {"state": "STOPPED"}

        if self.state == "INIT_FIRST":
            prior = None
            if self.depth_prior is not None:
                # no image path here, as in the JAX package: a prior that
                # needs one (PrecomputedDepthPrior) returns None
                p = self.depth_prior(image, self.frame_idx, None)
                if p is not None and p.shape == (self.cam.height, self.cam.width):
                    prior = torch.as_tensor(np.asarray(p, np.float32)).to(self.device)
            self._init_state = set_first(pyr, self.cam, self.cfg, prior_idepth=prior)
            self._first_pyr = pyr
            self._first_ts = timestamp
            self.state = "INIT"
            self._anchor_kf = self.frame_idx
            self._record(timestamp, self._anchor_kf, SE3.identity(device=self.device))
            self._set_abs_pose(self._anchor_kf, self._restart_anchor)
            return {"state": self.state}

        if self.state == "LOST":
            out = self._process_lost(pyr, timestamp)
            self.stats.append(out)
            return out

        if self.state == "INIT":
            res = try_initialize(self._init_state, pyr, self.cam, self.cfg)
            self._init_state = res.state
            if bool(res.success):
                self._promote_initialization(pyr, timestamp)
                self.state = "TRACKING"
            else:
                self._record(timestamp, self._anchor_kf, res.state.T)
            return {"state": self.state, "init_energy": float(res.energy)}

        return self._track_frame(pyr, img, timestamp)

    # -- phases ---------------------------------------------------------------

    def _promote_initialization(self, pyr, timestamp):
        cfg, cam, dev = self.cfg, self.cam, self.device
        ist, _scale = normalize_scale(self._init_state)

        anchor = self._restart_anchor
        window = win_mod.empty_window(cfg, cam.height, cam.width, dev)
        # KF0 at the segment anchor, KF1 at the initializer pose
        window, slot0 = win_mod.add_keyframe(
            window, self._first_pyr[0], anchor,
            torch.zeros(2, dtype=torch.float32, device=dev), self._anchor_kf)
        window = window.replace(ba=ba_mod.anchor_first_frame(window.ba, 0, cfg))
        window, slot1 = win_mod.add_keyframe(
            window, pyr[0], ist.T.compose(anchor), ist.ab, self.frame_idx)
        # activate the initializer's points, hosted in slot0
        window = win_mod.add_points(window, slot0, ist.uv, ist.idepth, ist.valid[0], cfg)
        new_ba, _ = ba_mod.run_ba(window.ba, window.images, cam, cfg, self.mesh)
        new_ba = ba_mod.update_residual_status(new_ba, window.images, cam, cfg, self.mesh)
        self._window = window.replace(ba=new_ba)
        self._place_on_mesh()

        self._kf_slot = int(slot1)
        self._kf_id = self.frame_idx
        self._win_count = 2
        self._pending_marg = None
        self._push_recent_row(self._kf_slot)
        self._kf_pyr = pyr
        self._kf_grad0_prev = self._first_pyr[0]
        self._kf_ab = ist.ab
        self._sync_kf_poses()
        self._rebuild_tracker_ref()

        rho_lo, rho_hi = _working_rho_range(self._window.ba, cfg)
        uv, valid, _ = select_points(pyr[0], cfg.points_per_kf)
        self._immature = seed_immatures(self._immature, self._kf_slot, pyr[0], uv,
                                        valid, rho_lo, rho_hi)

        self._T_prev = self._kf_T
        self._T_curr = self._kf_T
        self._kf_exposure = getattr(self, "_cur_exposure", None)
        self._record(timestamp, self._kf_id, SE3.identity(device=dev))
        self._set_abs_pose(self._kf_id, self._kf_T, keyframe=True)
        self._frames_since_kf = 0

    def _rebuild_tracker_ref(self):
        self._tracker_ref = _tracker_ref_in_frame(self._window, self._kf_slot, self._kf_pyr,
                                                  self.cam, self.cfg)
        self._n_ref = max(int(torch.sum(self._tracker_ref.valid[0])), 1)

    def _track_frame(self, pyr, img, timestamp, T_seed: SE3 | None = None,
                     use_seed: torch.Tensor | None = None) -> dict:
        """Per-frame tracking (_frame_step), then the keyframe/failure state
        machine on its scalar bundle. A subclass may hand in a seed pose and
        gate it with a device scalar `use_seed` (default: used)."""
        cfg, cam = self.cfg, self.cam
        # complete the previous keyframe's async marginalization once its
        # pieces are >= 2 frames old (a deterministic completion point)
        self._complete_pending_marg(min_age=2)
        exp = getattr(self, "_cur_exposure", None)
        a0 = 0.0
        if exp and getattr(self, "_kf_exposure", None):
            a0 = float(np.log(exp / self._kf_exposure))
        # exposure-aware affine initialization: a = log(t_j / t_kf) when the
        # capture provides exposure times (reference: Exposure.h:118-125)
        ab_init = torch.zeros(2, dtype=torch.float32, device=self.device)
        if a0:
            ab_init[0] = a0
        if T_seed is not None and use_seed is None:
            use_seed = torch.ones((), dtype=torch.bool, device=self.device)
        with self.sheet.timer("time_track").frame(self.frame_idx):
            imm2, T_world, T_rel, ab, scalars = _frame_step(
                pyr, cam, self._tracker_ref, self._immature,
                self._window.ba.T, self._window.ba.frame_valid,
                self._kf_T, self._T_curr, self._T_prev, T_seed, use_seed,
                self._recent_rows, ab_init, cfg,
            )
        self._immature = imm2
        self._T_prev = self._T_curr
        self._T_curr = T_world
        entry = {
            "frame_idx": self.frame_idx, "ts": timestamp, "pyr": pyr,
            "T_world": T_world, "T_rel": T_rel, "ab": ab,
            "scalars": scalars, "kf_id": self._kf_id,
            "exposure": exp, "gt": self._cur_gt,
        }
        entry.update(self._entry_extras())
        if self.pipelined:
            self._stage_bundle(entry)
            self._pending.append(entry)
            if len(self._pending) > 1:
                out = self._finalize_frame(self._pending.pop(0))
                self.stats.append(out)
                # fall back to lag 0 when tracking shows stress (a failed pose
                # or the recovery battery fired), so the state machine acts on
                # fresh state; healthy frames keep the pipeline full
                if not out.get("ok", True) or out.get("suspect", False):
                    self._flush_pending()
                return out
            return {"state": "TRACKING", "ok": True, "kf": False, "pending": True}
        out = self._finalize_frame(entry)
        self.stats.append(out)
        return out

    def _stage_bundle(self, entry: dict):
        """Start the copy of a pipelined frame's scalar bundle to the host
        (read one frame later, in _finalize_frame)."""
        entry["_copy"] = HostCopy([entry["scalars"]])

    def _fetch_scalars(self, entry: dict) -> np.ndarray:
        """A frame's scalar bundle on the host: from the copy started at
        dispatch when there is one, else read now."""
        cp = entry.get("_copy")
        if cp is not None and cp.same([entry["scalars"]]):
            return cp.result()[0]
        return host_fetch([entry["scalars"]])[0]

    def _finalize_frame(self, entry: dict) -> dict:
        """Consume one frame's results: record the pose, run the failure
        counter / LOST transition, decide and execute the keyframe event
        (reference: the scalar tail of Hybrid.cpp:167 processFrame)."""
        cfg = self.cfg
        fidx, timestamp, pyr = entry["frame_idx"], entry["ts"], entry["pyr"]
        sc = entry.get("scalars_np")   # a subclass may have fetched the bundle
        if sc is None:                 # together with its own results
            sc = self._fetch_scalars(entry)
        rel_R = sc[11:20].reshape(3, 3).astype(np.float64)
        rel_t = sc[20:23].astype(np.float64)
        num_valid = int(sc[0])
        saturated = float(sc[1])
        flow = float(sc[2])
        energy = float(sc[3])
        pose_ok = bool(sc[4] > 0.5) and bool(
            np.all(np.isfinite(rel_t)) and np.all(np.isfinite(rel_R)))
        self._record(timestamp, entry["kf_id"], (rel_R, rel_t), frame_idx=fidx,
                     gt=entry.get("gt"))
        if pose_ok:
            self._track_fails = 0
        else:
            self._track_fails += 1
            log.warn("direct tracking failed (%d valid points, fail #%d)",
                     num_valid, self._track_fails)
            if self._track_fails >= cfg.max_track_fails:
                # record (but do not act on) the in-flight frames so the
                # trajectory stays complete, then drop them: the segment is over
                for e in self._pending:
                    e_sc = self._fetch_scalars(e)
                    self._record(e["ts"], e["kf_id"],
                                 (e_sc[11:20].reshape(3, 3).astype(np.float64),
                                  e_sc[20:23].astype(np.float64)),
                                 frame_idx=e["frame_idx"], gt=e.get("gt"))
                self._pending.clear()
                return self._on_tracking_lost(pyr, timestamp)

        self._frames_since_kf += 1
        # KF triggers: resolution-normalized flow score, staleness, and the
        # tracked-point-ratio rule (reference: direct/Tracking.cpp:28-41)
        kf_score = float(sc[9])
        n_ref = max(int(sc[10]), 1)
        # a pipelined frame tracked against a reference that a keyframe has
        # replaced since carries a stale flow score: it must not keyframe
        stale_ref = entry["kf_id"] != self._kf_id
        need_kf = pose_ok and not stale_ref and (
            cfg.kf_flow_weight * kf_score > cfg.kf_flow_threshold
            or self._frames_since_kf >= 8
            or num_valid < cfg.kf_point_ratio * n_ref
        )
        out = {
            "state": "TRACKING",
            "flow": flow,
            "energy": energy,
            "num_valid": num_valid,
            "kf": bool(need_kf),
            "ok": pose_ok,
            "cov_rot_diag": np.asarray(sc[6:9]),
            "saturated": saturated,
            "suspect": bool(sc[5] > 0.5),
            "motion": (float(sc[25]), float(sc[26])),
        }
        self._last_track_ab = sc[23:25]
        if need_kf:
            with self.sheet.timer("time_keyframe").frame(fidx):
                self._make_keyframe(pyr, entry["ab"], timestamp,
                                    T_new=entry["T_world"], frame_idx=fidx,
                                    exposure=entry.get("exposure"))
        for k in ("flow", "energy", "num_valid", "saturated"):
            self.sheet.push(k, fidx, out[k])
        return out

    def _entry_extras(self) -> dict:
        """Subclass hook: extra device handles to carry in a frame's entry
        (the hybrid stashes its ORB features and PnP results here for its
        scalar tail in _finalize_frame, one frame later in pipelined mode)."""
        return {}

    def _flush_pending(self) -> list[dict]:
        """Finalize every in-flight pipelined frame (end of stream, or before
        a consumer that needs the whole trajectory), then complete the
        pending marginalization."""
        outs = []
        while self._pending:
            out = self._finalize_frame(self._pending.pop(0))
            self.stats.append(out)
            outs.append(out)
        self._complete_pending_marg()
        return outs

    # -- failure handling -----------------------------------------------------

    def _on_tracking_lost(self, pyr, timestamp) -> dict:
        """Consecutive-failure limit hit: try relocalization (subclasses);
        else enter LOST and retry for a grace window before a blind restart
        or stop (reference: restartOrStop AbstractSlam.cpp:98-104)."""
        if self._attempt_relocalization(pyr, timestamp):
            log.important("relocalized at frame %d", self.frame_idx)
            return {"state": self.state, "ok": True, "relocalized": True, "kf": False}
        if self.cfg.stop_on_lost:
            log.important("tracking lost at frame %d: stopping", self.frame_idx)
            self.stopped = True
            return {"state": "STOPPED", "ok": False, "kf": False}
        log.important("tracking lost at frame %d: entering LOST", self.frame_idx)
        self.state = "LOST"
        self._lost_frames = 0
        return {"state": "LOST", "ok": False, "kf": False}

    def _process_lost(self, pyr, timestamp) -> dict:
        """One frame in the LOST state: hold the last pose, retry
        relocalization, restart after the grace window."""
        self._record(timestamp, self._kf_id, self._T_curr.compose(self._kf_T.inverse()))
        if self._attempt_relocalization(pyr, timestamp):
            log.important("relocalized at frame %d", self.frame_idx)
            return {"state": self.state, "ok": True, "relocalized": True, "kf": False}
        self._lost_frames += 1
        if self._lost_frames >= self.cfg.lost_grace_frames:
            self._restart_segment(pyr, timestamp, self._T_curr)
            return {"state": self.state, "ok": False, "kf": False, "restarted": True}
        return {"state": "LOST", "ok": False, "kf": False}

    def _attempt_relocalization(self, pyr, timestamp) -> bool:
        """No relocalization machinery in the direct-only runtime."""
        return False

    def _restart_segment(self, pyr, timestamp, anchor: SE3):
        """Restart the map in a fresh segment anchored at `anchor`: the
        current frame becomes the new first frame."""
        self.segments += 1
        self._pending.clear()
        self._pending_marg = None
        self._win_count = 0
        self._recent_rows = torch.full_like(self._recent_rows, -1)
        log.important("restarting map: segment %d anchored at frame %d",
                      self.segments, self.frame_idx)
        anchor = anchor.normalized()
        cfg = self.cfg
        self._window = None
        self._tracker_ref = None
        self._immature = empty_immatures(cfg.max_frames, cfg.points_per_kf, self.device)
        self._init_state = set_first(pyr, self.cam, cfg)
        self._first_pyr = pyr
        self._first_ts = timestamp
        self.state = "INIT"
        self._track_fails = 0
        self._frames_since_kf = 0
        self._restart_anchor = anchor
        self._anchor_kf = self.frame_idx
        self._kf_id = self.frame_idx
        self._T_prev = anchor
        self._T_curr = anchor
        self._set_abs_pose(self.frame_idx, anchor)

    def _make_keyframe(self, pyr, ab, timestamp, T_new: SE3 | None = None,
                       frame_idx: int | None = None, exposure: float | None = None):
        """Keyframe event: finish the in-flight marginalization, activate
        matured candidates, insert + BA, refresh the tracker reference, and
        start the next marginalization when the window is full."""
        cfg, cam = self.cfg, self.cam
        if T_new is None:
            T_new = self._T_curr
        if frame_idx is None:
            frame_idx = self.frame_idx
        self._complete_pending_marg()
        window, self._immature = _activate_and_clear(self._window, self._immature, cfg)

        if ab is None:
            ab = torch.as_tensor(np.asarray(
                getattr(self, "_last_track_ab", np.zeros(2, np.float32)))).to(self.device)
        window, slot, energy, T_kf, ab_new = _kf_insert_and_ba(
            window, pyr[0], T_new, self._kf_ab, ab, frame_idx, cam, cfg, self.mesh)

        self._window = window
        self._win_count += 1
        self._kf_grad0_prev = self._kf_pyr[0]
        self._kf_pyr = pyr
        self._kf_slot = int(slot)
        self._kf_id = frame_idx
        self._kf_ab = ab_new
        self._kf_T = T_kf
        self._kf_exposure = (exposure if exposure is not None
                             else getattr(self, "_cur_exposure", None))
        self._frames_since_kf = 0
        i = self._fid2map.get(frame_idx)
        if i is not None:
            self.map.set_keyframe(i)
            self.map.f_group[i] |= np.uint32(self.map.groups.frame_group("DIRECTKEYFRAME"))
        # tracking continuity: current pose snaps to the optimized KF pose
        # (pipelined frames already extend past it)
        if not self._pending:
            self._T_curr = self._kf_T
        self._tracker_ref, self._immature = _refresh_after_kf(
            window, self._kf_slot, pyr, self._immature, cam, cfg)
        self._push_recent_row(self._kf_slot)
        if self._pending:
            # pipelined mode: the frames dispatched before this event tracked
            # the OLD reference; track them again against the fresh one and
            # rebase the motion-model chain on the refreshed poses
            T_prev_w = self._kf_T
            for e in self._pending:
                T_w, T_r, ab2, sc = _retrack_step(e["pyr"], cam, self._tracker_ref,
                                                  self._kf_T, e["T_world"], e["ab"], ab, cfg)
                self._T_prev = T_prev_w
                e.update(T_world=T_w, T_rel=T_r, ab=ab2, scalars=sc, kf_id=self._kf_id)
                self._stage_bundle(e)
                T_prev_w = T_w
            self._T_curr = T_prev_w

        # window full after the insert: start the ASYNC marginalization now
        # (reference order — BA, then tryMarginalize, direct/Mapping.cpp:47)
        if self._win_count >= cfg.max_frames:
            self._start_async_marg()

    def _push_recent_row(self, slot: int):
        """Record `slot` as the most recently seeded immature row."""
        self._recent_rows = torch.cat([
            torch.full((1,), int(slot), dtype=torch.int32, device=self.device),
            self._recent_rows[:-1]])

    def _place_on_mesh(self):
        """Check the window's BA state against the mesh's layout and place it
        on the mesh's device (no-op without a mesh). Called where a window
        is created or restored, as the JAX package shards it there."""
        if self.mesh is None or self._window is None:
            return
        self._window = self._window.replace(
            ba=sharding.shard_ba_state(self._window.ba, self.mesh))

    # -- asynchronous marginalization -----------------------------------------

    def _start_async_marg(self):
        """Queue the device half of frame marginalization (slot choice +
        linearize/contract) without reading it; the host f64 Schur completes
        two frames later (or at the next keyframe event)."""
        window = self._window
        slot_dev = win_mod.choose_marginalization_slot(window, self._kf_slot)
        pieces = ba_mod._marg_pieces(window.ba, window.images, self.cam, self.cfg,
                                     slot_dev, self.mesh)
        self._pending_marg = (pieces, slot_dev, self.frame_idx)

    def _complete_pending_marg(self, min_age: int = 0):
        """Finish the in-flight marginalization once its device pieces are
        at least `min_age` frames old."""
        if self._pending_marg is None:
            return
        pieces, slot_dev, born = self._pending_marg
        if self.frame_idx - born < min_age:
            return
        self._pending_marg = None
        slot = int(slot_dev)
        packed, hosted = ba_mod.marg_host_schur(pieces, slot, self.cfg)
        self._window, self._immature = _marg_finish(
            self._window, self._immature, torch.as_tensor(packed).to(self.device),
            hosted, slot, self.cfg)
        self._win_count -= 1

    # -- outputs ---------------------------------------------------------------

    def trajectory_c2w(self) -> tuple[np.ndarray, np.ndarray]:
        """(timestamps (N,), poses (N, 4, 4) camera-to-world) from the map
        (deform-composed with the final optimized keyframe poses)."""
        self._flush_pending()
        if self._window is not None:
            self._sync_kf_poses()
        return self.map.trajectory_c2w()

    def live_error(self) -> dict | None:
        """Scale-corrected ATE/RPE against stored groundtruth, from the map."""
        self._flush_pending()
        if self._window is not None:
            self._sync_kf_poses()
        return self.map.refresh_error_from_groundtruth()

    def export_results(self, out_dir: str, prefix: str = "result"):
        """Five-file trajectory export via the map."""
        self._flush_pending()
        if self._window is not None:
            self._sync_kf_poses()
        self.map.export_results(out_dir, prefix)

    # -- checkpoint / resume --------------------------------------------------

    _CKPT_SCALARS = (
        "state", "frame_idx", "segments", "stopped", "_anchor_kf",
        "_kf_slot", "_kf_id", "_frames_since_kf", "_track_fails",
        "_lost_frames", "_fid2map", "_first_ts", "_win_count",
        "_kf_exposure",
    )
    _CKPT_PYTREES = (
        "_window", "_immature", "_init_state", "_first_pyr", "_kf_pyr",
        "_kf_grad0_prev", "_kf_T", "_kf_ab", "_T_prev", "_T_curr",
        "_restart_anchor", "_recent_rows",
    )

    def _ckpt_extra(self) -> dict:
        """State beyond the JAX package's scalar and pytree lists that the
        next frames read. The tracker reference rides along: rebuilt from a
        window that a completed marginalization has changed since, it would
        differ from the one the uninterrupted run tracks against."""
        return {"tracker_ref": self._tracker_ref, "n_ref": self._n_ref,
                "last_track_ab": getattr(self, "_last_track_ab", None),
                "stats": self.stats}

    def _ckpt_restore_extra(self, extra: dict) -> None:
        self._tracker_ref = extra["tracker_ref"]
        self._n_ref = extra["n_ref"]
        if extra["last_track_ab"] is not None:
            self._last_track_ab = extra["last_track_ab"]
        self.stats = extra["stats"]

    def save_state(self, path: str) -> None:
        """Serialize the full SLAM state (arenas, window, map, host scalars)
        so a run can resume mid-sequence and continue exactly as the
        uninterrupted run. The file holds numpy arrays and this package's
        own Python objects only (device tensors as `OnDevice` arrays), so a
        state saved on the card loads on the CPU and the other way round.
        An in-flight asynchronous marginalization rides along as it is and
        completes at the frame the uninterrupted run completes it; so do the
        pipelined mode's in-flight frames (the JAX package finalizes them
        before it saves, which changes the run that saved), without their
        host copies, which the resumed run reads anew."""
        payload = {
            "scalars": {k: getattr(self, k, None) for k in self._CKPT_SCALARS},
            "pytrees": {k: getattr(self, k, None) for k in self._CKPT_PYTREES},
            "map": self.map,
            "extra": self._ckpt_extra(),
            "pending_marg": self._pending_marg,
            "pending": [{k: v for k, v in e.items() if not k.startswith("_")}
                        for e in self._pending],
        }
        with open(path, "wb") as f:
            pickle.dump(to_host(payload), f)

    def load_state(self, path: str) -> None:
        """Restore a checkpoint written by save_state into this instance
        (which must share cam and cfg), every array on this instance's
        device. Unpickling runs code: load only files save_state wrote."""
        with open(path, "rb") as f:
            payload = to_device(pickle.load(f), self.device)
        for k, v in payload["scalars"].items():
            setattr(self, k, v)
        for k, v in payload["pytrees"].items():
            setattr(self, k, v)
        self.map = payload["map"]
        self._pending_marg = payload["pending_marg"]
        self._pending = payload.get("pending", [])   # absent in older checkpoints
        self._ckpt_restore_extra(payload["extra"])
        self._place_on_mesh()
