"""Parity of the PyTorch port's direct pipeline modules (residuals, tracker,
selector, initializer, tracer, window, photometric BA and marginalization)
with the JAX package, on the CPU.

Inputs are rendered at 160x120 from the synthetic scene (or drawn from a
seed with numpy) and both packages start from identical state (`convert.py`).
Tolerances, with their reasons:
  - integer outputs and masks (selected pixels, neighbour lists, validity,
    slots) must agree exactly;
  - one sweep of the same f32 formulas agrees to a few ulps (rtol 1e-5);
  - sums over hundreds of points (Hessians, energies) are reduced in another
    order by the two frameworks: rtol 1e-4 relative to the largest entry;
  - iterative solvers (LM tracking, initializer, BA) amplify those last-bit
    differences through their accept/reject tests; they are held to the
    pose / depth bounds stated at each test, far below the tracker's own
    accuracy (0.04 translation, 0.01 rad).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import libcml_tpu.models.direct.ba as jba
import libcml_tpu.models.direct.initializer as jinit
import libcml_tpu.models.direct.residuals as jres
import libcml_tpu.models.direct.tracer as jtr
import libcml_tpu.models.direct.tracker as jtrk
import libcml_tpu.models.direct.window as jwin
from libcml_tpu.core.camera import PinholeCamera as JCam
from libcml_tpu.core.lie import SE3 as JSE3, se3_exp as jse3_exp
from libcml_tpu.data.synthetic import SyntheticScene, forward_trajectory
from libcml_tpu.models.direct.config import DirectConfig as JCfg
from libcml_tpu.models.direct.selector import select_points as jselect
from libcml_tpu.ops.image import bilinear as jbilinear, build_gradient_pyramid as jpyr

import libcml_tpu_torch.models.direct.ba as tba
import libcml_tpu_torch.models.direct.initializer as tinit
import libcml_tpu_torch.models.direct.residuals as tres
import libcml_tpu_torch.models.direct.tracer as ttr
import libcml_tpu_torch.models.direct.tracker as ttrk
import libcml_tpu_torch.models.direct.window as twin
from libcml_tpu_torch import convert
from libcml_tpu_torch.core.camera import PinholeCamera as TCam
from libcml_tpu_torch.core.lie import SE3 as TSE3
from libcml_tpu_torch.models.direct.config import DirectConfig as TCfg
from libcml_tpu_torch.models.direct.selector import select_points as tselect
from libcml_tpu_torch.ops.image import build_gradient_pyramid as tpyr

# The suite runs in several worker processes that share a few cores: one
# torch thread each, since with torch's default thread pool per process the
# workers' spinning threads slow each other down many times over.
torch.set_num_threads(1)

CAM_ARGS = (110.0, 110.0, 79.5, 59.5, 160, 120)
CFG_KW = dict(num_levels=3, max_points=256, points_per_kf=64, init_points=256,
              max_frames=4, tracker_iters=8, init_iters=12, ba_iters=4)
JCAM, TCAM = JCam.make(*CAM_ARGS), TCam.make(*CAM_ARGS)
JCFG, TCFG = JCfg(**CFG_KW), TCfg(**CFG_KW)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _t(x):
    return convert.tensor(np.asarray(x))


def _jse3(R, t):
    return JSE3(R=jnp.asarray(R, jnp.float32), t=jnp.asarray(t, jnp.float32))


def _tse3(T):
    return convert.from_np(TSE3, convert.to_np(jax.device_get(T)))


def _close(got, want, rtol=1e-5, atol=1e-5, **kw):
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=atol, **kw)


def _pose_gap(Tt, Tj):
    """(translation, rotation angle) between the port's and the reference's
    pose."""
    Rt, Rj = _np(Tt.R).astype(np.float64), _np(Tj.R).astype(np.float64)
    ang = np.arccos(np.clip((np.trace(Rt @ Rj.T) - 1) / 2, -1, 1))
    return float(np.linalg.norm(_np(Tt.t) - _np(Tj.t))), float(ang)


@pytest.fixture(scope="module")
def scene():
    """Rendered frames 0..6 (step 0.08 m), their gradient pyramids in both
    packages, ground-truth poses and inverse depths."""
    sc = SyntheticScene.default(JCAM, seed=3)
    poses = forward_trajectory(7, step=0.08, yaw_rate=0.003)
    imgs, ideps = zip(*(sc.render(R, t) for R, t in poses))
    jp = [jpyr(jnp.asarray(im), 3) for im in imgs]
    tp = [tpyr(_t(im), 3) for im in imgs]
    Ts = [_jse3(R, t) for R, t in poses]
    return dict(imgs=imgs, ideps=ideps, jp=jp, tp=tp, T=Ts)


@pytest.fixture(scope="module")
def points(scene):
    """Frame 0's selected points with ground-truth inverse depth."""
    uv, valid, score = jselect(scene["jp"][0][0], 256)
    idepth = jbilinear(jnp.asarray(scene["ideps"][0]), uv)
    valid = valid & (idepth > 1e-3)
    return uv, valid, idepth


# -- selector, residuals ------------------------------------------------------------


@pytest.mark.parametrize("n_points", [64, 256])
def test_select_points_matches_reference(scene, n_points):
    want = jselect(scene["jp"][0][0], n_points)
    got = tselect(scene["tp"][0][0], n_points)
    np.testing.assert_array_equal(_np(got[0]), _np(want[0]))    # pixels: exact
    np.testing.assert_array_equal(_np(got[1]), _np(want[1]))
    _close(got[2], want[2])


def test_residuals_and_normal_equations_match_reference(scene, points):
    uv, valid, idepth = points
    T = jse3_exp(jnp.asarray([0.01, -0.02, 0.05, 0.004, -0.003, 0.002], jnp.float32))
    G0, G1 = scene["jp"][0][0], scene["jp"][2][0]
    color = jbilinear(G0[..., 0], jres.pattern_uv(uv))
    weight = jnp.ones_like(color) * jnp.where(valid, 1.0, 0.0)[:, None]
    evj = jres.evaluate_residuals(G1, JCAM, uv, idepth, color, weight, T, 0.05, -2.0,
                                  huber_k=9.0, cutoff=40.0)
    evt = tres.evaluate_residuals(_t(G1), TCAM, _t(uv), _t(idepth), _t(color), _t(weight),
                                  _tse3(T), torch.tensor(0.05), torch.tensor(-2.0),
                                  huber_k=9.0, cutoff=40.0)
    np.testing.assert_array_equal(_np(evt.valid), _np(evj.valid))
    for f in ("w", "uv_j", "J_uv_Xj", "X_i", "X_j", "s_ji"):
        _close(getattr(evt, f), getattr(evj, f), rtol=1e-5, atol=1e-4, err_msg=f)
    # a 1e-6 px difference in the warp meets image gradients of up to ~500
    # per px: residuals and sampled gradients agree to 2e-3 on a 0-255 scale
    _close(evt.r, evj.r, rtol=1e-5, atol=2e-3)
    _close(evt.g, evj.g, rtol=1e-5, atol=2e-3)
    _close(evt.energy, evj.energy, rtol=1e-4, atol=5e-2)
    Jj = jres.rel_pose_jacobian(evj, color)
    Jt = tres.rel_pose_jacobian(evt, _t(color))
    # Jacobians carry the sampled gradient g: held to 1e-4 of their largest
    # entry for the same reason
    _close(Jt, Jj, rtol=1e-5, atol=1e-4 * float(np.abs(_np(Jj)).max()))
    Jrj = jres.idepth_jacobian(evj, T, idepth)
    _close(tres.idepth_jacobian(evt, _tse3(T), _t(idepth)), Jrj, rtol=1e-5,
           atol=1e-4 * float(np.abs(_np(Jrj)).max()))
    Hj, bj, Ej = jres.gauss_newton_system(Jj, evj.r, evj.w)
    Ht, bt, Et = tres.gauss_newton_system(Jt, evt.r, evt.w)
    scale = float(np.abs(_np(Hj)).max())
    _close(Ht, Hj, rtol=1e-4, atol=1e-5 * scale)
    _close(bt, bj, rtol=1e-4, atol=1e-5 * float(np.abs(_np(bj)).max()))
    _close(Et, Ej, rtol=1e-4)


# -- tracker --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def refs(scene, points):
    uv, valid, idepth = points
    rj = jtrk.make_tracker_ref(scene["jp"][0], JCAM, uv, idepth, valid, JCFG)
    rt = ttrk.make_tracker_ref(scene["tp"][0], TCAM, _t(uv), _t(idepth), _t(valid), TCFG)
    return rj, rt


def test_make_tracker_ref_matches_reference(refs):
    rj, rt = refs
    np.testing.assert_array_equal(_np(rt.valid), _np(rj.valid))
    for f in ("uv", "color", "weight", "idepth"):
        _close(getattr(rt, f), getattr(rj, f), err_msg=f)
    # the converted reference is the same state
    rc = convert.from_np(ttrk.TrackerRef, convert.to_np(jax.device_get(rj)))
    for f in ("uv", "color", "weight", "valid", "idepth"):
        np.testing.assert_array_equal(_np(getattr(rc, f)), _np(getattr(rj, f)))


@pytest.mark.parametrize("frame", [1, 2])
def test_track_matches_reference(scene, refs, frame):
    """The LM schedule, accept rule and early exit are the reference's, so
    both land on the same pose: 1e-4 m / 1e-4 rad (the same basin; the
    last-bit energy differences may shift the final accepted step)."""
    rj, _ = refs
    rt = convert.from_np(ttrk.TrackerRef, convert.to_np(jax.device_get(rj)))
    ab = np.zeros(2, np.float32)
    want = jtrk.track(scene["jp"][frame], JCAM, rj, JSE3.identity(), jnp.asarray(ab), JCFG)
    got = ttrk.track(scene["tp"][frame], TCAM, rt, TSE3.identity(), _t(ab), TCFG)
    dt, dr = _pose_gap(got.T_ji, want.T_ji)
    assert dt < 1e-4 and dr < 1e-4, (dt, dr)
    _close(got.ab, want.ab, atol=1e-3)
    assert abs(int(got.num_valid) - int(want.num_valid)) <= 1
    for f in ("energy", "flow", "flow_no_trans", "saturated"):
        _close(getattr(got, f), getattr(want, f), rtol=1e-3, atol=1e-4, err_msg=f)
    _close(got.cov_pose, want.cov_pose, rtol=1e-2, atol=1e-9)
    # and both are right: the ground-truth relative pose
    T_gt = scene["T"][frame].compose(scene["T"][0].inverse())
    gt_t, gt_r = _pose_gap(got.T_ji, T_gt)
    assert gt_t < 0.04 and gt_r < 0.01


def test_track_all_invalid_is_finite(scene, refs):
    """The all-invalid probe: a singular system must give a finite pose (the
    solve returns nan/inf, the energy test rejects it)."""
    _, rt = refs
    dead = rt.replace(valid=torch.zeros_like(rt.valid))
    got = ttrk.track(scene["tp"][2], TCAM, dead, TSE3.identity(), torch.zeros(2), TCFG)
    assert np.isfinite(_np(got.T_ji.t)).all() and np.isfinite(_np(got.T_ji.R)).all()
    assert int(got.num_valid) == 0 and float(got.energy) == 0.0


def test_motion_hypotheses_and_track_multi_match_reference(scene, refs):
    rj, _ = refs
    rt = convert.from_np(ttrk.TrackerRef, convert.to_np(jax.device_get(rj)))
    T_pred = scene["T"][1].compose(scene["T"][0].inverse())
    T_extra = jse3_exp(jnp.asarray([0.0, 0.0, 0.1, 0.0, 0.01, 0.0], jnp.float32))
    Hj = jtrk.motion_hypotheses(T_pred, JSE3.identity(), T_extra=T_extra)
    Ht = ttrk.motion_hypotheses(_tse3(T_pred), TSE3.identity(), T_extra=_tse3(T_extra))
    assert Ht.t.shape == Hj.t.shape == (15, 3)
    _close(Ht.R, Hj.R, rtol=1e-6, atol=1e-6)
    _close(Ht.t, Hj.t, rtol=1e-6, atol=1e-6)
    ab = jnp.zeros(2, jnp.float32)
    want = jtrk.track_multi(scene["jp"][2], JCAM, rj, Hj, ab, JCFG)
    got = ttrk.track_multi(scene["tp"][2], TCAM, rt, Ht, _t(ab), TCFG)
    # the hypotheses all reach one basin, their coarse energies equal to
    # ~1e-5 relative, so the argmin may take another of them; the fine
    # levels then stop within the convergence step (tracker_converge_eps)
    dt, dr = _pose_gap(got.T_ji, want.T_ji)
    assert dt < 1e-3 and dr < 1e-3, (dt, dr)
    _close(got.energy, want.energy, rtol=1e-3)


# -- initializer ------------------------------------------------------------------------


def test_initializer_matches_reference(scene):
    """set_first exactly (pixels, neighbour lists, masks); then the
    coarse-to-fine initialization against frames 1..3, each attempt started
    from the reference's own state, to 1e-3 m / 1e-3 rad and 1e-2 relative
    idepth (20-40 LM steps with a depth-smoothness coupling)."""
    sj = jinit.set_first(scene["jp"][0], JCAM, JCFG)
    st = tinit.set_first(scene["tp"][0], TCAM, TCFG)
    for f in ("uv", "valid", "nbr", "snapped", "snapped_age"):
        np.testing.assert_array_equal(_np(getattr(st, f)), _np(getattr(sj, f)), err_msg=f)
    for f in ("color", "weight", "idepth", "ab"):
        _close(getattr(st, f), getattr(sj, f), err_msg=f)
    for k in (1, 2, 3):
        st = convert.from_np(tinit.InitializerState, convert.to_np(jax.device_get(sj)))
        rj = jinit.try_initialize(sj, scene["jp"][k], JCAM, JCFG)
        rt = tinit.try_initialize(st, scene["tp"][k], TCAM, TCFG)
        assert bool(rt.success) == bool(rj.success)
        assert bool(rt.state.snapped) == bool(rj.state.snapped)
        assert int(rt.num_valid) == int(rj.num_valid)
        dt, dr = _pose_gap(rt.state.T, rj.state.T)
        assert dt < 1e-3 and dr < 1e-3, (k, dt, dr)
        _close(rt.state.idepth, rj.state.idepth, rtol=1e-2, atol=1e-3)
        sj = rj.state
    nj, fj = jinit.normalize_scale(sj)
    st = convert.from_np(tinit.InitializerState, convert.to_np(jax.device_get(sj)))
    nt, ft = tinit.normalize_scale(st)
    _close(ft, fj)
    _close(nt.idepth, nj.idepth)
    _close(nt.T.t, nj.T.t)


# -- tracer -----------------------------------------------------------------------------


def test_trace_points_matches_reference(scene, points):
    uv, valid, _ = points
    color = jbilinear(scene["jp"][0][0][..., 0], jres.pattern_uv(uv))
    T_oh = scene["T"][2].compose(scene["T"][0].inverse())
    ab = jnp.asarray([0.0, 0.0], jnp.float32)
    want = jtr.trace_points(color, uv, valid, scene["jp"][2][0], T_oh, ab, JCAM, JCFG)
    got = ttr.trace_points(_t(color), _t(uv), _t(valid), scene["tp"][2][0], _tse3(T_oh),
                           _t(ab), TCAM, TCFG)
    np.testing.assert_array_equal(_np(got.good), _np(want.good))
    ok = _np(want.good)
    _close(_np(got.idepth)[ok], _np(want.idepth)[ok], rtol=1e-4, atol=1e-5)
    # quality = second-best / best SSD: a ratio of two small minima, where
    # last-bit differences in either are magnified (1e-3 relative)
    _close(got.quality, want.quality, rtol=1e-3, atol=1e-4)
    _close(got.pixel_span, want.pixel_span, rtol=1e-4, atol=1e-4)


def _arenas(scene, points):
    """An immature arena with rows seeded from frames 0 and 1, in both
    packages from the same inputs."""
    uv, valid, _ = points
    aj = jtr.empty_immatures(4, 256)
    at = ttr.empty_immatures(4, 256)
    for slot, k in ((0, 0), (1, 1)):
        lo, hi = jnp.asarray(0.05, jnp.float32), jnp.asarray(2.0, jnp.float32)
        aj = jtr.seed_immatures(aj, jnp.asarray(slot), scene["jp"][k][0], uv, valid, lo, hi)
        at = ttr.seed_immatures(at, slot, scene["tp"][k][0], _t(uv), _t(valid), _t(lo),
                                _t(hi))
    T_hosts = JSE3(R=jnp.stack([scene["T"][i].R for i in (0, 1, 0, 0)]),
                   t=jnp.stack([scene["T"][i].t for i in (0, 1, 0, 0)]))
    host_valid = jnp.asarray([True, True, False, False])
    return aj, at, T_hosts, host_valid


def _arena_close(at, aj):
    a, b = convert.to_np(at), convert.to_np(jax.device_get(aj))
    for f in ("n_ok", "n_fail", "valid"):
        np.testing.assert_array_equal(a[f], b[f], err_msg=f)
    for f in ("uv", "color", "rho_lo", "rho_hi"):
        np.testing.assert_allclose(a[f], b[f], rtol=1e-4, atol=1e-5, err_msg=f)


def test_seed_and_trace_immatures_match_reference(scene, points):
    aj, at, T_hosts, hv = _arenas(scene, points)
    _arena_close(at, aj)
    Th = _tse3(T_hosts)
    for k in (2, 3):
        aj = jtr.trace_immatures(aj, T_hosts, hv, scene["jp"][k][0], scene["T"][k], JCAM, JCFG)
        at = ttr.trace_immatures(at, Th, _t(hv), scene["tp"][k][0], _tse3(scene["T"][k]),
                                 TCAM, TCFG)
        _arena_close(at, aj)
    (rt, mt), (rj, mj) = ttr.mature_mask(at, TCFG), jtr.mature_mask(aj, JCFG)
    np.testing.assert_array_equal(_np(rt), _np(rj))
    _close(mt, mj, rtol=1e-4)


@pytest.mark.parametrize("rows", [[1, -1], [-1, 0], [0, 1], [-1, -1]])
def test_trace_immatures_rows_drops_pad_rows(scene, points, rows):
    """-1 pad rows are dropped from the scatter (the reference's
    mode="drop"), never written onto row 0."""
    aj, at, T_hosts, hv = _arenas(scene, points)
    r = np.asarray(rows, np.int32)
    want = jtr.trace_immatures_rows(aj, jnp.asarray(r), T_hosts, hv, scene["jp"][3][0],
                                    scene["T"][3], JCAM, JCFG)
    got = ttr.trace_immatures_rows(at, _t(r), _tse3(T_hosts), _t(hv), scene["tp"][3][0],
                                   _tse3(scene["T"][3]), TCAM, TCFG)
    _arena_close(got, want)
    if 0 not in rows:
        np.testing.assert_array_equal(_np(got.n_ok[0]), _np(at.n_ok[0]))


# -- window, BA, marginalization -----------------------------------------------------------


KF_FRAMES = [0, 2, 4, 6]


def _build_windows(scene, pose_noise=0.004, seed=1, n_kf=4):
    """The same window built by each package from the same numpy inputs:
    keyframes at frames 0, 2, 4, 6 with perturbed poses, points with
    ground-truth inverse depth."""
    rng = np.random.default_rng(seed)
    wj = jwin.empty_window(JCFG, JCAM.height, JCAM.width)
    wt = twin.empty_window(TCFG, TCAM.height, TCAM.width)
    for n, i in enumerate(KF_FRAMES[:n_kf]):
        xi = (rng.normal(0, pose_noise, 6) if n else np.zeros(6)).astype(np.float32)
        Tj = jse3_exp(jnp.asarray(xi)).compose(scene["T"][i])
        wj, sj = jwin.add_keyframe(wj, scene["jp"][i][0], Tj, jnp.zeros(2), jnp.asarray(i))
        wt, stt = twin.add_keyframe(wt, scene["tp"][i][0], _tse3(Tj), torch.zeros(2), i)
        assert int(sj) == int(stt)
        uv, valid, _ = jselect(scene["jp"][i][0], 64)
        uvi = np.asarray(uv).astype(int)
        rho = scene["ideps"][i][np.clip(uvi[:, 1], 0, 119), np.clip(uvi[:, 0], 0, 159)]
        ok = np.asarray(valid) & (rho > 1e-3)
        wj = jwin.add_points(wj, sj, uv, jnp.asarray(rho), jnp.asarray(ok), JCFG)
        wt = twin.add_points(wt, stt, _t(uv), _t(rho), _t(ok), TCFG)
    wj = wj.replace(ba=jba.anchor_first_frame(wj.ba, 0, JCFG))
    wt = wt.replace(ba=tba.anchor_first_frame(wt.ba, 0, TCFG))
    return wj, wt


def _window_close(wt, wj, rtol=1e-5, atol=1e-5):
    a, b = convert.to_np(wt), convert.to_np(jax.device_get(wj))
    for f in ("frame_valid", "host", "point_valid", "res_active"):
        np.testing.assert_array_equal(a["ba"][f], b["ba"][f], err_msg=f)
    np.testing.assert_array_equal(a["frame_id"], b["frame_id"])
    for f in ("ab", "ab_fej", "delta", "uv", "idepth", "idepth_fej", "color", "weight"):
        np.testing.assert_allclose(a["ba"][f], b["ba"][f], rtol=rtol, atol=atol, err_msg=f)
    for f in ("T", "T_fej"):
        for k in ("R", "t"):
            np.testing.assert_allclose(a["ba"][f][k], b["ba"][f][k], rtol=rtol, atol=atol)
    np.testing.assert_allclose(a["images"], b["images"], rtol=1e-6, atol=1e-4)


@pytest.fixture(scope="module")
def windows(scene):
    return _build_windows(scene)


def _from_jax_window(wj):
    return convert.from_np(twin.Window, convert.to_np(jax.device_get(wj)))


def test_window_build_matches_reference(windows):
    wj, wt = windows
    _window_close(wt, wj)
    assert int(twin.num_valid_frames(wt)) == int(jwin.num_valid_frames(wj)) == 4
    for latest in (3, 1):
        assert int(twin.choose_marginalization_slot(wt, latest)) == \
            int(jwin.choose_marginalization_slot(wj, jnp.asarray(latest)))


def test_ba_linearize_energy_and_step_match_reference(windows):
    wj, _ = windows
    wt = _from_jax_window(wj)
    lj = jba.linearize(wj.ba, wj.images, JCAM, JCFG)
    lt = tba.linearize(wt.ba, wt.images, TCAM, TCFG)
    np.testing.assert_array_equal(_np(lt.active), _np(lj.active))
    for f in ("r", "w", "J_t", "J_h", "J_rho", "energy"):
        ref = _np(getattr(lj, f))
        _close(getattr(lt, f), ref, rtol=1e-4, atol=1e-5 * max(1.0, float(np.abs(ref).max())),
               err_msg=f)
    _close(tba.total_energy(wt.ba, wt.images, TCAM, TCFG),
           jba.total_energy(wj.ba, wj.images, JCAM, JCFG), rtol=1e-4)
    lam = 1e-3
    sj, _, _ = jba.ba_step(wj.ba, wj.images, JCAM, JCFG, jnp.asarray(lam, jnp.float32))
    st, _ = tba.ba_step(wt.ba, wt.images, TCAM, TCFG, torch.tensor(lam))
    _close(st.T.t, sj.T.t, atol=1e-5)
    _close(st.T.R, sj.T.R, atol=1e-5)
    _close(st.idepth, sj.idepth, rtol=1e-3, atol=1e-4)


def test_run_ba_matches_reference(windows):
    """4 LM iterations of the windowed BA from identical state: poses to
    2e-4, inverse depths to 1e-2 relative, energies to 1e-3."""
    wj, _ = windows
    wt = _from_jax_window(wj)
    bj, Ej = jba.run_ba(wj.ba, wj.images, JCAM, JCFG)
    bt, Et = tba.run_ba(wt.ba, wt.images, TCAM, TCFG)
    _close(Et, Ej, rtol=1e-3)
    _close(bt.T.t, bj.T.t, atol=2e-4)
    _close(bt.T.R, bj.T.R, atol=2e-4)
    _close(bt.idepth, bj.idepth, rtol=1e-2, atol=1e-3)
    np.testing.assert_array_equal(_np(bt.point_valid), _np(bj.point_valid))
    # the FEJ / residual-status bookkeeping on the refined state
    bt2 = convert.from_np(tba.BAState, convert.to_np(jax.device_get(bj)))
    for fj_, ft_ in ((jba.relinearize, tba.relinearize), (jba.refresh_fej, tba.refresh_fej)):
        a, b = ft_(bt2), fj_(bj)
        _close(a.b_m, b.b_m, rtol=1e-4, atol=1e-3)
        _close(a.delta, b.delta, atol=1e-6)
        _close(a.idepth_fej, b.idepth_fej)
    a = tba.update_residual_status(bt2, wt.images, TCAM, TCFG)
    b = jba.update_residual_status(bj, wj.images, JCAM, JCFG)
    np.testing.assert_array_equal(_np(a.res_active), _np(b.res_active))
    g = np.random.default_rng(0).normal(size=8 * JCFG.max_frames).astype(np.float32)
    _close(tba.orthogonalize_gradient(bt2, _t(g)), jba.orthogonalize_gradient(bj, jnp.asarray(g)),
           rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("slot", [1, 2])
def test_marginalization_matches_reference(windows, slot):
    """Both marginalizations from identical state: the f32 device path
    (`marginalize_frame`) and the runtime's f64 host Schur
    (`_marg_pieces` -> `marg_host_schur` -> `_marg_apply`). The prior is a
    Schur complement of Hessians reaching ~1e8: held to 1e-3 of its largest
    entry; masks exactly."""
    wj, _ = windows
    wj = wj.replace(ba=jba.run_ba(wj.ba, wj.images, JCAM, JCFG)[0])
    wt = _from_jax_window(wj)
    for fj_, ft_ in ((lambda: jba.marginalize_frame(wj.ba, wj.images, JCAM, JCFG,
                                                    jnp.asarray(slot)),
                      lambda: tba.marginalize_frame(wt.ba, wt.images, TCAM, TCFG, slot)),
                     (lambda: jba.marginalize_frame_f64(wj.ba, wj.images, JCAM, JCFG, slot),
                      lambda: tba.marginalize_frame_f64(wt.ba, wt.images, TCAM, TCFG, slot))):
        a, b = ft_(), fj_()
        for f in ("frame_valid", "point_valid", "res_active"):
            np.testing.assert_array_equal(_np(getattr(a, f)), _np(getattr(b, f)), err_msg=f)
        Hb, bb = _np(b.H_m), _np(b.b_m)
        _close(a.H_m, Hb, rtol=1e-3, atol=1e-3 * float(np.abs(Hb).max()))
        _close(a.b_m, bb, rtol=1e-3, atol=1e-3 * max(1.0, float(np.abs(bb).max())))
    # the three pieces of the asynchronous form, one by one
    pj = jax.device_get(jba._marg_pieces(wj.ba, wj.images, JCAM, JCFG, jnp.asarray(slot)))
    pt = tba._marg_pieces(wt.ba, wt.images, TCAM, TCFG, slot)
    assert len(pt) == len(pj)
    for k, (x, y) in enumerate(zip(pt, pj)):
        y = np.asarray(y)
        if y.dtype == bool:
            np.testing.assert_array_equal(_np(x), y, err_msg=str(k))
        else:
            _close(x, y, rtol=1e-3, atol=1e-3 * max(1.0, float(np.abs(y).max())),
                   err_msg=str(k))
    packed_j, _ = jba.marg_host_schur(pj, slot, JCFG)
    packed_t, hosted_t = tba.marg_host_schur(pt, slot, TCFG)
    assert packed_t.dtype == np.float32
    np.testing.assert_allclose(packed_t, packed_j, rtol=1e-3,
                               atol=1e-3 * float(np.abs(packed_j).max()))
