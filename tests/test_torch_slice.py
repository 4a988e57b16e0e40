"""The port's slice end to end against the JAX package, on the CPU:
sequential DirectOdometry over a rendered sequence, and the hybrid's
per-frame indirect tracking programs (_extract, _project_match_pnp,
_local_map_pass2).

Tolerances: the 12-frame odometry runs must take the same keyframes and
reach ATE < 0.1 in both packages; their poses are held to 2e-3 per frame.
That is 20x what the two runs differ by here (~1e-4: the tracker's last-bit
energy differences move a converged LM step by at most its convergence
tolerance, and BA carries that through the window) and 20x below the
tracker's own two-view accuracy budget (0.04). Matches are integers and
must agree exactly; the PnP pose to 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import libcml_tpu.runtime.hybrid as jhyb
from libcml_tpu.core.camera import PinholeCamera as JCam
from libcml_tpu.core.lie import SE3 as JSE3
from libcml_tpu.data.synthetic import SyntheticScene, forward_trajectory
from libcml_tpu.eval.trajectory import ate_rmse
from libcml_tpu.models.direct.config import DirectConfig as JCfg
from libcml_tpu.runtime.odometry import DirectOdometry as JOdo

import libcml_tpu_torch.models.indirect.matching as tmatching
import libcml_tpu_torch.runtime.hybrid as thyb
from libcml_tpu_torch import convert
from libcml_tpu_torch import workload as wl
from libcml_tpu_torch.core.camera import PinholeCamera as TCam
from libcml_tpu_torch.core.lie import SE3 as TSE3
from libcml_tpu_torch.data.synthetic import SyntheticScene as TScene
from libcml_tpu_torch.eval.trajectory import ate_rmse as tate_rmse
from libcml_tpu_torch.models.direct.config import DirectConfig as TCfg
from libcml_tpu_torch.models.indirect.orb import OrbFeatures
from libcml_tpu_torch.runtime.odometry import DirectOdometry as TOdo

# The suite runs in several worker processes that share a few cores: one
# torch thread each, since with torch's default thread pool per process the
# workers' spinning threads slow each other down many times over.
torch.set_num_threads(1)

CAM_ARGS = (110.0, 110.0, 79.5, 59.5, 160, 120)
# the small-scale odometry configuration of the reference's recovery tests
CFG_KW = dict(num_levels=3, max_points=1024, points_per_kf=256, init_points=256,
              max_frames=5, tracker_iters=8, init_iters=12, ba_iters=6,
              kf_flow_threshold=0.55, activate_min_traces=2,
              activate_max_relwidth=0.35, outlier_energy=300.0)
N_FRAMES = 12


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _t(x):
    return convert.tensor(np.asarray(x))


@pytest.fixture(scope="module")
def seq():
    cam = JCam.make(*CAM_ARGS)
    sc = SyntheticScene.default(cam, seed=3)
    poses = forward_trajectory(N_FRAMES, step=0.08, yaw_rate=0.003)
    frames = [sc.render(R, t) for R, t in poses]
    gt = []
    for R, t in poses:
        M = np.eye(4)
        M[:3, :3], M[:3, 3] = R, t
        gt.append(np.linalg.inv(M))
    return dict(poses=poses, imgs=[f[0] for f in frames], ideps=[f[1] for f in frames],
                gt_c2w=np.asarray(gt))


def _run(odo, imgs):
    kfs, states = [], []
    for i, img in enumerate(imgs):
        out = odo.process(img, float(i))
        kfs.append(bool(out.get("kf", False)))
        states.append(out["state"])
    ts, est = odo.trajectory_c2w()
    return kfs, states, ts, est


def test_direct_odometry_matches_reference(seq):
    want = _run(JOdo(JCam.make(*CAM_ARGS), JCfg(**CFG_KW)), seq["imgs"])
    odo = TOdo(TCam.make(*CAM_ARGS), TCfg(**CFG_KW), device="cpu")
    got = _run(odo, seq["imgs"])
    assert got[0] == want[0], "keyframe decisions differ"
    assert got[1] == want[1], "state sequences differ"
    np.testing.assert_array_equal(got[2], want[2])
    assert sum(got[0]) >= 2 and odo.segments == 0
    gt = seq["gt_c2w"][:, :3, 3]
    ate_t = tate_rmse(got[3][:, :3, 3], gt, with_scale=True)
    ate_j = ate_rmse(want[3][:, :3, 3], gt, with_scale=True)
    assert ate_t < 0.1 and ate_j < 0.1, (ate_t, ate_j)
    gap = np.abs(got[3] - want[3]).max(axis=(1, 2))
    assert gap.max() < 2e-3, gap
    # the system-of-record map and the stats sheet are filled as in the reference
    assert odo.map.n_frames == N_FRAMES
    assert odo.sheet.stat("time_track").series()[0]


def test_direct_odometry_defaults_to_the_card():
    """Without device= the entry point runs on CUDA; where there is none it
    raises rather than running on the CPU."""
    cam, cfg = TCam.make(*CAM_ARGS), TCfg(**CFG_KW)
    if torch.cuda.is_available():
        assert TOdo(cam, cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            TOdo(cam, cfg)


@pytest.mark.parametrize("kw", [dict(mesh=object())])
def test_unported_modes_raise(kw):
    with pytest.raises(NotImplementedError):
        TOdo(TCam.make(*CAM_ARGS), TCfg(**CFG_KW), device="cpu", **kw)


def test_black_frames_lost_then_restart(seq):
    """The LOST and restart path: black frames drive the runtime into LOST
    and then a new segment, without coasting on the motion model (the
    reference's tests/test_recovery.py scenario)."""
    import dataclasses

    cfg = dataclasses.replace(TCfg(**CFG_KW), max_track_fails=2, lost_grace_frames=3)
    cam = TCam.make(*CAM_ARGS)
    sc = TScene.default(cam, seed=3)
    poses = forward_trajectory(22, step=0.08, yaw_rate=0.003)
    odo = TOdo(cam, cfg, device="cpu")
    black = np.zeros((cam.height, cam.width), np.float32)
    states = [odo.process(sc.render(*poses[i])[0], float(i))["state"] for i in range(8)]
    assert odo.state == "TRACKING"
    states += [odo.process(black, float(i))["state"] for i in range(8, 16)]
    assert "LOST" in states and odo.segments >= 1, states
    _, est = odo.trajectory_c2w()
    assert np.linalg.norm(est[7:, :3, 3] - est[7, :3, 3], axis=1).max() < 0.5
    for i in range(16, 22):
        odo.process(sc.render(*poses[i])[0], float(i))
    assert odo.state in ("TRACKING", "INIT")
    assert np.isfinite(odo.trajectory_c2w()[1]).all()


def test_synthetic_renderers_agree():
    """The device renderer chip_smoke.py uses on the card computes the
    numpy renderer's image (float64 rays; the image is box-filtered in f64
    then rounded to f32) and the same inverse depth."""
    cam = TCam.make(*CAM_ARGS)
    sc = TScene.default(cam, seed=3)
    R, t = forward_trajectory(3, step=0.08, yaw_rate=0.003)[2]
    img, idep = sc.render(R, t)
    img_d, idep_d = sc.render_device(R, t, "cpu")
    np.testing.assert_allclose(_np(img_d), img, rtol=0, atol=1e-3)
    np.testing.assert_allclose(_np(idep_d), idep, rtol=1e-6, atol=1e-7)


def test_workload_map_reprojects_onto_frame0_corners():
    """The full-width map chip_smoke.py and profile_slice.py track against:
    MAP_CAP slots, frame 0's corners first and the padding invalid, each
    valid point projecting back onto its corner under the true pose (a float32
    unproject/project round trip at depths of a few metres: 1e-2 px)."""
    dev = torch.device("cpu")
    cam, traj, frames = wl.render_frames(dev, 1)
    (Xw, desc, valid, level), n = wl.build_map(cam, traj, frames, dev)
    f0 = wl.extract(frames[0])
    k = f0.uv.shape[0]
    assert Xw.shape == (thyb.MAP_CAP, 3) and desc.shape == (thyb.MAP_CAP, 8)
    assert n == int(valid.sum()) > 100
    assert not valid[k:].any()
    assert torch.equal(desc[:k], f0.desc) and torch.equal(level[:k], f0.level)
    T0 = wl.se3(*traj[0], dev)
    uv, in_front = cam.project(Xw[:k] @ T0.R.T + T0.t)
    ok = _np(valid[:k])
    assert _np(in_front)[ok].all()
    np.testing.assert_allclose(_np(uv)[ok], _np(f0.uv)[ok], rtol=0, atol=1e-2)


def test_projection_match_inputs_are_track_frames(monkeypatch):
    """chip_smoke.py's phase-4 masks case: the inputs that
    projection_match_inputs builds for frame 1 are those of track_frame's
    first Hamming resolution, bit for bit, at full width."""
    dev = torch.device("cpu")
    cam, traj, frames = wl.render_frames(dev, 2)
    map_, n = wl.build_map(cam, traj, frames, dev)
    f1 = wl.extract(frames[1])
    want = wl.projection_match_inputs(map_, cam, traj, f1, 1, dev)
    seen = []
    resolve = tmatching.hamming_resolve
    monkeypatch.setattr(tmatching, "hamming_resolve",
                        lambda *args: (seen.append(args), resolve(*args))[1])
    wl.track_frame(map_, cam, traj, f1, 1, dev)
    assert len(seen) == 2
    for got, w in zip(seen[0], want):
        assert torch.equal(got, w)
    assert want[4].shape == (thyb.MAP_CAP, f1.desc.shape[0])
    assert 0 < int(want[1].sum()) <= n


# -- the hybrid's per-frame tracking programs -------------------------------------------


P_MAP = 512          # map arena at this size (MAP_CAP = 4096 at full size)


@pytest.fixture(scope="module")
def hybrid_inputs(seq):
    """ORB features of frames 0, 2 and 3 from each package, and a map built
    from frame 0's corners with the renderer's depth and the true pose."""
    cam = JCam.make(*CAM_ARGS)
    feats_j = {i: jax.device_get(jhyb._extract(jnp.asarray(seq["imgs"][i]), 128, 3))
               for i in (0, 2, 3)}
    feats_t = {i: thyb._extract(_t(seq["imgs"][i]), 128, 3) for i in (0, 2, 3)}
    f0 = feats_j[0]
    uv = np.asarray(f0.uv)
    ui = np.clip(np.round(uv).astype(int), 0, [CAM_ARGS[4] - 1, CAM_ARGS[5] - 1])
    rho = seq["ideps"][0][ui[:, 1], ui[:, 0]]
    ok = np.asarray(f0.valid) & (rho > 0)
    Xc = np.asarray(cam.unproject(jnp.asarray(uv), jnp.asarray(np.maximum(rho, 1e-6))))
    R0, t0 = seq["poses"][0]
    Xw = ((Xc - t0) @ R0).astype(np.float32)
    n = len(uv)
    pad = lambda a, fill: np.concatenate(   # noqa: E731
        [a, np.full((P_MAP - n,) + a.shape[1:], fill, a.dtype)])
    mp = dict(Xw=pad(Xw, 0.0), desc=pad(np.asarray(f0.desc), 0), valid=pad(ok, False),
              level=pad(np.asarray(f0.level), 0))
    return feats_j, feats_t, mp


def test_extract_matches_reference(hybrid_inputs):
    feats_j, feats_t, _ = hybrid_inputs
    for i in feats_j:
        a, b = convert.to_np(feats_t[i]), convert.to_np(feats_j[i])
        for f in ("uv", "level", "valid"):
            np.testing.assert_array_equal(a[f], b[f])
        np.testing.assert_array_equal(a["desc"].view(np.uint32), b["desc"])
        np.testing.assert_allclose(a["angle"], b["angle"], rtol=1e-5, atol=1e-5)


def _se3_pair(R, t):
    Tj = JSE3(R=jnp.asarray(R, jnp.float32), t=jnp.asarray(t, jnp.float32))
    return Tj, convert.from_np(TSE3, convert.to_np(jax.device_get(Tj)))


@pytest.mark.parametrize("frame", [2, 3])
def test_project_match_pnp_and_pass2_match_reference(seq, hybrid_inputs, frame):
    feats_j, _, mp = hybrid_inputs
    fj = feats_j[frame]
    ft = convert.from_np(OrbFeatures, convert.to_np(fj))      # identical features
    Tc_j, Tc_t = _se3_pair(*seq["poses"][frame - 1])
    Tp_j, Tp_t = _se3_pair(*seq["poses"][frame - 2])
    cam_j, cam_t = JCam.make(*CAM_ARGS), TCam.make(*CAM_ARGS)
    mj = {k: jnp.asarray(v) for k, v in mp.items()}
    mt = {k: _t(v) for k, v in mp.items()}

    m_j, r_j, b_j, s_j = jhyb._project_match_pnp(
        mj["Xw"], mj["desc"], mj["valid"], mj["level"], Tc_j, Tp_j, cam_j,
        fj.desc, fj.uv, fj.level, fj.angle, fj.valid)
    m_t, r_t, b_t, s_t = thyb._project_match_pnp(
        mt["Xw"], mt["desc"], mt["valid"], mt["level"], Tc_t, Tp_t, cam_t,
        ft.desc, ft.uv, ft.level, ft.angle, ft.valid)
    np.testing.assert_array_equal(_np(m_t.valid), _np(m_j.valid))
    np.testing.assert_array_equal(_np(m_t.idx), _np(m_j.idx))
    np.testing.assert_array_equal(_np(m_t.dist), _np(m_j.dist))
    assert int(m_t.num) == int(m_j.num) >= 12
    np.testing.assert_array_equal(_np(r_t.inlier), _np(r_j.inlier))
    assert bool(s_t) == bool(s_j)
    np.testing.assert_allclose(_np(r_t.T.R), _np(r_j.T.R), atol=1e-5)
    np.testing.assert_allclose(_np(r_t.T.t), _np(r_j.T.t), atol=1e-5)
    assert b_t.shape == b_j.shape == (20,) and b_t.dtype == torch.float32
    np.testing.assert_array_equal(_np(b_t)[:3], _np(b_j)[:3])
    np.testing.assert_allclose(_np(b_t)[3:15], _np(b_j)[3:15], atol=1e-5)
    np.testing.assert_allclose(_np(b_t)[15:18], _np(b_j)[15:18], rtol=1e-3, atol=1e-12)
    np.testing.assert_allclose(_np(b_t)[18:], _np(b_j)[18:], atol=1e-4)

    v_j, b2_j = jhyb._local_map_pass2(mj["Xw"], mj["desc"], mj["valid"], mj["level"], r_j.T,
                                      cam_j, fj.desc, fj.uv, fj.level, fj.valid)
    T_ref = convert.from_np(TSE3, convert.to_np(jax.device_get(r_j.T)))
    v_t, b2_t = thyb._local_map_pass2(mt["Xw"], mt["desc"], mt["valid"], mt["level"], T_ref,
                                      cam_t, ft.desc, ft.uv, ft.level, ft.valid)
    np.testing.assert_array_equal(_np(v_t), _np(v_j))
    np.testing.assert_array_equal(_np(b2_t), _np(b2_j))
