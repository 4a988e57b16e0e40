"""Parity of the PyTorch port's relocalization and bootstrap modules with
the JAX package, on the CPU: the VFC filter, the BoW vocabulary and keyframe
retrieval, EPnP RANSAC and the two-view initializer (both fed the
reference's own random draws), and, on the port alone, the reference tests'
blackout-and-return relocalization (tests/test_recovery.py) and two-view
bootstrap (tests/test_twoview_bootstrap.py) with their own bounds.

Tolerances, with their reasons:
  - masks, word ids, vocabulary words, idf and retrieval ranks are exact;
  - retrieval scores are sums of a few hundred f32 terms: 1e-6;
  - EPnP and the two-view pose come out of eigen-decompositions and an LM
    polish run in f32 by both frameworks: poses to 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import libcml_tpu.models.indirect.bow as jbow
import libcml_tpu.runtime.hybrid as jhyb
from libcml_tpu.core.camera import PinholeCamera as JCam
from libcml_tpu.core.lie import se3_exp as jse3_exp
from libcml_tpu.data.synthetic import SyntheticScene, forward_trajectory
from libcml_tpu.models.indirect.epnp import epnp_ransac as jransac, epnp_solve as jsolve
from libcml_tpu.models.indirect.matching import vfc_filter as jvfc
from libcml_tpu.models.indirect.twoview import two_view_init as jtwo

import libcml_tpu_torch.models.indirect.bow as tbow
from libcml_tpu_torch import convert
from libcml_tpu_torch.core.camera import PinholeCamera as TCam
from libcml_tpu_torch.models.direct.config import DirectConfig as TCfg
from libcml_tpu_torch.models.indirect.epnp import epnp_ransac as transac, epnp_solve as tsolve
from libcml_tpu_torch.models.indirect.matching import vfc_filter as tvfc
from libcml_tpu_torch.models.indirect.orb import OrbFeatures
from libcml_tpu_torch.models.indirect.twoview import two_view_init as ttwo
from libcml_tpu_torch.runtime.hybrid import HybridOdometry

# The suite runs in several worker processes that share a few cores: one
# torch thread each, since with torch's default thread pool per process the
# workers' spinning threads slow each other down many times over.
torch.set_num_threads(1)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _t(x):
    return convert.tensor(np.asarray(x))


def _close(got, want, rtol=1e-5, atol=1e-5, **kw):
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=atol, **kw)


# -- VFC -------------------------------------------------------------------------------------


def _field(seed, N=128, n_out=12, rot=0.0):
    """Seeded matches whose displacement is a smooth field (a shift and a
    small rotation about the image centre) with `n_out` gross outliers."""
    rng = np.random.default_rng(seed)
    uv_q = rng.uniform(0, 300, (N, 2)).astype(np.float32)
    c, s = np.cos(rot), np.sin(rot)
    uv_t = (uv_q - 150) @ np.array([[c, -s], [s, c]], np.float32).T + 150 + [5.0, -3.0]
    uv_t[:n_out] += rng.uniform(-60, 60, (n_out, 2))
    valid = rng.random(N) > 0.1
    return uv_q, uv_t.astype(np.float32), valid


@pytest.mark.parametrize("seed,rot", [(4, 0.0), (5, 0.05), (6, 0.1)])
def test_vfc_filter_matches_reference(seed, rot):
    uv_q, uv_t, valid = _field(seed, rot=rot)
    want = np.asarray(jvfc(jnp.asarray(uv_q), jnp.asarray(uv_t), jnp.asarray(valid)))
    got = _np(tvfc(_t(uv_q), _t(uv_t), _t(valid)))
    np.testing.assert_array_equal(got, want)
    # the reference test's own bounds (tests/test_matching.py:73)
    assert got[12:][valid[12:]].mean() > 0.9 and got[:12].mean() < 0.3


# -- vocabulary and retrieval ------------------------------------------------------------------


@pytest.fixture(scope="module")
def vocabularies(tmp_path_factory):
    """Both packages' default vocabularies, each trained from scratch on its
    own ORB of the same rendered frames (into temporary caches)."""
    d = tmp_path_factory.mktemp("voc")
    return (jbow.default_vocabulary(str(d / "jax.npz")),
            tbow.default_vocabulary(d / "torch.npz"))


def test_default_vocabulary_matches_reference(vocabularies):
    jv, tv = vocabularies
    assert tv.num_words == jv.num_words > 100
    np.testing.assert_array_equal(tv.words, np.asarray(jv.words))
    np.testing.assert_array_equal(tv.idf, np.asarray(jv.idf))


@pytest.mark.parametrize("seed", [0, 1])
def test_train_vocabulary_matches_reference(seed):
    rng = np.random.default_rng(seed)
    centers = rng.integers(0, 2**32, (12, 8), dtype=np.uint64).astype(np.uint32)
    flips = rng.integers(0, 2**32, (600, 8), dtype=np.uint64).astype(np.uint32) \
        & rng.integers(0, 2**32, (600, 8), dtype=np.uint64).astype(np.uint32) \
        & rng.integers(0, 2**32, (600, 8), dtype=np.uint64).astype(np.uint32)
    desc = centers[rng.integers(0, 12, 600)] ^ flips
    jv = jbow.train_vocabulary(desc, k=5, depth=3, iters=6, seed=seed)
    tv = tbow.train_vocabulary(desc.view(np.int32), k=5, depth=3, iters=6, seed=seed)
    np.testing.assert_array_equal(tv.words, np.asarray(jv.words))
    np.testing.assert_array_equal(tv.idf, np.asarray(jv.idf))


CAM_ARGS = (110.0, 110.0, 79.5, 59.5, 160, 120)
JCAM, TCAM = JCam.make(*CAM_ARGS), TCam.make(*CAM_ARGS)


@pytest.fixture(scope="module")
def frames():
    """ORB features (192 per level, 2 levels) of 20 rendered frames, from
    the JAX package and carried into the port."""
    sc = SyntheticScene.default(JCAM, seed=3)
    feats = []
    for R, t in forward_trajectory(20, step=0.08, yaw_rate=0.003):
        f = jax.device_get(jhyb._extract(jnp.asarray(sc.render(R, t)[0]), 192, 2))
        feats.append((f, convert.from_np(OrbFeatures, convert.to_np(f))))
    return feats


def test_keyframe_database_matches_reference(vocabularies, frames):
    jv, tv = vocabularies
    jdb, tdb = jbow.KeyframeDatabase(jv), tbow.KeyframeDatabase(tv)
    for kf in (0, 3, 6, 9, 12, 15):
        fj, ft = frames[kf]
        jdb.add(kf, fj.desc, fj.valid)
        tdb.add(kf, ft.desc, ft.valid)
    for q in (1, 7, 10, 13, 19):
        fj, ft = frames[q]
        np.testing.assert_array_equal(_np(tv.assign(ft.desc, ft.valid)),
                                      np.asarray(jv.assign(fj.desc, fj.valid)))
        want = jdb.query(fj.desc, fj.valid, max_results=3)
        got = tdb.query(ft.desc, ft.valid, max_results=3)
        assert [k for k, _ in got] == [k for k, _ in want], (q, got, want)
        _close([s for _, s in got], [s for _, s in want], rtol=0, atol=1e-6)
    # the nearest stored keyframe ranks first
    assert tdb.query(frames[7][1].desc, frames[7][1].valid)[0][0] in (6, 9)
    tdb.remove(6)
    jdb.remove(6)
    fj, ft = frames[7]
    assert [k for k, _ in tdb.query(ft.desc, ft.valid)] == \
        [k for k, _ in jdb.query(fj.desc, fj.valid)]
    a, b = tv.bow_vector(ft.desc, ft.valid), tv.bow_vector(frames[9][1].desc, frames[9][1].valid)
    _close(tbow.score_l1(a, b), jbow.score_l1(jnp.asarray(_np(a)), jnp.asarray(_np(b))),
           rtol=0, atol=1e-6)


# -- EPnP --------------------------------------------------------------------------------------

PCAM_ARGS = (200.0, 200.0, 159.5, 119.5, 320, 240)
JPCAM, TPCAM = JCam.make(*PCAM_ARGS), TCam.make(*PCAM_ARGS)


def _pnp_scene(seed, N=64, bad_frac=0.35):
    """tests/test_epnp.py's scene: points 3-9 m ahead, a known pose, 0.3 px
    noise and a share of gross outliers."""
    rng = np.random.default_rng(seed)
    Xw = np.stack([rng.uniform(-2, 2, N), rng.uniform(-1.5, 1.5, N),
                   rng.uniform(3.0, 9.0, N)], axis=1).astype(np.float32)
    T_gt = jse3_exp(jnp.asarray([0.3, -0.2, 0.4, 0.05, -0.08, 0.03], jnp.float32))
    uv, ok = JPCAM.project(T_gt.apply(jnp.asarray(Xw)))
    uv = np.asarray(uv) + rng.normal(0, 0.3, (N, 2))
    bad = rng.choice(N, int(bad_frac * N), replace=False)
    uv[bad] += rng.uniform(30, 120, (len(bad), 2)) * rng.choice([-1, 1], (len(bad), 2))
    valid = np.asarray(ok) & (rng.random(N) > 0.05)
    return Xw, uv.astype(np.float32), valid, T_gt, bad


def _reference_subsets(valid, seed, n_hyp=64, subset=6):
    """epnp_ransac's own draws (libcml_tpu/models/indirect/epnp.py:176-182)."""
    p = valid.astype(np.float32)
    p = jnp.asarray(p / max(p.sum(), 1e-9))
    keys = jax.random.split(jax.random.PRNGKey(seed), n_hyp)
    pick = jax.vmap(lambda k: jax.random.choice(k, len(valid), (subset,), replace=False, p=p))
    return np.asarray(pick(keys))


def test_epnp_solve_matches_reference():
    Xw, uv, valid, _, _ = _pnp_scene(0, bad_frac=0.0)
    w = valid.astype(np.float32)
    Tj = jsolve(jnp.asarray(Xw), jnp.asarray(uv), jnp.asarray(w), JPCAM)
    Tt = tsolve(_t(Xw), _t(uv), _t(w), TPCAM)
    _close(Tt.R, Tj.R, rtol=0, atol=1e-4)
    _close(Tt.t, Tj.t, rtol=0, atol=1e-4)


@pytest.mark.parametrize("seed", [2, 3])
def test_epnp_ransac_matches_reference(seed):
    Xw, uv, valid, T_gt, bad = _pnp_scene(seed)
    want = jransac(jnp.asarray(Xw), jnp.asarray(uv), jnp.asarray(valid), JPCAM,
                   jax.random.PRNGKey(seed))
    got = transac(_t(Xw), _t(uv), _t(valid), TPCAM,
                  subsets=_t(_reference_subsets(valid, seed)))
    assert bool(got.ok) and bool(want.ok)
    np.testing.assert_array_equal(_np(got.inliers), np.asarray(want.inliers))
    _close(got.T.R, want.T.R, rtol=0, atol=1e-4)
    _close(got.T.t, want.T.t, rtol=0, atol=1e-4)
    _close(got.T.t, T_gt.t, rtol=0, atol=0.08)            # tests/test_epnp.py's bound
    assert _np(got.inliers)[bad].mean() < 0.2
    # the port's own draws reach the same pose
    gen = torch.Generator().manual_seed(seed)
    own = transac(_t(Xw), _t(uv), _t(valid), TPCAM, generator=gen)
    assert bool(own.ok)
    _close(own.T.t, T_gt.t, rtol=0, atol=0.08)


# -- two-view initializer ------------------------------------------------------------------------

TCAM2_ARGS = (300.0, 300.0, 159.5, 119.5, 320, 240)
JCAM2, TCAM2 = JCam.make(*TCAM2_ARGS), TCam.make(*TCAM2_ARGS)


def _two_view_scene(seed, N=300):
    """tests/test_twoview.py's scene: 0.4 px noise, 15 % outlier matches."""
    rng = np.random.default_rng(seed)
    Xw = rng.uniform([-3, -2, 4], [3, 2, 12], (N, 3)).astype(np.float32)
    T1 = jse3_exp(jnp.asarray([0.4, 0.05, 0.1, 0.01, -0.03, 0.005], jnp.float32))

    def proj(R, t):
        Xc = Xw @ np.asarray(R).T + np.asarray(t)
        return np.c_[300.0 * Xc[:, 0] / Xc[:, 2] + 159.5,
                     300.0 * Xc[:, 1] / Xc[:, 2] + 119.5], Xc[:, 2]

    uv0, z0 = proj(np.eye(3), np.zeros(3))
    uv1, z1 = proj(T1.R, T1.t)
    uv0 += rng.normal(0, 0.4, uv0.shape)
    uv1 += rng.normal(0, 0.4, uv1.shape)
    out = rng.choice(N, N // 7, replace=False)
    uv1[out] += rng.uniform(20, 80, (len(out), 2))
    return uv0.astype(np.float32), uv1.astype(np.float32), (z0 > 0) & (z1 > 0), T1


@pytest.mark.parametrize("seed", [0, 1])
def test_two_view_init_matches_reference(seed):
    uv0, uv1, valid, T1 = _two_view_scene(seed)
    key = jax.random.PRNGKey(seed)
    want = jtwo(jnp.asarray(uv0), jnp.asarray(uv1), jnp.asarray(valid), JCAM2, key)
    # two_view_init's own draws (libcml_tpu/models/indirect/twoview.py:50-54,170-172)
    k_f, k_h, _ = jax.random.split(key, 3)
    idx_f = np.asarray(jax.random.randint(k_f, (256, 8), 0, len(uv0)))
    idx_h = np.asarray(jax.random.randint(k_h, (256, 4), 0, len(uv0)))
    got = ttwo(_t(uv0), _t(uv1), _t(valid), TCAM2, idx_f=_t(idx_f), idx_h=_t(idx_h))
    assert bool(got.ok) and bool(want.ok)
    assert bool(got.used_homography) == bool(want.used_homography)
    assert int(got.num_inliers) == int(want.num_inliers)
    np.testing.assert_array_equal(_np(got.inlier), np.asarray(want.inlier))
    _close(got.T_10.R, want.T_10.R, rtol=0, atol=1e-4)
    _close(got.T_10.t, want.T_10.t, rtol=0, atol=1e-4)
    # the hypotheses' scores sum truncated Sampson errors of 8-point fits
    # made by two eigen-solvers in f32: up to 1.0e-3 apart on these inputs
    _close(got.score_f, want.score_f, rtol=2e-3)
    t_est, t_gt = _np(got.T_10.t), np.asarray(T1.t)
    assert np.dot(t_est, t_gt) / (np.linalg.norm(t_est) * np.linalg.norm(t_gt)) > 0.995


# -- the port's HybridOdometry: relocalization and the two-view bootstrap ------------------------

# tests/test_recovery.py:13-28
RECOVERY_CFG = dict(num_levels=3, max_points=1024, points_per_kf=256, init_points=256,
                    max_frames=5, tracker_iters=8, init_iters=12, ba_iters=6,
                    kf_flow_threshold=0.55, activate_min_traces=2, activate_max_relwidth=0.35,
                    outlier_energy=300.0, max_track_fails=2, lost_grace_frames=3)


def test_port_hybrid_relocalizes_after_blackout():
    """tests/test_recovery.py:75-114 on the port: 14 frames, 4 black frames,
    then viewpoint 8 again. BoW retrieval, descriptor matching, VFC and EPnP
    must recover a pose within 0.15 of viewpoint 8's earlier estimate."""
    sc = SyntheticScene.default(JCAM, seed=3)
    poses = forward_trajectory(20, step=0.08, yaw_rate=0.003)
    odo = HybridOdometry(TCAM, TCfg(**RECOVERY_CFG), orb_budget=192, orb_levels=2,
                         device="cpu")
    black = np.zeros((TCAM.height, TCAM.width), np.float32)
    for i in range(14):
        odo.process(sc.render(*poses[i])[0], float(i))
    assert odo.state == "TRACKING"
    assert len(odo._kf_store) >= 2, "no relocalization keyframes stored"
    _, est = odo.trajectory_c2w()
    p8_before = est[8, :3, 3].copy()
    t = 14.0
    for _ in range(4):
        odo.process(black, t)
        t += 1.0
    img8 = sc.render(*poses[8])[0]
    relocalized = False
    for _ in range(3):
        out = odo.process(img8, t)
        t += 1.0
        if out.get("relocalized"):
            relocalized = True
            break
    assert relocalized, f"never relocalized (state {odo.state})"
    assert odo._pt_valid.sum() > 0          # the relocalized restart kept the map
    _, est = odo.trajectory_c2w()
    err = np.linalg.norm(est[-1, :3, 3] - p8_before)
    assert err < 0.15, f"relocalized pose off by {err:.3f}"


def test_port_twoview_bootstrap_promotes_and_tracks():
    """tests/test_twoview_bootstrap.py:21 on the port: the ORB two-view
    bootstrap between frames 0 and 6 gives the ground truth's translation
    direction (cos > 0.95), and tracking continues from it."""
    cfg = TCfg(num_levels=3, max_points=512, points_per_kf=128, init_points=128,
               max_frames=5, tracker_iters=8, init_iters=12, ba_iters=4,
               kf_flow_threshold=0.55, activate_min_traces=2,
               activate_max_relwidth=0.35, outlier_energy=300.0)
    sc = SyntheticScene.default(JCAM, seed=3)
    poses = forward_trajectory(12, step=0.1, yaw_rate=0.003)
    imgs = [sc.render(R, t)[0] for R, t in poses]
    odo = HybridOdometry(TCAM, cfg, orb_budget=256, orb_levels=2, device="cpu")
    odo.process(imgs[0], 0.0)
    assert odo._twoview_bootstrap(torch.as_tensor(imgs[6], dtype=torch.float32), 6.0)
    assert odo.state == "TRACKING"
    M0, M6 = np.eye(4), np.eye(4)
    M0[:3, :3], M0[:3, 3] = poses[0]
    M6[:3, :3], M6[:3, 3] = poses[6]
    t_gt = (M6 @ np.linalg.inv(M0))[:3, 3]
    t_est = _np(odo._kf_T.t)
    cos = np.dot(t_est, t_gt) / (np.linalg.norm(t_est) * np.linalg.norm(t_gt) + 1e-12)
    assert cos > 0.95, f"translation direction off (cos {cos:.3f})"
    for i in range(7, 12):
        out = odo.process(imgs[i], float(i))
    assert out.get("ok")
    _, est = odo.trajectory_c2w()
    assert np.isfinite(est[:, :3, 3]).all()


def test_bootstrap_fires_from_process():
    """process() runs the bootstrap itself once the direct initializer has
    not converged for 15 frames (every 5th frame after that)."""
    odo = HybridOdometry(TCAM, TCfg(**RECOVERY_CFG), orb_budget=192, orb_levels=2,
                         device="cpu")
    calls = []
    odo._twoview_bootstrap = lambda img, ts: calls.append(odo.frame_idx) or False
    flat = np.full((TCAM.height, TCAM.width), 128.0, np.float32)   # never initializes
    for i in range(26):
        odo.process(flat, float(i))
    assert odo.state == "INIT"
    a = odo._anchor_kf       # the first frame's index
    assert calls == [a + 15, a + 20, a + 25]
