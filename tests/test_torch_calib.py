"""Parity of the port's self-calibration and depth priors with the JAX
package, on the CPU:

  - models/calib: the response basis and fit, the response LUT, the radtan
    distortion fit (radial only and full) and the distortion map, on seeded
    numpy inputs;
  - CalibSlam's two fits on a JAX CalibSlam harvest carried across
    (convert.calib_harvest): the distortion fit on the distorted run's
    correspondences, the response fit on an exposure run's pairs;
  - CalibSlam end to end on tests/test_calib_slam.py's 18 distorted 160x120
    frames (k1 -0.12, k2 0.02, yaw 0.02 a frame): fitted k1 negative and a
    remap closer to the true one than the identity, and the two packages'
    fitted k1 compared;
  - both depth priors (the precomputed .npy and uint16 PNG renders, a tiny
    seeded torch model) and set_first / DirectOdometry fed from a prior.

Tolerances: the fits are float32 Gauss-Newton solves over thousands of
residuals summed in another order by each framework: parameters to 1e-4
relative to their size (the LUT to 1e-3 grey levels, the remap to 1e-3 px).
End to end, the fit is weakly observable (tests/test_calib_slam.py says
so) and the run chaotic: runs whose last bits differ harvest different
points (map counts part by up to 100 of ~600 from frame 9 on) and fit
different parameters. Measured on these frames: the JAX package k1
-0.109 / +0.021 / -0.057 on 1 / 3 / 8 CPU cores, the port -0.141 / -0.037
with 1 / 3 torch threads. So the port is held to the reference test's own
criteria (k1 negative, a remap closer to the truth than the identity), the
same indirect keyframes as the JAX run, a harvest within 10 % of its size,
and k1 within 2 |k1_true| = 0.24 of the JAX run's (the spread above is
0.16). k2 is not compared: it trades off against k1, and the same runs put
it anywhere from -0.048 to 0.187.
"""


import jax.numpy as jnp
import numpy as np
import pytest
import torch

import libcml_tpu.models.calib as jcal
from libcml_tpu.core.camera import PinholeCamera as JCam
from libcml_tpu.core.camera import build_remap, invert_distortion, radtan_distort
from libcml_tpu.data.synthetic import SyntheticScene, forward_trajectory
from libcml_tpu.models.direct.config import DirectConfig as JCfg
from libcml_tpu.models.direct.initializer import set_first as jset_first
from libcml_tpu.models.direct.prior import PrecomputedDepthPrior as JPre
from libcml_tpu.models.direct.prior import TorchDepthPrior as JTorchPrior
from libcml_tpu.runtime.calib import CalibSlam as JCalib
from libcml_tpu.runtime.odometry import DirectOdometry as JOdo
from libcml_tpu.runtime.odometry import _preprocess as jpreprocess

import libcml_tpu_torch.models.calib as tcal
from libcml_tpu_torch import convert
from libcml_tpu_torch.core.camera import PinholeCamera as TCam
from libcml_tpu_torch.models.direct.config import DirectConfig as TCfg
from libcml_tpu_torch.models.direct.initializer import set_first as tset_first
from libcml_tpu_torch.models.direct.prior import PrecomputedDepthPrior as TPre
from libcml_tpu_torch.models.direct.prior import TorchDepthPrior as TTorchPrior
from libcml_tpu_torch.runtime.calib import CalibSlam as TCalib
from libcml_tpu_torch.runtime.odometry import DirectOdometry as TOdo
from libcml_tpu_torch.runtime.odometry import _preprocess as tpreprocess

# one torch thread per test process (tests/test_torch_slice.py says why)
torch.set_num_threads(1)

CAM_ARGS = (110.0, 110.0, 79.5, 59.5, 160, 120)
JCAM, TCAM = JCam.make(*CAM_ARGS), TCam.make(*CAM_ARGS)
# tests/test_calib_slam.py
CFG_KW = dict(num_levels=3, max_points=512, points_per_kf=128, init_points=128,
              max_frames=5, tracker_iters=8, init_iters=12, ba_iters=4,
              kf_flow_threshold=0.55, activate_min_traces=2, activate_max_relwidth=0.35,
              outlier_energy=300.0)
K1, K2 = -0.12, 0.02


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _t(x):
    return torch.as_tensor(np.array(x))


def _close(got, want, rtol=1e-5, atol=1e-5):
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=atol)


# -- models/calib ---------------------------------------------------------------------------


def _pairs(seed, n=3000):
    """Intensity pairs of one surface under exposure ratios 1.3 / 0.8 through
    a gamma-0.85 response, with 5 % gross outliers and 10 % invalid."""
    rng = np.random.default_rng(seed)
    irr = rng.uniform(0.05, 0.75, n)
    e = np.where(rng.random(n) < 0.5, 1.3, 0.8).astype(np.float32)
    i1 = 255.0 * irr ** 0.85
    i2 = 255.0 * np.clip(e * irr, 0, 1) ** 0.85 + rng.normal(0, 0.5, n)
    i2[rng.random(n) < 0.05] = rng.uniform(0, 255, int((rng.random(n) < 0.05).sum()) or 1)[0]
    valid = rng.random(n) > 0.1
    return i1.astype(np.float32), i2.astype(np.float32), e, valid


@pytest.mark.parametrize("seed", [0, 1])
def test_response_fit_matches_reference(seed):
    i1, i2, e, valid = _pairs(seed)
    x = np.linspace(0, 1, 37, dtype=np.float32)
    _close(tcal._response_basis(_t(x)), jcal._response_basis(jnp.asarray(x)), atol=1e-7)
    cj = jcal.calibrate_response(*(jnp.asarray(a) for a in (i1, i2, e, valid)))
    ct = tcal.calibrate_response(*(_t(a) for a in (i1, i2, e, valid)))
    _close(ct, cj, rtol=1e-4, atol=1e-5)
    assert np.abs(_np(cj)).max() > 1e-2           # the fit moved off the identity
    _close(tcal.apply_response(_t(cj), _t(x)), jcal.apply_response(cj, jnp.asarray(x)),
           atol=1e-6)
    _close(tcal.response_lut(_t(cj)), jcal.response_lut(cj), atol=1e-3)


def _distortion_problem(seed, n=1500):
    """Camera-frame points and their radtan-distorted pixels (k1 -0.12, k2
    0.02, p1 1e-3, p2 -5e-4), with 1 px noise, 5 % outliers, 10 % invalid
    rows and a few non-finite ones."""
    rng = np.random.default_rng(seed)
    xn = rng.uniform([-0.7, -0.5], [0.7, 0.5], (n, 2))
    z = rng.uniform(1.0, 8.0, n)
    Xc = np.c_[xn * z[:, None], z].astype(np.float32)
    xd = radtan_distort(xn, K1, K2, 1e-3, -5e-4)
    uv = np.c_[110.0 * xd[:, 0] + 79.5, 110.0 * xd[:, 1] + 59.5] + rng.normal(0, 1.0, (n, 2))
    out = rng.random(n) < 0.05
    uv[out] += rng.uniform(-40, 40, (int(out.sum()), 2))
    valid = rng.random(n) > 0.1
    Xc[:3] = np.nan
    valid[:3] = False
    return Xc, uv.astype(np.float32), valid


@pytest.mark.parametrize("radial_only", [True, False])
def test_distortion_fit_matches_reference(radial_only):
    Xc, uv, valid = _distortion_problem(3)
    pj = jcal.calibrate_distortion(jnp.asarray(Xc), jnp.asarray(uv), jnp.asarray(valid), JCAM,
                                   radial_only=radial_only)
    pt = tcal.calibrate_distortion(_t(Xc), _t(uv), _t(valid), TCAM, radial_only=radial_only)
    _close(pt, pj, rtol=1e-4, atol=1e-6)
    assert _np(pt)[0] < -0.1 and abs(_np(pt)[1] - K2) < 0.02
    _close(tcal.distortion_map(_np(pt), TCAM), jcal.distortion_map(pj, JCAM), atol=1e-3)


# -- CalibSlam --------------------------------------------------------------------------------


def _distort(xn):
    return radtan_distort(xn, K1, K2, 0.0, 0.0)


@pytest.fixture(scope="module")
def calib_runs():
    """Both packages' CalibSlam over the 18 distorted frames, and the JAX
    package's over tests/test_calib_slam.py's 12 exposure-varying frames."""
    sc = SyntheticScene.default(JCAM, seed=3)
    sc_d = SyntheticScene(sc.planes, JCAM, tex3d=sc.tex3d,
                          undistort_xn=lambda xn: invert_distortion(_distort, xn))
    imgs = [sc_d.render(R, t)[0].astype(np.float32)
            for R, t in forward_trajectory(18, step=0.08, yaw_rate=0.02)]
    runs = {}
    for name, odo in (("jax", JCalib(JCAM, JCfg(**CFG_KW), orb_budget=192, orb_levels=2)),
                      ("torch", TCalib(TCAM, TCfg(**CFG_KW), orb_budget=192, orb_levels=2,
                                       device="cpu"))):
        for i, img in enumerate(imgs):
            odo.process(img, float(i))
        runs[name] = odo
    expo = JCalib(JCAM, JCfg(**CFG_KW), orb_budget=128, orb_levels=2)
    for i, (R, t) in enumerate(forward_trajectory(12, step=0.08, yaw_rate=0.003)):
        img, _ = sc.render(R, t)
        e = 1.0 if i % 2 == 0 else 1.3
        expo.process((255.0 * np.clip(e * img / 255.0, 0, 1) ** 0.85).astype(np.float32),
                     float(i), exposure=e)
    runs["jax_exposure"] = expo
    return runs


def _remap_errors(remap):
    true_remap = build_remap(JCAM, np.asarray(JCAM.K()), _distort)
    H, W = JCAM.height, JCAM.width
    u, v = np.meshgrid(np.arange(W, dtype=np.float32), np.arange(H, dtype=np.float32))
    sl = np.s_[H // 6: -H // 6, W // 6: -W // 6]
    err = np.linalg.norm(np.asarray(remap)[sl] - true_remap[sl], axis=-1).mean()
    err_id = np.linalg.norm(np.stack([u, v], -1)[sl] - true_remap[sl], axis=-1).mean()
    return err, err_id


def test_calib_fits_on_carried_harvest(calib_runs):
    """The port's two fits on the JAX runs' harvests carried across."""
    jodo, expo = calib_runs["jax"], calib_runs["jax_exposure"]
    port = TCalib(TCAM, TCfg(**CFG_KW), orb_budget=192, orb_levels=2, device="cpu")
    convert.load_calib_harvest(port, convert.calib_harvest(jodo))
    assert sum(len(a) for a in port._geo_Xc) > 200
    pj, pt = jodo.fit_distortion(), port.fit_distortion()
    assert pj is not None and pt is not None
    _close(pt, pj, rtol=1e-4, atol=1e-6)
    convert.load_calib_harvest(port, convert.calib_harvest(expo))
    lj, lt = expo.fit_response(), port.fit_response()
    assert lj is not None and lt is not None
    _close(lt, lj, atol=1e-3)
    assert lt[128] < 128.0 and np.all(np.diff(lt) > -1.0)


def test_calib_slam_end_to_end(calib_runs, tmp_path):
    """CalibSlam on raw distorted frames: both packages track, fit a barrel
    k1 and a remap better than the identity; their parameters agree."""
    jodo, todo = calib_runs["jax"], calib_runs["torch"]
    assert todo.state == "TRACKING" and todo.segments == 0
    assert todo.optimal_triangulation is False
    assert [k["frame"] for k in todo._ind_kfs] == [k["frame"] for k in jodo._ind_kfs]
    n_t, n_j = (sum(len(a) for a in o._geo_Xc) for o in (todo, jodo))
    assert abs(n_t - n_j) <= 0.1 * n_j, (n_t, n_j)
    pj, pt = jodo.fit_distortion(), todo.fit_distortion()
    assert pt is not None and pt[0] < -1e-3, pt
    assert abs(pt[0] - pj[0]) <= 2 * abs(K1), (pt, pj)
    cal = todo.finalize()
    err, err_id = _remap_errors(cal.remap)
    assert err < err_id, (err, err_id)
    assert cal.gamma is None                  # constant exposure: no response fit
    todo.save(str(tmp_path / "calib.npz"))
    z = np.load(tmp_path / "calib.npz")
    np.testing.assert_array_equal(z["remap"], cal.remap)
    assert float(z["fx"]) == 110.0 and int(z["width"]) == 160


# -- depth priors -----------------------------------------------------------------------------


class _TinyDepth(torch.nn.Module):
    """A two-layer convolutional stand-in for a monocular depth model."""

    def __init__(self):
        super().__init__()
        g = torch.Generator().manual_seed(7)
        self.c1 = torch.nn.Conv2d(1, 4, 3, padding=1)
        self.c2 = torch.nn.Conv2d(4, 1, 3, padding=1)
        with torch.no_grad():
            for p in self.parameters():
                p.copy_(torch.randn(p.shape, generator=g) * 0.5)

    def forward(self, x):
        return self.c2(torch.tanh(self.c1(x)))


def test_depth_priors_match_reference(tmp_path):
    from PIL import Image

    rng = np.random.default_rng(5)
    npy = rng.uniform(0.1, 2.0, (120, 160)).astype(np.float32)
    np.save(tmp_path / "a.idepth.npy", npy)
    png = rng.integers(0, 65536, (120, 160)).astype(np.uint16)
    Image.fromarray(png).save(tmp_path / "b.idepth.midas_large.png")
    for name in ("a.png", "b.png", "c.png"):
        path = str(tmp_path / name)
        want, got = JPre()(None, 0, path), TPre()(None, 0, path)
        if want is None:
            assert got is None
        else:
            np.testing.assert_array_equal(got, want)
    assert TPre()(None, 0, None) is None
    img = SyntheticScene.default(JCAM, seed=3).render(*forward_trajectory(1)[0])[0]
    model = _TinyDepth()
    want = JTorchPrior(model)(img, 0)
    got = TTorchPrior(model, device="cpu")(img, 0)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert got.shape == (120, 160) and got.min() >= 0.1 and got.max() <= 2.0


def test_set_first_from_prior_matches_reference():
    """set_first seeded from a prior, and DirectOdometry(depth_prior=...)
    whose first frame goes through it, against the JAX package."""
    sc = SyntheticScene.default(JCAM, seed=3)
    img, idepth = sc.render(*forward_trajectory(1)[0])
    cfg_j, cfg_t = JCfg(**CFG_KW), TCfg(**CFG_KW)
    sj = jset_first(jpreprocess(jnp.asarray(img), cfg_j.num_levels), JCAM, cfg_j,
                    prior_idepth=jnp.asarray(idepth))
    st = tset_first(tpreprocess(_t(img), cfg_t.num_levels), TCAM, cfg_t,
                    prior_idepth=_t(idepth))
    np.testing.assert_array_equal(_np(st.uv), _np(sj.uv))
    _close(st.idepth, sj.idepth, rtol=1e-5, atol=1e-6)
    assert np.std(_np(st.idepth)) > 0.05       # seeded from the prior, not 1.0

    def prior(image, frame_idx, path):
        assert path is None                     # as the JAX package calls it
        return idepth

    jodo = JOdo(JCAM, cfg_j, depth_prior=prior)
    todo = TOdo(TCAM, cfg_t, depth_prior=prior, device="cpu")
    jodo.process(img, 0.0)
    todo.process(img, 0.0)
    _close(todo._init_state.idepth, jodo._init_state.idepth, rtol=1e-5, atol=1e-6)
    # PrecomputedDepthPrior never fires through process (no path there)
    odo = TOdo(TCAM, cfg_t, depth_prior=TPre(), device="cpu")
    odo.process(img, 0.0)
    np.testing.assert_array_equal(_np(odo._init_state.idepth), 1.0)


def test_calib_entry_points_default_to_the_card():
    """CalibSlam and TorchDepthPrior run on the CUDA card unless the caller
    names the CPU; without CUDA they raise."""
    if torch.cuda.is_available():
        assert TCalib(TCAM, TCfg(**CFG_KW)).device.type == "cuda"
        assert TTorchPrior(_TinyDepth()).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            TCalib(TCAM, TCfg(**CFG_KW))
        with pytest.raises(RuntimeError, match="CUDA"):
            TTorchPrior(_TinyDepth())
