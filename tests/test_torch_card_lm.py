"""The LM kernels (csrc/track_lm.cu, csrc/pnp_lm.cu) on the card, held to
their plain forms under track_lm.parity and pnp_lm.parity: the tracker's
levels for the recovery battery about a perturbed prediction (15 starts, two
identical) with track's statistics, and PnP at N = 4096 with ~30 % outliers.

The inputs are those of tests/test_torch_lm_kernels.py (160x120, the same
seeds and sizes), built with the port alone: this file imports only torch,
numpy, pytest and the port, so that it runs on the card machine (which has
no JAX package):

    python -m pytest --noconftest -q tests/test_torch_card_*.py

Without a card every case skips.
"""

import numpy as np
import pytest
import torch

import libcml_tpu_torch.models.direct.tracker as trk
import libcml_tpu_torch.models.indirect.pnp as pnp
from libcml_tpu_torch import convert
from libcml_tpu_torch.core.camera import PinholeCamera
from libcml_tpu_torch.core.lie import SE3, se3_exp
from libcml_tpu_torch.data.synthetic import SyntheticScene, forward_trajectory
from libcml_tpu_torch.models.direct.config import DirectConfig
from libcml_tpu_torch.models.direct.selector import select_points
from libcml_tpu_torch.ops import pnp_lm, track_lm
from libcml_tpu_torch.ops.image import bilinear, build_gradient_pyramid

torch.set_num_threads(1)

CAM_ARGS = (110.0, 110.0, 79.5, 59.5, 160, 120)
CFG = DirectConfig(num_levels=3, max_points=256, points_per_kf=64, init_points=256,
                   max_frames=4, tracker_iters=8, init_iters=12, ba_iters=4)
CAM = PinholeCamera.make(*CAM_ARGS)


def _t(x):
    return convert.tensor(np.asarray(x))


def _se3(R, t):
    return SE3(R=_t(np.asarray(R, np.float32)), t=_t(np.asarray(t, np.float32)))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no CPU mode")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def scene():
    """Frames 0 and 2 at 160x120, frame 0's 256 selected points with
    ground-truth inverse depth and their tracker reference, frame 2's
    pyramid, the true relative pose."""
    sc = SyntheticScene.default(CAM, seed=3)
    poses = forward_trajectory(3, step=0.08, yaw_rate=0.003)
    (img0, idep0), _, (img2, _) = (sc.render(R, t) for R, t in poses)
    pyr0, pyr2 = (build_gradient_pyramid(_t(im), 3) for im in (img0, img2))
    uv, valid, _ = select_points(pyr0[0], 256)
    idepth = bilinear(_t(idep0), uv)
    valid = valid & (idepth > 1e-3)
    ref = trk.make_tracker_ref(pyr0, CAM, uv, idepth, valid, CFG)
    T_gt = _se3(*poses[2]).compose(_se3(*poses[0]).inverse())
    return dict(ref=ref, pyr2=pyr2, T_gt=T_gt)


def _hypotheses(scene) -> SE3:
    """The recovery battery about a perturbed prediction, with the prediction
    given twice (as _retrack_step does): 15 starts, two of them identical."""
    T_pred = se3_exp(torch.tensor([0.01, 0.0, 0.05, 0.0, 0.01, 0.0])).compose(scene["T_gt"])
    return trk.motion_hypotheses(T_pred, SE3.identity(), T_extra=T_pred)


def _pnp_problem(seed, n=4096, outliers=0.3):
    """N matches of a 160x120 camera: ~30 % outliers, per-match sigma2 of
    three pyramid levels, some points behind the camera, some invalid."""
    rng = np.random.default_rng(seed)
    Xw = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n), rng.uniform(3, 8, n)], -1)
    Xw[rng.random(n) < 0.03, 2] *= -1.0                  # behind the camera
    T = se3_exp(torch.tensor([0.05, -0.02, 0.1, 0.01, -0.02, 0.015]))
    R, t = T.R.numpy().astype(np.float64), T.t.numpy().astype(np.float64)
    Xc = Xw @ R.T + t
    uv = np.stack([110 * Xc[:, 0] / Xc[:, 2] + 79.5, 110 * Xc[:, 1] / Xc[:, 2] + 59.5], -1)
    uv += rng.normal(0, 0.5, uv.shape)
    bad = rng.random(n) < outliers
    uv[bad] += rng.uniform(-30, 30, (bad.sum(), 2))
    valid = rng.random(n) > 0.05
    sigma2 = 1.2 ** (2.0 * rng.integers(0, 3, n))
    T0 = se3_exp(torch.tensor([0.03, -0.01, 0.05, 0.0, 0.0, 0.0]))
    return Xw.astype(np.float32), uv.astype(np.float32), valid, sigma2.astype(np.float32), T0


def test_cuda_track_lm_matches_plain(cuda, scene):
    ref, grads, Ht = scene["ref"], scene["pyr2"], _hypotheses(scene)
    levels = [2, 1, 0]
    args = [[grads[l].to(cuda) for l in levels], [CAM.level(l) for l in levels]] + [
        [getattr(ref, name)[l].to(cuda) for l in levels]
        for name in ("uv", "color", "weight", "valid")] + [
        ref.idepth.to(cuda), Ht.R.contiguous().to(cuda), Ht.t.contiguous().to(cuda),
        torch.zeros(15, 2, device=cuda), torch.zeros(2, device=cuda), CFG, True]
    before = track_lm.track_lm_cuda.launches
    got = track_lm.track_lm_cuda(*args)
    torch.cuda.synchronize()
    assert track_lm.track_lm_cuda.launches == before + 1
    res = track_lm.parity(got, trk.track_levels_plain(*args), CFG)
    assert res["ok"] and res["stats_err"] is not None, res


def test_cuda_pnp_lm_matches_plain(cuda):
    Xw, uv, valid, s2, T0 = _pnp_problem(7)
    args = [_t(x).to(cuda) for x in (Xw, uv, valid, s2)] + [
        T0.R.contiguous().to(cuda), T0.t.contiguous().to(cuda)]
    cam = PinholeCamera.make(*CAM_ARGS)
    before = pnp_lm.pnp_lm_cuda.launches
    got = pnp_lm.pnp_lm_cuda(*args, cam, 4, 10)
    torch.cuda.synchronize()
    assert pnp_lm.pnp_lm_cuda.launches == before + 1
    res = pnp_lm.parity(got, pnp.pnp_lm_plain(*args, cam, 4, 10), *args[:4], cam)
    assert res["ok"], res
