"""The two LM kernels' plain forms held to the JAX package, their dispatch and
wrapper checks, the kernels' schedule and sum order modelled on the CPU.

The tracker's LM (`tracker.track_levels_plain`, the plain form of
csrc/track_lm.cu) and motion-only PnP (`pnp.pnp_lm_plain`, the plain form of
csrc/pnp_lm.cu) run here on the CPU against the JAX package's programs on
inputs made with numpy from a seed (160x120, a few hundred points; PnP at
N = 4096). The kernels cannot run here. Two models stand in for them:
- their schedule, one sweep an LM step (the system at T_new summed with
  E_new and kept on accept, the system of T kept on reject; PnP's E_new over
  the step's ok(T), the re-classification merged into the next round's first
  sweep and into the covariance sweep), written in torch with the plain
  forms' own functions and held to the plain forms bit for bit;
- their arithmetic order (each thread of a cluster of 8 blocks of 256 its
  points in index order, a warp shuffle tree, the warps in order, the
  blocks in rank order), their upper-triangle normal equations and their
  pivoted elimination, in numpy, held to the plain forms within the
  tolerances phase 13 of chip_smoke.py applies on the card
  (`ops.track_lm.PARITY_TOL`, `ops.pnp_lm.PARITY_TOL`).
The kernels themselves are held to the plain forms on the card by
tests/test_torch_card_lm.py (skipped without CUDA) and by chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import libcml_tpu.models.direct.tracker as jtrk
import libcml_tpu.models.indirect.pnp as jpnp
from libcml_tpu.core.camera import PinholeCamera as JCam
from libcml_tpu.core.lie import SE3 as JSE3, se3_exp as jse3_exp
from libcml_tpu.data.synthetic import SyntheticScene, forward_trajectory
from libcml_tpu.models.direct.config import DirectConfig as JCfg
from libcml_tpu.models.direct.selector import select_points as jselect
from libcml_tpu.ops.image import bilinear as jbilinear, build_gradient_pyramid as jpyr

import libcml_tpu_torch.models.direct.tracker as ttrk
import libcml_tpu_torch.models.indirect.pnp as tpnp
from libcml_tpu_torch import convert
from libcml_tpu_torch.core.camera import PinholeCamera as TCam
from libcml_tpu_torch.core.lie import SE3 as TSE3
from libcml_tpu_torch.models.direct.config import DirectConfig as TCfg
from libcml_tpu_torch.models.direct.residuals import (
    PATTERN_CENTER, evaluate_residuals, rel_pose_jacobian)
from libcml_tpu_torch.ops import pnp_lm, track_lm
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
THREADS, WARPS, CLUSTER = 256, 8, 8   # csrc/track_lm.cu, pnp_lm.cu, lm_common.cuh


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _t(x):
    return convert.tensor(np.asarray(x))


def _jse3(R, t):
    return JSE3(R=jnp.asarray(R, jnp.float32), t=jnp.asarray(t, jnp.float32))


@pytest.fixture(scope="module")
def scene():
    """Frames 0 and 2 at 160x120 and frame 0's 256 selected points with
    ground-truth inverse depth; the reference point set in both packages
    (the port's converted from the JAX package's)."""
    sc = SyntheticScene.default(JCAM, seed=3)
    poses = forward_trajectory(3, step=0.08, yaw_rate=0.003)
    (img0, idep0), _, (img2, _) = (sc.render(R, t) for R, t in poses)
    jp = [jpyr(jnp.asarray(im), 3) for im in (img0, img2)]
    tp = [tpyr(_t(im), 3) for im in (img0, img2)]
    uv, valid, _ = jselect(jp[0][0], 256)
    idepth = jbilinear(jnp.asarray(idep0), uv)
    valid = valid & (idepth > 1e-3)
    rj = jtrk.make_tracker_ref(jp[0], JCAM, uv, idepth, valid, JCFG)
    rt = convert.from_np(ttrk.TrackerRef, convert.to_np(jax.device_get(rj)))
    T_gt = _jse3(*poses[2]).compose(_jse3(*poses[0]).inverse())
    return dict(jp=jp, tp=tp, rj=rj, rt=rt, T_gt=T_gt)


def _level_args(scene, levels):
    """track_levels_plain's per-level arguments for `levels` (in order)."""
    rt, tp = scene["rt"], scene["tp"][1]
    return ([tp[l] for l in levels], [TCAM.level(l) for l in levels],
            [rt.uv[l] for l in levels], [rt.color[l] for l in levels],
            [rt.weight[l] for l in levels], [rt.valid[l] for l in levels])


def _hypotheses(scene):
    """The recovery battery about a perturbed prediction, with the prediction
    given twice (as _retrack_step does): 15 starts, two of them identical."""
    T_pred = jse3_exp(jnp.asarray([0.01, 0.0, 0.05, 0.0, 0.01, 0.0], jnp.float32)).compose(
        scene["T_gt"])
    Hj = jtrk.motion_hypotheses(T_pred, JSE3.identity(), T_extra=T_pred)
    return Hj, TSE3(R=_t(Hj.R), t=_t(Hj.t))


# -- (a) the plain forms against the JAX package ----------------------------------------


@pytest.mark.parametrize("case", ["track_levels", "coarse_battery"])
def test_track_levels_plain_matches_jax(scene, case):
    """Every hypothesis through the listed levels: the plain form against the
    JAX `_track_level` chain per hypothesis (all levels, B = 2) and against
    `jax.vmap` of track_multi's coarse_refine (the two coarse levels, B = 15).
    Same schedule and accept rule; the last-bit differences of the two
    frameworks' sums may move the final accepted step: 1e-4 in the pose, 1e-3
    in (a, b) and relative in the energy (as test_torch_direct's tracker
    tests)."""
    jp, rj = scene["jp"][1], scene["rj"]
    Hj, Ht = _hypotheses(scene)
    if case == "track_levels":
        levels = [2, 1, 0]
        sel = [0, 3]
    else:
        levels = [2, 1]
        sel = list(range(15))
    ab0 = np.array([0.02, -1.5], np.float32)
    abc = np.array([0.01, -1.0], np.float32)
    R, t, ab, E, iters, trace, _ = ttrk.track_levels_plain(
        *_level_args(scene, levels), scene["rt"].idepth, Ht.R[sel].contiguous(),
        Ht.t[sel].contiguous(), _t(np.tile(ab0, (len(sel), 1))), _t(abc), TCFG)
    assert iters.shape == (len(sel), len(levels)) and iters.dtype == torch.int32
    assert trace.shape == (len(sel), len(levels), TCFG.tracker_iters, 3)
    ran = torch.arange(TCFG.tracker_iters)[None, None] < iters[..., None].long()
    assert torch.isfinite(trace[ran]).all() and torch.isnan(trace[~ran]).all()

    def chain(T0):
        T, ab, E = T0, jnp.asarray(ab0), jnp.asarray(0.0, jnp.float32)
        for l in levels:
            T, ab, E = jtrk._track_level(jp[l], JCAM.level(l), rj.uv[l], rj.idepth,
                                         rj.color[l], rj.weight[l], rj.valid[l], T, ab, JCFG,
                                         ab_center=jnp.asarray(abc))
        return T.R, T.t, ab, E

    Tj = jax.tree.map(lambda x: x[jnp.asarray(sel)], Hj)
    if case == "coarse_battery":
        want = jax.vmap(chain)(Tj)
    else:
        outs = [chain(jax.tree.map(lambda x, i=i: x[i], Tj)) for i in range(len(sel))]
        want = [jnp.stack(x) for x in zip(*outs)]
    np.testing.assert_allclose(_np(R), np.asarray(want[0]), atol=1e-4)
    np.testing.assert_allclose(_np(t), np.asarray(want[1]), atol=1e-4)
    np.testing.assert_allclose(_np(ab), np.asarray(want[2]), atol=1e-3)
    np.testing.assert_allclose(_np(E), np.asarray(want[3]), rtol=1e-3)
    if case == "coarse_battery":
        # the prediction twice (starts 0 and 6): the same bits, a tie
        assert torch.equal(R[0], R[6]) and float(E[0]) == float(E[6])


def test_best_hypothesis_takes_the_first_on_ties():
    """track_multi's on-device pick: the lowest energy, the first of an exact
    tie, as jnp.argmin; poses and (a, b) gathered from that start."""
    E = np.array([3.0, 1.5, 2.0, 1.5, 9.0], np.float32)
    R = _t(np.stack([np.eye(3, dtype=np.float32) * (k + 1) for k in range(5)]))
    t = _t(np.arange(15, dtype=np.float32).reshape(5, 3))
    ab = _t(np.arange(10, dtype=np.float32).reshape(5, 2))
    T, ab_best = ttrk._best_hypothesis(R, t, ab, _t(E))
    k = int(jnp.argmin(jnp.asarray(E)))
    assert k == 1
    assert torch.equal(T.R, R[k]) and torch.equal(T.t, t[k]) and torch.equal(ab_best, ab[k])


def _pnp_problem(seed, n=4096, outliers=0.3):
    """N matches of a 160x120 camera: ~30 % outliers, per-match sigma2 of
    three pyramid levels, some points behind the camera, some invalid."""
    rng = np.random.default_rng(seed)
    Xw = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n), rng.uniform(3, 8, n)], -1)
    Xw[rng.random(n) < 0.03, 2] *= -1.0                  # behind the camera
    xi = np.array([0.05, -0.02, 0.1, 0.01, -0.02, 0.015], np.float32)
    T = jse3_exp(jnp.asarray(xi))
    R, t = np.asarray(T.R, np.float64), np.asarray(T.t, np.float64)
    Xc = Xw @ R.T + t
    uv = np.stack([110 * Xc[:, 0] / Xc[:, 2] + 79.5, 110 * Xc[:, 1] / Xc[:, 2] + 59.5], -1)
    uv += rng.normal(0, 0.5, uv.shape)
    bad = rng.random(n) < outliers
    uv[bad] += rng.uniform(-30, 30, (bad.sum(), 2))
    valid = rng.random(n) > 0.05
    sigma2 = 1.2 ** (2.0 * rng.integers(0, 3, n))
    T0 = jse3_exp(jnp.asarray([0.03, -0.01, 0.05, 0.0, 0.0, 0.0], jnp.float32))
    return (Xw.astype(np.float32), uv.astype(np.float32), valid,
            sigma2.astype(np.float32), T0, t)


def _pnp_plain(Xw, uv, valid, s2, T0):
    return tpnp.pnp_lm_plain(_t(Xw), _t(uv), _t(valid), _t(s2), _t(T0.R), _t(T0.t),
                             TCam.make(*CAM_ARGS), 4, 10)


@pytest.mark.parametrize("case", ["outliers", "all_invalid"])
def test_pnp_lm_plain_matches_jax(case):
    """The plain form against the JAX solve_pnp at N = 4096: identical inlier
    sets, the pose to 1e-5, the covariance to 1e-3 relative (as
    test_torch_indirect's PnP test); all-invalid gives a finite pose and no
    inlier in both."""
    Xw, uv, valid, s2, T0, t_true = _pnp_problem(7)
    if case == "all_invalid":
        valid = np.zeros_like(valid)
    want = jpnp.solve_pnp(jnp.asarray(Xw), jnp.asarray(uv), jnp.asarray(valid), T0,
                          JCam.make(*CAM_ARGS), sigma2=jnp.asarray(s2))
    R, t, inlier, n_in, cov, chi2, trace = _pnp_plain(Xw, uv, valid, s2, T0)
    accepted = (trace[..., 1] < trace[..., 0]).sum(-1)
    np.testing.assert_array_equal(_np(inlier), np.asarray(want.inlier))
    assert int(n_in) == int(want.num_inliers) and n_in.dtype == torch.int64
    np.testing.assert_allclose(_np(R), np.asarray(want.T.R), atol=1e-5)
    np.testing.assert_allclose(_np(t), np.asarray(want.T.t), atol=1e-5)
    np.testing.assert_allclose(_np(cov), np.asarray(want.cov), rtol=1e-3, atol=1e-9)
    np.testing.assert_allclose(float(chi2), float(want.chi2), rtol=1e-3, atol=1e-6)
    assert trace.shape == (4, 10, 2)
    if case == "all_invalid":
        assert int(n_in) == 0 and int(accepted.sum()) == 0
        assert np.isfinite(_np(R)).all() and np.isfinite(_np(t)).all()
    else:
        assert int(n_in) > 2000 and np.abs(_np(t) - t_true).max() < 0.02
        assert int(accepted[0]) > 0


# -- (c) CPU tensors take the plain path ------------------------------------------------


def test_cpu_tensors_take_the_plain_path(scene):
    """track, track_multi and solve_pnp on CPU tensors give the plain forms'
    results, and neither kernel's launch counter moves."""
    track_lm.track_lm_cuda.launches = pnp_lm.pnp_lm_cuda.launches = 0
    rt, tp = scene["rt"], scene["tp"][1]
    _, Ht = _hypotheses(scene)
    ab0 = torch.zeros(2)
    got = ttrk.track(tp, TCAM, rt, Ht.index(0), ab0, TCFG)
    want = ttrk.track_levels_plain(*_level_args(scene, [2, 1, 0]), rt.idepth, Ht.R[:1],
                                   Ht.t[:1], ab0[None], ab0, TCFG, stats=True)
    assert torch.equal(got.T_ji.R, want[0][0]) and torch.equal(got.T_ji.t, want[1][0])
    for f, w in zip(("energy", "num_valid", "cov_pose", "flow", "flow_no_trans", "saturated"),
                    want[6]):
        assert torch.equal(getattr(got, f), w[0]), f
    multi = ttrk.track_multi(tp, TCAM, rt, Ht, ab0, TCFG)
    assert torch.isfinite(multi.T_ji.t).all() and multi.T_ji.R.device.type == "cpu"
    Xw, uv, valid, s2, T0, _ = _pnp_problem(3, n=500)
    res = tpnp.solve_pnp(_t(Xw), _t(uv), _t(valid), TSE3(R=_t(T0.R), t=_t(T0.t)),
                         TCam.make(*CAM_ARGS), sigma2=_t(s2))
    plain = _pnp_plain(Xw, uv, valid, s2, T0)
    assert torch.equal(res.T.R, plain[0]) and torch.equal(res.inlier, plain[2])
    assert track_lm.track_lm_cuda.launches == 0 and pnp_lm.pnp_lm_cuda.launches == 0


# -- (d) the wrappers' checks -----------------------------------------------------------


def _track_inputs(scene, **over):
    args = dict(zip(("grads", "cams", "uv", "color", "weight", "valid"),
                    _level_args(scene, [2, 1])))
    args.update(idepth=scene["rt"].idepth, R0=torch.eye(3)[None].clone(),
                t0=torch.zeros(1, 3), ab0=torch.zeros(1, 2), ab_center=torch.zeros(2),
                cfg=TCFG)
    args.update(over)
    return args


def _pnp_inputs(**over):
    Xw, uv, valid, s2, T0, _ = _pnp_problem(1, n=64)
    args = dict(Xw=_t(Xw), uv=_t(uv), valid=_t(valid), sigma2=_t(s2), R0=_t(T0.R),
                t0=_t(T0.t), cam=TCam.make(*CAM_ARGS), rounds=4, iters=10)
    args.update(over)
    return args


@pytest.mark.parametrize("what", ["cpu", "dtype", "noncontiguous", "shape"])
def test_wrappers_reject_what_the_kernels_do_not_take(scene, what):
    """Checked before anything is built or launched: a wrong dtype (TypeError),
    a non-contiguous or misshapen input, and CPU tensors (ValueError)."""
    bad_t = {"cpu": {}, "dtype": {"t0": torch.zeros(1, 3, dtype=torch.float64)},
             "noncontiguous": {"R0": torch.eye(3)[None].transpose(1, 2)},
             "shape": {"ab0": torch.zeros(2, 2)}}[what]
    bad_p = {"cpu": {}, "dtype": {"valid": torch.ones(64, dtype=torch.int32)},
             "noncontiguous": {"uv": torch.zeros(2, 64).t()},
             "shape": {"sigma2": torch.ones(63)}}[what]
    err = TypeError if what == "dtype" else ValueError
    with pytest.raises(err):
        track_lm.track_lm_cuda(**_track_inputs(scene, **bad_t))
    with pytest.raises(err):
        pnp_lm.pnp_lm_cuda(**_pnp_inputs(**bad_p))
    assert track_lm.track_lm_cuda.launches == 0 and pnp_lm.pnp_lm_cuda.launches == 0


# -- (e) the kernels' schedule, modelled in torch ---------------------------------------


def _one_sweep_level(grad, cam, uv, idepth, color, weight, valid, T, ab, cfg, ab_center):
    """csrc/track_lm.cu's level schedule with the plain form's arithmetic:
    one sweep at (T, ab) gives the energy and the normal equations there;
    a step solves the kept system, and its one sweep at (T_new, ab_new)
    gives E_new and the system there, kept on accept (the system of T kept
    on reject). Returns _track_level_plain's tuple."""
    wm = torch.where(valid[:, None], weight, torch.zeros_like(weight))
    prior = torch.tensor((0.0,) * 6 + (1e-1, 1e-3))

    def sweep(T, ab):
        ev = evaluate_residuals(grad, cam, uv, idepth, color, wm, T, ab[0], ab[1],
                                huber_k=cfg.huber_intensity, cutoff=cfg.tracker_cutoff,
                                pattern=PATTERN_CENTER)
        ok = ev.valid & valid
        n = torch.clamp(torch.sum(ok), min=1)
        E = torch.sum(torch.where(ok, ev.energy, torch.zeros_like(ev.energy))) / n
        H, b, _ = ttrk.gauss_newton_system(rel_pose_jacobian(ev, color), ev.r, ev.w)
        return E, H, b

    E, H, b = sweep(T, ab)
    lam = torch.full((), 1e-4, dtype=torch.float32)
    trace = torch.full((cfg.tracker_iters, 3), float("nan"))
    it = 0
    while it < cfg.tracker_iters:
        dx = ttrk._solve_scaled(H + torch.diag(prior),
                                b + prior * torch.cat([torch.zeros(6), ab - ab_center]), lam, cfg)
        T_new = ttrk.se3_exp(-dx[:6]).compose(T)
        ab_new = ab - dx[6:]
        E_new, H_new, b_new = sweep(T_new, ab_new)
        accept = E_new < E
        step_norm = torch.linalg.norm(dx)
        trace[it] = torch.stack([E, E_new, step_norm])
        T = ttrk.se3_select(accept, T_new, T)
        ab = torch.where(accept, ab_new, ab)
        E = torch.where(accept, E_new, E)
        if bool(accept):
            H, b = H_new, b_new
        lam = torch.where(accept, torch.clamp(lam * 0.5, min=1e-7), torch.clamp(lam * 4.0, max=1e2))
        it += 1
        if bool((accept & (step_norm < cfg.tracker_converge_eps))
                | (~accept & (lam >= 1e2 - 1e-6))):
            break
    return T, ab, E, it, trace


def _one_sweep_track_levels(grads, cams, uv, color, weight, valid, idepth, R0, t0, ab0,
                            ab_center, cfg):
    """track_levels_plain's loop over starts and levels around
    _one_sweep_level; its tuple without the statistics."""
    out = []
    for h in range(R0.shape[0]):
        T, ab = TSE3(R=R0[h], t=t0[h]), ab0[h]
        E = torch.zeros(())
        its, traces = [], []
        for l in range(len(grads)):
            T, ab, E, it, trace = _one_sweep_level(grads[l], cams[l], uv[l], idepth, color[l],
                                                   weight[l], valid[l], T, ab, cfg, ab_center)
            its.append(it)
            traces.append(trace)
        out.append((T.R, T.t, ab, E, torch.tensor(its, dtype=torch.int32), torch.stack(traces)))
    return (*(torch.stack(x) for x in zip(*out)), None)


def _one_sweep_pnp(Xw, uv, valid, sigma2, R0, t0, cam, rounds, iters):
    """csrc/pnp_lm.cu's schedule with the plain form's arithmetic: a round
    opens with one sweep at T that re-classifies (after the first round) and
    gives E, H and b over ok(T); each step solves the kept system, and its
    one sweep at T_new gives E_new over the step's ok(T) and the system
    over ok(T_new), kept on accept; the covariance sweep re-classifies last.
    Returns pnp_lm_plain's tuple."""
    chi2_2d = tpnp._CHI2_2D
    w_meas = 1.0 / sigma2
    eye6 = torch.eye(6)

    def system(r, Xc, chi2, ok):
        hub = torch.where(chi2 > chi2_2d, torch.sqrt(chi2_2d / torch.clamp(chi2, min=1e-12)),
                          torch.ones_like(chi2))
        w = torch.where(ok, w_meas * hub, torch.zeros_like(chi2))
        J = tpnp._jacobian(Xc, cam)
        return (torch.einsum("nud,n,nue->de", J, w, J), torch.einsum("nud,n,nu->d", J, w, r),
                tpnp._robust_energy(chi2, ok))

    T, inlier, trace = TSE3(R=R0, t=t0), valid, []
    for rnd in range(rounds if iters > 0 else 0):
        lam = torch.full((), 1e-4, dtype=torch.float32)
        r, Xc, z_ok = tpnp._residuals(T, Xw, uv, cam)
        chi2 = torch.sum(r * r, -1) * w_meas
        if rnd > 0:
            inlier = valid & z_ok & (chi2 < chi2_2d)
        ok = inlier & z_ok
        H, b, E = system(r, Xc, chi2, ok)
        for _ in range(iters):
            dx, _ = torch.linalg.solve_ex(H + lam * torch.diag(torch.diag(H)) + 1e-8 * eye6, b)
            T_new = tpnp.se3_exp(-dx).compose(T)
            r, Xc, z_ok = tpnp._residuals(T_new, Xw, uv, cam)
            chi2 = torch.sum(r * r, -1) * w_meas
            E_new = tpnp._robust_energy(chi2, ok)
            ok_new = inlier & z_ok
            H_new, b_new, E_n = system(r, Xc, chi2, ok_new)
            accept = E_new < E
            trace.append(torch.stack([E, E_new]))
            T = tpnp.se3_select(accept, T_new, T)
            if bool(accept):
                ok, H, b, E = ok_new, H_new, b_new, E_n
            lam = torch.where(accept, torch.clamp(lam * 0.5, min=1e-9),
                              torch.clamp(lam * 4.0, max=1e3))
    r, Xc, z_ok = tpnp._residuals(T, Xw, uv, cam)
    chi2 = torch.sum(r * r, -1) * w_meas
    if rounds > 0:
        inlier = valid & z_ok & (chi2 < chi2_2d)
    J = tpnp._jacobian(Xc, cam)
    w = torch.where(inlier, w_meas, torch.zeros_like(w_meas))
    cov, _ = torch.linalg.inv_ex(torch.einsum("nud,n,nue->de", J, w, J) + 1e-6 * eye6)
    chi2_sum = torch.sum(torch.where(inlier, chi2, torch.zeros_like(w_meas)))
    trace = (torch.stack(trace) if trace else torch.zeros((0, 2))).reshape(rounds, iters, 2)
    return T.R, T.t, inlier, torch.sum(inlier), cov, chi2_sum, trace


def _assert_bits(got, want):
    """Equal bit for bit, output by output (NaN where NaN)."""
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = _np(g), _np(w)
        assert g.dtype == w.dtype and g.shape == w.shape, i
        if g.dtype == np.float32:
            g, w = g.view(np.int32), w.view(np.int32)
        assert np.array_equal(g, w), i


@pytest.mark.parametrize("case", ["battery", "all_invalid", "iters0"])
def test_one_sweep_schedule_equals_track_levels_plain(scene, case):
    """The tracker kernel's schedule (one sweep a step: the system at T_new
    summed with E_new, T's system kept on reject) with the plain form's
    arithmetic equals track_levels_plain bit for bit: the same decisions at
    every step (the traces) and the same outputs. The battery's 15 starts
    through three levels; every point invalid (every step rejected: E and
    E_new are 0); tracker_iters 0 (each level only its first sweep)."""
    _, Ht = _hypotheses(scene)
    args = list(_level_args(scene, [2, 1, 0]))
    cfg = TCFG
    if case == "all_invalid":
        args[5] = [torch.zeros_like(v) for v in args[5]]
    if case == "iters0":
        cfg = TCfg(**{**CFG_KW, "tracker_iters": 0})
    ab0 = _t(np.tile(np.array([0.02, -1.5], np.float32), (15, 1)))
    abc = _t(np.array([0.01, -1.0], np.float32))
    rest = (scene["rt"].idepth, Ht.R, Ht.t, ab0, abc, cfg)
    want = ttrk.track_levels_plain(*args, *rest)
    got = _one_sweep_track_levels(*args, *rest)
    _assert_bits(got[:6], want[:6])
    trace, steps = _np(want[5]), _np(want[4])
    if case == "battery":
        assert (steps > 1).any() and (trace[..., 1] < trace[..., 0]).any()
    elif case == "all_invalid":
        # every level rejects every step it takes
        assert (steps == cfg.tracker_iters).all()
        assert not (trace[..., 1] < trace[..., 0]).any()
    else:
        assert trace.shape[2] == 0 and (steps == 0).all()


@pytest.mark.parametrize("case", ["outliers", "all_invalid", "iters0", "rounds0"])
def test_one_sweep_schedule_equals_pnp_lm_plain(case):
    """The PnP kernel's schedule (one sweep a step: E_new over the step's
    ok(T), the system at T_new over ok(T_new), T's system kept on reject; the
    re-classification merged into the next round's first sweep and into the
    covariance sweep) with the plain form's arithmetic equals pnp_lm_plain
    bit for bit, N = 4096 with outliers and points behind the camera; every
    match invalid (every step rejected); iters 0 (only the
    re-classifications); rounds 0 (only the covariance)."""
    Xw, uv, valid, s2, T0, _ = _pnp_problem(7)
    if case == "all_invalid":
        valid = np.zeros_like(valid)
    rounds, iters = {"iters0": (4, 0), "rounds0": (0, 10)}.get(case, (4, 10))
    args = (_t(Xw), _t(uv), _t(valid), _t(s2), _t(T0.R), _t(T0.t), TCam.make(*CAM_ARGS),
            rounds, iters)
    want = tpnp.pnp_lm_plain(*args)
    _assert_bits(_one_sweep_pnp(*args), want)
    accepted = _np(want[6][..., 1] < want[6][..., 0])
    if case == "outliers":
        assert accepted.any() and not accepted.all()
    elif case == "all_invalid":
        assert accepted.size == 40 and not accepted.any()


# -- (f) the kernels' sum order and solve, modelled -------------------------------------


def _cluster_sum(v: np.ndarray) -> np.ndarray:
    """The kernels' cluster reduction of (P, k) f32 values: thread g of the
    CLUSTER x 256 sums its points g, g + 2048, ... in order; in each block a
    shuffle-down tree in each warp, then the warps' partials in warp order;
    then the blocks' partials in rank order (lm_common.cuh cluster_sum)."""
    v = v.astype(np.float32)
    P, k = v.shape
    G = CLUSTER * THREADS
    acc = np.zeros((G, k), np.float32)
    for s in range(0, P, G):
        chunk = v[s:s + G]
        acc[:len(chunk)] += chunk
    w = acc.reshape(CLUSTER, WARPS, 32, k)
    for off in (16, 8, 4, 2, 1):
        w = w.copy()
        w[:, :, :32 - off] = w[:, :, :32 - off] + w[:, :, off:]
    blocks = w[:, 0, 0].copy()
    for i in range(1, WARPS):
        blocks = blocks + w[:, i, 0]
    out = blocks[0].copy()
    for r in range(1, CLUSTER):
        out = out + blocks[r]
    return out


def _lu_solve(A: np.ndarray, B: np.ndarray) -> np.ndarray:
    """lm_common.cuh warp_solve: elimination with partial pivoting (the
    first row of largest magnitude; a NaN never displaces the diagonal), the
    multipliers scaled by the pivot's reciprocal, then back substitution
    multiplying by the pivots' reciprocals, in f32."""
    n = A.shape[0]
    M = np.concatenate([A, B], 1).astype(np.float32)
    rcp = np.zeros(n, np.float32)
    for k in range(n):
        p, best = k, abs(M[k, k])
        for i in range(k + 1, n):
            if abs(M[i, k]) > best:
                p, best = i, abs(M[i, k])
        M[[k, p]] = M[[p, k]]
        rcp[k] = np.float32(1.0) / M[k, k]
        for r in range(k + 1, n):
            lr = np.float32(M[r, k] * rcp[k])
            M[r, k + 1:] = M[r, k + 1:] - lr * M[k, k + 1:]
    X = np.zeros_like(B, dtype=np.float32)
    for k in range(n - 1, -1, -1):
        s = M[k, n:].copy()
        for j in range(k + 1, n):
            s = s - M[k, j] * X[j]
        X[k] = s * rcp[k]
    return X


def _upper(H: np.ndarray) -> np.ndarray:
    """The symmetric matrix from the upper triangle the kernels sum."""
    U = np.triu(H)
    return U + np.triu(U, 1).T


def _model_track_level(grad, cam, uv, idepth, color, weight, valid, R, t, ab, abc, cfg):
    """csrc/track_lm.cu's level loop: one sweep a step (E and the system
    from the same per-point values, the system of T kept on reject), the
    cluster sums and the pivoted solve (per-point values from the plain
    residuals)."""
    wm = torch.where(valid[:, None], weight, torch.zeros_like(weight))
    s = np.array([cfg.scale_trans] * 3 + [cfg.scale_rot] * 3 + [cfg.scale_a, cfg.scale_b],
                 np.float32)

    def sweep(R, t, ab):
        ev = evaluate_residuals(grad, cam, uv, idepth, color, wm, TSE3(R=_t(R), t=_t(t)),
                                torch.tensor(ab[0]), torch.tensor(ab[1]),
                                huber_k=cfg.huber_intensity, cutoff=cfg.tracker_cutoff,
                                pattern=PATTERN_CENTER)
        ok = _np(ev.valid & valid)
        J = _np(rel_pose_jacobian(ev, color))[:, 0]
        jw = J * _np(ev.w)
        cols = [jw[:, d] * J[:, f] for d in range(8) for f in range(d, 8)]
        cols += [jw[:, d] * _np(ev.r)[:, 0] for d in range(8)]
        cols += [np.where(ok, _np(ev.energy), 0.0), ok.astype(np.float32)]
        sums = _cluster_sum(np.stack(cols, -1))
        H = np.zeros((8, 8), np.float32)
        H[np.triu_indices(8)] = sums[:36]
        return np.float32(sums[44] / max(sums[45], np.float32(1.0))), _upper(H), sums[36:44]

    E, H, b = sweep(R, t, ab)
    lam, it = np.float32(1e-4), 0
    trace = np.full((cfg.tracker_iters, 3), np.nan, np.float32)
    prior = np.array([0.0] * 6 + [1e-1, 1e-3], np.float32)
    while it < cfg.tracker_iters:
        Hp = H + np.diag(prior)
        bp = b + prior * np.concatenate([np.zeros(6, np.float32), ab - abc])
        Hs = (Hp * s[:, None]) * s[None, :]
        Hs[np.diag_indices(8)] = (np.diag(Hs) + lam * np.diag(Hs)) + np.float32(1e-8)
        dx = _lu_solve(Hs, (bp * s)[:, None])[:, 0] * s
        Tn = ttrk.se3_exp(_t(-dx[:6])).compose(TSE3(R=_t(R), t=_t(t)))
        Rn, tn, abn = _np(Tn.R), _np(Tn.t), (ab - dx[6:]).astype(np.float32)
        E_new, H_new, b_new = sweep(Rn, tn, abn)
        accept = E_new < E
        trace[it] = (E, E_new, np.linalg.norm(dx))
        if accept:
            R, t, ab, E, H, b = Rn, tn, abn, E_new, H_new, b_new
        lam = np.float32(max(lam * 0.5, 1e-7) if accept else min(lam * 4.0, 1e2))
        it += 1
        if (accept and np.linalg.norm(dx) < cfg.tracker_converge_eps) or (
                not accept and lam >= np.float32(1e2 - 1e-6)):
            break
    return R, t, ab, E, it, trace


def _model_pnp(Xw, uv, valid, s2, R, t, rounds=4, iters=10):
    """csrc/pnp_lm.cu: one sweep a step (E_new over the step's ok(T) and
    the system at T_new over ok(T_new) from the same per-match values, T's
    system kept on reject), the re-classification merged into the next
    round's first sweep and into the covariance sweep, the cluster sums and
    the pivoted solve (per-match values from the plain residuals and
    Jacobian)."""
    cam = TCam.make(*CAM_ARGS)
    w_meas = (np.float32(1.0) / s2).astype(np.float32)
    chi2_2d = np.float32(5.991)

    def res(R, t):
        r, Xc, z_ok = tpnp._residuals(TSE3(R=_t(R), t=_t(t)), _t(Xw), _t(uv), cam)
        r = _np(r)
        return r, _np(tpnp._jacobian(Xc, cam)), _np(z_ok), (r * r).sum(-1) * w_meas

    def robust(c):
        return np.minimum(c, chi2_2d * np.sqrt(np.maximum(c / chi2_2d, np.float32(1.0))))

    def system(r, J, chi2, ok, ok_step):
        """H, b, E over ok and E_new over ok_step (the step's mask)."""
        hub = np.where(chi2 > chi2_2d, np.sqrt(chi2_2d / np.maximum(chi2, 1e-12)), 1.0)
        w = np.where(ok, w_meas * hub, 0.0).astype(np.float32)
        cols = [(J[:, 0, d] * w) * J[:, 0, e] + (J[:, 1, d] * w) * J[:, 1, e]
                for d in range(6) for e in range(d, 6)]
        cols += [(J[:, 0, d] * w) * r[:, 0] + (J[:, 1, d] * w) * r[:, 1] for d in range(6)]
        cols += [np.where(ok, robust(chi2), 0.0), np.where(ok_step, robust(chi2), 0.0)]
        sums = _cluster_sum(np.stack(cols, -1))
        H = np.zeros((6, 6), np.float32)
        H[np.triu_indices(6)] = sums[:21]
        return _upper(H), sums[21:27], sums[27], sums[28]

    inlier, trace = valid.copy(), []
    for rnd in range(rounds if iters > 0 else 0):
        lam = np.float32(1e-4)
        r, J, z_ok, chi2 = res(R, t)
        if rnd > 0:
            inlier = valid & z_ok & (chi2 < chi2_2d)
        ok = inlier & z_ok
        H, b, E, _ = system(r, J, chi2, ok, ok)
        for _ in range(iters):
            Hd = H.copy()
            Hd[np.diag_indices(6)] = (np.diag(H) + lam * np.diag(H)) + np.float32(1e-8)
            dx = _lu_solve(Hd, b[:, None])[:, 0]
            Tn = ttrk.se3_exp(_t(-dx)).compose(TSE3(R=_t(R), t=_t(t)))
            Rn, tn = _np(Tn.R), _np(Tn.t)
            r, J, z_ok, chi2 = res(Rn, tn)
            ok_new = inlier & z_ok
            H_new, b_new, E_n, E_new = system(r, J, chi2, ok_new, ok)
            trace.append((E, E_new))
            if E_new < E:
                R, t, ok, H, b, E = Rn, tn, ok_new, H_new, b_new, E_n
                lam = np.float32(max(lam * 0.5, 1e-9))
            else:
                lam = np.float32(min(lam * 4.0, 1e3))
    r, J, z_ok, chi2 = res(R, t)
    if rounds > 0:
        inlier = valid & z_ok & (chi2 < chi2_2d)
    w = np.where(inlier, w_meas, 0.0).astype(np.float32)
    cols = [(J[:, 0, d] * w) * J[:, 0, e] + (J[:, 1, d] * w) * J[:, 1, e]
            for d in range(6) for e in range(d, 6)]
    cols += [np.where(inlier, chi2, 0.0), inlier.astype(np.float32)]
    sums = _cluster_sum(np.stack(cols, -1))
    H = np.zeros((6, 6), np.float32)
    H[np.triu_indices(6)] = sums[:21]
    cov = _lu_solve(_upper(H) + np.float32(1e-6) * np.eye(6, dtype=np.float32),
                    np.eye(6, dtype=np.float32))
    return (R, t, inlier, np.int64(inlier.sum()), cov, np.float32(sums[21]),
            np.array(trace, np.float32).reshape(rounds, iters, 2))


def _track_model_parity(scene, rep: int, starts) -> dict:
    """track_lm.parity of the kernel's model against track_levels_plain
    through three levels from `starts` of the battery, with every point
    `rep` times."""
    _, Ht = _hypotheses(scene)
    args = tuple([torch.cat([v] * rep) if k > 1 else v for v in a]
                 for k, a in enumerate(_level_args(scene, [2, 1, 0])))
    idepth = torch.cat([scene["rt"].idepth] * rep)
    ab0 = np.array([0.02, -1.5], np.float32)
    abc = np.array([0.01, -1.0], np.float32)
    outs = []
    for h in starts:
        R, t, ab = _np(Ht.R[h]), _np(Ht.t[h]), ab0
        its, traces = [], []
        for i in range(3):
            grad, cam, uv, color, weight, valid = (a[i] for a in args)
            R, t, ab, E, it, trace = _model_track_level(grad, cam, uv, idepth, color, weight,
                                                        valid, R, t, ab, abc, TCFG)
            its.append(it)
            traces.append(trace)
        outs.append((R, t, ab, np.float32(E), np.array(its, np.int32), np.stack(traces)))
    model = (*(torch.from_numpy(np.stack(x)) for x in zip(*outs)), None)
    sel = torch.tensor(starts)
    want = ttrk.track_levels_plain(*args, idepth, Ht.R[sel], Ht.t[sel],
                                   _t(np.tile(ab0, (len(starts), 1))), _t(abc), TCFG)
    return track_lm.parity(model, want, TCFG)


def test_track_kernel_model_within_parity_tolerance(scene):
    """The tracker kernel's schedule and arithmetic order (one sweep a step,
    cluster sums, upper-triangle H, pivoted solve by reciprocals) against the plain form's
    two sweeps a step in einsum order, through three
    levels from every start of the battery: within track_lm.parity's bounds,
    the one phase 13 of chip_smoke.py applies to the kernel on the card (a
    start whose steps differ must first differ at a decision within
    DECISION_TOL of its threshold). Then with every point 17 times (P 4352,
    as phase 13's case past the registers makes it), from three starts: the
    cluster sum spreads the points over all eight ranks, and a thread gets
    more points than the KREG x 2048 it holds in registers."""
    res = _track_model_parity(scene, 1, range(15))
    assert res["ok"], res
    # most starts take the same steps; the rest differ first at a decision
    # at its threshold
    assert len(res["diverged"]) <= 5, res
    assert 17 * scene["rt"].idepth.numel() > 2 * CLUSTER * THREADS
    res = _track_model_parity(scene, 17, (0, 6, 11))
    assert res["ok"], res


def test_pnp_kernel_model_within_parity_tolerance():
    """The PnP kernel's schedule and arithmetic order (one sweep a step, the
    re-classification merged, cluster sums) against the plain form's, N = 4096
    with outliers and points behind the camera, three seeds: within
    pnp_lm.parity's bounds, as phase 13 applies them on the card."""
    for seed in (7, 8, 9):
        Xw, uv, valid, s2, T0, _ = _pnp_problem(seed)
        model = _model_pnp(Xw, uv, valid, s2, np.asarray(T0.R), np.asarray(T0.t))
        model = tuple(torch.as_tensor(np.asarray(x)) for x in model)
        want = _pnp_plain(Xw, uv, valid, s2, T0)
        res = pnp_lm.parity(model, want, _t(Xw), _t(uv), _t(valid), _t(s2),
                            TCam.make(*CAM_ARGS))
        assert res["ok"], res
