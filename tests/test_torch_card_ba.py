"""The window BA kernels (csrc/ba_run.cu, ba_sweep.cu, ba_solve.cu) on the
card, held to their plain forms: run_ba and run_ba_mixed in one launch and
on a world of one (the mesh's split launches), the two routes to each other
bit for bit, the residual status and the marginalization pieces, and two
faults planted in the mixed BA's one launch that the smoke's check refuses.

The window is tests/test_torch_ba_kernels.py's (keyframes 0, 2, 4, 6 of the
160x120 synthetic scene, 64 points each), built with the port alone: this
file imports only torch, numpy, pytest and the port, so that it runs on the
card machine (which has no JAX package):

    python -m pytest --noconftest -q tests/test_torch_card_*.py

Without a card every case skips. tests/test_torch_ba_kernels.py imports the
window, the factors, the configurations and the run comparison from here.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import libcml_tpu_torch.models.direct.ba as tba
import libcml_tpu_torch.models.direct.window as twin
from libcml_tpu_torch import convert
from libcml_tpu_torch.core.camera import PinholeCamera as TCam
from libcml_tpu_torch.core.lie import SE3 as TSE3, se3_exp
from libcml_tpu_torch.data.synthetic import SyntheticScene, forward_trajectory
from libcml_tpu_torch.models.direct.config import DirectConfig as TCfg
from libcml_tpu_torch.models.direct.selector import select_points
from libcml_tpu_torch.ops import ba_sweep as bk
from libcml_tpu_torch.ops.image import build_gradient_pyramid

torch.set_num_threads(1)

CAM_ARGS = (110.0, 110.0, 79.5, 59.5, 160, 120)
CFG_KW = dict(num_levels=3, max_points=256, points_per_kf=64, init_points=256,
              max_frames=4, tracker_iters=8, init_iters=12, ba_iters=4)
TCAM = TCam.make(*CAM_ARGS)
TCFG = TCfg(**CFG_KW)
KF_FRAMES = [0, 2, 4, 6]
# every step rejected: the candidates' inverse depths clamped to 1e-3
REJECTING = TCfg(**{**CFG_KW, "ba_iters": 2, "idepth_max": 1e-3})
# tests/test_torch_direct.py test_run_ba_matches_reference's bounds
TOL = {"E_rel": 1e-3, "T": 2e-4, "idepth_rel": 1e-2, "idepth_abs": 1e-3}
# run_ba_mixed's: tests/test_torch_hybrid.py's run_ba_mixed parity bounds
# (bk.MIXED_PARITY_TOL), the factors' inverse depths held like idepth
MIXED_TOL = bk.MIXED_PARITY_TOL


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def build_window() -> dict:
    """Keyframes at frames 0, 2, 4, 6 with perturbed poses, 64 points each
    at their rendered inverse depth; the rendered images kept for the mixed
    case's factors."""
    scene = SyntheticScene.default(TCAM, seed=3)
    poses = forward_trajectory(7, step=0.08, yaw_rate=0.003)
    rng = np.random.default_rng(1)
    w = twin.empty_window(TCFG, TCAM.height, TCAM.width)
    rendered = {}
    for n, i in enumerate(KF_FRAMES):
        img, idep = scene.render(*poses[i])
        rendered[i] = (img, idep)
        g0 = build_gradient_pyramid(torch.tensor(img), 1)[0]
        xi = torch.tensor(rng.normal(0, 0.004, 6) if n else np.zeros(6), dtype=torch.float32)
        T = se3_exp(xi).compose(TSE3(R=torch.tensor(poses[i][0], dtype=torch.float32),
                                     t=torch.tensor(poses[i][1], dtype=torch.float32)))
        w, slot = twin.add_keyframe(w, g0, T, torch.zeros(2), i)
        uv, valid, _ = select_points(g0, 64)
        ui = _np(uv).astype(int)
        rho = idep[np.clip(ui[:, 1], 0, 119), np.clip(ui[:, 0], 0, 159)]
        ok = _np(valid) & (rho > 1e-3)
        w = twin.add_points(w, slot, uv, torch.tensor(rho), torch.tensor(ok), TCFG)
    w = w.replace(ba=tba.anchor_first_frame(w.ba, 0, TCFG))
    return {"ba": w.ba, "images": w.images, "poses": poses, "rendered": rendered}


def build_factors(window, Q=32, seed=5, noise=0.5, sigma2=1.0) -> tba.IndirectFactors:
    """Indirect factors hosted in slot 0: frame 0's pixels at their rendered
    depth, projected with the true poses into slots 1-3, `noise` px of
    Gaussian noise, measurement variance `sigma2`."""
    rng = np.random.default_rng(seed)
    F = TCFG.max_frames
    _, idep = window["rendered"][0]
    uv = np.c_[rng.uniform(10, 150, Q), rng.uniform(10, 110, Q)].astype(np.float32)
    rho = idep[uv[:, 1].astype(int), uv[:, 0].astype(int)].astype(np.float32)
    Xh = _np(TCAM.unproject(torch.tensor(uv), torch.tensor(rho))).astype(np.float64)
    R0, t0 = window["poses"][0]
    Xw = (Xh - t0) @ R0
    obs = np.zeros((Q, F, 2), np.float32)
    ok = np.zeros((Q, F), bool)
    for s, i in enumerate(KF_FRAMES[1:], start=1):
        R, t = window["poses"][i]
        Xc = Xw @ R.T + t
        pix = np.c_[110.0 * Xc[:, 0] / Xc[:, 2] + 79.5, 110.0 * Xc[:, 1] / Xc[:, 2] + 59.5]
        obs[:, s] = pix + rng.normal(0, noise, pix.shape)
        ok[:, s] = (Xc[:, 2] > 0.1) & (pix[:, 0] > 2) & (pix[:, 0] < 157) & (pix[:, 1] > 2) \
            & (pix[:, 1] < 117)
    rho0 = (rho * rng.uniform(0.97, 1.03, Q)).astype(np.float32)
    return convert.from_np(tba.IndirectFactors, dict(
        uv=uv, host=np.zeros(Q, np.int32), idepth=rho0, point_valid=rho > 1e-3, obs_uv=obs,
        obs_valid=ok, sigma2=np.full((Q, F), sigma2, np.float32)))


def assert_run_close(st, E, ref_st, ref_E, tol=TOL, idepth_i=None):
    """The run comparison at `tol`; `idepth_i`: the factors' inverse depths
    (got, want), held like idepth."""
    np.testing.assert_allclose(_np(E), _np(ref_E), rtol=tol["E_rel"])
    np.testing.assert_allclose(_np(st.T.t), _np(ref_st.T.t), atol=tol["T"])
    np.testing.assert_allclose(_np(st.T.R), _np(ref_st.T.R), atol=tol["T"])
    np.testing.assert_allclose(_np(st.idepth), _np(ref_st.idepth), rtol=tol["idepth_rel"],
                               atol=tol["idepth_abs"])
    np.testing.assert_array_equal(_np(st.point_valid), _np(ref_st.point_valid))
    if idepth_i is not None:
        np.testing.assert_allclose(_np(idepth_i[0]), _np(idepth_i[1]), rtol=tol["idepth_rel"],
                                   atol=tol["idepth_abs"])


@pytest.fixture(scope="module")
def window():
    return build_window()


# -- the kernels on the card --------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no CPU mode")
    return torch.device("cuda")


def _to(st, dev):
    return convert.from_np(tba.BAState, convert.to_np(st), device=dev)


def _cpu(st):
    return convert.from_np(tba.BAState, convert.to_np(st))


def _ind_to(ind, dev):
    return convert.from_np(tba.IndirectFactors, convert.to_np(ind), device=dev)


def _smoke():
    """chip_smoke.py (at the repo's root), whose phase-14 checks these
    tests share; imported inside the tests that use it."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    return chip_smoke


def _launches() -> dict:
    return {"run": bk.ba_run_cuda.launches, "sweep": bk.ba_sweep_cuda.launches,
            "solve": bk.ba_solve_cuda.launches}


@pytest.fixture(scope="module")
def mesh_of_one():
    """A world of one over NCCL in this process (the mesh's route: split
    sweep, solve and FINISH launches with identity collectives between
    them), destroyed at the module's end."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no CPU mode")
    import torch.distributed as dist

    from libcml_tpu_torch.parallel.sharding import make_mesh
    mesh = make_mesh()
    yield mesh
    dist.destroy_process_group()


@pytest.mark.parametrize("case", ["default", "rejected"])
@pytest.mark.parametrize("route", ["one_launch", "mesh"])
def test_cuda_run_ba_matches_plain(cuda, window, request, route, case):
    """run_ba on the card, in one launch of the run kernel (the unsharded
    route) or in split sweep, solve and FINISH launches (the route of a mesh,
    here a world of one), held to run_ba_plain; with every step rejected the
    state keeps its bits."""
    cfg = TCFG if case == "default" else REJECTING
    mesh = request.getfixturevalue("mesh_of_one") if route == "mesh" else None
    st, images = _to(window["ba"], cuda), window["images"].to(cuda)
    before = _launches()
    got, E = tba.run_ba(st, images, TCAM, cfg, mesh)
    torch.cuda.synchronize()
    launches = {k: v - before[k] for k, v in _launches().items()}
    if route == "one_launch":
        assert launches == {"run": 1, "sweep": 0, "solve": 0}
    else:
        assert launches == {"run": 0, "sweep": 2 + 3 * cfg.ba_iters, "solve": cfg.ba_iters}
    want, E_want = tba.run_ba_plain(st, images, TCAM, cfg)
    assert_run_close(_cpu(got), E.cpu(), _cpu(want), E_want.cpu())
    if case == "rejected":
        for x, y in ((got.T.R, st.T.R), (got.T.t, st.T.t), (got.ab, st.ab),
                     (got.delta, st.delta), (got.idepth, st.idepth)):
            assert torch.equal(x, y)


@pytest.mark.parametrize("case", ["default", "rejected", "mixed"])
def test_cuda_one_launch_equals_mesh_of_one(cuda, mesh_of_one, window, case):
    """The run kernel and a world of one's split launches run the same
    device functions in the same orders: the same bits (E, the trace, every
    state tensor, and for run_ba_mixed the factors' inverse depths)."""
    cfg = TCFG if case == "default" else REJECTING
    st, images = _to(window["ba"], cuda), window["images"].to(cuda)
    ind = _ind_to(build_factors(window), cuda) if case == "mixed" else None
    traces = [torch.empty((cfg.ba_iters, 2), device=cuda) for _ in range(2)]
    a = tba._run_ba_cuda(st, images, TCAM, cfg, None, ind=ind, trace=traces[0])
    b = tba._run_ba_cuda(st, images, TCAM, cfg, mesh_of_one, ind=ind, trace=traces[1])
    torch.cuda.synchronize()
    (a, *ai, Ea), (b, *bi, Eb) = a, b
    assert torch.equal(Ea, Eb) and torch.equal(traces[0], traces[1])
    for x, y in ((a.T.R, b.T.R), (a.T.t, b.T.t), (a.ab, b.ab), (a.delta, b.delta),
                 (a.idepth, b.idepth), *zip(ai, bi)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("route", ["one_launch", "mesh"])
def test_cuda_run_ba_mixed_matches_plain(cuda, window, request, route):
    """run_ba_mixed on the card, in one launch of the run kernel (the
    factors swept, solved and back-substituted inside it) or in the split
    launches of a world of one, held to run_ba_mixed_plain at
    bk.MIXED_PARITY_TOL, the factors' inverse depths too; the one launch is
    all the call enqueues, and it waits for nothing (chip_smoke.py's
    _syncs, phase 14's check)."""
    mesh = request.getfixturevalue("mesh_of_one") if route == "mesh" else None
    st, images = _to(window["ba"], cuda), window["images"].to(cuda)
    ind = _ind_to(build_factors(window), cuda)
    before = _launches()
    got, got_i, E = tba.run_ba_mixed(st, images, TCAM, TCFG, ind, mesh)
    torch.cuda.synchronize()
    launches = {k: v - before[k] for k, v in _launches().items()}
    if route == "one_launch":
        assert launches == {"run": 1, "sweep": 0, "solve": 0}
        inside = _smoke()._syncs(lambda: tba.run_ba_mixed(st, images, TCAM, TCFG, ind))
        assert inside == {"syncs": 0, "memcpys": 0, "enqueues": 1}, inside
    else:
        n = TCFG.ba_iters
        assert launches == {"run": 0, "sweep": 2 + 3 * n, "solve": n}
    want, want_i, E_want = tba.run_ba_mixed_plain(st, images, TCAM, TCFG, ind)
    assert_run_close(_cpu(got), E.cpu(), _cpu(want), E_want.cpu(), MIXED_TOL,
                     (got_i.idepth.cpu(), want_i.idepth.cpu()))


def test_cuda_run_ba_mixed_at_capacity(cuda, window):
    """At bk.run_max_groups (the window's point groups and the factors'
    filling every block's shared memory) run_ba_mixed is one launch with a
    finite result no higher in energy than its start; one factor point more
    is refused before any launch."""
    st, images = _to(window["ba"], cuda), window["images"].to(cuda)
    P = st.uv.shape[0]
    Q = (bk.run_max_groups(cuda) - -(-P // bk.GROUP_POINTS)) * bk.GROUP_POINTS
    ind = _ind_to(build_factors(window, Q=Q), cuda)
    E0 = tba.total_energy(st, images, TCAM, TCFG, ind)
    before = _launches()
    got, got_i, E = tba.run_ba_mixed(st, images, TCAM, TCFG, ind)
    torch.cuda.synchronize()
    assert {k: v - before[k] for k, v in _launches().items()} == {"run": 1, "sweep": 0, "solve": 0}
    assert torch.isfinite(got.T.t).all() and torch.isfinite(got_i.idepth).all()
    assert float(E) <= float(E0)
    big = _ind_to(build_factors(window, Q=Q + 1), cuda)
    before = _launches()
    with pytest.raises(ValueError, match="at most"):
        tba.run_ba_mixed(st, images, TCAM, TCFG, big)
    assert _launches() == before


def test_cuda_status_and_marg_match_plain(cuda, window):
    st, images = _to(window["ba"], cuda), window["images"].to(cuda)
    got = tba.update_residual_status(st, images, TCAM, TCFG)
    want = tba.update_residual_status_plain(st, images, TCAM, TCFG)
    assert torch.equal(got.res_active, want.res_active)
    assert torch.equal(got.point_valid, want.point_valid)
    got = tba._marg_pieces(st, images, TCAM, TCFG, 1)
    want = tba._marg_pieces_plain(st, images, TCAM, TCFG, 1)
    for x, y in zip(got[:4], want[:4]):
        ref = _np(y.cpu())
        np.testing.assert_allclose(_np(x.cpu()), ref, rtol=1e-3,
                                   atol=1e-3 * max(1.0, float(np.abs(ref).max())))


def test_cuda_planted_mixed_faults_are_refused(cuda, window, tmp_path):
    """Each of chip_smoke.py's planted faults (BA_MIXED_FAULTS: the
    reprojection Huber threshold at 4, the factors' Schur pair left out of
    the damped system), built from a copy of the sources and run through the
    one launch on factors whose residuals straddle the Huber threshold
    (sigma2 0.1: chi2 ~5 at 0.5 px), fails the smoke's verdict for the mixed
    BA (mixed_verdict: run_ba_verdict at bk.MIXED_PARITY_TOL with the float64
    run), while the shipped kernel passes it; each reading is printed beside
    the tolerance."""
    from libcml_tpu_torch.ops import kernel_build as kb

    cs = _smoke()
    st, images = _to(window["ba"], cuda), window["images"].to(cuda)
    ind = _ind_to(build_factors(window, sigma2=0.1), cuda)
    tr = []
    plain = (*tba.run_ba_mixed_plain(st, images, TCAM, TCFG, ind, trace=tr), tr)
    f64 = cs.run_ba_f64(st, images, TCAM, TCFG, ind)
    paths = cs.write_ba_faults(tmp_path)
    kb.build_many(list(paths.values()))
    verdicts = {}
    for name, path in [("shipped", bk.RUN_SOURCE), *paths.items()]:
        with cs.ba_run_source(path):
            v, dec = cs.mixed_verdict(st, images, TCAM, TCFG, ind, plain, f64)
        verdicts[name] = v["ok"]
        print(name, json.dumps({"ok": v["ok"], "max_err": v["parity"]["max_err"],
                                "tol": MIXED_TOL, "decisions": dec["kernel"]}))
    assert verdicts == {"shipped": True, **{name: False for name in cs.BA_MIXED_FAULTS}}, verdicts
