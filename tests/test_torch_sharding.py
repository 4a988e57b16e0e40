"""Point-sharded bundle adjustment of the PyTorch port (parallel/sharding.py,
`mesh=` in models/direct/ba.py and DirectOdometry), on the CPU.

The ranks are gloo processes started with torch.multiprocessing (spawn,
`file://` init); each runs one torch thread and imports no JAX (this module
imports the JAX package only inside the tests that run in the parent). The
parent waits for them under its own deadline and kills them when they
overrun.

tests/test_multichip.py's cases, on the port:
  - the windowed BA (and the mixed BA with indirect factors) at worlds 2 and
    4 against the JAX package's single-device and 8-way sharded runs, at
    that test's tolerances (T.t rtol 1e-2 / atol 1e-4, idepth rtol 1e-2 /
    atol 5e-3: sharded reductions add f32 sums in another order);
  - against the port's unsharded BA, where the sharded one differs only in
    the order of its f32 sums. Reordering the point rows of the unsharded
    problem alone moves one LM step's inverse depths by up to 9.1e-5 and
    its translations by up to 5.4e-6 (measured on this case), so one step
    is held to 2e-4 and 2e-5 (a double-counted or dropped term moves it by
    orders more). Over the two LM iterations reordering alone moves a
    weakly held inverse depth by up to 2.2e-2 (one step drives it to the
    clamp, the next back from it), so the whole solve is held at the JAX
    tolerances to the nearest of the unsharded solve and its row-reordered
    twins: no single summation order is the reference for that point;
  - within one world every rank's state equals rank 0's, and two runs are
    bit-identical (the determinism discipline of that test);
  - a world of one is the unsharded arithmetic exactly;
  - DirectOdometry(mesh=) over that test's 12-frame scene at 2 and 4 ranks
    against the unsharded run: per-frame relative translations rtol 1e-2 /
    atol 1e-5, path length rtol 2e-3; a meshed checkpoint resumes exactly.
"""

import dataclasses
import sys
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from libcml_tpu_torch import convert
from libcml_tpu_torch.core.camera import PinholeCamera as TCam
from libcml_tpu_torch.core.lie import SE3 as TSE3
from libcml_tpu_torch.data.synthetic import SyntheticScene, forward_trajectory
from libcml_tpu_torch.models.direct import ba as tba
from libcml_tpu_torch.models.direct.config import DirectConfig as TCfg
from libcml_tpu_torch.parallel import sharding as sh
from libcml_tpu_torch.runtime.odometry import DirectOdometry as TOdo

torch.set_num_threads(1)

# tests/test_multichip.py:52-55: the BA case
P = 128
BA_KW = dict(num_levels=2, max_points=P, max_frames=3, ba_iters=2)
H, W = 32, 48
BA_CAM_ARGS = (100.0, 100.0, W / 2 - 0.5, H / 2 - 0.5, W, H)
Q = 32                       # indirect factors of the mixed case
# tests/test_multichip.py:137-143: the runtime case
ODO_KW = dict(num_levels=3, max_points=512, points_per_kf=128, init_points=128,
              max_frames=5, tracker_iters=6, init_iters=10, ba_iters=4,
              kf_flow_threshold=0.55, activate_min_traces=2,
              activate_max_relwidth=0.35, outlier_energy=300.0)
ODO_CAM_ARGS = (110.0, 110.0, 79.5, 59.5, 160, 120)
N_FRAMES = 12
MESH_FRAMES = 10             # the hybrid and CalibSlam runs of a world of one
SAVE_AT = 8
RANK_TIMEOUT_S = 300.0

LAM = 1e-3                   # the damping of the one-step comparison
N_REORDER = 4                # row-reordered twins of the unsharded solve
STEP_TOL = {"T.t": dict(rtol=0.0, atol=2e-5), "T.R": dict(rtol=0.0, atol=2e-5),
            "ab": dict(rtol=0.0, atol=2e-5), "idepth": dict(rtol=0.0, atol=2e-4),
            "ind_idepth": dict(rtol=0.0, atol=2e-4)}
STATE_TOL = dict(t=dict(rtol=1e-2, atol=1e-4), idepth=dict(rtol=1e-2, atol=5e-3))


# -- the ranks ------------------------------------------------------------------


def _rank_main(task, rank: int, world: int, out_dir: str, args):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{out_dir}/init", rank=rank,
                            world_size=world)
    try:
        mesh = sh.make_mesh(world, device="cpu")
        out = task(mesh, *args)
        out["all_reduces"] = mesh.all_reduces
        out["all_gathers"] = mesh.all_gathers
        out["jax_imported"] = "jax" in sys.modules
        np.savez(f"{out_dir}/rank{rank}.npz", **out)
    finally:
        dist.destroy_process_group()


def _spawn(out_dir, task, world: int, *args, timeout: float = RANK_TIMEOUT_S) -> list[dict]:
    """Run `task(mesh, *args)` on `world` gloo ranks, their files in the
    empty directory `out_dir`; returns each rank's dict of arrays. Fails
    (after killing the ranks) when one fails or they overrun `timeout`."""
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(task, r, world, out_dir, args), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        while any(p.is_alive() for p in procs):
            if any(p.exitcode not in (None, 0) for p in procs):
                break
            if time.monotonic() > deadline:
                pytest.fail(f"{world} ranks overran {timeout} s")
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(10)
    codes = [p.exitcode for p in procs]
    assert codes == [0] * world, f"rank exit codes {codes}"
    outs = [dict(np.load(f"{out_dir}/rank{r}.npz")) for r in range(world)]
    assert not any(bool(o["jax_imported"]) for o in outs), "a rank imported JAX"
    return outs


def _ba_inputs(case):
    state = convert.from_np(tba.BAState, case["state"])
    ind = convert.from_np(tba.IndirectFactors, case["ind"])
    return state, convert.tensor(case["images"]), ind


def _state_arrays(prefix: str, state: tba.BAState) -> dict:
    out = {}
    for f in dataclasses.fields(state):
        x = getattr(state, f.name)
        if isinstance(x, TSE3):
            out[f"{prefix}{f.name}.R"], out[f"{prefix}{f.name}.t"] = x.R.numpy(), x.t.numpy()
        else:
            out[f"{prefix}{f.name}"] = x.numpy()
    return out


def _ba_task(mesh, case):
    """One LM step of each solver, then run_ba and run_ba_mixed over the
    mesh, each twice from the same state."""
    cam, cfg = TCam.make(*BA_CAM_ARGS), TCfg(**BA_KW)
    state, images, ind = _ba_inputs(case)
    step = sh.sharded_ba_step(cam, cfg, mesh)
    st, _ = tba.ba_step(state, images, cam, cfg, torch.tensor(LAM), mesh=mesh)
    out = _state_arrays("step.", st)
    st, ind_out, _ = tba.ba_step(state, images, cam, cfg, torch.tensor(LAM), ind, mesh=mesh)
    out.update(_state_arrays("mixed_step.", st), **{"mixed_step.ind_idepth":
                                                    ind_out.idepth.numpy()})
    for run in (0, 1):
        st, E = step(state, images)
        out.update(_state_arrays(f"ba{run}.", st), **{f"ba{run}.E": E.numpy()})
        st, ind_out, E = tba.run_ba_mixed(sh.shard_ba_state(state, mesh), images, cam, cfg, ind,
                                          mesh=mesh)
        out.update(_state_arrays(f"mixed{run}.", st), **{f"mixed{run}.E": E.numpy(),
                                                         f"mixed{run}.ind_idepth":
                                                             ind_out.idepth.numpy()})
    return out


def _odometry_task(mesh, imgs, ckpt_dir):
    """DirectOdometry(mesh=) over the frames, saving its state before frame
    SAVE_AT, then a fresh meshed instance resumed from the file."""
    cam, cfg = TCam.make(*ODO_CAM_ARGS), TCfg(**ODO_KW)
    ckpt = f"{ckpt_dir}/rank{mesh.rank}.pkl"
    odo = TOdo(cam, cfg, mesh=mesh, device="cpu")
    for i, img in enumerate(imgs):
        if i == SAVE_AT:
            odo.save_state(ckpt)
        odo.process(img, float(i))
    _, est = odo.trajectory_c2w()
    resumed = TOdo(cam, cfg, mesh=mesh, device="cpu")
    resumed.load_state(ckpt)
    for i in range(SAVE_AT, len(imgs)):
        resumed.process(imgs[i], float(i))
    _, est_resumed = resumed.trajectory_c2w()
    return {"est": est, "est_resumed": est_resumed, "keyframes": odo._win_count,
            **_state_arrays("window.", odo._window.ba)}


# -- the JAX package's case (built in the parent) -------------------------------


@pytest.fixture(scope="module")
def ba_case():
    """tests/test_multichip.py:37's window, built by the JAX package, with
    Q indirect factors on it; the JAX package's single-device and 8-way
    runs of run_ba and run_ba_mixed; the port's unsharded runs."""
    import jax
    import jax.numpy as jnp

    from libcml_tpu.core.camera import PinholeCamera
    from libcml_tpu.core.lie import SE3, se3_exp
    from libcml_tpu.models.direct import ba as ba_mod
    from libcml_tpu.models.direct import window as win_mod
    from libcml_tpu.models.direct.config import DirectConfig
    from libcml_tpu.ops.image import build_gradient_pyramid
    from libcml_tpu.parallel.sharding import ba_shardings, make_mesh, replicated, \
        shard_ba_state, sharded_ba_step

    cfg = DirectConfig(**BA_KW)
    cam = PinholeCamera.make(*BA_CAM_ARGS)
    rng = np.random.default_rng(1)
    img = jnp.asarray(np.cumsum(rng.standard_normal((H, W)), axis=1).astype(np.float32) * 5.0
                      + 127.0)
    grad0 = build_gradient_pyramid(img, 1)[0]
    window = win_mod.empty_window(cfg, H, W)
    window, s0 = win_mod.add_keyframe(window, grad0, SE3.identity(), jnp.zeros(2),
                                      jnp.asarray(0, jnp.int32))
    window = window.replace(ba=ba_mod.anchor_first_frame(window.ba, 0, cfg))
    T1 = se3_exp(jnp.asarray([0.02, 0, 0.05, 0, 0.003, 0], jnp.float32))
    window, _ = win_mod.add_keyframe(window, grad0, T1, jnp.zeros(2), jnp.asarray(1, jnp.int32))
    uv = jnp.asarray(rng.uniform([4, 4], [W - 4, H - 4], (P, 2)), jnp.float32)
    rho = jnp.asarray(rng.uniform(0.5, 1.5, (P,)), jnp.float32)
    window = win_mod.add_points(window, s0, uv, rho, jnp.ones((P,), bool), cfg)

    # indirect factors hosted in slot 0, observed in slot 1 through T1 with
    # 0.5 px noise, a few gross outliers, and perturbed starting depths
    uv_q = rng.uniform([4, 4], [W - 4, H - 4], (Q, 2)).astype(np.float32)
    rho_q = rng.uniform(0.5, 1.5, Q).astype(np.float32)
    Xh = np.asarray(cam.unproject(jnp.asarray(uv_q), jnp.asarray(rho_q)))
    R1, t1 = np.asarray(T1.R), np.asarray(T1.t)
    Xc = Xh @ R1.T + t1
    pix = np.c_[100.0 * Xc[:, 0] / Xc[:, 2] + BA_CAM_ARGS[2],
                100.0 * Xc[:, 1] / Xc[:, 2] + BA_CAM_ARGS[3]]
    obs_uv = np.zeros((Q, cfg.max_frames, 2), np.float32)
    obs_uv[:, 1] = pix + rng.normal(0, 0.5, pix.shape)
    obs_uv[:3, 1] += 8.0
    obs_valid = np.zeros((Q, cfg.max_frames), bool)
    obs_valid[:, 1] = True
    fac = dict(uv=uv_q, host=np.zeros(Q, np.int32),
               idepth=(rho_q * rng.uniform(0.97, 1.03, Q)).astype(np.float32),
               point_valid=np.ones(Q, bool), obs_uv=obs_uv, obs_valid=obs_valid,
               sigma2=np.ones((Q, cfg.max_frames), np.float32))
    ind = ba_mod.IndirectFactors(**{k: jnp.asarray(v) for k, v in fac.items()})

    def mixed(st, im, ind_):
        return ba_mod.run_ba_mixed(st, im, cam, cfg, ind_)

    mesh = make_mesh(8)
    jax_runs = {
        "single": jax.jit(lambda st, im: ba_mod.run_ba(st, im, cam, cfg))(window.ba,
                                                                          window.images),
        "sharded8": sharded_ba_step(cam, cfg, mesh)(shard_ba_state(window.ba, mesh),
                                                    window.images),
        "mixed_single": jax.jit(mixed)(window.ba, window.images, ind),
        "mixed_sharded8": jax.jit(mixed, in_shardings=(
            ba_shardings(window.ba, mesh), replicated(mesh), replicated(mesh)))(
                shard_ba_state(window.ba, mesh), window.images, ind),
    }
    case = {"state": convert.to_np(jax.device_get(window.ba)),
            "images": np.asarray(window.images), "ind": fac}
    # the port, unsharded, on the same inputs
    tcam, tcfg = TCam.make(*BA_CAM_ARGS), TCfg(**BA_KW)
    state, images, tind = _ba_inputs(case)
    port = {"plain": tba.run_ba(state, images, tcam, tcfg),
            "mixed_plain": tba.run_ba_mixed(state, images, tcam, tcfg, tind),
            "step": tba.ba_step(state, images, tcam, tcfg, torch.tensor(LAM)),
            "mixed_step": tba.ba_step(state, images, tcam, tcfg, torch.tensor(LAM), tind)}
    # the same solves with the point rows in other orders, mapped back
    rng = np.random.default_rng(5)
    port["reordered"], port["mixed_reordered"] = [], []
    for _ in range(N_REORDER):
        perm = torch.as_tensor(rng.permutation(P))
        back = torch.argsort(perm)
        shuffled = state.replace(**{k: getattr(state, k)[perm] for k in POINT_FIELDS})
        for key, (st, *rest) in (
                ("reordered", tba.run_ba(shuffled, images, tcam, tcfg)),
                ("mixed_reordered", tba.run_ba_mixed(shuffled, images, tcam, tcfg, tind))):
            port[key].append((st.replace(**{k: getattr(st, k)[back] for k in POINT_FIELDS}),
                              *rest))
    return case, jax_runs, port


POINT_FIELDS = ("uv", "host", "idepth", "idepth_fej", "color", "weight", "point_valid",
                "res_active")


@pytest.fixture(scope="module", params=[2, 4], ids=lambda w: f"world{w}")
def ba_ranks(request, ba_case, tmp_path_factory):
    case, _, _ = ba_case
    return request.param, _spawn(tmp_path_factory.mktemp("ba_ranks"), _ba_task, request.param,
                                 case)


def _close_state(got: dict, prefix: str, t_want, idepth_want, what: str):
    np.testing.assert_allclose(got[f"{prefix}T.t"], np.asarray(t_want), **STATE_TOL["t"],
                               err_msg=f"{what}: T.t")
    np.testing.assert_allclose(got[f"{prefix}idepth"], np.asarray(idepth_want),
                               **STATE_TOL["idepth"], err_msg=f"{what}: idepth")


def test_sharded_run_ba_matches_jax_single_and_8_way(ba_case, ba_ranks):
    _, jax_runs, _ = ba_case
    world, outs = ba_ranks
    for name in ("single", "sharded8"):
        st, _ = jax_runs[name]
        _close_state(outs[0], "ba0.", st.T.t, st.idepth, f"world {world} vs JAX {name}")
    assert np.isfinite(outs[0]["ba0.E"])


def _near_one_of(got, runs, tol: dict, what: str):
    """Every entry of `got` within `tol` of the same entry of one of `runs`."""
    runs = np.stack([np.asarray(r) for r in runs])
    slack = tol["atol"] + tol["rtol"] * np.abs(runs)
    ok = np.any(np.abs(got[None] - runs) <= slack, axis=0)
    assert ok.all(), f"{what}: entries {np.flatnonzero(~ok.ravel())[:10]} off every run"


def _close_to_port(got: dict, prefix: str, runs, what: str):
    for field, tol in (("T.t", STATE_TOL["t"]), ("idepth", STATE_TOL["idepth"])):
        _near_one_of(got[f"{prefix}{field}"],
                     [(st.T.t if field == "T.t" else st.idepth).numpy() for st in runs], tol,
                     f"{what}: {field}")


def test_sharded_ba_step_matches_port_unsharded(ba_case, ba_ranks):
    """One LM step, with and without the indirect factors: the reduced
    system and the gathered idepth steps agree with the unsharded step to
    twice (translations about four times) what reordering the rows alone moves it
    by (module docstring)."""
    _, _, port = ba_case
    world, outs = ba_ranks
    st, _ = port["step"]
    for k, want in (("T.t", st.T.t), ("T.R", st.T.R), ("idepth", st.idepth), ("ab", st.ab)):
        np.testing.assert_allclose(outs[0][f"step.{k}"], want.numpy(), **STEP_TOL[k], err_msg=k)
    st, ind, _ = port["mixed_step"]
    for k, want in (("T.t", st.T.t), ("idepth", st.idepth), ("ind_idepth", ind.idepth)):
        np.testing.assert_allclose(outs[0][f"mixed_step.{k}"], want.numpy(), **STEP_TOL[k],
                                   err_msg=f"mixed {k}")


def test_sharded_run_ba_matches_port_unsharded(ba_case, ba_ranks):
    _, _, port = ba_case
    world, outs = ba_ranks
    runs = [port["plain"][0]] + [r[0] for r in port["reordered"]]
    _close_to_port(outs[0], "ba0.", runs, f"world {world}")
    np.testing.assert_array_equal(outs[0]["ba0.point_valid"], runs[0].point_valid.numpy())


def test_sharded_run_ba_mixed_matches_jax_and_port(ba_case, ba_ranks):
    """The indirect factors, the marginalization prior and the gauge priors
    are held whole by every rank: counted once, the sharded mixed BA lands
    on the unsharded one."""
    _, jax_runs, port = ba_case
    world, outs = ba_ranks
    for name in ("mixed_single", "mixed_sharded8"):
        st, ind, _ = jax_runs[name]
        _close_state(outs[0], "mixed0.", st.T.t, st.idepth, f"world {world} vs JAX {name}")
        np.testing.assert_allclose(outs[0]["mixed0.ind_idepth"], np.asarray(ind.idepth),
                                   **STATE_TOL["idepth"])
    runs = [port["mixed_plain"]] + port["mixed_reordered"]
    _close_to_port(outs[0], "mixed0.", [r[0] for r in runs], f"world {world} mixed")
    _near_one_of(outs[0]["mixed0.ind_idepth"], [r[1].idepth.numpy() for r in runs],
                 STATE_TOL["idepth"], f"world {world} mixed: indirect idepth")
    # the mixed terms moved the solve: it is not the photometric run_ba's
    assert not np.array_equal(outs[0]["mixed0.T.t"], outs[0]["ba0.T.t"])


def test_sharded_ranks_are_bit_identical(ba_ranks):
    world, outs = ba_ranks
    for r, out in enumerate(outs[1:], start=1):
        for k, v in outs[0].items():
            np.testing.assert_array_equal(out[k], v, err_msg=f"rank {r}: {k}")


def test_sharded_repeats_are_bit_identical(ba_ranks):
    world, outs = ba_ranks
    for k, v in outs[0].items():
        for run in ("ba", "mixed"):
            if k.startswith(f"{run}0."):
                np.testing.assert_array_equal(outs[0][f"{run}1." + k[len(run) + 2:]], v,
                                              err_msg=k)
    # one all-reduce an energy, one a step; one all-gather a step (the two
    # single steps, then 2 runs of each solver, ba_iters 2: 3 energies and 2
    # steps a solve)
    assert int(outs[0]["all_reduces"]) == 2 + 4 * (2 * BA_KW["ba_iters"] + 1)
    assert int(outs[0]["all_gathers"]) == 2 + 4 * BA_KW["ba_iters"]


# -- a world of one, in this process --------------------------------------------


@pytest.fixture(scope="module")
def mesh1():
    assert not dist.is_initialized()
    mesh = sh.make_mesh(device="cpu")
    yield mesh
    dist.destroy_process_group()


def test_world_of_one_is_the_unsharded_arithmetic(ba_case, mesh1):
    """A mesh of one rank runs exactly the unsharded arithmetic plus identity
    collectives: run_ba, run_ba_mixed, the outlier pass and the
    marginalization pieces bit-identical to mesh=None."""
    case, _, _ = ba_case
    cam, cfg = TCam.make(*BA_CAM_ARGS), TCfg(**BA_KW)
    state, images, ind = _ba_inputs(case)
    assert (mesh1.world_size, mesh1.rank) == (1, 0)
    pairs = [
        (tba.run_ba(state, images, cam, cfg), tba.run_ba(state, images, cam, cfg, mesh1)),
        (tba.run_ba_mixed(state, images, cam, cfg, ind),
         tba.run_ba_mixed(state, images, cam, cfg, ind, mesh1)),
    ]
    st = pairs[0][0][0]
    pairs.append((tba.update_residual_status(st, images, cam, cfg),
                  tba.update_residual_status(st, images, cam, cfg, mesh1)))
    pairs.append((tba._marg_pieces(st, images, cam, cfg, 1),
                  tba._marg_pieces(st, images, cam, cfg, 1, mesh1)))
    for plain, meshed in pairs:
        a, b = convert.to_np(plain), convert.to_np(meshed)
        flat_a, flat_b = _flatten(a), _flatten(b)
        assert flat_a.keys() == flat_b.keys()
        for k in flat_a:
            np.testing.assert_array_equal(flat_b[k], flat_a[k], err_msg=k)


def _flatten(x, prefix="") -> dict:
    if isinstance(x, dict):
        return {k2: v2 for k, v in x.items() for k2, v2 in _flatten(v, f"{prefix}{k}.").items()}
    if isinstance(x, (tuple, list)):
        return {k2: v2 for i, v in enumerate(x) for k2, v2 in _flatten(v, f"{prefix}{i}.").items()}
    return {prefix: np.asarray(x)}


def test_mesh_checks(mesh1):
    """make_mesh refuses a size that is not the world's; the point rows must
    divide evenly; a mesh on another device and an object that is not a
    Mesh are refused by the odometry."""
    with pytest.raises(ValueError, match="world has 1"):
        sh.make_mesh(3, device="cpu")
    two = dataclasses.replace(mesh1, world_size=2)
    with pytest.raises(ValueError, match="divide evenly"):
        sh.point_sharding(two).rows(127)
    assert sh.point_sharding(two).rows(128) == slice(0, 64)
    state = tba.empty_state(TCfg(**BA_KW))
    specs = sh.ba_shardings(state, mesh1)
    assert {k for k, v in specs.items() if isinstance(v, sh.PointSharding)} == {
        "uv", "host", "idepth", "idepth_fej", "color", "weight", "point_valid", "res_active"}
    with pytest.raises(ValueError, match="divide evenly"):
        sh.shard_ba_state(tba.empty_state(TCfg(**{**BA_KW, "max_points": 127})),
                          dataclasses.replace(mesh1, world_size=2))
    cam, cfg = TCam.make(*ODO_CAM_ARGS), TCfg(**ODO_KW)
    with pytest.raises(ValueError, match="computes on"):
        TOdo(cam, cfg, mesh=dataclasses.replace(mesh1, device=torch.device("meta")),
             device="cpu")
    with pytest.raises(TypeError, match="Mesh"):
        TOdo(cam, cfg, mesh="points", device="cpu")
    assert TOdo(cam, cfg, mesh=mesh1, device="cpu").mesh is mesh1


@pytest.mark.parametrize("kind", ["hybrid", "calib"])
def test_hybrid_and_calib_take_a_mesh(mesh1, kind):
    """HybridOdometry and CalibSlam take `mesh=` through to DirectOdometry
    (as in the JAX package) and, at a world of one, run exactly as without
    it: the same trajectory and map, with the window BA's collectives
    counted on the mesh."""
    from libcml_tpu_torch.runtime.calib import CalibSlam
    from libcml_tpu_torch.runtime.hybrid import HybridOdometry

    cls = {"hybrid": HybridOdometry, "calib": CalibSlam}[kind]
    cam, cfg = TCam.make(*ODO_CAM_ARGS), TCfg(**ODO_KW)
    sc = SyntheticScene.default(cam, seed=2)
    imgs = [sc.render(R, t)[0] for R, t in forward_trajectory(MESH_FRAMES, step=0.1)]
    runs = []
    for mesh in (None, mesh1):
        mesh1.all_reduces = 0
        odo = cls(cam, cfg, orb_budget=128, orb_levels=2, device="cpu", mesh=mesh)
        for i, img in enumerate(imgs):
            odo.process(img, float(i))
        _, est = odo.trajectory_c2w()
        runs.append((est, odo._pt_valid.copy(), odo._pt_Xw.copy(), mesh1.all_reduces))
    (a, va, xa, _), (b, vb, xb, n_reduce) = runs
    np.testing.assert_array_equal(b, a)
    np.testing.assert_array_equal(vb, va)
    np.testing.assert_array_equal(xb, xa)
    assert n_reduce > 0


# -- DirectOdometry(mesh=) ----------------------------------------------------------


@pytest.fixture(scope="module")
def odometry_frames():
    cam, cfg = TCam.make(*ODO_CAM_ARGS), TCfg(**ODO_KW)
    sc = SyntheticScene.default(cam, seed=2)
    imgs = [sc.render(R, t)[0] for R, t in forward_trajectory(N_FRAMES, step=0.1)]
    plain = TOdo(cam, cfg, device="cpu")
    for i, img in enumerate(imgs):
        plain.process(img, float(i))
    _, est = plain.trajectory_c2w()
    return imgs, est


@pytest.fixture(scope="module", params=[2, 4], ids=lambda w: f"world{w}")
def odometry_runs(request, odometry_frames, tmp_path_factory):
    imgs, est = odometry_frames
    out_dir = tmp_path_factory.mktemp("odometry_ranks")
    return est, _spawn(out_dir, _odometry_task, request.param, imgs, str(out_dir))


def test_sharded_direct_odometry_matches_unsharded(odometry_runs):
    """tests/test_multichip.py:121 on the port, at 2 and 4 ranks."""
    a, outs = odometry_runs
    b = outs[0]["est"]
    assert np.isfinite(b).all() and b.shape == a.shape
    rel_a = np.linalg.norm(np.diff(a[:, :3, 3], axis=0), axis=1)
    rel_b = np.linalg.norm(np.diff(b[:, :3, 3], axis=0), axis=1)
    moving = rel_a > 1e-4
    assert moving.sum() >= N_FRAMES // 2
    np.testing.assert_allclose(rel_b[moving], rel_a[moving], rtol=1e-2, atol=1e-5)
    np.testing.assert_allclose(rel_b[moving].sum(), rel_a[moving].sum(), rtol=2e-3)
    # every rank holds the same trajectory and window, and the window BA ran
    # over the mesh
    for out in outs[1:]:
        for k, v in outs[0].items():
            np.testing.assert_array_equal(out[k], v, err_msg=k)
    assert int(outs[0]["all_reduces"]) > 0 and int(outs[0]["all_gathers"]) > 0


def test_meshed_checkpoint_resumes_exactly(odometry_runs):
    """A meshed run saved before frame SAVE_AT and resumed by a fresh meshed
    instance ends on the uninterrupted trajectory bit for bit."""
    _, outs = odometry_runs
    for out in outs:
        np.testing.assert_array_equal(out["est_resumed"], out["est"])
