"""Parity of the port's pipelined modes with the JAX package, on the CPU:
pipelined DirectOdometry, the pipelined hybrid (which always stages its
indirect keyframe postprocess over later frames), and the sequential hybrid
with staged back-end ticks, each package in the same mode, over the 18
rendered 160x120 frames of tests/test_hybrid_pipelined.py
(SyntheticScene.default(cam, seed=3), tests/test_pipelined.py's config).

The port's HybridOdometry(pipelined=True) is held to the JAX package's
HybridOdometry(pipelined=True, staged_indpost=True): the JAX package's own
pipelined=True alone completes the postprocess at once (its gate at
runtime/hybrid.py:817 reads staged_indpost only), against its comment that
the pipelined mode always stages; the port does not copy that.

Tolerances, as tests/test_torch_hybrid.py sets them and for its reasons:
per-frame state, keyframe decision and mode, and the indirect keyframes,
exactly; every frame's pose within 2e-3, both as the map holds it when the
frame is finalized and in the final trajectory. The final trajectory is
compared relative to frame 0: a monocular window's BA leaves the gauge
(the whole trajectory's pose) weakly held, and in the pipelined direct run
the last keyframe's BA turns the whole trajectory, frame 0 included, by
2.1e-3 in the port and not in the JAX package, from window poses 2.2e-4
apart; the port against itself at eight torch threads instead of one ends
2.0e-2 apart. Relative to frame 0 the packages stay within 5.2e-4.
"""

import numpy as np
import pytest
import torch

from libcml_tpu.core.camera import PinholeCamera as JCam
from libcml_tpu.data.synthetic import SyntheticScene, forward_trajectory
from libcml_tpu.eval.trajectory import ate_rmse
from libcml_tpu.models.direct.config import DirectConfig as JCfg
from libcml_tpu.runtime.hybrid import HybridOdometry as JHybrid
from libcml_tpu.runtime.odometry import DirectOdometry as JOdo

from libcml_tpu_torch.core.camera import PinholeCamera as TCam
from libcml_tpu_torch.models.direct.config import DirectConfig as TCfg
from libcml_tpu_torch.runtime.hybrid import HybridOdometry as THybrid
from libcml_tpu_torch.runtime.odometry import DirectOdometry as TOdo

# one torch thread per test process (tests/test_torch_slice.py says why)
torch.set_num_threads(1)

CAM_ARGS = (110.0, 110.0, 79.5, 59.5, 160, 120)
# tests/test_pipelined.py and tests/test_hybrid_pipelined.py
CFG_KW = dict(num_levels=3, max_points=1024, points_per_kf=256, init_points=256,
              max_frames=5, tracker_iters=8, init_iters=12, ba_iters=6,
              kf_flow_threshold=0.55, activate_min_traces=2, activate_max_relwidth=0.35,
              outlier_energy=300.0)
ORB = dict(orb_budget=192, orb_levels=2)
N_FRAMES = 18
TOL = 2e-3


@pytest.fixture(scope="module")
def seq():
    cam = JCam.make(*CAM_ARGS)
    sc = SyntheticScene.default(cam, seed=3)
    poses = forward_trajectory(N_FRAMES, step=0.08, yaw_rate=0.003)
    gt = []
    for R, t in poses:
        M = np.eye(4)
        M[:3, :3], M[:3, 3] = R, t
        gt.append(np.linalg.inv(M))
    return dict(imgs=[sc.render(R, t)[0] for R, t in poses], gt_c2w=np.asarray(gt))


def _run(odo, imgs):
    outs, live = [], []
    for i, img in enumerate(imgs):
        outs.append(odo.process(img, float(i)))
        live.append(odo.map.trajectory_c2w()[1])
    ts, est = odo.trajectory_c2w()
    return outs, ts, est, live


def _from_frame0(est):
    return np.einsum("ij,njk->nik", np.linalg.inv(est[0]), est)


def _assert_parity(seq, want, got, jodo, todo, hybrid: bool):
    (outs_j, ts_j, est_j, live_j), (outs_t, ts_t, est_t, live_t) = want, got
    keys = ("state", "kf", "mode") if hybrid else ("state", "kf")
    for key in keys:
        assert [o.get(key) for o in outs_t] == [o.get(key) for o in outs_j], key
    # the frames finalized inside the final flush
    assert [o.get("kf") for o in todo.stats] == [o.get("kf") for o in jodo.stats]
    np.testing.assert_array_equal(ts_t, ts_j)
    assert todo.segments == 0 and jodo.segments == 0
    assert len(todo.map.frames_in_group("KEYFRAME")) == len(jodo.map.frames_in_group("KEYFRAME"))
    if hybrid:
        assert todo.mode_history == jodo.mode_history
        assert [k["frame"] for k in todo._ind_kfs] == [k["frame"] for k in jodo._ind_kfs]
        assert len(todo._ind_kfs) >= 2 and todo._indpost is None
    live_gap = [np.abs(a - b).max() for a, b in zip(live_t, live_j)]
    assert max(live_gap) < TOL, live_gap
    gap = np.abs(_from_frame0(est_t) - _from_frame0(est_j)).max(axis=(1, 2))
    assert gap.max() < TOL, gap
    gt = seq["gt_c2w"][:, :3, 3]
    ate_t = ate_rmse(est_t[:, :3, 3], gt, with_scale=True)
    ate_j = ate_rmse(est_j[:, :3, 3], gt, with_scale=True)
    assert ate_t < 0.1 and ate_j < 0.1, (ate_t, ate_j)


def test_pipelined_direct_matches_reference(seq):
    jodo = JOdo(JCam.make(*CAM_ARGS), JCfg(**CFG_KW), pipelined=True)
    want = _run(jodo, seq["imgs"])
    todo = TOdo(TCam.make(*CAM_ARGS), TCfg(**CFG_KW), pipelined=True, device="cpu")
    got = _run(todo, seq["imgs"])
    _assert_parity(seq, want, got, jodo, todo, hybrid=False)
    # the lag: the first tracked frame reports itself pending, later ones
    # report the frame before them
    assert any(o.get("pending") for o in got[0])
    assert sum(o.get("kf", False) for o in todo.stats) >= 2


def _tick_frames(odo):
    """(frames of the keyframe postprocess events, frames the ticks ran in)."""
    return ([int(f) for f in odo.sheet.stat("time_ind_post").series()[0]],
            [int(f) for f in odo.sheet.stat("time_ind_tick").series()[0]])


@pytest.mark.parametrize("mode", ["pipelined", "staged"])
def test_hybrid_modes_match_reference(seq, mode):
    """The port's pipelined hybrid against the JAX package's
    pipelined=True, staged_indpost=True; the sequential hybrid with staged
    BA ticks (staged_indpost=True) on both sides."""
    pipe = mode == "pipelined"
    jodo = JHybrid(JCam.make(*CAM_ARGS), JCfg(**CFG_KW), pipelined=pipe, staged_indpost=True,
                   **ORB)
    want = _run(jodo, seq["imgs"])
    todo = THybrid(TCam.make(*CAM_ARGS), TCfg(**CFG_KW), pipelined=pipe,
                   staged_indpost=not pipe, device="cpu", **ORB)
    assert todo.staged_indpost
    got = _run(todo, seq["imgs"])
    _assert_parity(seq, want, got, jodo, todo, hybrid=True)
    assert int(todo._pt_valid.sum()) > 50 and todo._kf_store
    # the ticks spread over later frames (the sheet merges the ticks that
    # ran in one frame into one sample): pipelined, the first event's first
    # tick waited TICK_LAG frames after the frame that dispatched it; staged,
    # its bookkeeping tick ran in its own frame and a BA tick in a later one
    events, ticks = _tick_frames(todo)
    assert len(events) >= 2 and ticks, (events, ticks)
    if pipe:
        assert min(ticks) >= events[0] + 1 + THybrid.TICK_LAG, (events, ticks)
    else:
        later = [t for t in ticks if t > events[0]]
        assert events[0] in ticks and later and later[0] <= events[1], (events, ticks)

