"""The pipelined hybrid's in-flight state, on the CPU: the staged keyframe
tick and the in-flight frame as convert.py reads them from either package
(tests/test_torch_pipelined.py's frames and configuration), a JAX tick
carried into the port, and checkpoints that carry both and resume exactly.
"""

import numpy as np
import pytest
import torch

from libcml_tpu.core.camera import PinholeCamera as JCam
from libcml_tpu.models.direct.config import DirectConfig as JCfg
from libcml_tpu.runtime.hybrid import HybridOdometry as JHybrid

from libcml_tpu_torch import convert
from libcml_tpu_torch.core.camera import PinholeCamera as TCam
from libcml_tpu_torch.data.synthetic import SyntheticScene as TScene
from libcml_tpu_torch.data.synthetic import forward_trajectory as tforward
from libcml_tpu_torch.models.direct.config import DirectConfig as TCfg
from libcml_tpu_torch.runtime.hybrid import HybridOdometry as THybrid

# one torch thread per test process (tests/test_torch_slice.py says why)
torch.set_num_threads(1)

# tests/test_torch_pipelined.py's configuration
CAM_ARGS = (110.0, 110.0, 79.5, 59.5, 160, 120)
CFG_KW = dict(num_levels=3, max_points=1024, points_per_kf=256, init_points=256,
              max_frames=5, tracker_iters=8, init_iters=12, ba_iters=6,
              kf_flow_threshold=0.55, activate_min_traces=2, activate_max_relwidth=0.35,
              outlier_energy=300.0)
ORB = dict(orb_budget=192, orb_levels=2)


@pytest.fixture(scope="module")
def seq():
    sc = TScene.default(TCam.make(*CAM_ARGS), seed=3)
    return dict(imgs=[sc.render(R, t)[0] for R, t in tforward(12, step=0.08, yaw_rate=0.003)])


def test_inflight_state_matches_and_carries(seq):
    """Mid-run, in lockstep: the first staged keyframe tick in flight that
    triangulates (the second keyframe event) and
    the in-flight frame, as convert reads them from either package, agree;
    the JAX run's tick carried into the port (convert.load_staged_tick)
    lands the same keyframe record and map as the JAX run's own."""
    jodo = JHybrid(JCam.make(*CAM_ARGS), JCfg(**CFG_KW), pipelined=True, staged_indpost=True,
                   **ORB)
    todo = THybrid(TCam.make(*CAM_ARGS), TCfg(**CFG_KW), pipelined=True, device="cpu", **ORB)
    for i, img in enumerate(seq["imgs"]):
        jodo.process(img, float(i))
        todo.process(img, float(i))
        st = jodo._indpost
        if st is not None and st["phase"] == "match" and st["has_tri"]:
            break
    else:
        pytest.fail("no staged tick in flight")
    tj, tt = convert.staged_tick(jodo), convert.staged_tick(todo)
    for k in ("phase", "tick_born", "frame_idx", "kf_id", "has_tri"):
        assert tt[k] == tj[k], k
    assert len(tt["refs"]) == len(tj["refs"]) == 19
    for a, b in zip(tt["refs"][:4], tj["refs"][:4]):      # the projection match
        np.testing.assert_array_equal(a, b)
    pj, pt = convert.pending_entries(jodo), convert.pending_entries(todo)
    assert [e["frame_idx"] for e in pt] == [e["frame_idx"] for e in pj] == [i]
    assert [e["kf_id"] for e in pt] == [e["kf_id"] for e in pj]
    np.testing.assert_allclose(pt[0]["scalars"][:1], pj[0]["scalars"][:1])   # num_valid
    # the JAX tick, carried across, and ticked on both sides
    np.testing.assert_array_equal(todo._pt_valid, jodo._pt_valid)
    convert.load_staged_tick(todo, tj)
    jodo._tick_indpost()
    todo._tick_indpost()
    np.testing.assert_array_equal(todo._pt_valid, jodo._pt_valid)
    np.testing.assert_array_equal(todo._ind_kfs[-1]["obs_point"], jodo._ind_kfs[-1]["obs_point"])
    assert todo._indpost["phase"] == jodo._indpost["phase"] == "ba"


def test_pipelined_checkpoint_resumes_exactly(seq, tmp_path):
    """A pipelined hybrid saved with a frame and a staged tick in flight
    resumes exactly as the run that saved (which the save does not change)
    and as an uninterrupted run."""
    cam = TCam.make(*CAM_ARGS)
    imgs = seq["imgs"]

    def make():
        return THybrid(cam, TCfg(**CFG_KW), pipelined=True, device="cpu", **ORB)

    def finish(odo, start):
        for i in range(start, len(imgs)):
            odo.process(imgs[i], float(i))
        return odo.trajectory_c2w()[1], odo._pt_valid.copy(), odo._pt_Xw.copy()

    a = finish(make(), 0)
    b = make()
    save_at = None
    for i, img in enumerate(imgs):
        if save_at is None and b._indpost is not None and b._pending:
            save_at = i
            b.save_state(str(tmp_path / "ckpt"))
        b.process(img, float(i))
    assert save_at is not None, "no tick in flight to save"
    b = (b.trajectory_c2w()[1], b._pt_valid.copy(), b._pt_Xw.copy())
    c = make()
    c.load_state(str(tmp_path / "ckpt"))
    assert c._pending and c._indpost is not None
    c = finish(c, save_at)
    for x, y, z in zip(a, b, c):
        np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(x, z)
