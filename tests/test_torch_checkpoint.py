"""Checkpoints, repeatability and the experiment harness of the PyTorch
port, on the CPU.

tests/test_checkpoint.py and tests/test_determinism.py run on the port: a run
saved mid-sequence and resumed in a fresh instance continues EXACTLY as the
uninterrupted run (the JAX package allows 5e-3: its save completes the
pending marginalization early and its resume rebuilds the tracker reference
from the window); two identical instances give identical trajectories. The
checkpoint keeps the JAX package's scalar and pytree names, and its file holds
numpy arrays and the port's own objects only, so a state saved on the card
loads on the CPU. The harness keeps tests/test_harness.py's cache semantics,
with cache keys of its own.
"""

import dataclasses
import json
import os
import pickle

import numpy as np
import pytest
import torch

import libcml_tpu.eval.harness as jharness
import libcml_tpu_torch.eval.harness as tharness
from libcml_tpu.runtime.odometry import DirectOdometry as JaxDirectOdometry
from libcml_tpu_torch.core.camera import PinholeCamera
from libcml_tpu_torch.data.synthetic import SyntheticScene, forward_trajectory
from libcml_tpu_torch.models.direct.config import DirectConfig
from libcml_tpu_torch.native.io import write_png_gray
from libcml_tpu_torch.runtime.hybrid import HybridOdometry
from libcml_tpu_torch.runtime.odometry import DirectOdometry, OnDevice

torch.set_num_threads(1)

CFG = DirectConfig(
    num_levels=3, max_points=512, points_per_kf=128, init_points=128,
    max_frames=5, tracker_iters=8, init_iters=12, ba_iters=4,
    kf_flow_threshold=0.55, activate_min_traces=2,
    activate_max_relwidth=0.35, outlier_energy=300.0,
)
CAM = PinholeCamera.make(110.0, 110.0, 79.5, 59.5, 160, 120)


@pytest.fixture(scope="module")
def frames():
    sc = SyntheticScene.default(CAM, seed=3)
    return [sc.render(R, t)[0] for R, t in forward_trajectory(14, step=0.08, yaw_rate=0.003)]


def _direct():
    return DirectOdometry(CAM, CFG, device="cpu")


def _hybrid():
    return HybridOdometry(CAM, CFG, orb_budget=128, orb_levels=2, device="cpu")


def _run(odo, imgs, start, stop):
    for i in range(start, stop):
        odo.process(imgs[i], float(i))
    return odo


def test_checkpoint_names_match_reference():
    assert DirectOdometry._CKPT_SCALARS == JaxDirectOdometry._CKPT_SCALARS
    assert DirectOdometry._CKPT_PYTREES == JaxDirectOdometry._CKPT_PYTREES


def test_direct_repeats_and_resumes_exactly(frames, tmp_path):
    """tests/test_determinism.py and test_checkpoint.py:20-52 on the port.
    Two instances fed the same frames agree at every frame (one of them
    saves at frame 9, with its asynchronous marginalization in flight, and
    goes on: saving changes nothing); a fresh instance that loads the file
    and runs frames 10-13 ends on the uninterrupted trajectory exactly."""
    a, b = _direct(), _direct()
    ckpt = str(tmp_path / "state.pkl")
    for i, img in enumerate(frames):
        if i == 10:
            assert b._pending_marg is not None, "meant to carry a pending marginalization"
            b.save_state(ckpt)
        out_a, out_b = a.process(img, float(i)), b.process(img, float(i))
        assert out_a["state"] == out_b["state"], f"diverged at frame {i}"
        np.testing.assert_array_equal(a._T_curr.t.numpy(), b._T_curr.t.numpy(),
                                      err_msg=f"frame {i}")
    _, est_a = a.trajectory_c2w()
    np.testing.assert_array_equal(b.trajectory_c2w()[1], est_a)

    c = _direct()
    c.load_state(ckpt)
    assert (c.frame_idx, c.state) == (9, "TRACKING")
    _run(c, frames, 10, len(frames))
    np.testing.assert_array_equal(c.trajectory_c2w()[1], est_a)


@pytest.fixture(scope="module")
def hybrid_saved(frames, tmp_path_factory):
    """A hybrid run over 12 frames that saved its state after frame 8
    (test_checkpoint.py:55-78), and the file."""
    ckpt = str(tmp_path_factory.mktemp("ckpt") / "hyb.pkl")
    odo = _hybrid()
    for i in range(12):
        if i == 9:
            odo.save_state(ckpt)
        odo.process(frames[i], float(i))
    return odo, ckpt


def test_hybrid_resumes_exactly(frames, hybrid_saved):
    """The resumed hybrid's trajectory, map arena, keyframe ring and modes
    equal the uninterrupted run's exactly."""
    ref, ckpt = hybrid_saved
    b = _hybrid()
    b.load_state(ckpt)
    assert b.frame_idx == 8 and len(b._ind_kfs) > 0 and b._pt_valid.sum() > 0
    _run(b, frames, 9, 12)
    assert b.state == "TRACKING" and len(b._ind_kfs) == len(ref._ind_kfs)
    np.testing.assert_array_equal(b.trajectory_c2w()[1], ref.trajectory_c2w()[1])
    np.testing.assert_array_equal(b._pt_valid, ref._pt_valid)
    np.testing.assert_array_equal(b._pt_Xw, ref._pt_Xw)
    assert b.mode_history == ref.mode_history


def test_checkpoint_file_holds_no_tensors(hybrid_saved):
    """Device tensors are stored as OnDevice numpy arrays: the file unpickles
    without building any torch tensor, and load_state puts them on the
    loading instance's device."""
    _, ckpt = hybrid_saved
    with open(ckpt, "rb") as f:
        payload = pickle.load(f)
    seen = {"arrays": 0}

    def walk(x):
        assert not isinstance(x, torch.Tensor)
        if isinstance(x, OnDevice):
            assert isinstance(x.array, np.ndarray)
            seen["arrays"] += 1
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
        elif hasattr(x, "__dataclass_fields__"):
            for name in x.__dataclass_fields__:
                walk(getattr(x, name))

    walk(payload)
    assert seen["arrays"] > 20
    b = _hybrid()
    b.load_state(ckpt)
    assert b._window.ba.T.R.device == torch.device("cpu")
    assert isinstance(b._last_kf_feats.desc, torch.Tensor)


# -- the experiment harness (tests/test_harness.py:61-131) -------------------------


@pytest.fixture(scope="module")
def kitti_seq(frames, tmp_path_factory):
    """The first 10 frames as a KITTI layout with poses.txt."""
    seq = tmp_path_factory.mktemp("kitti") / "04"
    (seq / "image_0").mkdir(parents=True)
    lines = []
    for i, (R, t) in enumerate(forward_trajectory(10, step=0.08, yaw_rate=0.003)):
        write_png_gray(str(seq / "image_0" / f"{i:06d}.png"),
                       np.clip(frames[i], 0, 255).astype(np.uint8))
        M = np.eye(4)
        M[:3, :3], M[:3, 3] = R, t
        lines.append(" ".join(f"{v:.9f}" for v in np.linalg.inv(M)[:3].reshape(-1)))
    (seq / "calib.txt").write_text(
        "P0: 110.0 0.0 80.0 0.0 0.0 110.0 60.0 0.0 0.0 0.0 1.0 0.0\n")
    (seq / "poses.txt").write_text("\n".join(lines) + "\n")
    return str(seq)


def test_run_sequence_and_cache(kitti_seq, tmp_path):
    db = tharness.ResultDatabase(str(tmp_path / "db.json"))
    kw = dict(db=db, max_frames=8, device="cpu", odometry_factory=DirectOdometry)
    m = tharness.run_sequence(kitti_seq, CFG, **kw)
    assert m["frames"] == 8 and not m["cached"] and m["device"] == "cpu"
    assert np.isfinite(m["ate_rmse"]) and m["ate_rmse"] < 0.15
    m2 = tharness.run_sequence(kitti_seq, CFG, **kw)
    assert m2["cached"] and m2["ate_rmse"] == m["ate_rmse"]
    with open(db.path) as f:
        assert len(json.load(f)) == 1
    # the two packages never share a cache entry
    jdb = jharness.ResultDatabase(str(tmp_path / "jdb.json"))
    assert tharness._code_hash() != jharness._code_hash()
    assert jdb.key(kitti_seq, CFG, "x") != db.key(kitti_seq, CFG, "x")


def test_statson_and_bruteforce(kitti_seq, tmp_path, capsys):
    db = tharness.ResultDatabase(str(tmp_path / "db.json"))
    kw = dict(db=db, max_frames=6, device="cpu", odometry_factory=DirectOdometry)
    out = tharness.statson([kitti_seq], CFG, **kw)
    assert len(out) == 1 and "STAT ate" in capsys.readouterr().out
    grid = {"tracker_iters": [6, 8]}
    r0 = tharness.bruteforce_sweep([kitti_seq], CFG, grid, host_index=0, num_hosts=2, **kw)
    r1 = tharness.bruteforce_sweep([kitti_seq], CFG, grid, host_index=1, num_hosts=2, **kw)
    # disjoint host slices cover the grid exactly once
    assert len(r0) == 1 and len(r1) == 1
    assert r0[0]["settings"] != r1[0]["settings"]


def test_genetic_search_converges(monkeypatch):
    @dataclasses.dataclass(frozen=True)
    class Cfg:
        a: float = 0.0
        b: float = 0.0

    def fake_run_sequence(seq, cfg, db=None, **kw):
        return {"ate_rmse": (cfg.a - 3.0) ** 2 + (cfg.b + 1.0) ** 2}

    monkeypatch.setattr(tharness, "run_sequence", fake_run_sequence)
    hist = tharness.genetic_search(["seq"], Cfg(), {"a": (-5.0, 5.0), "b": (-5.0, 5.0)},
                                   generations=8, population=10, seed=1)
    assert hist[-1]["best_ate"] < hist[0]["best_ate"]
    assert hist[-1]["best_ate"] < 0.5 and abs(hist[-1]["best"]["a"] - 3.0) < 1.5


def test_plot_results(tmp_path):
    out = tharness.plot_results([{"dataset": "seq/a", "ate_rmse": 0.1},
                                 {"dataset": "seq/b", "ate_rmse": 0.3}],
                                str(tmp_path / "plot.png"))
    assert os.path.isfile(out) and os.path.getsize(out) > 100
