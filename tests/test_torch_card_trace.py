"""The epipolar tracer's kernel (csrc/trace_epipolar.cu) on the card, held to
its plain form (`tracer.trace_immatures_rows_plain`) under
`ops.trace_epipolar.parity`, on the seeded arenas of
tests/test_torch_trace_kernels.py: the recent rows, padding, a dead host
slot, a NaN observer pose, all-padding rows, and intervals so wide that
hypotheses leave the image. The call is one launch,
leaves its inputs as they were, and repeats bit for bit.

This file imports only torch, numpy, pytest and the port, so that it runs on
the card machine (which has no JAX package):

    python -m pytest --noconftest -q tests/test_torch_card_*.py

Without a card every case skips. tests/test_torch_trace_kernels.py imports
the case builder from here.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from libcml_tpu_torch import convert
from libcml_tpu_torch.core.camera import PinholeCamera
from libcml_tpu_torch.core.lie import SE3, se3_exp
from libcml_tpu_torch.data.synthetic import SyntheticScene, forward_trajectory
from libcml_tpu_torch.models.direct import tracer
from libcml_tpu_torch.models.direct.config import DirectConfig
from libcml_tpu_torch.models.direct.selector import select_points
from libcml_tpu_torch.ops import trace_epipolar as te
from libcml_tpu_torch.ops.image import bilinear, build_gradient_pyramid

torch.set_num_threads(1)

CAM_ARGS = (110.0, 110.0, 79.5, 59.5, 160, 120)
CFG_KW = dict(num_levels=3, max_points=256, points_per_kf=64, init_points=256,
              max_frames=4, tracker_iters=8, init_iters=12, ba_iters=4)
CAM, CFG = PinholeCamera.make(*CAM_ARGS), DirectConfig(**CFG_KW)
# (slot, frame) of each seeded arena row; slot 3 holds no live keyframe
SEEDED = ((0, 0), (1, 1), (2, 2), (3, 0))
OBSERVER = 4
CASES = {"recent": [2, 1, 0], "padding": [1, -1, 2], "dead_slot": [3, 2, -1],
         "nan_pose": [2, 1, 0], "all_padding": [-1, -1, -1], "wide": [2, 1, 0]}
SEEDS = (0, 1, 2)


def _t(x):
    return convert.tensor(np.ascontiguousarray(x))


@functools.lru_cache(maxsize=None)
def _frames():
    """Frames 0-4 of the 160x120 synthetic scene (step 0.08): the level-0
    gradient images, inverse depths and world-to-camera poses."""
    sc = SyntheticScene.default(CAM, seed=3)
    poses = forward_trajectory(OBSERVER + 1, step=0.08, yaw_rate=0.003)
    out = []
    for R, t in poses:
        img, idep = sc.render(R, t)
        out.append((build_gradient_pyramid(_t(img), 1)[0], _t(idep), R, t))
    return out


def trace_case(case: str, seed: int) -> dict:
    """trace_immatures_rows' inputs (CPU tensors) for one case: an arena of 4
    slots x 64 candidates seeded from frames 0, 1, 2 and 0, slot 3 dead;
    each candidate's interval about its true inverse depth (a quarter of
    them the wide default), its counts and validity drawn from `seed`; the
    host poses perturbed by ~0.002; frame 4 observing. "wide": every
    interval [0.05, 50], so that a point's near hypotheses leave the image
    while its far ones stay in it (lanes of one warp disagree)."""
    frames, rng = _frames(), np.random.default_rng(seed)
    K = CFG.points_per_kf
    arena = tracer.empty_immatures(len(SEEDED), K)
    for slot, i in SEEDED:
        grad, idep = frames[i][0], frames[i][1]
        uv, valid, _ = select_points(grad, K)
        arena = tracer.seed_immatures(arena, slot, grad, uv, valid, _t(np.float32(0.05)),
                                      _t(np.float32(2.0)))
    rho = np.stack([bilinear(frames[i][1], arena.uv[s]).numpy() for s, i in SEEDED])
    shape = rho.shape
    lo = rho * np.exp(-rng.uniform(0.05, 1.5, shape))
    hi = rho * np.exp(rng.uniform(0.05, 1.5, shape))
    wide = rng.random(shape) < (1.0 if case == "wide" else 0.25)
    top = 50.0 if case == "wide" else 2.0
    arena = arena.replace(
        rho_lo=_t(np.where(wide, 0.05, lo).astype(np.float32)),
        rho_hi=_t(np.where(wide, top, hi).astype(np.float32)),
        n_ok=_t(rng.integers(0, 3, shape).astype(np.int32)),
        n_fail=_t(rng.integers(0, 4, shape).astype(np.int32)),
        valid=arena.valid & _t(rng.random(shape) > 0.1))
    Ts = [se3_exp(_t(rng.normal(0, 0.002, 6).astype(np.float32))).compose(
        SE3(R=_t(np.float32(frames[i][2])), t=_t(np.float32(frames[i][3])))) for _, i in SEEDED]
    T_hosts = SE3(R=torch.stack([T.R for T in Ts]), t=torch.stack([T.t for T in Ts]))
    t_obs = np.float32(frames[OBSERVER][3]).copy()
    if case == "nan_pose":
        t_obs[0] = np.nan
    return dict(arena=arena, rows=_t(np.int32(CASES[case])), T_hosts=T_hosts,
                host_valid=_t(np.array([True, True, True, False])),
                obs_grad=frames[OBSERVER][0],
                T_obs=SE3(R=_t(np.float32(frames[OBSERVER][2])), t=_t(t_obs)))


def _to(x, dev):
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    if dataclasses.is_dataclass(x):
        return type(x)(**{f.name: _to(getattr(x, f.name), dev) for f in dataclasses.fields(x)})
    return x


def _args(c: dict, dev) -> list:
    return [_to(c[k], dev) for k in ("arena", "rows", "T_hosts", "host_valid", "obs_grad",
                                     "T_obs")] + [CAM, CFG]


def _probes(c: dict, dev) -> torch.Tensor:
    return torch.full((len(c["rows"]), CFG.points_per_kf, len(te.PROBE_FIELDS)),
                      float("nan"), device=dev)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("case", list(CASES))
def test_cuda_trace_rows_matches_plain(cuda, case, seed):
    """One launch through the dispatcher, held to the plain form on the card
    under parity; the inputs untouched; a second call gives the same bits."""
    c = trace_case(case, seed)
    args = _args(c, cuda)
    before = {f.name: getattr(args[0], f.name).clone() for f in dataclasses.fields(args[0])}
    pk, pp = _probes(c, cuda), _probes(c, cuda)
    launches = te.trace_rows_cuda.launches
    got = tracer.trace_immatures_rows(*args, probes=pk)
    torch.cuda.synchronize()
    assert te.trace_rows_cuda.launches == launches + 1
    want = tracer.trace_immatures_rows_plain(*args, probes=pp)
    res = te.parity(got, want, (pk, pp), args[1], CFG)
    assert res["ok"], res
    for f in dataclasses.fields(got):
        assert torch.equal(getattr(args[0], f.name), before[f.name]), f.name
        assert torch.equal(getattr(got, f.name),
                           getattr(tracer.trace_immatures_rows(*args), f.name)), f.name
