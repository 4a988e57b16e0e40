"""The indirect local BA's kernel (csrc/local_ba.cu) on the card, held to its
plain form run_local_ba_plain: the seeded problems of
tests/test_torch_hybrid.py's local-BA test (frames 0 and 1 fixed), the edge
cases (every observation invalid, a valid point without a valid
observation, a step whose candidate is not finite, a two-view problem with
frame 0 fixed, no iterations, six frames), every frame count from 1 to 8 (the
solve's padded sizes 8 to 48), every observation made twice (pairs of two
observations, longer lists than the kernel keeps in shared memory), a
problem at the hybrid's map capacity (4096 points, ~9,216 observations over
6 keyframes), one with more point groups than the card has SMs and two at a
full-hybrid call's size, two runs bit for bit, and the finiteness reject.

The problems are built with the port alone: this file imports only torch,
numpy, pytest and the port, so that it runs on the card machine (which has
no JAX package):

    python -m pytest --noconftest -q tests/test_torch_card_*.py

Without a card every case skips. tests/test_torch_local_ba_kernels.py
imports the problems from here.
"""

import numpy as np
import pytest
import torch

import libcml_tpu_torch.models.indirect.indirect_ba as tiba
from libcml_tpu_torch.core.camera import PinholeCamera as TCam
from libcml_tpu_torch.core.lie import SE3 as TSE3, se3_exp
from libcml_tpu_torch.ops import local_ba as lba

torch.set_num_threads(1)

CAM_ARGS = (110.0, 110.0, 79.5, 59.5, 160, 120)
TCAM = TCam.make(*CAM_ARGS)
# the smoke's full-width camera (workload.py): the map-capacity problem's
FULL_CAM = TCam.make(520.0, 520.0, 319.5, 239.5, 640, 480)
MAP_CAP = 4096              # runtime/hybrid.py MAP_CAP
KF_RING = 6                 # runtime/hybrid.py KF_RING


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _poses(M: int) -> tuple[np.ndarray, np.ndarray]:
    """tests/test_torch_hybrid.py _local_problem's frames: a sideways
    baseline of 0.25 m a frame and a small yaw."""
    R = np.stack([_np(se3_exp(torch.tensor([0, 0, 0, 0, 0.02 * m, 0], dtype=torch.float32)).R)
                  for m in range(M)])
    t = np.stack([np.array([-0.25 * m, 0.02 * m, -0.05 * m], np.float32) for m in range(M)])
    return R, t


def problem_from(d: dict) -> tiba.IndirectBAProblem:
    """An IndirectBAProblem on the CPU from numpy arrays (T as R, t)."""
    return tiba.IndirectBAProblem(
        T=TSE3(R=torch.tensor(d["R"], dtype=torch.float32),
               t=torch.tensor(d["t"], dtype=torch.float32)),
        **{k: torch.tensor(v) for k, v in d.items() if k not in ("R", "t")})


def local_problem(seed: int, M: int = 5, N: int = 120, fixed: int = 2,
                  cam: TCam = TCAM) -> dict:
    """tests/test_torch_hybrid.py _local_problem as numpy arrays, built with
    the port's se3_exp: M frames along x (the first `fixed` held), N points,
    noisy observations with a few outliers, perturbed poses and points."""
    rng = np.random.default_rng(seed)
    Xw = np.c_[rng.uniform(-2, 2, (N, 2)), rng.uniform(3, 8, N)].astype(np.float32)
    R, t = _poses(M)
    obs_f, obs_p, obs_uv = [], [], []
    for m in range(M):
        Xc = Xw @ R[m].T + t[m]
        pix = np.c_[cam.fx * Xc[:, 0] / Xc[:, 2] + cam.cx, cam.fy * Xc[:, 1] / Xc[:, 2] + cam.cy]
        seen = rng.random(N) < 0.8
        obs_f.append(np.full(seen.sum(), m))
        obs_p.append(np.flatnonzero(seen))
        obs_uv.append(pix[seen] + rng.normal(0, 0.5, (seen.sum(), 2)))
    obs_uv = np.concatenate(obs_uv).astype(np.float32)
    K = len(obs_uv)
    obs_uv[rng.choice(K, 12, replace=False)] += 30.0
    xi = rng.normal(0, 0.01, (M, 6)).astype(np.float32)
    xi[0] = 0
    T = se3_exp(torch.tensor(xi)).compose(TSE3(R=torch.tensor(R), t=torch.tensor(t)))
    return dict(R=_np(T.R), t=_np(T.t), frame_valid=np.ones(M, bool),
                frame_fixed=np.arange(M) < fixed,
                Xw=(Xw + rng.normal(0, 0.05, Xw.shape)).astype(np.float32),
                point_valid=rng.random(N) < 0.95,
                obs_frame=np.concatenate(obs_f).astype(np.int32),
                obs_point=np.concatenate(obs_p).astype(np.int32), obs_uv=obs_uv,
                obs_valid=rng.random(K) < 0.97,
                obs_sigma2=(1.2 ** (2.0 * rng.integers(0, 3, K))).astype(np.float32))


def two_view_problem(seed: int, N: int = 150) -> dict:
    """runtime/hybrid.py's two-view bootstrap refinement: M = 2, frame 0
    fixed at the identity, every point seen by both frames (observations
    frame-major: 0..N-1 in frame 0, then frame 1), sigma^2 = 1."""
    rng = np.random.default_rng(seed)
    Xw = np.c_[rng.uniform(-2, 2, (N, 2)), rng.uniform(3, 8, N)].astype(np.float32)
    R, t = _poses(2)
    uv = []
    for m in range(2):
        Xc = Xw @ R[m].T + t[m]
        uv.append(np.c_[110.0 * Xc[:, 0] / Xc[:, 2] + 79.5, 110.0 * Xc[:, 1] / Xc[:, 2] + 59.5]
                  + rng.normal(0, 0.3, (N, 2)))
    xi = np.zeros((2, 6), np.float32)
    xi[1] = rng.normal(0, 0.01, 6)
    T = se3_exp(torch.tensor(xi)).compose(TSE3(R=torch.tensor(R), t=torch.tensor(t)))
    ok = rng.random(N) < 0.9
    return dict(R=_np(T.R), t=_np(T.t), frame_valid=np.ones(2, bool),
                frame_fixed=np.array([True, False]),
                Xw=(Xw + rng.normal(0, 0.05, Xw.shape)).astype(np.float32), point_valid=ok,
                obs_frame=np.r_[np.zeros(N), np.ones(N)].astype(np.int32),
                obs_point=np.tile(np.arange(N), 2).astype(np.int32),
                obs_uv=np.concatenate(uv).astype(np.float32), obs_valid=np.tile(ok, 2),
                obs_sigma2=np.ones(2 * N, np.float32))


def map_cap_problem(seed: int = 0, N: int = MAP_CAP, seen: int = 1536,
                    outliers: int = 90) -> dict:
    """A local BA at the hybrid's capacity: KF_RING (6) keyframes 0.1 m apart
    at 640x480, frame 0 fixed, MAP_CAP (4096) points, each keyframe seeing
    1536 of them (ORB 512 x 3 levels: K = 9,216), observations frame-major
    as runtime/hybrid.py assembles them, sigma^2 of the levels (1.2^2l), a
    few outliers. Smaller `N`, `seen` (points a keyframe sees) and
    `outliers` give the same geometry at another size."""
    rng = np.random.default_rng(seed)
    M = KF_RING
    cam = FULL_CAM
    Xw = np.c_[rng.uniform(-4, 4, (N, 2)), rng.uniform(4, 12, N)].astype(np.float32)
    R = np.stack([_np(se3_exp(torch.tensor([0, 0, 0, 0, 0.01 * m, 0], dtype=torch.float32)).R)
                  for m in range(M)])
    t = np.stack([np.array([-0.1 * m, 0.0, -0.05 * m], np.float32) for m in range(M)])
    of, op, ouv = [], [], []
    for m in range(M):
        Xc = Xw @ R[m].T + t[m]
        pix = np.c_[cam.fx * Xc[:, 0] / Xc[:, 2] + cam.cx, cam.fy * Xc[:, 1] / Xc[:, 2] + cam.cy]
        sel = np.sort(rng.choice(N, seen, replace=False))
        of.append(np.full(sel.size, m))
        op.append(sel)
        ouv.append(pix[sel] + rng.normal(0, 0.7, (sel.size, 2)))
    obs_uv = np.concatenate(ouv).astype(np.float32)
    K = len(obs_uv)
    obs_uv[rng.choice(K, outliers, replace=False)] += 25.0
    xi = rng.normal(0, 0.003, (M, 6)).astype(np.float32)
    xi[0] = 0
    T = se3_exp(torch.tensor(xi)).compose(TSE3(R=torch.tensor(R), t=torch.tensor(t)))
    return dict(R=_np(T.R), t=_np(T.t), frame_valid=np.ones(M, bool),
                frame_fixed=np.arange(M) == 0,
                Xw=(Xw + rng.normal(0, 0.03, Xw.shape)).astype(np.float32),
                point_valid=np.ones(N, bool), obs_frame=np.concatenate(of).astype(np.int32),
                obs_point=np.concatenate(op).astype(np.int32), obs_uv=obs_uv,
                obs_valid=np.ones(K, bool),
                obs_sigma2=(1.2 ** (2.0 * rng.integers(0, 3, K))).astype(np.float32))


def hybrid_shaped_problem(seed: int = 0) -> dict:
    """map_cap_problem at the size of a full-hybrid local BA of the smoke's
    run (chip_smoke.py phase 5: M 6, N 654, K 1653): 654 points, each
    keyframe seeing 276 of them (K = 1,656), 16 outliers."""
    return map_cap_problem(seed, N=654, seen=276, outliers=16)


def frames_problem(M: int) -> dict:
    """local_problem with M frame slots, 1 to 8: the kernel's solve at each
    padded size Dp = 8 ceil(6M / 8) (8 to 48; one row a lane up to Dp 32 at
    M 5, two rows from Dp 40 at M 6). Frame 0 fixed up to M 2, frames 0 and
    1 above."""
    return local_problem(10 + M, M=M, N=90, fixed=1 if M <= 2 else 2)


def many_groups_problem() -> dict:
    """map_cap_problem with 5,000 points (313 point groups, more than the
    card's 132 SMs: each block owns three groups), each keyframe seeing
    1,800 of them (K = 10,800), 100 outliers."""
    return map_cap_problem(1, N=5000, seen=1800, outliers=100)


def repeated_obs_problem() -> dict:
    """local_problem with 8 frames and every observation made twice (the
    copy 0.3 px off): each (point, frame) pair holds two observations, and a
    group of 16 points holds more list positions than the kernel keeps in
    shared memory (128)."""
    d = local_problem(3, M=8, N=64, fixed=2)
    rng = np.random.default_rng(3)
    K = d["obs_frame"].size
    order = np.argsort(np.r_[np.arange(K), np.arange(K) + 0.5], kind="stable")
    twice = {k: np.r_[v, v] for k, v in d.items() if k.startswith("obs_")}
    twice["obs_uv"] = np.r_[d["obs_uv"], d["obs_uv"] + rng.normal(0, 0.3, d["obs_uv"].shape)]
    d.update({k: v[order].astype(d[k].dtype) for k, v in twice.items()})
    return d


def edge_case(name: str) -> tuple[dict, tuple[int, int]]:
    """The named edge case (numpy arrays) and its stages' iterations."""
    d = local_problem(0)
    iters = (5, 10)
    if name == "all_invalid":
        d["obs_valid"][:] = False
    elif name == "point_without_obs":
        # point 3 valid, none of its observations valid
        d["point_valid"][3] = True
        d["obs_valid"][d["obs_point"] == 3] = False
    elif name == "nonfinite_step":
        # a zero variance gives one observation a NaN weight: every step's
        # candidate is NaN and scores 0 (its observations drop out), below
        # the held energy; the port rejects it (the JAX package accepts it)
        k = int(np.flatnonzero(d["obs_valid"] & d["point_valid"][d["obs_point"]]
                               & (d["obs_frame"] >= 2))[0])
        d["obs_sigma2"][k] = 0.0
    elif name == "two_view":
        d = two_view_problem(0)
    elif name == "no_iterations":
        iters = (0, 0)
    elif name == "six_frames":
        d = local_problem(1, M=6, N=100, fixed=2)
    else:
        raise ValueError(name)
    return d, iters


EDGE_CASES = ("all_invalid", "point_without_obs", "nonfinite_step", "two_view",
              "no_iterations", "six_frames")


# -- the kernel on the card ---------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no CPU mode")
    return torch.device("cuda")


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal bit for bit (a NaN equals a NaN of the same bits)."""
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and torch.equal(a, b)


def _to(prob, dev):
    return tiba.IndirectBAProblem(
        T=TSE3(R=prob.T.R.to(dev), t=prob.T.t.to(dev)),
        **{k: getattr(prob, k).to(dev) for k in ("frame_valid", "frame_fixed", "Xw",
                                                 "point_valid", "obs_frame", "obs_point",
                                                 "obs_uv", "obs_valid", "obs_sigma2")})


def _case(name: str) -> tuple[dict, tuple[int, int], TCam]:
    if name.startswith("seed"):
        return local_problem(int(name[4:])), (5, 10), TCAM
    if name == "map_cap":
        return map_cap_problem(), (5, 10), FULL_CAM
    if name == "many_groups":
        return many_groups_problem(), (5, 10), FULL_CAM
    if name == "repeated_obs":
        return repeated_obs_problem(), (5, 10), TCAM
    if name.startswith("frames"):
        return frames_problem(int(name[6:])), (5, 10), TCAM
    if name.startswith("hybrid"):
        return hybrid_shaped_problem(int(name[6:])), (5, 10), FULL_CAM
    d, iters = edge_case(name)
    return d, iters, TCAM


# the well-conditioned cases (two fixed frames): the kernel within the bounds
# of the plain form on the CPU, nothing pruned otherwise without an
# explanation, as tests/test_torch_local_ba_kernels.py holds its model. (The
# plain form on the card rounds otherwise: cuBLAS's products, solve_ex.)
WITHIN = ("seed0", "seed1", "six_frames")


@pytest.mark.parametrize("name", ["seed0", "seed1", *EDGE_CASES, "map_cap", "hybrid0",
                                  "hybrid1", *(f"frames{m}" for m in range(1, 9)),
                                  "many_groups", "repeated_obs"])
def test_cuda_local_ba_matches_plain(cuda, name):
    """The kernel on a card problem is one launch, held to
    run_local_ba_plain by local_ba.parity beside a float64 run of the plain
    form (local_ba.compare); on WITHIN's problems within PARITY_TOL of the
    plain form, as the CPU model test holds the model."""
    d, iters, cam = _case(name)
    prob = _to(problem_from(d), cuda)
    rep = lba.compare(prob, cam, iters)
    got = rep["got"]
    info = {k: v for k, v in rep.items() if k not in ("got", "want", "trace", "mid")}
    assert rep["launches"] == 1
    assert rep["ok"], info
    if name in WITHIN:
        pc = problem_from(d)
        mid_p = []
        want = tiba.run_local_ba_plain(pc, cam, *iters, mid=mid_p)
        rc = lba.parity(_to(got, "cpu"), want, pc, cam, lba.f64_run(pc, cam, *iters),
                        (rep["mid"].cpu(), mid_p[0].obs_valid))
        assert rc["ok"] and rc["within"] and not rc["unexplained_obs"], rc
    if name in ("all_invalid", "no_iterations"):
        # no step accepted: the state keeps its bits
        assert same_bits(got.T.R, prob.T.R) and same_bits(got.T.t, prob.T.t)
        assert same_bits(got.Xw, prob.Xw)
    if name == "nonfinite_step":
        # the first stage's candidates are all NaN and score below the held
        # energy, and none is taken; its prune drops the observation
        tr = rep["trace"][:iters[0]]
        assert (tr[:, 2] == 0).all() and (tr[:, 1] < tr[:, 0]).all()
    if name == "point_without_obs":
        assert torch.equal(got.Xw[3], prob.Xw[3])


def test_cuda_local_ba_dispatch_is_one_launch(cuda):
    """The public run_local_ba on a card problem launches the kernel once
    and never the plain loop."""
    prob = _to(problem_from(local_problem(0)), cuda)
    before = lba.local_ba_cuda.launches
    out = tiba.run_local_ba(prob, TCAM)
    torch.cuda.synchronize()
    assert lba.local_ba_cuda.launches - before == 1
    assert out.Xw.device == prob.Xw.device and out.obs_valid.dtype == torch.bool


@pytest.mark.parametrize("name", ["seed0", "map_cap"])
def test_cuda_local_ba_repeats_bit_for_bit(cuda, name):
    """Two runs of the kernel on the same problem: the same bits (T, Xw,
    obs_valid, every step's trace)."""
    d, iters, cam = _case(name)
    prob = _to(problem_from(d), cuda)
    outs = []
    for _ in range(2):
        trace = torch.empty((sum(iters), 3), dtype=torch.float64, device=cuda)
        outs.append((lba.local_ba_cuda(prob, cam, *iters, trace=trace), trace))
    torch.cuda.synchronize()
    (a, ta), (b, tb) = outs
    for x, y in ((a.T.R, b.T.R), (a.T.t, b.T.t), (a.Xw, b.Xw), (a.obs_valid, b.obs_valid),
                 (ta, tb)):
        assert same_bits(x, y)


def test_cuda_local_ba_rejects_a_nonfinite_candidate(cuda):
    """A candidate with a non-finite pose or point is rejected even when its
    energy is lower: here a NaN point that is not valid (its observations
    never count) makes every candidate non-finite, so no step is taken and
    the state keeps its bits, as in the plain form."""
    d = local_problem(0)
    d["point_valid"][5] = False
    d["Xw"][5] = np.nan
    prob = _to(problem_from(d), cuda)
    trace = torch.empty((15, 3), dtype=torch.float64, device=cuda)
    got = lba.local_ba_cuda(prob, TCAM, trace=trace)
    tr = _np(trace)
    assert (tr[:, 2] == 0).all()                 # every candidate non-finite
    assert (tr[:, 1] < tr[:, 0]).any()           # and some scored lower
    assert same_bits(got.T.R, prob.T.R) and same_bits(got.T.t, prob.T.t)
    assert same_bits(got.Xw, prob.Xw)
    want = tiba.run_local_ba_plain(prob, TCAM)
    assert torch.equal(got.obs_valid, want.obs_valid)


def test_cuda_local_ba_takes_its_most_points(cuda):
    """At local_ba.max_points (every block owning as many point groups as
    its shared memory holds) the kernel is one launch, held to
    run_local_ba_plain as test_cuda_local_ba_matches_plain holds it; one
    point more is refused before any launch."""
    n = lba.max_points(cuda)
    assert n >= MAP_CAP
    d = map_cap_problem(3, N=n, seen=2000, outliers=100)
    prob = _to(problem_from(d), cuda)
    rep = lba.compare(prob, FULL_CAM)
    info = {k: v for k, v in rep.items() if k not in ("got", "want", "trace", "mid")}
    assert rep["launches"] == 1 and rep["ok"], info
    more = prob.replace(Xw=torch.cat([prob.Xw, prob.Xw[:1]]),
                        point_valid=torch.cat([prob.point_valid, prob.point_valid[:1]]))
    before = lba.local_ba_cuda.launches
    with pytest.raises(ValueError, match="points"):
        lba.local_ba_cuda(more, FULL_CAM)
    assert lba.local_ba_cuda.launches == before


def test_cuda_local_ba_refuses_what_it_does_not_take(cuda):
    prob = _to(problem_from(local_problem(0)), cuda)
    before = lba.local_ba_cuda.launches
    nine = prob.replace(T=TSE3(R=torch.eye(3, device=cuda).expand(9, 3, 3).contiguous(),
                               t=torch.zeros(9, 3, device=cuda)))
    with pytest.raises(ValueError, match="frame slots"):
        lba.local_ba_cuda(nine, TCAM)
    with pytest.raises(TypeError, match="dtype"):
        lba.local_ba_cuda(prob.replace(obs_frame=prob.obs_frame.long()), TCAM)
    assert lba.local_ba_cuda.launches == before
