"""The pair tests computed inside the Hamming kernel (csrc/hamming_match.cu,
match_projection's and match_epipolar's) and the triangulation kernel
(csrc/triangulate.cu) on the card, held to their plain forms: the
predicate modes bit for bit against the mask mode fed the plain form's mask
except at counted edge pairs (hamming_match.pair_parity), the triangulation
within its tolerances of the plain form and of its float64 model
(triangulate.tri_parity). Seeded two-view scenes at ORB budgets 512 and
2000 a level (presets/orb2000.yaml; 3 levels), every query masked, a single
row and column, a pure rotation (every triangulation refused) and a 9 mm
forward baseline (the epipoles' cross products under 1e-12); one
launch a match, two for _epipolar_triangulate, and no (N, M) tensor.

This file imports only torch, numpy, pytest and the port, so that it runs on
the card machine (which has no JAX package):

    python -m pytest --noconftest -q tests/test_torch_card_*.py

Without a card every case skips. tests/test_torch_tri_kernels.py imports
the case builders from here.
"""

import math

import numpy as np
import pytest
import torch

from libcml_tpu_torch.core.camera import PinholeCamera
from libcml_tpu_torch.core.lie import SE3
from libcml_tpu_torch.models.indirect import matching
from libcml_tpu_torch.models.indirect.triangulation import fundamental
from libcml_tpu_torch.ops import hamming_match as hm
from libcml_tpu_torch.ops import triangulate as tr
from libcml_tpu_torch.runtime import hybrid

torch.set_num_threads(1)

# the smoke's full-width camera (workload.py)
CAM = PinholeCamera.make(520.0, 520.0, 319.5, 239.5, 640, 480)


def _rot(yaw: float, pitch: float = 0.0) -> np.ndarray:
    cy, sy, cp, sp = math.cos(yaw), math.sin(yaw), math.cos(pitch), math.sin(pitch)
    Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    Rx = np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]])
    return Ry @ Rx


def _flip(desc: np.ndarray, n: int, rng) -> np.ndarray:
    """Copies of (K, 8) uint32 descriptors with `n` random bits flipped each."""
    bits = np.unpackbits(desc.astype(">u4").view(np.uint8).reshape(len(desc), 32), axis=1)
    for row in bits:
        row[rng.choice(256, n, replace=False)] ^= 1
    return np.packbits(bits, axis=1).view(">u4").astype(np.uint32).reshape(len(desc), 8)


def two_view_case(name: str, cam: PinholeCamera = CAM) -> dict:
    """A seeded two-keyframe scene: N corners in keyframe 0 (uv0, levels,
    angles, descriptors), M in keyframe 1, of which the first n_common are
    the same points (their descriptors a few bits apart, their angles
    rotated together), poses T0 and T_new (world to camera, float32
    arrays). `name`: "b512", "b2000" (3 levels of that budget), "all_masked",
    "n1", "nK" (K corners a keyframe), "pure_rotation", "forward" (a 9 mm
    forward baseline)."""
    rng = np.random.default_rng(sum(map(ord, name)))
    if name[0] == "n" and name[1:].isdigit():
        N = M = int(name[1:])
    else:
        N = M = 3 * {"b2000": 2000}.get(name, 512)
    n_common = max(1, int(0.6 * N))
    R0, t0 = np.eye(3), np.zeros(3)
    if name == "pure_rotation":
        Rn, tn = _rot(0.03, 0.01), np.zeros(3)
    elif name == "forward":
        # 9 mm forward, the CLI corridor's keyframe baseline: the translated
        # F's cross products fall under the epipole normalisation's floor
        Rn = _rot(0.001)
        tn = -Rn @ np.array([0.0002, 0.0001, 0.009])
    else:
        Rn = _rot(0.02, 0.005)
        tn = -Rn @ np.array([0.25, 0.02, 0.1])        # a 0.27 m baseline, camera 1's centre
    # points in front of both cameras, inside keyframe 0's frame
    def points(n):
        uv = rng.uniform([20, 20], [cam.width - 20, cam.height - 20], (n, 2))
        z = rng.uniform(2.0, 12.0, n)
        return np.c_[(uv[:, 0] - cam.cx) / cam.fx * z, (uv[:, 1] - cam.cy) / cam.fy * z, z]

    def project(X, R, t):
        Xc = X @ R.T + t
        return np.c_[cam.fx * Xc[:, 0] / Xc[:, 2] + cam.cx, cam.fy * Xc[:, 1] / Xc[:, 2] + cam.cy]

    X = points(n_common)
    uv0 = np.r_[project(X, R0, t0), rng.uniform([0, 0], [cam.width, cam.height],
                                                 (N - n_common, 2))]
    uv1 = np.r_[project(X, Rn, tn), rng.uniform([0, 0], [cam.width, cam.height],
                                                 (M - n_common, 2))]
    uv0 += rng.normal(0, 0.6, uv0.shape)
    uv1 += rng.normal(0, 0.6, uv1.shape)
    # corner 1's order shuffled, so that a match is no identity map
    perm = rng.permutation(M)
    desc0 = rng.integers(0, 2**32, (N, 8), dtype=np.uint32)
    desc1 = rng.integers(0, 2**32, (M, 8), dtype=np.uint32)
    desc1[:n_common] = _flip(desc0[:n_common], 12, rng)
    angle0 = rng.uniform(0, 2 * math.pi, N)
    angle1 = rng.uniform(0, 2 * math.pi, M)
    angle1[:n_common] = np.mod(angle0[:n_common] + 0.05 + rng.normal(0, 0.02, n_common),
                               2 * math.pi)
    angle1[:n_common:7] = rng.uniform(0, 2 * math.pi, len(angle1[:n_common:7]))  # outliers
    level0 = rng.integers(0, 3, N).astype(np.int32)
    level1 = level0.copy() if N == M else rng.integers(0, 3, M).astype(np.int32)
    level1[n_common:] = rng.integers(0, 3, M - n_common)
    valid0 = rng.random(N) > 0.15
    valid1 = rng.random(M) > 0.15
    if name == "all_masked":
        valid0[:] = False
    if name == "n1":
        valid0[:] = valid1[:] = True
    f32 = lambda a: np.asarray(a, np.float32)   # noqa: E731
    return {"desc0": desc0, "uv0": f32(uv0), "valid0": valid0, "angle0": f32(angle0),
            "level0": level0, "desc1": desc1[perm], "uv1": f32(uv1[perm]),
            "valid1": valid1[perm], "angle1": f32(angle1[perm]), "level1": level1[perm],
            "R0": f32(R0), "t0": f32(t0), "R_new": f32(Rn), "t_new": f32(tn),
            "X": X}


def projection_case(name: str, cam: PinholeCamera = CAM) -> dict:
    """match_projection's inputs from a two-view case: keyframe 0's points
    (a 4096-slot map, the common points valid and the rest padding) against
    keyframe 1's corners at its pose. "strideS": b512's points only in the
    map slots 5, 5 + S, 5 + 2 S, ... (S 512: row group 5 of the mask mode's plan; S 264:
    one row group of the pair modes' plan on 132 SMs, so that its warps take
    two live rows each)."""
    stride = int(name[6:]) if name.startswith("stride") else None
    c = two_view_case("b512" if stride else name, cam)
    P = max(4096, len(c["X"]))
    slots = np.arange(5, P, stride)[:len(c["X"])] if stride else np.arange(len(c["X"]))
    n = len(slots)
    Xw = np.zeros((P, 3), np.float32)
    Xw[slots] = c["X"][:n]
    valid = np.zeros(P, bool)
    valid[slots] = True if stride else c["valid0"][:n]
    desc = np.zeros((P, 8), np.uint32)
    desc[slots] = c["desc0"][:n]
    level = np.zeros(P, np.int32)
    level[slots] = c["level0"][:n]
    return {"Xw": Xw, "desc_p": desc, "valid_p": valid, "level_p": level,
            "R": c["R_new"], "t": c["t_new"], "desc_f": c["desc1"], "uv_f": c["uv1"],
            "level_f": c["level1"], "valid_f": c["valid1"]}


def tensors(case: dict, dev) -> dict:
    """The case's arrays as tensors on `dev` (uint32 words as int32)."""
    out = {}
    for k, v in case.items():
        v = np.asarray(v)
        out[k] = torch.as_tensor(v.view(np.int32) if v.dtype == np.uint32 else v).to(dev)
    return out


def se3(R, t) -> SE3:
    return SE3(R=R, t=t)


# n1537: a triangulation of 1,537 rows (one more than a block count of
# 8-row blocks); n2049: one corner over the pair modes' column chunk
# (PAIR_CW), so the split route runs; n1001: N a multiple of neither 8 nor 32
TWO_VIEW_CASES = ["b512", "b2000", "all_masked", "n1", "n1537", "pure_rotation", "forward"]
PROJECTION_CASES = ["b512", "b2000", "all_masked", "n1", "stride512", "stride264", "n2049",
                    "n1001"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no CPU mode")
    return torch.device("cuda")


def _peak_growth(fn):
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated() - before


@pytest.mark.parametrize("radius", [15.0, 9.0])
@pytest.mark.parametrize("name", PROJECTION_CASES)
def test_cuda_projection_match(cuda, name, radius):
    c = tensors(projection_case(name), cuda)
    T = se3(c["R"], c["t"])
    args = (c["Xw"], c["desc_p"], c["valid_p"], c["level_p"], T, CAM, c["desc_f"], c["uv_f"],
            c["level_f"], c["valid_f"])
    before = hm.match_projection_cuda.launches, hm.hamming_resolve_cuda.launches
    (m, uv_p), grew = _peak_growth(lambda: matching.match_projection(*args, radius=radius))
    assert (hm.match_projection_cuda.launches, hm.hamming_resolve_cuda.launches) == \
        (before[0] + 1, before[1])
    P, F = c["Xw"].shape[0], c["uv_f"].shape[0]
    if F >= 64:   # below, a (P, F) mask is no larger than the outputs
        assert grew < P * F // 2, f"{grew} bytes allocated: an (N, M) tensor"
    got = hm.match_projection_cuda(*args[:4], T.R, T.t, CAM, *args[6:], radius=radius)
    vis, pair, uv_plain = matching.projection_pair_mask(c["Xw"], c["valid_p"], c["level_p"], T,
                                                        CAM, c["uv_f"], c["level_f"], radius)
    want = hm.hamming_resolve_cuda(c["desc_p"], vis, c["desc_f"], c["valid_f"], pair)
    best, _, ok = matching._finish(*want, 100, 0.9)
    edges = hm.projection_edges(c["Xw"], c["valid_p"], c["level_p"], c["R"], c["t"], CAM,
                                c["uv_f"], c["level_f"], c["valid_f"], radius)
    rep = hm.pair_parity(got, (*want, best, ok), edges)
    assert rep["ok"], rep
    assert torch.equal(m.idx, got.best) and torch.equal(m.valid, got.ok)
    # the projected pixels of the visible points: float64's, rounded once
    vis64 = edges["vis"]
    d64 = (uv_p.double() - edges["uv"]).abs().amax(1)[vis64]
    dp = (uv_p - uv_plain).abs().amax(1)[vis64]
    assert d64.numel() == 0 or (float(d64.max()) < 1e-4 and float(dp.max()) < 1e-2)
    if name == "all_masked":
        assert int(got.num) == 0
    elif name.startswith("b") or name == "n2049":
        assert int(got.num) > 100
    elif name.startswith("stride"):
        assert int(got.num) > 0


@pytest.mark.parametrize("name", ["b512", "b2000", "n1", "n2049", "n1001"])
def test_cuda_epipolar_match_with_F(cuda, name):
    c = tensors(two_view_case(name), cuda)
    T_10 = se3(c["R_new"], c["t_new"]).compose(se3(c["R0"], c["t0"]).inverse())
    F = fundamental(T_10, CAM)
    args = (c["desc0"], c["uv0"], c["valid0"], c["desc1"], c["uv1"], c["valid1"], F)
    before = hm.match_epipolar_cuda.launches, hm.hamming_resolve_cuda.launches
    m = matching.match_epipolar(*args)
    assert (hm.match_epipolar_cuda.launches, hm.hamming_resolve_cuda.launches) == \
        (before[0] + 1, before[1])
    got = hm.match_epipolar_cuda(*args[:6], F=F)
    pair = matching.epipolar_pair_mask(c["uv0"], c["uv1"], F)
    want = hm.hamming_resolve_cuda(c["desc0"], c["valid0"], c["desc1"], c["valid1"], pair)
    best, _, ok = matching._finish(*want, 50, 0.8)
    edges = hm.epipolar_edges(c["uv0"], c["valid0"], c["uv1"], c["valid1"], F.double())
    rep = hm.pair_parity(got, (*want, best, ok), edges)
    assert rep["ok"], rep
    assert torch.equal(m.idx, got.best) and int(m.num) == int(got.num)


@pytest.mark.parametrize("optimal", [True, False])
@pytest.mark.parametrize("name", TWO_VIEW_CASES)
def test_cuda_epipolar_triangulate(cuda, name, optimal):
    c = tensors(two_view_case(name), cuda)
    T0, Tn = se3(c["R0"], c["t0"]), se3(c["R_new"], c["t_new"])
    args = (c["desc0"], c["uv0"], c["valid0"], c["angle0"], c["desc1"], c["uv1"], c["valid1"],
            c["angle1"], Tn, T0, CAM)
    counts = lambda: (hm.match_epipolar_cuda.launches, tr.triangulate_cuda.launches,   # noqa
                      hm.hamming_resolve_cuda.launches)
    before = counts()
    m, X0, ok, t_norm = hybrid._epipolar_triangulate(*args, optimal=optimal)
    torch.cuda.synchronize()
    assert counts() == (before[0] + 1, before[1] + 1, before[2])
    mp, Xp, okp, np_ = hybrid._epipolar_triangulate_plain(*args, optimal=optimal)
    assert abs(float(t_norm) - float(np_)) <= 1e-6 * max(float(np_), 1.0)
    # the match, against the mask mode on the plain form's mask
    pm = hm.match_epipolar_cuda(*args[:3], *args[4:7], poses=(Tn.R, Tn.t, T0.R, T0.t), cam=CAM)
    T_10 = Tn.compose(T0.inverse())
    F = fundamental(T_10, CAM)
    pair = matching.epipolar_pair_mask(c["uv0"], c["uv1"], F)
    want = hm.hamming_resolve_cuda(c["desc0"], c["valid0"], c["desc1"], c["valid1"], pair)
    best, _, okw = matching._finish(*want, 50, 0.8)
    geom = pm.geom.cpu().numpy()
    edges = hm.epipolar_edges(c["uv0"], c["valid0"], c["uv1"], c["valid1"],
                              pm.geom[:9].reshape(3, 3))
    rep = hm.pair_parity(pm, (*want, best, okw), edges)
    assert rep["ok"], rep
    assert torch.equal(m.idx, pm.best) and torch.equal(m.valid, pm.ok)
    # the triangulation on the plain form's match, against the plain form and the model
    probe = torch.full((X0.shape[0], 4), float("nan"), device=cuda)
    Xk, okk = tr.triangulate_cuda(c["uv0"], c["uv1"], c["angle0"], c["angle1"], mp.idx,
                                  mp.valid, pm.geom, CAM, optimal, probe)
    plain = tr.plain_triangulate(c["uv0"], c["uv1"], c["angle0"], c["angle1"], mp.idx, mp.valid,
                                 F, T_10, CAM, optimal)
    model = tr.model_triangulate(*(x.cpu().numpy() for x in (c["uv0"], c["uv1"], c["angle0"],
                                                              c["angle1"], mp.idx, mp.valid)),
                                 geom, CAM, optimal)
    f64 = tr.plain_triangulate(c["uv0"].double(), c["uv1"].double(), c["angle0"], c["angle1"],
                               mp.idx, mp.valid, pm.geom[:9].reshape(3, 3),
                               se3(pm.geom[9:18].reshape(3, 3), pm.geom[18:21]), CAM, optimal)
    rep = tr.tri_parity({"X0": Xk, "ok": okk, "corrected": probe}, plain, model, f64, CAM)
    assert rep["ok"], rep
    if name == "pure_rotation":
        assert not bool(ok.any()) and not bool(okp.any())
    elif name in ("b512", "b2000", "n1537"):
        assert int(ok.sum()) > 100
