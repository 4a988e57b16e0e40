"""CPU checks of the pair tests computed inside the Hamming kernel and of the
triangulation kernel (ops/hamming_match.py match_projection_cuda and
match_epipolar_cuda, ops/triangulate.py), which run only on a card: their
numpy models (the kernels' arithmetic: the pair tests in float64, the bins
in float32, the cross-product epipoles, torch.linspace's grid, the first
index on ties, remainder) held to the plain forms and to the JAX package
(matching.match_projection, match_epipolar, triangulation.optimal_correct,
_min_cost_t, hybrid._epipolar_triangulate with optimal True and False),
on seeded numpy inputs at N <= 256; the t -> inf branch, exact grid ties, a
pure rotation and masked rows; the CPU path never loading a library and a
card call without one raising; and the verdicts (pair_parity, tri_parity)
refusing the faults the smoke plants. The kernels' own work split: the
pair modes' plan covering every row and column once, the triangulation's
warp argmin (its lane strides and shuffle order) against the sequential
loop's rule, the smoke's fault targets each once in the shipped sources,
and every `// stage:` mark found by tools/ba_stages.py.
"""

import math
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import libcml_tpu.models.indirect.matching as jmatch
import libcml_tpu.runtime.hybrid as jhyb
from libcml_tpu.core.camera import PinholeCamera as JCam
from libcml_tpu.core.lie import SE3 as JSE3
from libcml_tpu.models.indirect.triangulation import _min_cost_t as jmin_cost_t
from libcml_tpu.models.indirect.triangulation import optimal_correct as joptimal

from libcml_tpu_torch.core.camera import PinholeCamera as TCam
from libcml_tpu_torch.models.indirect import matching as tmatch
from libcml_tpu_torch.models.indirect import triangulation as ttri
from libcml_tpu_torch.ops import hamming_match as hm
from libcml_tpu_torch.ops import kernel_build as kb
from libcml_tpu_torch.ops import triangulate as tr
from libcml_tpu_torch.runtime import hybrid as thyb
from test_torch_card_tri import projection_case, se3, tensors, two_view_case

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
import ba_stages  # noqa: E402
import chip_smoke as cs  # noqa: E402

torch.set_num_threads(1)

# a 256-corner case at the tests' 160x120 camera (tests/test_torch_hybrid.py)
CAM_ARGS = (110.0, 110.0, 79.5, 59.5, 160, 120)
TCAM, JCAM = TCam.make(*CAM_ARGS), JCam.make(*CAM_ARGS)


def _small(name: str) -> dict:
    """A two-view case of 256 corners a keyframe at the small camera."""
    c = two_view_case(name, TCAM)
    n = min(256, len(c["uv0"]))
    out = {k: (v[:n] if k not in ("R0", "t0", "R_new", "t_new", "X") else v)
           for k, v in c.items()}
    return out


def _np(x):
    return np.asarray(x.cpu() if torch.is_tensor(x) else x)


def _model_match(desc_q, mask_q, desc_t, mask_t, live, max_dist, ratio) -> hm.PairMatch:
    """The predicate modes' outputs from a numpy pair test `live` (N, M):
    the resolution over the live pairs and matching._finish, on the CPU."""
    t = lambda a: torch.as_tensor(np.asarray(a))   # noqa: E731
    d1, d2, idx, col_row = hm.hamming_resolve_plain(t(desc_q), t(mask_q), t(desc_t), t(mask_t),
                                                    t(live))
    best, _, ok = tmatch._finish(d1, d2, idx, col_row, max_dist, ratio)
    return hm.PairMatch(d1=d1, d2=d2, idx=idx, col_row=col_row, best=best, ok=ok,
                        num=torch.sum(ok))


def _hold_to_reference(got: hm.PairMatch, idx, dist, valid, edges) -> dict:
    """The model's match against a reference MatchResult: rows that touch
    no edge pair equal in idx and distance, ok equal except on rows whose
    column such a pair reaches."""
    erows, reach = edges["erows"], edges["reach"]
    g_idx, g_d1, g_ok = _np(got.best), _np(got.d1), _np(got.ok)
    idx, dist, valid = np.asarray(idx), np.asarray(dist), np.asarray(valid)
    bad = ((g_idx != idx) | (g_d1 != dist)) & ~erows
    bad_ok = (g_ok != valid) & ~(erows | reach[g_idx] | reach[idx])
    return {"rows_beyond": int(bad.sum()), "ok_beyond": int(bad_ok.sum()),
            "edge_pairs": edges["n_pairs"]}


# -- the pair tests -------------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["b512", "all_masked"])
def test_projection_model_matches_plain_and_jax(name):
    c = projection_case(name, TCAM)
    n = 256
    c = {k: (v[:n] if np.ndim(v) and len(v) == 4096 else v) for k, v in c.items()}
    edges = hm.projection_edges(c["Xw"], c["valid_p"], c["level_p"], c["R"], c["t"], TCAM,
                                c["uv_f"], c["level_f"], c["valid_f"], 15.0)
    got = _model_match(c["desc_p"].view(np.int32), edges["vis"].numpy(),
                       c["desc_f"].view(np.int32), c["valid_f"], edges["live"].numpy(), 100, 0.9)
    t = tensors(c, "cpu")
    m, uv_p = tmatch.match_projection(t["Xw"], t["desc_p"], t["valid_p"], t["level_p"],
                                      se3(t["R"], t["t"]), TCAM, t["desc_f"], t["uv_f"],
                                      t["level_f"], t["valid_f"])
    rep = _hold_to_reference(got, m.idx, m.dist, m.valid, edges)
    assert rep["rows_beyond"] == 0 and rep["ok_beyond"] == 0, rep
    # uv_p: the float64 pixel rounded against the plain float32 form
    assert np.abs(edges["uv"].numpy().astype(np.float32) - _np(uv_p)).max() < 1e-3
    mj, uvj = jmatch.match_projection(
        jnp.asarray(c["Xw"]), jnp.asarray(c["desc_p"]), jnp.asarray(c["valid_p"]),
        jnp.asarray(c["level_p"]), JSE3(R=jnp.asarray(c["R"]), t=jnp.asarray(c["t"])), JCAM,
        jnp.asarray(c["desc_f"]), jnp.asarray(c["uv_f"]), jnp.asarray(c["level_f"]),
        jnp.asarray(c["valid_f"]))
    rep = _hold_to_reference(got, mj.idx, mj.dist, mj.valid, edges)
    assert rep["rows_beyond"] == 0 and rep["ok_beyond"] == 0, rep
    np.testing.assert_allclose(np.asarray(uvj), _np(uv_p), rtol=0, atol=1e-3)
    if name == "all_masked":
        assert int(got.num) == 0 and int(mj.num) == 0
    else:
        assert int(got.num) > 20


def _two_view_geometry(c: dict):
    """(T_10 as torch SE3 float32, F float32 torch, F float64 numpy from the
    float32 poses)."""
    t = tensors({k: c[k] for k in ("R0", "t0", "R_new", "t_new")}, "cpu")
    T_10 = se3(t["R_new"], t["t_new"]).compose(se3(t["R0"], t["t0"]).inverse())
    R, tt = T_10.R.double().numpy(), T_10.t.double().numpy()
    K = np.array([[TCAM.fx, 0, TCAM.cx], [0, TCAM.fy, TCAM.cy], [0, 0, 1.0]])
    Ki = np.linalg.inv(K)
    tx = np.array([[0, -tt[2], tt[1]], [tt[2], 0, -tt[0]], [-tt[1], tt[0], 0]])
    return T_10, ttri.fundamental(T_10, TCAM), Ki.T @ tx @ R @ Ki


def test_epipolar_model_matches_plain_and_jax():
    c = _small("b512")
    T_10, F, F64 = _two_view_geometry(c)
    edges = hm.epipolar_edges(c["uv0"], c["valid0"], c["uv1"], c["valid1"], F64)
    got = _model_match(c["desc0"].view(np.int32), c["valid0"], c["desc1"].view(np.int32),
                       c["valid1"], edges["live"].numpy(), 50, 0.8)
    t = tensors(c, "cpu")
    m = tmatch.match_epipolar(t["desc0"], t["uv0"], t["valid0"], t["desc1"], t["uv1"],
                              t["valid1"], F)
    rep = _hold_to_reference(got, m.idx, m.dist, m.valid, edges)
    assert rep["rows_beyond"] == 0 and rep["ok_beyond"] == 0, rep
    mj = jmatch.match_epipolar(*(jnp.asarray(c[k]) for k in ("desc0", "uv0", "valid0", "desc1",
                                                             "uv1", "valid1")),
                               jnp.asarray(F.numpy()))
    rep = _hold_to_reference(got, mj.idx, mj.dist, mj.valid, edges)
    assert rep["rows_beyond"] == 0 and rep["ok_beyond"] == 0, rep
    assert int(got.num) > 20


# -- the triangulation ----------------------------------------------------------------------------


def test_bins_remainder_and_orientation_match_plain_and_jax():
    """orientation_check's float32 bins: a negative difference a hair below
    0 (its remainder rounds to 2 pi: bin 30, clamped to 29), exact
    multiples of 2 pi, bin boundaries, ties among the top bins."""
    rng = np.random.default_rng(3)
    n = 240
    a0 = rng.uniform(0, 2 * math.pi, n).astype(np.float32)
    a1 = (a0 - rng.choice([0.05, 0.3, 1.0, 2.0], n)).astype(np.float32)
    a0[:5] = 0.0                                              # -tiny differences:
    a1[:5] = np.float32(1e-7) * np.arange(1, 6, dtype=np.float32)   # 2 pi after remainder
    a1[5:10] = a0[5:10] - np.float32(2 * math.pi)             # remainder exactly 0 or ~2 pi
    a1[10:20] = a0[10:20] - np.float32(2 * math.pi / 30) * np.arange(10, dtype=np.float32)
    idx = rng.permutation(n)
    a1 = a1[np.argsort(idx)]                                  # a0[i] pairs with a1[idx[i]]
    valid = rng.random(n) > 0.1
    bins = tr.model_bins(a0, a1, idx)
    d = torch.remainder(torch.tensor(a0) - torch.tensor(a1)[torch.tensor(idx)], 2.0 * math.pi)
    want = torch.clamp((d * (30 / (2.0 * math.pi))).to(torch.int32), 0, 29).numpy()
    np.testing.assert_array_equal(bins, want)
    assert bins[:5].max() == 29
    got = tr.model_orientation(a0, a1, idx, valid)
    np.testing.assert_array_equal(got, tmatch.orientation_check(
        torch.tensor(a0), torch.tensor(a1), torch.tensor(idx), torch.tensor(valid)).numpy())
    np.testing.assert_array_equal(got, np.asarray(jmatch.orientation_check(
        jnp.asarray(a0), jnp.asarray(a1), jnp.asarray(idx), jnp.asarray(valid))))


def test_grid_is_linspaces_formula_and_symmetric():
    """grid_angles is torch.linspace's formula on the card (start + i step
    below the middle, end - (128 - i) step from it) in float64: exactly
    that, exactly symmetric (so an even cost ties exactly), and within a
    float32 rounding of torch.linspace's float32 values."""
    half = math.pi / 2 - 1e-3
    step = (half - (-half)) / (tr.GRID - 1)
    g = tr.grid_angles()
    for i in range(tr.GRID):
        assert g[i] == (-half + step * i if i < tr.GRID // 2 else half - step * (tr.GRID - 1 - i))
    np.testing.assert_array_equal(g, -g[::-1])
    assert g[tr.GRID // 2] == 0.0
    lin = torch.linspace(-half, half, tr.GRID, dtype=torch.float32).numpy()
    np.testing.assert_allclose(g, lin, rtol=0, atol=2.4e-7)


def test_min_cost_t_matches_plain_and_jax_with_exact_ties():
    """The model's _min_cost_t against the plain form's and the JAX
    package's on random pencils (t within 1e-4 of each other, or costs
    within 1e-6: flat minima), and on FAULT_PENCILS["tie"]'s exact tie,
    where the first index takes t = -0.3 in the model and the plain form
    (torch.linspace's symmetric grid) and the last index +0.3."""
    rng = np.random.default_rng(5)
    n = 64
    a, b, c, d = rng.normal(size=(4, n))
    f0, f1 = rng.uniform(-2, 2, (2, n))
    tm, cm, _, _ = tr.model_min_cost_t(a, b, c, d, f0, f1)
    tp, cp = ttri._min_cost_t(*(torch.tensor(x, dtype=torch.float32) for x in (a, b, c, d, f0,
                                                                               f1)))
    tj, cj = jmin_cost_t(*(jnp.asarray(x, jnp.float32) for x in (a, b, c, d, f0, f1)))
    for t_ref, c_ref in ((tp.numpy(), cp.numpy()), (np.asarray(tj), np.asarray(cj))):
        close = np.abs(np.arctan(tm) - np.arctan(t_ref)) < 1e-4
        flat = np.abs(cm - c_ref) <= 1e-6 * np.maximum(np.abs(cm), 1e-6)
        assert np.all(close | flat)
    # the exact tie: s(t) = t^2 + 1 / (100 t^2 + 1) (a = 10, d = 1, f1 = 1)
    tie = [np.array([x]) for x in (10.0, 0.0, 0.0, 1.0, 0.0, 1.0)]
    t_first, _, i_first, costs = tr.model_min_cost_t(*tie)
    t_last, _, i_last, _ = tr.model_min_cost_t(*tie, faults=("grid_ties_to_the_last_index",))
    assert costs[0, i_first[0]] == costs[0, i_last[0]] and i_first[0] < i_last[0]
    assert abs(t_first[0] + 0.3) < 1e-6 and abs(t_last[0] - 0.3) < 1e-6
    tp, _ = ttri._min_cost_t(*(torch.tensor(x, dtype=torch.float32) for x in tie))
    assert abs(float(tp[0]) + 0.3) < 1e-3



@pytest.mark.parametrize("scene", ["small", "forward"])
def test_lane_section_model_matches_golden_and_jax(scene):
    """The kernel's section search over a warp's lanes (tr.lane_section, in
    place of the reference's 40 golden-section steps): on seeded pencils
    its minimum within 1e-7 rad of the golden model's and of the JAX
    package's float32 _min_cost_t (or their costs equal to float64's
    flatness, 1e-12 relative, and float32's, 1e-6); on noisy two-view pairs
    its corrected pixels within MODEL_TOL of the golden model's and of the
    JAX package's optimal_correct run in float64 (the same basins)."""
    rng = np.random.default_rng(5)
    a, b, c, d = rng.normal(size=(4, 256))
    f0, f1 = rng.uniform(-2, 2, (2, 256))
    tl, cl, _, _ = tr.model_min_cost_t(a, b, c, d, f0, f1, search="lanes")
    tg, cg, _, _ = tr.model_min_cost_t(a, b, c, d, f0, f1)
    tj, cj = jmin_cost_t(*(jnp.asarray(x, jnp.float32) for x in (a, b, c, d, f0, f1)))
    for t_ref, c_ref, flat in ((tg, cg, 1e-12), (np.asarray(tj), np.asarray(cj), 1e-6)):
        close = np.abs(np.arctan(tl) - np.arctan(t_ref)) < 1e-7
        same = np.abs(cl - c_ref) <= flat * np.maximum(np.abs(cl), 1e-6)
        assert np.all(close | same)
    n = 200
    cam = TCAM if scene == "small" else FORWARD_CAM
    rng = np.random.default_rng(9)
    uv = rng.uniform([10, 10], [cam.width - 10, cam.height - 10], (n, 2))
    z = rng.uniform(2.0, 12.0, n)
    X = np.c_[(uv[:, 0] - cam.cx) / cam.fx * z, (uv[:, 1] - cam.cy) / cam.fy * z, z]
    R = _rot_small(0.01) if scene == "small" else np.eye(3)
    t = np.array([0.2, 0.01, 0.05]) if scene == "small" else np.array([0.0002, 0.0001, -0.009])
    Xc = X @ R.T + t
    x1 = np.c_[cam.fx * Xc[:, 0] / Xc[:, 2] + cam.cx, cam.fy * Xc[:, 1] / Xc[:, 2] + cam.cy]
    x0 = uv + rng.normal(0, 0.5, uv.shape)
    x1 = x1 + rng.normal(0, 0.7, x1.shape)
    Ki = np.linalg.inv(np.array([[cam.fx, 0, cam.cx], [0, cam.fy, cam.cy], [0, 0, 1.0]]))
    F = Ki.T @ np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]]) @ R @ Ki
    lanes = tr.model_correct(F, x0, x1, search="lanes")
    golden = tr.model_correct(F, x0, x1)
    hold = golden["basin_gap"] > tr.BASIN_REL
    assert hold.mean() > 0.95
    px = tr.MODEL_TOL["px"]
    assert np.abs(lanes["corrected"] - golden["corrected"]).max(1)[hold].max() <= px
    with jax.enable_x64(True):
        j0, j1 = joptimal(jnp.asarray(x0), jnp.asarray(x1), jnp.asarray(F))
    jx = np.c_[np.asarray(j0), np.asarray(j1)]
    assert np.abs(lanes["corrected"] - jx).max(1)[hold].max() <= px


def _rot_small(yaw: float) -> np.ndarray:
    c, s = math.cos(yaw), math.sin(yaw)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])

def _f64_plain(c, idx, valid, F64, T_10, optimal):
    t = tensors(c, "cpu")
    T = se3(T_10.R.double(), T_10.t.double())
    return tr.plain_triangulate(t["uv0"].double(), t["uv1"].double(), t["angle0"], t["angle1"],
                                torch.as_tensor(idx), torch.as_tensor(valid),
                                torch.tensor(F64), T, TCAM, optimal)


# the smoke's 640x480 camera moving 9 mm forward between keyframes (the CLI
# corridor's keyframe baseline): the translated F's pairwise cross products
# fall under _norm_epi's 1e-12 floor, so the epipole must be made unit
# first, as the SVD's vector is
FORWARD_CAM = TCam.make(520.0, 520.0, 319.5, 239.5, 640, 480)


@pytest.mark.parametrize("scene", ["small", "forward"])
def test_correction_model_matches_plain_and_jax(scene):
    """optimal_correct on noisy two-view pairs: the model (cross-product
    epipoles) against the plain form (SVD), the JAX package, and the plain
    form in float64, where the epipoles' sign and scale cannot matter."""
    n = 200
    if scene == "small":
        c = _small("b512")
        x0, X = c["uv0"][:n], c["X"][:n]
        T_10, F, F64 = _two_view_geometry(c)
        cam = TCAM
    else:
        cam = FORWARD_CAM
        rng = np.random.default_rng(7)
        uv = rng.uniform([40, 40], [600, 440], (n, 2))
        z = rng.uniform(3.0, 20.0, n)
        X = np.c_[(uv[:, 0] - cam.cx) / cam.fx * z, (uv[:, 1] - cam.cy) / cam.fy * z, z]
        x0 = (uv + rng.normal(0, 0.5, uv.shape)).astype(np.float32)
        R = np.array([[0.9999995, 0.0, 0.001], [0.0, 1.0, 0.0], [-0.001, 0.0, 0.9999995]])
        T_10 = se3(torch.tensor(R, dtype=torch.float32),
                   torch.tensor([0.0002, 0.0001, -0.009], dtype=torch.float32))
        F = ttri.fundamental(T_10, cam)
        Rd, td = T_10.R.double().numpy(), T_10.t.double().numpy()
        Ki = np.linalg.inv(np.array([[cam.fx, 0, cam.cx], [0, cam.fy, cam.cy], [0, 0, 1.0]]))
        F64 = Ki.T @ np.array([[0, -td[2], td[1]], [td[2], 0, -td[0]], [-td[1], td[0], 0]]) \
            @ Rd @ Ki
    R, tt = T_10.R.double().numpy(), T_10.t.double().numpy()
    Xc = X @ R.T + tt
    x1 = np.c_[cam.fx * Xc[:, 0] / Xc[:, 2] + cam.cx,
               cam.fy * Xc[:, 1] / Xc[:, 2] + cam.cy].astype(np.float32)
    x1 += np.random.default_rng(1).normal(0, 0.7, x1.shape).astype(np.float32)
    m = tr.model_correct(F64, x0, x1)
    hold = m["basin_gap"] > tr.BASIN_REL
    assert hold.mean() > 0.95
    p0, p1 = ttri.optimal_correct(torch.tensor(x0), torch.tensor(x1), F)
    d0, d1 = ttri.optimal_correct(torch.tensor(x0).double(), torch.tensor(x1).double(),
                                  torch.tensor(F64))
    j0, j1 = joptimal(jnp.asarray(x0), jnp.asarray(x1), jnp.asarray(F.numpy()))
    np.testing.assert_allclose(m["corrected"][hold], np.c_[d0.numpy(), d1.numpy()][hold],
                               rtol=0, atol=1e-6)
    # float32's SVD: within 2e-3 px at the small camera's baseline; at the
    # forward camera's, the plain float32 forms' own distance from float64
    for ref in (np.c_[p0.numpy(), p1.numpy()], np.c_[np.asarray(j0), np.asarray(j1)]):
        err = np.abs(m["corrected"] - ref).max(1)[hold]
        own = np.abs(np.c_[d0.numpy(), d1.numpy()] - ref).max(1)[hold]
        assert np.all((err <= 2e-3) | (err <= own + 1e-6))
    assert np.abs(m["corrected"][:, :2] - x0).max() > 0.3        # not a trivial correction


def test_asymptote_branch_matches_float64():
    """FAULT_PENCILS["asymptote"]: the minimum lies at t -> inf beyond the
    grid's reach; the model and the plain form and JAX in float64 take the
    asymptote's point (0.1, 0) / (0, 0); without the branch the model
    stays at the grid's interior minimum."""
    F = np.asarray(tr.FAULT_PENCILS["asymptote"])
    z = np.zeros((1, 2))
    m = tr.model_correct(F, z, z)
    assert bool(m["use_inf"][0])
    d0, d1 = ttri.optimal_correct(torch.zeros(1, 2).double(), torch.zeros(1, 2).double(),
                                  torch.tensor(F))
    with jax.enable_x64(True):
        j0, j1 = joptimal(jnp.zeros((1, 2)), jnp.zeros((1, 2)), jnp.asarray(F))
    for ref in (np.c_[d0.numpy(), d1.numpy()], np.c_[np.asarray(j0), np.asarray(j1)]):
        np.testing.assert_allclose(m["corrected"], ref, rtol=0, atol=1e-6)
    np.testing.assert_allclose(m["corrected"][0], [0.1, 0.0, 0.0, 0.0], atol=1e-9)
    off = tr.model_correct(F, z, z, ("asymptote_left_out",))
    assert np.abs(off["corrected"] - m["corrected"]).max() > 0.05


@pytest.mark.parametrize("optimal", [True, False])
@pytest.mark.parametrize("name", ["b512", "pure_rotation", "all_masked"])
def test_epipolar_triangulate_model_matches_plain_and_jax(name, optimal):
    """The whole _epipolar_triangulate: the model's match (float64 pair
    test) and triangulation against the port's plain form and the JAX
    package, under the smoke's verdicts; a pure rotation refuses every
    point and masked rows match nothing."""
    c = _small(name)
    T_10, F, F64 = _two_view_geometry(c)
    t = tensors(c, "cpu")
    T0, Tn = se3(t["R0"], t["t0"]), se3(t["R_new"], t["t_new"])
    args = (t["desc0"], t["uv0"], t["valid0"], t["angle0"], t["desc1"], t["uv1"], t["valid1"],
            t["angle1"])
    mp, Xp, okp, _ = thyb._epipolar_triangulate(*args, Tn, T0, TCAM, optimal=optimal)
    mj, Xj, okj, _ = jhyb._epipolar_triangulate(
        *(jnp.asarray(c[k]) for k in ("desc0", "uv0", "valid0", "angle0", "desc1", "uv1",
                                      "valid1", "angle1")),
        JSE3(R=jnp.asarray(c["R_new"]), t=jnp.asarray(c["t_new"])),
        JSE3(R=jnp.asarray(c["R0"]), t=jnp.asarray(c["t0"])), JCAM, optimal=optimal)
    edges = hm.epipolar_edges(c["uv0"], c["valid0"], c["uv1"], c["valid1"], F64)
    got = _model_match(c["desc0"].view(np.int32), c["valid0"], c["desc1"].view(np.int32),
                       c["valid1"], edges["live"].numpy(), 50, 0.8)
    for ref in ((mp.idx, mp.dist, mp.valid), (mj.idx, mj.dist, mj.valid)):
        rep = _hold_to_reference(got, *(np.asarray(_np(x)) for x in ref), edges)
        assert rep["rows_beyond"] == 0 and rep["ok_beyond"] == 0, rep
    geom = np.r_[F64.ravel(), T_10.R.double().numpy().ravel(), T_10.t.double().numpy(),
                 np.linalg.norm(T_10.t.double().numpy())]
    idx, valid = _np(mp.idx), _np(mp.valid)
    model = tr.model_triangulate(c["uv0"], c["uv1"], c["angle0"], c["angle1"], idx, valid, geom,
                                 TCAM, optimal)
    got_tri = {"X0": model["X0"].astype(np.float32), "ok": model["ok"],
               "corrected": model["corrected"].astype(np.float32)}
    plain = tr.plain_triangulate(t["uv0"], t["uv1"], t["angle0"], t["angle1"], mp.idx, mp.valid,
                                 F, T_10, TCAM, optimal)
    np.testing.assert_array_equal(_np(plain["ok"]), _np(okp))
    f64 = _f64_plain(c, idx, valid, F64, T_10, optimal)
    rep = tr.tri_parity(got_tri, plain, model, f64, TCAM)
    assert rep["ok"], rep
    # against the JAX package on its own match, which is the port's here
    np.testing.assert_array_equal(_np(mj.idx), idx)
    jm = {"X0": np.asarray(Xj), "ok": np.asarray(okj), "corrected": _np(plain["corrected"])}
    rep = tr.tri_parity(got_tri, jm, model, f64, TCAM)
    assert rep["ok"], rep
    if name == "pure_rotation":
        assert not model["ok"].any() and not np.asarray(okj).any()
    elif name == "all_masked":
        assert not model["ok"].any() and int(got.num) == 0 and int(mj.num) == 0
    else:
        assert model["ok"].sum() > 20


# -- the verdicts and the dispatch ----------------------------------------------------------------


@pytest.mark.parametrize("fault", [None, *tr.FAULTS])
@pytest.mark.parametrize("pencil", sorted(tr.FAULT_PENCILS))
def test_tri_parity_refuses_planted_faults(pencil, fault):
    """tri_parity on the fault pencils: the honest model passes, each fault
    fails on the pencil where it shows (and passes on the other)."""
    case = tr.fault_case(pencil)
    args = (case["uv0"], case["uv1"], case["angle0"], case["angle1"], case["idx"],
            case["valid"], case["geom"], TCAM)
    model = tr.model_triangulate(*args)
    got = tr.model_triangulate(*args, faults=() if fault is None else (fault,))
    g = case["geom"]
    f64 = tr.plain_triangulate(*(torch.tensor(case[k]).double() for k in ("uv0", "uv1")),
                               torch.tensor(case["angle0"]), torch.tensor(case["angle1"]),
                               torch.tensor(case["idx"]), torch.tensor(case["valid"]),
                               torch.tensor(g[:9].reshape(3, 3)),
                               se3(torch.tensor(g[9:18].reshape(3, 3)), torch.tensor(g[18:21])),
                               TCAM)
    rep = tr.tri_parity({k: got[k] for k in ("X0", "ok", "corrected")}, f64, model, f64, TCAM)
    shows = {"grid_ties_to_the_last_index": "tie", "asymptote_left_out": "asymptote"}
    assert rep["ok"] == (fault is None or shows[fault] != pencil), rep


def test_pair_parity_refuses_a_wider_level_window():
    """pair_parity: the projection model with |level_p - level_f| <= 2 (the
    smoke's planted fault) against the mask mode on the plain mask fails;
    the honest model passes."""
    c = projection_case("b512", TCAM)
    c = {k: (v[:256] if np.ndim(v) and len(v) == 4096 else v) for k, v in c.items()}
    edges = hm.projection_edges(c["Xw"], c["valid_p"], c["level_p"], c["R"], c["t"], TCAM,
                                c["uv_f"], c["level_f"], c["valid_f"], 15.0)
    t = tensors(c, "cpu")
    vis, pair, _ = tmatch.projection_pair_mask(t["Xw"], t["valid_p"], t["level_p"],
                                               se3(t["R"], t["t"]), TCAM, t["uv_f"],
                                               t["level_f"], 15.0)
    want = hm.hamming_resolve_plain(t["desc_p"], vis, t["desc_f"], t["valid_f"], pair)
    best, _, ok = tmatch._finish(*want, 100, 0.9)
    dq, dt = c["desc_p"].view(np.int32), c["desc_f"].view(np.int32)
    vis = edges["vis"].numpy()
    honest = _model_match(dq, vis, dt, c["valid_f"], edges["live"].numpy(), 100, 0.9)
    assert hm.pair_parity(honest, (*want, best, ok), edges)["ok"]
    lev = np.abs(c["level_p"][:, None] - c["level_f"][None, :]) <= 2
    d2 = ((edges["uv"].numpy()[:, None, :] - c["uv_f"][None].astype(np.float64)) ** 2).sum(-1)
    r = np.float32(15.0) * np.float32(1.5) ** c["level_p"].astype(np.float32)
    wide = vis[:, None] & c["valid_f"][None] & lev & (d2 <= (r * r)[:, None])
    faulty = _model_match(dq, vis, dt, c["valid_f"], wide, 100, 0.9)
    rep = hm.pair_parity(faulty, (*want, best, ok), edges)
    assert not rep["ok"] and rep["rows_beyond_edge"] > 0, rep


def test_cpu_calls_load_no_library_and_card_calls_raise_without_one(monkeypatch):
    """On CPU tensors the matches and _epipolar_triangulate take the plain
    forms and never load a kernel library; a call that takes the card path
    with the library missing raises instead of falling back."""
    loaded = []

    def missing(*args, **kw):
        loaded.append(args)
        raise kb.KernelBuildError("nvcc not found")

    monkeypatch.setattr(kb, "load", missing)
    c = tensors(_small("n1"), "cpu")
    T0, Tn = se3(c["R0"], c["t0"]), se3(c["R_new"], c["t_new"])
    args = (c["desc0"], c["uv0"], c["valid0"], c["angle0"], c["desc1"], c["uv1"], c["valid1"],
            c["angle1"], Tn, T0, TCAM)
    thyb._epipolar_triangulate(*args)
    p = tensors(projection_case("n1", TCAM), "cpu")
    tmatch.match_projection(p["Xw"], p["desc_p"], p["valid_p"], p["level_p"],
                            se3(p["R"], p["t"]), TCAM, p["desc_f"], p["uv_f"], p["level_f"],
                            p["valid_f"])
    assert loaded == []
    # the card path: tensors claiming CUDA take the kernels, whose wrappers
    # load their library first
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    for fn in (lambda: thyb._epipolar_triangulate(*args),
               lambda: tmatch.match_projection(p["Xw"], p["desc_p"], p["valid_p"],
                                               p["level_p"], se3(p["R"], p["t"]), TCAM,
                                               p["desc_f"], p["uv_f"], p["level_f"],
                                               p["valid_f"])):
        with pytest.raises(kb.KernelBuildError):
            fn()


# -- the kernels' work split and the smoke's faults -----------------------------------------------


@pytest.mark.parametrize("M", [1, 1536, hm.PAIR_CW + 1])
@pytest.mark.parametrize("N", [1, 7, 650, 4096])
def test_pair_plan_covers_every_row_and_column_once(N, M):
    """pair_plan's units (row group g: rows g + j groups, j < PAIR_ROWS;
    chunk k: columns [k cw, (k + 1) cw)) hold every row and column exactly
    once, pass hamming_pairs_launch's checks, and fit one wave of
    PAIR_BLOCKS_PER_SM blocks an SM on 132 SMs where a wave can hold them."""
    groups, chunks, cw = hm.pair_plan(N, M, 132)
    rows = (np.arange(groups)[:, None] + np.arange(hm.PAIR_ROWS)[None, :] * groups).ravel()
    rows = rows[rows < N]
    np.testing.assert_array_equal(np.sort(rows), np.arange(N))
    cols = np.concatenate([np.arange(k * cw, min((k + 1) * cw, M)) for k in range(chunks)])
    np.testing.assert_array_equal(cols, np.arange(M))
    assert 0 < cw <= hm.PAIR_CW and chunks * cw >= M and (chunks - 1) * cw < M
    assert groups * hm.PAIR_ROWS >= N
    if -(-N // hm.PAIR_ROWS) * chunks <= hm.PAIR_BLOCKS_PER_SM * 132:
        assert groups * chunks <= hm.PAIR_BLOCKS_PER_SM * 132
    assert (chunks == 1) == (M <= hm.PAIR_CW)


def _grid_costs(pencils) -> np.ndarray:
    """The 129 grid costs of (N, 6) pencils (a, b, c, d, f0, f1)."""
    P = np.asarray(pencils, np.float64)
    tan = np.tan(tr.grid_angles())[None, :]
    return tr._cost(tan, *(P[:, k:k + 1] for k in range(6)))


@pytest.mark.parametrize("case", ["tie", "random", "nan_at_0", "nan_elsewhere"])
def test_warp_argmin_follows_the_sequential_rule(case):
    """The kernel's grid argmin as its warp finds it (tr.warp_argmin: lane l
    folds l, l + 32, ..., then xor shuffles) against the reference loop's
    rule (tr.sequential_argmin): the exact tie of FAULT_PENCILS["tie"]
    (first index; the fault the last), seeded random pencils with and
    without costs rounded into ties, a NaN at index 0 (kept), NaNs
    elsewhere (never taken)."""
    rng = np.random.default_rng(11)
    if case == "tie":
        costs = _grid_costs([[10.0, 0.0, 0.0, 1.0, 0.0, 1.0]])
    else:
        costs = _grid_costs(np.c_[rng.normal(size=(256, 4)), rng.uniform(-2, 2, (256, 2))])
        costs[128:] = np.round(costs[128:], 1)          # many exact ties
    if case == "nan_at_0":
        costs[:, 0] = np.nan
    if case == "nan_elsewhere":
        costs[rng.random(costs.shape) < 0.2] = np.nan
        costs[:, 0] = np.where(np.isnan(costs[:, 0]), 1e9, costs[:, 0])
    got, want = tr.warp_argmin(costs), tr.sequential_argmin(costs)
    np.testing.assert_array_equal(got, want)
    if case == "nan_at_0":
        assert (got == 0).all()
    else:
        assert not np.isnan(costs[np.arange(len(got)), got]).any()
    last = tr.warp_argmin(costs, last_on_ties=True)
    if case == "tie":
        assert last[0] > got[0] and costs[0, last[0]] == costs[0, got[0]]
    if case == "random":
        assert (last != got).any()
        row_min = np.nanmin(costs, 1)
        np.testing.assert_array_equal(costs[np.arange(len(got)), last], row_min)


@pytest.mark.parametrize("fault", sorted(cs.TRI_FAULTS))
def test_tri_fault_targets_occur_once_in_shipped_sources(fault, tmp_path):
    """Each of the smoke's planted faults (cs.TRI_FAULTS) names a line its
    shipped source holds exactly once, and the copy write_tri_faults makes
    differs from it by that substitution alone."""
    src, old, new = cs.TRI_FAULTS[fault]
    text = src.read_text()
    assert text.count(old) == 1 and new not in text
    copy = cs.write_tri_faults(tmp_path)[fault]
    assert copy.read_text() == text.replace(old, new)
    assert src.read_text() == text


@pytest.mark.parametrize("source", [hm.SOURCE, tr.SOURCE], ids=lambda p: p.name)
def test_stage_marks_are_found_by_ba_stages(source, tmp_path):
    """Every `// stage:` mark of the pair-test and triangulation sources is
    one that tools/ba_stages.py's MARK finds, each name once, and the copy
    that instrument writes (as --pairs does) has a stamp for each; a source
    that has marks gets no UNMARKED_PAIR_MARKS."""
    text = source.read_text()
    written = [ln.strip()[len("// stage: "):] for ln in text.splitlines()
               if ln.strip().startswith("// stage:")]
    found = [m.group(2) for m in ba_stages.MARK.finditer(text)]
    assert found == written and len(set(found)) == len(found) > 0, (written, found)
    assert ba_stages.add_unmarked_pair_marks(source.name, text) == text

    class Tree:
        csrc = kb.CSRC

    copy, stages = ba_stages.instrument(Tree(), tmp_path / "pair_stages",
                                        prefix=("hamming_", "triangulate"),
                                        edit=ba_stages.add_unmarked_pair_marks)
    stamped = (copy / source.name).read_text()
    assert set(found) <= set(stages)
    assert all(f"ba_stage({stages.index(n)});" in stamped for n in found)
    assert not any(ln.strip().startswith("// stage:") for ln in stamped.splitlines())
