"""Parity of the PyTorch port's indirect front end (FAST, ORB, the matcher and
its Hamming resolution, PnP) with the JAX package, on the CPU.

Inputs are rendered from the synthetic scene or drawn from a seed with
numpy; both packages start from the same arrays (`convert.py`). Integer
outputs (corner pixels, levels, descriptor bits, match index / distance /
validity) must agree exactly. Float outputs computed by the same f32
formulas agree to a few ulps; the iterative PnP solve gets a bound stated at
its test.

The hand-written CUDA kernel cannot run here; its plain version is held to
the Pallas kernel in interpret mode (as tests/test_matching.py runs it), its
rule for splitting the work into units and merging their partials is
modelled here and held to both, and the kernel itself is held to its plain
version on the card (tests/test_torch_card_hamming.py, which holds the
numpy case generators, skipped without CUDA, and chip_smoke.py).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import libcml_tpu.models.indirect.fast as jfast
import libcml_tpu.models.indirect.matching as jmatch
import libcml_tpu.models.indirect.orb as jorb
import libcml_tpu.models.indirect.pnp as jpnp
from libcml_tpu.core.camera import PinholeCamera as JCam
from libcml_tpu.core.lie import SE3 as JSE3, se3_exp as jse3_exp
from libcml_tpu.data.synthetic import SyntheticScene, forward_trajectory
from libcml_tpu.ops.image import build_pyramid as jbuild_pyramid
from libcml_tpu.ops.pallas_match import hamming_resolve_pallas

import libcml_tpu_torch.models.indirect.fast as tfast
import libcml_tpu_torch.models.indirect.matching as tmatch
import libcml_tpu_torch.models.indirect.orb as torb
import libcml_tpu_torch.models.indirect.pnp as tpnp
from libcml_tpu_torch import convert
from libcml_tpu_torch.core.camera import PinholeCamera as TCam
from libcml_tpu_torch.core.lie import SE3 as TSE3
from libcml_tpu_torch.ops import hamming_match as hm
from libcml_tpu_torch.ops.image import build_pyramid as tbuild_pyramid
from test_torch_card_hamming import NEW_CASES, RATIO_CASES, RESOLVE_CASES, ratio_case, resolve_case

# The suite runs in several worker processes that share a few cores: one
# torch thread each, since with torch's default thread pool per process the
# workers' spinning threads slow each other down many times over.
torch.set_num_threads(1)

CAM_ARGS = (110.0, 110.0, 79.5, 59.5, 160, 120)
BUDGET, LEVELS = 128, 3


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _t(x):
    return convert.tensor(np.asarray(x))


def _jse3(R, t):
    return JSE3(R=jnp.asarray(R, jnp.float32), t=jnp.asarray(t, jnp.float32))


def _tse3(R, t):
    return TSE3(R=_t(np.asarray(R, np.float32)), t=_t(np.asarray(t, np.float32)))


@pytest.fixture(scope="module")
def frames():
    """Two rendered 160x120 frames, their ground-truth poses and depths, and
    the JAX package's ORB features of each (3 levels, 128 per level)."""
    cam = JCam.make(*CAM_ARGS)
    scene = SyntheticScene.default(cam, seed=3)
    poses = forward_trajectory(3, step=0.08, yaw_rate=0.003)
    imgs, ideps = zip(*(scene.render(R, t) for R, t in poses[::2]))
    feats = [jax.device_get(jorb.extract_orb(jbuild_pyramid(jnp.asarray(im), LEVELS),
                                             budget_per_level=BUDGET)) for im in imgs]
    return dict(imgs=imgs, ideps=ideps, poses=poses[::2], feats=feats)


# -- FAST / ORB -----------------------------------------------------------------------


def test_brief_pattern_bit_for_bit():
    a, b = torb.brief_pattern(), jorb.brief_pattern()
    assert a.dtype == b.dtype == np.float32 and a.shape == (256, 2, 2)
    np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))


def test_popcount_and_hamming_matrix_exact():
    rng = np.random.default_rng(1)
    da = rng.integers(0, 2**32, (33, 8), dtype=np.uint32)
    db = rng.integers(0, 2**32, (47, 8), dtype=np.uint32)
    da[0] = 0xFFFFFFFF
    db[0] = 0
    np.testing.assert_array_equal(_np(torb.popcount32(_t(da))),
                                  _np(jorb.popcount32(jnp.asarray(da))))
    np.testing.assert_array_equal(_np(torb.hamming_matrix(_t(da), _t(db))),
                                  _np(jorb.hamming_matrix(jnp.asarray(da), jnp.asarray(db))))


@pytest.mark.parametrize("threshold", [8.0, 12.0, 20.0])
def test_fast_matches_reference(frames, threshold):
    img = frames["imgs"][0]
    sj = _np(jfast.fast_score_map(jnp.asarray(img), threshold))
    st = _np(tfast.fast_score_map(_t(img), threshold))
    # same f32 sums over the same lanes; corner support must be identical
    np.testing.assert_array_equal(st > 0, sj > 0)
    np.testing.assert_allclose(st, sj, rtol=1e-6, atol=1e-3)
    np.testing.assert_array_equal(_np(tfast._maxpool3(_t(sj))),
                                  _np(jfast._maxpool3(jnp.asarray(sj))))
    uvj, scj, okj = (_np(x) for x in jfast.fast_detect(jnp.asarray(img), threshold, 200))
    uvt, sct, okt = (_np(x) for x in tfast.fast_detect(_t(img), threshold, 200))
    np.testing.assert_array_equal(okt, okj)
    np.testing.assert_array_equal(uvt, uvj)      # tie order: lowest index first
    np.testing.assert_allclose(sct, scj, rtol=1e-6, atol=1e-3)


def test_topk_ties_go_to_lowest_index():
    """lax.top_k's tie order, which torch.topk does not keep."""
    x = np.zeros(20, np.float32)
    x[[3, 7]] = 1.0
    vj, ij = jax.lax.top_k(jnp.asarray(x), 5)
    vt, it = torb.topk_stable(_t(x), 5)
    np.testing.assert_array_equal(_np(it), _np(ij))
    np.testing.assert_array_equal(_np(vt), _np(vj))


@pytest.mark.parametrize("frame", [0, 1])
def test_extract_orb_matches_reference(frames, frame):
    img = frames["imgs"][frame]
    want = frames["feats"][frame]
    got = torb.extract_orb(tbuild_pyramid(_t(img), LEVELS), budget_per_level=BUDGET)
    got = convert.to_np(got)
    assert got["desc"].dtype == np.int32
    np.testing.assert_array_equal(got["uv"], want.uv)
    np.testing.assert_array_equal(got["level"], want.level)
    np.testing.assert_array_equal(got["valid"], want.valid)
    np.testing.assert_allclose(got["score"], want.score, rtol=1e-6, atol=1e-3)
    np.testing.assert_allclose(got["angle"], want.angle, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got["desc"].view(np.uint32), want.desc)


# -- Hamming resolution: plain version vs the Pallas kernel -------------------------------


@functools.lru_cache(maxsize=None)
def _pallas(name):
    """The Pallas kernel in interpret mode on one case (numpy outputs)."""
    dq, mq, dt, mt, pm = resolve_case(name)
    out = hamming_resolve_pallas(jnp.asarray(dq), jnp.asarray(mq), jnp.asarray(dt),
                                 jnp.asarray(mt), None if pm is None else jnp.asarray(pm),
                                 tile_m=64, interpret=True)
    return tuple(np.asarray(x) for x in out)


@pytest.mark.parametrize("name", RESOLVE_CASES)
def test_hamming_resolve_plain_equals_pallas(name):
    """Exact equality of all four outputs, masked rows and columns included
    (a masked entry counts 257; ties go to the first occurrence)."""
    dq, mq, dt, mt, pm = resolve_case(name)
    want = _pallas(name)
    got = hm.hamming_resolve_plain(_t(dq), _t(mq), _t(dt), _t(mt),
                                   None if pm is None else _t(pm))
    for g, w, what in zip(got, want, ("d1", "d2", "idx", "col_row")):
        assert g.dtype == torch.int32, what
        np.testing.assert_array_equal(_np(g), _np(w), err_msg=what)


def test_hamming_resolve_dispatch_has_no_fallback():
    """CPU tensors take the plain version; the kernel's wrapper refuses
    anything but CUDA tensors and counts only its own launches."""
    dq, mq, dt, mt, pm = (_t(x) for x in resolve_case("odd_sizes"))
    before = hm.hamming_resolve_cuda.launches
    got = hm.hamming_resolve(dq, mq, dt, mt, pm)
    for g, w in zip(got, hm.hamming_resolve_plain(dq, mq, dt, mt, pm)):
        assert torch.equal(g, w)
    with pytest.raises(ValueError, match="CUDA"):
        hm.hamming_resolve_cuda(dq, mq, dt, mt, pm)
    meta = [x.to("meta") for x in (dq, mq, dt, mt)]
    with pytest.raises(ValueError, match="unsupported device"):
        hm.hamming_resolve(*meta)
    assert hm.hamming_resolve_cuda.launches == before


def _merge_rows(a, b):
    """The kernel's row merge: lexicographic on (d1, column), and
    d2 = min(winner.d2, loser.d1)."""
    a_wins = (a[0] < b[0]) | ((a[0] == b[0]) & (a[1] < b[1]))
    d1, i1, d2 = (torch.where(a_wins, x, y) for x, y in zip(a, b))
    return d1, i1, torch.minimum(d2, torch.where(a_wins, b[0], a[0]))


def _split_merge(dq, mq, dt, mt, pm, groups, chunks, cw):
    """The kernel's split-and-merge rule on the CPU: resolve_matrix on each
    (row group, column chunk) unit, row group g holding rows g, g + groups,
    ..., chunk k columns [k cw, (k + 1) cw); row partials merged by
    _merge_rows from an empty partial, column minima as (d, row) keys from
    (257, row 0)."""
    N, M = dq.shape[0], dt.shape[0]
    D = torb.hamming_matrix(dq, dt).to(torch.int32)
    rows_best = (torch.full((N,), 258, dtype=torch.int32),
                 torch.full((N,), 2**31 - 1, dtype=torch.int32),
                 torch.full((N,), 258, dtype=torch.int32))
    col_key = torch.full((M,), hm.COL_INIT, dtype=torch.int64)
    for g in range(groups):
        rows = torch.arange(g, N, groups)
        for k in range(chunks):
            cols = torch.arange(k * cw, min(k * cw + cw, M))
            sub = D[rows][:, cols]
            sub_pm = None if pm is None else pm[rows][:, cols]
            d1, d2, idx, col_row = hm.resolve_matrix(sub, mq[rows], mt[cols], sub_pm)
            part = (d1, (cols[idx.long()]).to(torch.int32), d2)
            merged = _merge_rows(tuple(x[rows] for x in rows_best), part)
            for x, m in zip(rows_best, merged):
                x[rows] = m
            mask = mq[rows][:, None] & mt[cols][None, :]
            if sub_pm is not None:
                mask &= sub_pm
            dcol = torch.where(mask, sub, hm.MASKED).gather(0, col_row[None].long())[0]
            key = dcol.long() * 2**32 + rows[col_row.long()]
            col_key[cols] = torch.minimum(col_key[cols], key)
    d1, i1, d2 = rows_best
    return (torch.clamp(d1, max=hm.MASKED), torch.clamp(d2, max=hm.MASKED),
            torch.where(d1 < hm.MASKED, i1, 0), (col_key % 2**32).to(torch.int32))


def _units(split, N, M, has_pair):
    """(groups, chunks, cw) of one way to split an (N, M) resolution."""
    if split.startswith("plan"):
        return hm.plan(N, M, has_pair, int(split.split("_")[1]))
    if split == "per_row":
        return N, 1, M
    return 1, M, 1                                     # per_column


@pytest.mark.parametrize("split", ["plan_1_sm", "plan_7_sms", "plan_132_sms", "per_row",
                                   "per_column"])
@pytest.mark.parametrize("name", RESOLVE_CASES + NEW_CASES)
def test_split_merge_equals_plain_and_pallas(name, split):
    """The kernel's rule (rows in strided groups, columns in chunks, partials
    merged) gives exactly the unsplit plain version and the Pallas kernel."""
    dq, mq, dt, mt, pm = (None if x is None else _t(x) for x in resolve_case(name))
    groups, chunks, cw = _units(split, dq.shape[0], dt.shape[0], pm is not None)
    got = _split_merge(dq, mq, dt, mt, pm, groups, chunks, cw)
    plain = hm.hamming_resolve_plain(dq, mq, dt, mt, pm)
    for g, p, w, what in zip(got, plain, _pallas(name), ("d1", "d2", "idx", "col_row")):
        assert g.dtype == torch.int32, what
        np.testing.assert_array_equal(_np(g), _np(p), err_msg=what)
        np.testing.assert_array_equal(_np(g), w, err_msg=what)


@pytest.mark.parametrize("has_pair", [True, False])
def test_plan_fits_the_kernel(has_pair):
    """Every plan meets the launcher's checks (csrc/hamming_match.cu): each
    row group within its rows, each chunk within the shared-memory width,
    no empty chunk; and the main path's shapes give every SM a unit."""
    rows, max_cw = ((hm.SPARSE_ROWS, hm.SPARSE_CW) if has_pair
                    else (hm.DENSE_ROWS, hm.DENSE_CW))
    for N in (1, 2, 17, 40, 67, 1536, 4096, 10_000):
        for M in (1, 16, 17, 301, 1536, 5000):
            for sms in (1, 7, 132):
                groups, chunks, cw = hm.plan(N, M, has_pair, sms)
                assert groups * rows >= N > (groups - 1) * rows
                assert 0 < cw <= max_cw and chunks * cw >= M > (chunks - 1) * cw
    for N, M in ((4096, 1536), (1536, 1536)):
        groups, chunks, _ = hm.plan(N, M, has_pair, 132)
        assert groups * chunks >= 132


# -- orb.match_ratio ------------------------------------------------------------------


def _ratio_case(name):
    """ratio_case, with the "shift" case's features extracted by the JAX
    package."""
    rng = np.random.default_rng(7)
    if name == "shift":
        # tests/test_indirect.py:85: ORB of a smoothed random image and of
        # the same image shifted by 5 px, extracted by the JAX package
        from scipy.ndimage import convolve

        base = convolve(rng.uniform(0, 255, (120, 160)).astype(np.float32), np.ones((3, 3)) / 9.0)
        feats = [jax.device_get(jorb.extract_orb(jbuild_pyramid(jnp.asarray(im), 2),
                                                 budget_per_level=128, threshold=8.0))
                 for im in (base, np.roll(base, (0, 5), axis=(0, 1)))]
        return feats[0].desc, feats[1].desc, feats[0].valid, feats[1].valid, {}
    return ratio_case(name)


@pytest.mark.parametrize("name", RATIO_CASES)
def test_match_ratio_matches_reference(name):
    """orb.match_ratio against the JAX package's: idx_b and good exactly,
    masked rows and columns, one live column, no live row or column, ties
    and mutual=False included."""
    da, db, va, vb, kw = _ratio_case(name)
    want = jorb.match_ratio(jnp.asarray(da), jnp.asarray(db), jnp.asarray(va),
                            jnp.asarray(vb), **kw)
    got = torb.match_ratio(_t(da), _t(db), _t(va), _t(vb), **kw)
    assert got[0].dtype == torch.int32 and got[1].dtype == torch.bool
    np.testing.assert_array_equal(_np(got[0]), _np(want[0]), err_msg="idx_b")
    np.testing.assert_array_equal(_np(got[1]), _np(want[1]), err_msg="good")
    if name == "shift":
        assert int(_np(want[1]).sum()) >= 10
    if name == "one_live_column":
        # the rows at 193-200 bits pass only because a 257 reads as "no second"
        np.testing.assert_array_equal(_np(got[1])[:8], [1, 1, 1, 1, 1, 1, 0, 0])


def test_match_ratio_has_no_fallback():
    """match_ratio resolves through hamming_resolve: the plain version for
    CPU tensors, the kernel for CUDA tensors, and nothing for any other
    device."""
    da, db, va, vb, _ = _ratio_case("masked")
    args = [_t(x).to("meta") for x in (da, db, va, vb)]
    with pytest.raises(ValueError, match="unsupported device"):
        torb.match_ratio(*args)


# -- matchers -------------------------------------------------------------------------


def _feat_pair(frames):
    fj = frames["feats"]
    ft = [convert.from_np(torb.OrbFeatures, convert.to_np(f)) for f in fj]
    return fj, ft


def _match_pair(frames, name):
    """(jax call, torch call) for one matcher on the two frames' features."""
    (j0, j1), (t0, t1) = _feat_pair(frames)
    if name == "descriptors":
        return (lambda: jmatch.match_descriptors(j0.desc, j0.valid, j1.desc, j1.valid),
                lambda: tmatch.match_descriptors(t0.desc, t0.valid, t1.desc, t1.valid))
    if name == "window":
        return (lambda: jmatch.match_window(j0.desc, j0.uv, j0.valid, j1.desc, j1.uv, j1.valid,
                                            radius=20.0),
                lambda: tmatch.match_window(t0.desc, t0.uv, t0.valid, t1.desc, t1.uv, t1.valid,
                                            radius=20.0))
    if name == "epipolar":
        F = np.array([[0, -1e-3, 0.06], [1e-3, 0, -0.08], [-0.06, 0.08, 0.0]], np.float32)
        return (lambda: jmatch.match_epipolar(j0.desc, j0.uv, j0.valid, j1.desc, j1.uv,
                                              j1.valid, jnp.asarray(F), epi_tol=30.0),
                lambda: tmatch.match_epipolar(t0.desc, t0.uv, t0.valid, t1.desc, t1.uv,
                                              t1.valid, _t(F), epi_tol=30.0))
    # projection: frame 0's corners lifted with the renderer's depth, seen
    # from frame 1's ground-truth pose
    rho = frames["ideps"][0]
    uv = np.asarray(j0.uv)
    ui = np.clip(np.round(uv).astype(int), 0, [CAM_ARGS[4] - 1, CAM_ARGS[5] - 1])
    r = np.maximum(rho[ui[:, 1], ui[:, 0]], 1e-6)
    cam = JCam.make(*CAM_ARGS)
    (R0, tr0), (R1, tr1) = frames["poses"]
    Xc = np.asarray(cam.unproject(jnp.asarray(uv), jnp.asarray(r)))
    Xw = ((Xc - tr0) @ R0).astype(np.float32)
    valid = np.asarray(j0.valid) & (rho[ui[:, 1], ui[:, 0]] > 0)
    tc = TCam.make(*CAM_ARGS)
    return (lambda: jmatch.match_projection(jnp.asarray(Xw), j0.desc, jnp.asarray(valid),
                                            j0.level, _jse3(R1, tr1), cam, j1.desc, j1.uv,
                                            j1.level, j1.valid),
            lambda: tmatch.match_projection(_t(Xw), t0.desc, _t(valid), t0.level,
                                            _tse3(R1, tr1), tc, t1.desc, t1.uv, t1.level,
                                            t1.valid))


@pytest.mark.parametrize("name", ["descriptors", "window", "projection", "epipolar"])
def test_matchers_match_reference(frames, name):
    fj, ft = _match_pair(frames, name)
    want, got = fj(), ft()
    if name == "projection":
        (want, uvj), (got, uvt) = want, got
        np.testing.assert_allclose(_np(uvt), _np(uvj), rtol=1e-6, atol=1e-3)
    assert int(got.num) == int(want.num) and int(want.num) > 5
    np.testing.assert_array_equal(_np(got.valid), _np(want.valid))
    np.testing.assert_array_equal(_np(got.idx), _np(want.idx))
    np.testing.assert_array_equal(_np(got.dist), _np(want.dist))


def test_matrix_resolve_and_orientation_check_match_reference(frames):
    (j0, j1), (t0, t1) = _feat_pair(frames)
    D = jorb.hamming_matrix(j0.desc, j1.desc)
    want = jmatch._resolve(D, j0.valid, j1.valid, None, 80, 0.9)
    got = tmatch._resolve(_t(D), t0.valid, t1.valid, None, 80, 0.9)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_np(g), _np(w))
    idx, valid = want[0], want[2]
    np.testing.assert_array_equal(
        _np(tmatch.orientation_check(t0.angle, t1.angle, _t(idx), _t(valid))),
        _np(jmatch.orientation_check(j0.angle, j1.angle, idx, valid)))


# -- PnP ------------------------------------------------------------------------------


def _pnp_problem(seed, n=300, outliers=0.2):
    rng = np.random.default_rng(seed)
    cam = JCam.make(*CAM_ARGS)
    Xw = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n), rng.uniform(3, 8, n)], -1)
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
    xi0 = np.array([0.03, -0.01, 0.05, 0.0, 0.0, 0.0], np.float32)
    return (Xw.astype(np.float32), uv.astype(np.float32), valid, sigma2.astype(np.float32),
            jse3_exp(jnp.asarray(xi)), xi0, cam, R, t)


@pytest.mark.parametrize("seed", [0, 1])
def test_solve_pnp_matches_reference(seed):
    """Same LM schedule and chi2 reclassification: identical inlier sets and
    the same pose to 1e-5 (40 f32 LM steps on a well-conditioned problem);
    covariance to 1e-3 relative."""
    Xw, uv, valid, s2, _, xi0, cam, R, t = _pnp_problem(seed)
    T0j = jse3_exp(jnp.asarray(xi0))
    want = jpnp.solve_pnp(jnp.asarray(Xw), jnp.asarray(uv), jnp.asarray(valid), T0j, cam,
                          sigma2=jnp.asarray(s2))
    T0t = _tse3(T0j.R, T0j.t)
    got = tpnp.solve_pnp(_t(Xw), _t(uv), _t(valid), T0t, TCam.make(*CAM_ARGS), sigma2=_t(s2))
    np.testing.assert_array_equal(_np(got.inlier), _np(want.inlier))
    assert int(got.num_inliers) == int(want.num_inliers) > 150
    np.testing.assert_allclose(_np(got.T.R), _np(want.T.R), atol=1e-5)
    np.testing.assert_allclose(_np(got.T.t), _np(want.T.t), atol=1e-5)
    np.testing.assert_allclose(_np(got.cov), _np(want.cov), rtol=1e-3, atol=1e-9)
    np.testing.assert_allclose(float(got.chi2), float(want.chi2), rtol=1e-3)
    assert np.abs(_np(got.T.t) - t).max() < 0.02


def test_solve_pnp_all_invalid_is_finite():
    Xw, uv, _, _, _, xi0, cam, _, _ = _pnp_problem(2)
    T0 = jse3_exp(jnp.asarray(xi0))
    got = tpnp.solve_pnp(_t(Xw), _t(uv), torch.zeros(len(Xw), dtype=torch.bool),
                         _tse3(T0.R, T0.t), TCam.make(*CAM_ARGS))
    assert int(got.num_inliers) == 0
    assert np.isfinite(_np(got.T.t)).all() and np.isfinite(_np(got.T.R)).all()


def test_triangulate_linear_matches_reference():
    """A wide (1 m) baseline keeps the 3x3 normal equations well conditioned,
    so the two frameworks' f32 LU solves agree to 1e-4 relative."""
    Xw, _, _, _, _, _, cam, _, _ = _pnp_problem(3, outliers=0.0)
    T = jse3_exp(jnp.asarray([1.0, 0.2, 0.1, 0.01, -0.05, 0.02], jnp.float32))
    R, t = np.asarray(T.R, np.float64), np.asarray(T.t, np.float64)
    proj = lambda X: np.stack([110 * X[:, 0] / X[:, 2] + 79.5,   # noqa: E731
                               110 * X[:, 1] / X[:, 2] + 59.5], -1).astype(np.float32)
    uv0, uv1 = proj(Xw), proj(Xw @ R.T + t)
    uv1[:5] = uv0[:5]                                  # a few degenerate pairs
    Xj, vj = jpnp.triangulate_linear(jnp.asarray(uv0), jnp.asarray(uv1), T, cam)
    Xt, vt = tpnp.triangulate_linear(_t(uv0), _t(uv1), _tse3(T.R, T.t), TCam.make(*CAM_ARGS))
    np.testing.assert_array_equal(_np(vt), _np(vj))
    np.testing.assert_allclose(_np(Xt)[5:], _np(Xj)[5:], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_np(Xt)[5:], Xw[5:], rtol=1e-2, atol=1e-2)


def test_convert_round_trips(frames):
    """convert.py carries the reference's camera, ORB features and match
    result into the port bit for bit, and back to numpy."""
    cj = JCam.make(*CAM_ARGS).level(1)
    ct = convert.from_np(TCam, convert.to_np(jax.device_get(cj)))
    assert ct == TCam.make(*CAM_ARGS).level(1)
    fj = frames["feats"][0]
    ft = convert.from_np(torb.OrbFeatures, convert.to_np(fj))
    assert ft.desc.dtype == torch.int32 and ft.level.dtype == torch.int32
    back = convert.to_np(ft)
    np.testing.assert_array_equal(back["desc"].view(np.uint32), fj.desc)
    np.testing.assert_array_equal(back["uv"], fj.uv)
    mj = jax.device_get(jmatch.match_descriptors(fj.desc, fj.valid, fj.desc, fj.valid))
    mt = convert.from_np(tmatch.MatchResult, convert.to_np(mj))
    for f in ("idx", "dist", "valid", "num"):
        np.testing.assert_array_equal(convert.to_np(mt)[f], np.asarray(getattr(mj, f)))
