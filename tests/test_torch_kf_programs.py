"""The direct path's keyframe programs (`_activate_and_clear`,
`_refresh_after_kf`) of the PyTorch port against the JAX package's jitted
programs, and the numpy models of their Hopper kernels' schedules
(ops/kf_programs.py) against the plain forms, on the CPU at 160x120.

Both packages start from the same numpy state (a window after three
keyframes with matured immature candidates, tests/test_torch_card_kf.py's
kf_case, carried across by `convert.py`). Tolerances, with their reasons:
  - every integer and boolean output (the point slots written, their
    hosts and residual flags, the arena's validity, the selected pixels)
    exactly; the activated inverse depths (a product, a square root and a
    clamp, each correctly rounded in both) exactly;
  - bilinear samples (colours, weights) to rtol 1e-5 / atol 1e-4: XLA may
    fuse the interpolation's products and sums;
  - the tracker reference's pixels to 1e-4 px and its validity exactly
    except at points whose deciding value sits within
    kf_programs.EDGE_REL of its threshold (the two frameworks round the
    point transforms' sums in their own order);
  - the working range's median to 1e-6 relative (jnp.nanmedian and
    torch.nanquantile interpolate the two middle values with other
    roundings).
The schedule models (the activation's free-slot scans, the z-buffer's two
passes, the regional quantile's and the range median's radix selection, the
stable top k by rank, the cells' first maxima by lanes) are held to the
plain forms and to a sort exactly; the smoke's planted faults are checked
against the kernel sources they edit.
"""

import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import libcml_tpu.models.direct.selector as jsel
import libcml_tpu.runtime.odometry as jodo
from libcml_tpu.core.camera import PinholeCamera as JCam
from libcml_tpu.core.lie import SE3 as JSE3
from libcml_tpu.models.direct.ba import BAState as JBAState
from libcml_tpu.models.direct.config import DirectConfig as JCfg
from libcml_tpu.models.direct.tracer import ImmatureArena as JArena
from libcml_tpu.models.direct.window import Window as JWindow

from libcml_tpu_torch import convert
from libcml_tpu_torch.models.direct import ba as tba
from libcml_tpu_torch.models.direct import selector as tsel
from libcml_tpu_torch.models.direct import tracer as ttr
from libcml_tpu_torch.models.direct import window as twin
from libcml_tpu_torch.ops import kf_programs as kfp
from libcml_tpu_torch.runtime import odometry as todo
from test_torch_card_kf import CASES, SIZES, kf_case

torch.set_num_threads(1)

_NESTED = {(JWindow, "ba"): JBAState, (JBAState, "T"): JSE3, (JBAState, "T_fej"): JSE3}


def _jax(cls, d: dict):
    """A JAX package dataclass from convert.to_np's dict."""
    kw = {}
    for f in dataclasses.fields(cls):
        sub = _NESTED.get((cls, f.name))
        kw[f.name] = _jax(sub, d[f.name]) if sub is not None else jnp.asarray(d[f.name])
    return cls(**kw)


def _np(x):
    return np.asarray(jax.device_get(x)) if not isinstance(x, torch.Tensor) else x.numpy()


def _jcfg(cfg):
    return JCfg(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)})


def _jcam(cam):
    return JCam.make(cam.fx, cam.fy, cam.cx, cam.cy, cam.width, cam.height)


@pytest.fixture(scope="module")
def cases():
    return {name: kf_case(name) for name in CASES}


def _both(c):
    wj = _jax(JWindow, convert.to_np(c.window))
    aj = _jax(JArena, convert.to_np(c.immature))
    pj = tuple(jnp.asarray(x.numpy()) for x in c.kf_pyr)
    return wj, aj, pj


_WINDOW_EXACT = ("uv", "host", "idepth", "idepth_fej", "point_valid", "res_active")


@pytest.mark.parametrize("name", CASES)
def test_activate_and_clear_matches_reference(cases, name):
    c = cases[name]
    wj, aj, _ = _both(c)
    wj2, aj2 = jodo._activate_and_clear(wj, aj, _jcfg(c.cfg))
    wt2, at2 = todo._activate_and_clear(c.window, c.immature, c.cfg)
    a, b = convert.to_np(wt2.ba), jax.device_get(wj2.ba)
    for f in _WINDOW_EXACT:
        np.testing.assert_array_equal(a[f], np.asarray(getattr(b, f)), err_msg=f)
    for f in ("color", "weight"):
        np.testing.assert_allclose(a[f], np.asarray(getattr(b, f)), rtol=1e-5, atol=1e-4,
                                   err_msg=f)
    np.testing.assert_array_equal(at2.valid.numpy(), _np(aj2.valid))
    # the kernel's scans: the same slots, each hosted in its row's slot
    ready, _ = ttr.mature_mask(c.immature, c.cfg)
    dest, pv = kfp.model_activate(c.window.ba.point_valid.numpy(), ready.numpy())
    np.testing.assert_array_equal(pv, a["point_valid"])
    for r in range(dest.shape[0]):
        s = dest[r][dest[r] >= 0]
        assert (a["host"][s] == r).all()
    if name in ("window", "overflow"):
        assert (dest >= 0).any()


def test_overflow_case_has_fewer_free_slots_than_ready(cases):
    """The planted arena: ready and waiting candidates interleave, and fewer
    point slots are free than candidates are ready, so the positional rule
    (a waiting candidate uses up its position; positions past the free
    slots are dropped) decides what lands."""
    c = cases["overflow"]
    ready, _ = ttr.mature_mask(c.immature, c.cfg)
    free = int((~c.window.ba.point_valid).sum())
    assert free < int(ready.sum())
    r0 = ready[0].numpy()
    assert r0[:6].tolist() == [True, False, True, True, False, True]
    dest, pv = kfp.model_activate(c.window.ba.point_valid.numpy(), ready.numpy())
    assert (dest[0][~r0] == -1).all()      # a waiting candidate writes nothing
    # the positional rule is not a compaction: with more ready candidates
    # than free slots a compaction would fill them all, but the waiting
    # candidates' positions stay free and ready ones are dropped
    assert not pv.all() and ((dest == -1) & ready.numpy()).any()
    first = kfp.model_free_slot_scan(c.window.ba.point_valid.numpy(), c.cfg.points_per_kf)
    np.testing.assert_array_equal(dest[0][: first.shape[0]][r0[: first.shape[0]]],
                                  first[r0[: first.shape[0]]])


@pytest.mark.parametrize("name", CASES)
def test_refresh_after_kf_matches_reference(cases, name):
    c = cases[name]
    wj, aj, pj = _both(c)
    rj, aj2 = jodo._refresh_after_kf(wj, jnp.asarray(c.slot), pj, aj, _jcam(c.cam),
                                     _jcfg(c.cfg))
    rt, at2 = todo._refresh_after_kf(c.window, c.slot, c.kf_pyr, c.immature, c.cam, c.cfg)
    a, b = convert.to_np(at2), {f.name: _np(getattr(aj2, f.name)) for f in
                                dataclasses.fields(JArena)}
    for f in ("uv", "n_ok", "n_fail", "valid"):
        np.testing.assert_array_equal(a[f], b[f], err_msg=f)
    np.testing.assert_allclose(a["color"], b["color"], rtol=1e-5, atol=1e-4)
    for f in ("rho_lo", "rho_hi"):
        np.testing.assert_allclose(a[f], b[f], rtol=1e-6, err_msg=f)
    flips = rt.valid.numpy() != _np(rj.valid)
    if flips.any():
        marg = kfp.ref_margins(c.window.ba, c.slot, c.cam, rt.valid.shape[0]).numpy()
        assert (marg[flips.any(0)] < kfp.EDGE_REL).all()
    ok = rt.valid.numpy() & _np(rj.valid)
    for f, atol in (("uv", 1e-4), ("color", 1e-3), ("weight", 1e-5)):
        np.testing.assert_allclose(getattr(rt, f).numpy()[ok], _np(getattr(rj, f))[ok],
                                   rtol=1e-5, atol=atol, err_msg=f)
    np.testing.assert_allclose(rt.idepth.numpy(), _np(rj.idepth), rtol=1e-5)
    if name == "all_invalid":
        assert not rt.valid.any()
    if name == "flat":
        assert not at2.valid[c.slot].any()


def test_all_invalid_window_range_is_one(cases):
    """No valid point: the median is NaN, taken as 1.0, so the range is
    [1/8, 8] in both packages and the kernel's model."""
    c = cases["all_invalid"]
    wj, _, _ = _both(c)
    lo_j, hi_j = jodo._working_rho_range(wj.ba, _jcfg(c.cfg))
    lo_t, hi_t = todo._working_rho_range(c.window.ba, c.cfg)
    lo_m, hi_m = kfp.model_rho_range(c.window.ba.idepth.numpy(), c.window.ba.point_valid.numpy(),
                                     c.cfg.idepth_min, c.cfg.idepth_max)
    for lo, hi in ((lo_j, hi_j), (lo_t, hi_t), (lo_m, hi_m)):
        assert float(lo) == 0.125 and float(hi) == 8.0


def _half_flat(c):
    g = c.kf_pyr[0].clone()
    g[c.cam.height // 3:] = torch.tensor([100.0, 0.0, 0.0])
    return g


@pytest.mark.parametrize("image", ["flat", "half_flat"])
def test_flat_keyframe_ties_take_the_lowest_index(cases, image):
    """Cells whose scores tie (all zero on a flat image) fill the top k in
    index order, in both packages and the kernel's rank model; on a
    keyframe flat below its top third the cut falls among the zeros."""
    c = cases["flat"] if image == "flat" else cases["window"]
    g = c.kf_pyr[0] if image == "flat" else _half_flat(c)
    n = c.cfg.points_per_kf
    want = jsel.select_points(jnp.asarray(g.numpy()), n)
    got = tsel.select_points(g, n)
    for x, y in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(x.numpy(), _np(y))
    geo = kfp.select_geometry(g.shape[0], g.shape[1], n)
    cells = _cell_scores(g, n)
    best, arg = kfp.model_cell_argmax(cells)
    top = kfp.model_rank_topk(best, geo["k"])
    cy, cx = top // geo["Wc"], top % geo["Wc"]
    oy, ox = arg[top] // geo["pot"], arg[top] % geo["pot"]
    np.testing.assert_array_equal(
        np.stack([cx * geo["pot"] + ox, cy * geo["pot"] + oy], -1).astype(np.float32),
        got[0].numpy()[: geo["k"]])
    zero = best[top] == 0
    assert zero.any()
    assert (np.diff(top[zero]) > 0).all()        # the tied cells in index order
    if image == "flat":
        np.testing.assert_array_equal(top, np.arange(geo["k"]))
    # the smoke's planted fault (ties to the highest index) shows here
    assert (kfp.model_rank_topk(best, geo["k"], ties_to_highest=True) != top).any()


def _cell_scores(g: torch.Tensor, n: int) -> np.ndarray:
    """select_points_plain's masked scores cut into its (cells, pot^2)."""
    H, W = g.shape[:2]
    from libcml_tpu_torch.ops.image import gradient_squared_norm

    g2 = gradient_squared_norm(g)
    th = tsel._regional_threshold(g2, 0.5, 7.0)
    yy, xx = torch.arange(H)[:, None], torch.arange(W)[None, :]
    ok = (g2 > th) & (xx >= 4) & (xx < W - 4) & (yy >= 4) & (yy < H - 4)
    score = torch.where(ok, g2, torch.zeros_like(g2))
    geo = kfp.select_geometry(H, W, n)
    p, Hc, Wc = geo["pot"], geo["Hc"], geo["Wc"]
    return (score[: Hc * p, : Wc * p].reshape(Hc, p, Wc, p).permute(0, 2, 1, 3)
            .reshape(Hc * Wc, p * p).numpy())


# -- the schedule models against the plain forms ---------------------------------------------


@pytest.mark.parametrize("P,threads,p_free", [(256, 256, 0.3), (300, 256, 0.5), (2048, 256, 0.1),
                                              (2048, 256, 0.9), (64, 256, 0.0)])
def test_model_free_slot_scans_match_add_points(P, threads, p_free):
    """model_activate's dependent scans (a thread a run of slots, an
    exclusive sum, positions listed under K) give add_points_plain's slots:
    each candidate's pixel is its id, so the arena says where it landed."""
    rng = np.random.default_rng(P + int(100 * p_free))
    cfg = dataclasses.replace(SIZES["160x120"][2], max_points=P)
    F, K = cfg.max_frames, min(64, P)
    w = twin.empty_window(cfg, 16, 16)
    pv0 = rng.random(P) >= p_free
    w = w.replace(ba=w.ba.replace(point_valid=torch.tensor(pv0)))
    ready = rng.random((F, K)) < 0.6
    for r in range(F):
        ids = torch.arange(r * K, (r + 1) * K, dtype=torch.float32)
        w = twin.add_points_plain(w, r, torch.stack([ids, ids], -1), torch.ones(K),
                                  torch.tensor(ready[r]), cfg)
    dest, pv = kfp.model_activate(pv0, ready, threads=threads)
    np.testing.assert_array_equal(pv, w.ba.point_valid.numpy())
    got = np.full((F, K), -1)
    landed = (w.ba.point_valid.numpy() & ~pv0)
    ids = w.ba.uv[:, 0].numpy().astype(int)
    for s in np.nonzero(landed)[0]:
        got[ids[s] // K, ids[s] % K] = s
    np.testing.assert_array_equal(dest, got)
    if (dest >= 0).sum() > 1:   # the smoke's planted fault (a slot further) shows here
        moved, _ = kfp.model_activate(pv0, ready, shift=1, threads=threads)
        assert (moved != dest).any()


@pytest.mark.parametrize("name", ["window", "crowded", "overflow"])
def test_model_zbuffer_matches_plain(cases, name):
    """The z-buffer's two passes (bits max-ed into a zeroed table, then the
    0.8 test) give _window_points_in_frame's validity."""
    c = cases[name]
    uv, rho, ok = todo._window_points_in_frame(c.window, c.slot, c.cam, c.cfg)
    ok0, cid = _pre_zbuffer(c, uv, rho)
    n_cells = ((c.cam.width + 3) // 4) * ((c.cam.height + 3) // 4)
    got = kfp.model_zbuffer(rho.numpy(), ok0.numpy(), cid.numpy(), n_cells)
    np.testing.assert_array_equal(got, ok.numpy())
    if name == "crowded":
        assert (ok0 & ~ok).any()        # the z-buffer removed points


def _pre_zbuffer(c, uv, rho):
    """_window_points_in_frame's validity before its z-buffer, and each
    point's cell, from its outputs (the same expressions)."""
    ba, cam = c.window.ba, c.cam
    X_h = cam.unproject(ba.uv, ba.idepth)
    R_h, t_h = ba.T.R[ba.host.long()], ba.T.t[ba.host.long()]
    X_w = torch.einsum("pji,pj->pi", R_h, X_h - t_h)
    z = (X_w @ ba.T.R[c.slot].T + ba.T.t[c.slot])[:, 2]
    ok0 = ba.point_valid & (z > 1e-6) & cam.in_bounds(uv, border=3.0) & (z > 1e-4)
    ui = torch.nan_to_num(uv, nan=0.0).to(torch.int32)
    Wc, Hc = (cam.width + 3) // 4, (cam.height + 3) // 4
    cx = torch.clamp(torch.div(ui[:, 0], 4, rounding_mode="floor"), 0, Wc - 1)
    cy = torch.clamp(torch.div(ui[:, 1], 4, rounding_mode="floor"), 0, Hc - 1)
    return ok0, (cy * Wc + cx).long()


def _regions(seed: int) -> list[np.ndarray]:
    rng = np.random.default_rng(seed)
    flat = np.zeros(1024, np.float32)
    ties = rng.integers(0, 5, 1024).astype(np.float32)
    smooth = rng.random(1024).astype(np.float32) * 100
    nan = smooth.copy()
    nan[17] = np.nan
    inf = smooth.copy()
    inf[3] = np.inf
    return [flat, ties, smooth, nan, inf]


@pytest.mark.parametrize("quantile", [0.5, 0.3])
def test_model_region_quantile_matches_torch(quantile):
    for v in _regions(1):
        want = torch.quantile(torch.tensor(v), quantile).numpy()
        got = kfp.model_region_quantile(v, quantile)
        np.testing.assert_array_equal(np.float32(got), want)


def test_model_region_thresholds_match_selector():
    """Each region's quantile of a rendered keyframe's gradient magnitudes,
    as the kernel's sort takes it, is _regional_threshold's."""
    c = kf_case("window")
    from libcml_tpu_torch.ops.image import gradient_squared_norm

    g = torch.sqrt(gradient_squared_norm(c.kf_pyr[0]))
    H, W = g.shape
    Hr, Wr = H // 32, W // 32
    blocks = g[: Hr * 32, : Wr * 32].reshape(Hr, 32, Wr, 32).permute(0, 2, 1, 3).reshape(
        Hr * Wr, -1)
    want = torch.quantile(blocks, 0.5, dim=-1).numpy()
    got = np.array([kfp.model_region_quantile(b.numpy()) for b in blocks])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_model_rank_topk_matches_topk_stable(seed):
    rng = np.random.default_rng(seed)
    best = rng.integers(0, 6, 1036).astype(np.float32)   # many ties
    best[rng.random(1036) < 0.3] = 0.0
    for k in (1, 512, 1036):
        want = tsel.topk_stable(torch.tensor(best), k)[1].numpy()
        np.testing.assert_array_equal(kfp.model_rank_topk(best, k), want)
    assert (kfp.model_rank_topk(best, 512, ties_to_highest=True)
            != kfp.model_rank_topk(best, 512)).any()


@pytest.mark.parametrize("pot", [17, 12, 2])
def test_model_cell_argmax_matches_torch(pot):
    rng = np.random.default_rng(pot)
    s = rng.integers(0, 3, (40, pot * pot)).astype(np.float32)   # ties inside cells
    s[5] = 0.0
    best, arg = kfp.model_cell_argmax(s)
    np.testing.assert_array_equal(best, torch.amax(torch.tensor(s), -1).numpy())
    np.testing.assert_array_equal(arg, torch.argmax(torch.tensor(s), -1).numpy())


@pytest.mark.parametrize("P,n_valid,nan_rows", [
    (256, 0, False), (256, 1, False), (256, 2, False), (256, 7, False), (256, 8, False),
    (256, 255, False), (1500, 941, False), (2047, 2047, False), (2048, 1024, False),
    (2048, 2, False), (2048, 0, True), (2048, 1, True), (2048, 2, True)])
def test_model_rho_range_matches_plain(P, n_valid, nan_rows):
    """The radix selection's median at torch.nanquantile's ranks (odd and
    even counts, a NaN inverse depth among the valid ones, counts that are
    no power of two; with `nan_rows` every fifth slot valid and NaN, so
    that 0, 1 or 2 keys of 2,048 slots take part), the range from it."""
    rng = np.random.default_rng(P + n_valid)
    cfg = dataclasses.replace(SIZES["160x120"][2], max_points=P)
    idepth = (rng.random(P) * 3).astype(np.float32)
    valid = np.zeros(P, bool)
    if nan_rows:
        idepth[::5] = np.nan
        valid[::5] = True
        valid[1 + 5 * np.arange(n_valid)] = True
    else:
        valid[rng.choice(P, n_valid, replace=False)] = True
        if n_valid > 2:
            idepth[np.nonzero(valid)[0][0]] = np.nan
    ba = tba.empty_state(cfg).replace(idepth=torch.tensor(idepth),
                                      point_valid=torch.tensor(valid))
    want = todo._working_rho_range_plain(ba, cfg)
    got = kfp.model_rho_range(idepth, valid, cfg.idepth_min, cfg.idepth_max)
    for x, y in zip(got, want):
        assert np.float32(x) == y.numpy(), (x, y)


def _order_keys(v) -> np.ndarray:
    return kfp._order_key(np.asarray(v, np.float32))


def _select_case(name: str):
    """(keys, [(r0, r1), ...]) of a hard case for the radix selection."""
    rng = np.random.default_rng(len(name))
    if name == "all_equal":
        return np.full(2048, 0x3F800000, np.uint32), [(0, 0), (1023, 1024), (2047, 2047)]
    if name == "two_values":
        k = _order_keys(rng.permutation(np.repeat(np.float32([5.0, 7.0]), 1024)))
        return k, [(1023, 1024), (1022, 1023), (1024, 1025)]
    if name == "signed_zeros":
        k = _order_keys(rng.permutation(np.float32([-0.0] * 600 + [0.0] * 600 + [-1.0, 1.0])))
        return k, [(600, 601), (599, 600), (0, 1), (1200, 1201)]
    if name == "top_keys":   # the largest keys, 0xFFFFFFFF among them (a NaN's order key)
        k = np.concatenate([np.full(3, 0xFFFFFFFF, np.uint32), np.uint32([0xFFFFFFFE, 0]),
                            rng.integers(0, 2**32 - 2, 1019, dtype=np.uint64).astype(np.uint32)])
        return rng.permutation(k), [(1021, 1022), (1020, 1021), (1023, 1023), (0, 1)]
    if name == "one_bucket":   # 1,024 keys under one top digit
        k = np.uint32(0x42000000) + rng.permutation(1024).astype(np.uint32)
        return k, [(511, 512), (0, 1), (1022, 1023)]
    if name == "one_low_bucket":   # and under one top three digits, with repeats
        k = np.uint32(0x42424200) + rng.integers(0, 256, 1024).astype(np.uint32)
        return k, [(511, 512), (255, 256)]
    P = int(name[1:])   # "pN": N random keys with repeats
    k = rng.integers(0, 2**20, P, dtype=np.uint64).astype(np.uint32) << np.uint32(12)
    return k, [((P - 1) // 2, P // 2), (0, 0), (P - 2, P - 1)]


@pytest.mark.parametrize("name", ["all_equal", "two_values", "signed_zeros", "top_keys",
                                  "one_bucket", "one_low_bucket", "p1500", "p2047", "p2048"])
def test_model_select_ranks_matches_sort(name):
    """model_select_ranks (the kernel's four radix passes, then the equal
    keys' count or the least key above) gives a sort's keys at both ranks."""
    keys, ranks = _select_case(name)
    s = np.sort(keys)
    for r0, r1 in ranks:
        assert kfp.model_select_ranks(keys, r0, r1) == (s[r0], s[r1]), (name, r0, r1)


def test_quantile_rank_fault_shows_on_striped_regions():
    """The smoke's planted fault (the region quantile's low rank one too
    high) changes a region's quantile where the two middle keys differ: a
    region of 512 zeros and 512 magnitudes c has median c / 2, the fault
    takes c; then no pixel of magnitude c passes the fault's threshold
    (c + 7)^2, where the honest one, (c / 2 + 7)^2, passes them all for
    c > 14."""
    c = np.float32(50.0)
    v = np.where(np.arange(1024) % 2 == 0, np.float32(0), c).astype(np.float32)
    q_lo, q_hi, q_w = kfp._quantile_rank(0.5)
    honest = kfp.model_region_quantile(v)
    assert honest == torch.quantile(torch.tensor(v), 0.5).numpy() == c / 2
    k0, k1 = kfp.model_select_ranks(v.view(np.uint32), q_lo + 1, q_hi)
    f = np.array([k0, k1], np.uint32).view(np.float32)
    faulty = kfp._lerp(f[0], f[1], np.float32(q_w))
    assert faulty == c
    assert (honest + 7) ** 2 < c * c < (faulty + 7) ** 2


def test_seed_immatures_dispatch_on_cpu_is_plain(cases):
    """On CPU tensors the dispatchers run the plain forms: the same
    tensors' values as the *_plain functions."""
    c = cases["window"]
    uv, valid, _ = tsel.select_points(c.kf_pyr[0], c.cfg.points_per_kf)
    u2, v2, _ = tsel.select_points_plain(c.kf_pyr[0], c.cfg.points_per_kf)
    assert torch.equal(uv, u2) and torch.equal(valid, v2)
    lo, hi = todo._working_rho_range(c.window.ba, c.cfg)
    a = ttr.seed_immatures(c.immature, c.slot, c.kf_pyr[0], uv, valid, lo, hi)
    b = ttr.seed_immatures_plain(c.immature, c.slot, c.kf_pyr[0], uv, valid, lo, hi)
    for f in dataclasses.fields(a):
        assert torch.equal(getattr(a, f.name), getattr(b, f.name))


def test_dispatchers_raise_on_other_devices():
    """A tensor on neither the CPU nor a card raises: no fallback."""
    cfg = SIZES["160x120"][2]
    w = twin.empty_window(cfg, 120, 160, device="meta")
    imm = ttr.empty_immatures(cfg.max_frames, cfg.points_per_kf, device="meta")
    with pytest.raises(ValueError):
        todo._activate_and_clear(w, imm, cfg)
    with pytest.raises(ValueError):
        todo._working_rho_range(w.ba, cfg)
    with pytest.raises(ValueError):
        twin.add_points(w, 0, torch.zeros((4, 2), device="meta"), torch.ones(4, device="meta"),
                        torch.ones(4, dtype=torch.bool, device="meta"), cfg)


# -- the smoke's planted faults and the stamp tool against the kernel sources ----------


def _chip_smoke():
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    return chip_smoke


@pytest.mark.parametrize("fault", ["dest_one_free_slot_further", "topk_ties_to_the_highest_index",
                                   "quantile_rank_one_too_high"])
def test_planted_fault_edits_its_kernel_once(fault, tmp_path):
    """chip_smoke.KF_FAULTS: each fault's line is in its kernel source
    once, and write_kf_faults' copy differs from the source there only."""
    cs = _chip_smoke()
    source, old, new, _ = cs.KF_FAULTS[fault]
    text = source.read_text()
    assert text.count(old) == 1 and old != new
    path = cs.write_kf_faults(tmp_path)[fault]
    assert path.read_text() == text.replace(old, new)
    assert (path.parent / "grid_barrier.cuh").exists()


def test_kf_stage_marks_are_found_by_ba_stages(tmp_path):
    """tools/ba_stages.py --kf stamps every `// stage:` mark of both
    keyframe kernels, and puts the marks that the sources of commit
    cb7cc16 lacked (KF_MARKS) where their anchors stand, such as the
    activation's ticket."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
    import ba_stages

    class Tree:
        csrc = kfp.kb.CSRC

    copy, stages = ba_stages.instrument(Tree(), tmp_path / "kf_stages", prefix=("kf_",),
                                        edit=ba_stages.add_kf_marks)
    assert stages == ["activate_start", "candidates", "scans", "scatter", "refresh_start",
                      "units", "phase1", "barrier1", "thresholds", "phase2", "barrier2",
                      "maxima", "phase3"]
    for name in ("kf_activate.cu", "kf_refresh.cu"):
        stamped = (copy / name).read_text()
        assert not any(ln.strip().startswith("// stage:") for ln in stamped.splitlines())
    anchor = ba_stages.KF_MARKS["kf_activate.cu"][2][0]
    old = "__global__ void k() {\n" + anchor + "\n  x();\n}\n"
    assert ba_stages.add_kf_marks("kf_activate.cu", old) == (
        "__global__ void k() {\n" + anchor + "\n  // stage: ticket\n  x();\n}\n")
