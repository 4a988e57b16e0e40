"""The ORB extraction kernel's algorithm (csrc/orb_extract.cu), modelled in
numpy and held, on the CPU, to the port's plain form extract_orb_plain and to
the JAX package's extract_orb.

The CUDA kernel cannot run here. The model follows its arithmetic: the
FAST score's 16 terms added in lane order, the arc test as an AND of the
doubled 16-bit mask shifted by 0..8 (the kernel's doubling form is held to
it on every mask), the NMS against the neighbours inside the image, each
cell's stable top-k by rank (the count of greater scores plus equal scores
at lower indices), each level's by the kernel's selection (score buckets,
the bucket holding the budget's rank, counts inside the buckets from it up,
the zero scores in index order; held to the ranks), the moment sums in warp
order (lane k takes the 31 x 31 offsets k, k + 32, ... inside the disk, then
a butterfly of 16, 8, 4, 2, 1), the rotated pattern sampled with
ops/image.bilinear's clamps, and the ballot's words, LSB first. It is held
under ops/orb_extract.parity (the verdict the card applies to the kernel)
and slot for slot; planted faults of the model must fail it. The kernel
itself is held to the plain form on the card
(tests/test_torch_card_orb.py, whose cases these are, and chip_smoke.py's
phase 17).
"""

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import libcml_tpu.models.indirect.orb as jorb
from libcml_tpu.ops.image import build_pyramid as jbuild_pyramid

import libcml_tpu_torch.models.indirect.orb as torb
from libcml_tpu_torch.ops import kernel_build as kb
from libcml_tpu_torch.ops import orb_extract as oe
from test_torch_card_orb import CASES, orb_case

torch.set_num_threads(1)

f32 = np.float32
CIRCLE = ((-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
          (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1))


def model_scores(img: np.ndarray, t: float, fault=None) -> np.ndarray:
    """fast_cells_kernel's FAST map: lane-order sums, the bitmask arc test."""
    H, W = img.shape
    c, t = img, f32(t)
    pad = np.pad(img, 3)
    hi, lo = c + t, c - t
    bm = np.zeros((H, W), np.uint32)
    dm = np.zeros((H, W), np.uint32)
    sb = np.zeros((H, W), f32)
    sd = np.zeros((H, W), f32)
    for i, (dy, dx) in enumerate(CIRCLE):
        v = pad[3 + dy:3 + dy + H, 3 + dx:3 + dx + W]
        b, d = v > hi, v < lo
        bm |= b.astype(np.uint32) << np.uint32(i)
        dm |= d.astype(np.uint32) << np.uint32(i)
        sb = sb + np.where(b, (v - c) - t, f32(0))
        sd = sd + np.where(d, (c - v) - t, f32(0))
    arc = 8 if fault == "arc8" else 9

    def reaches(m):
        x = m | (m << np.uint32(16))
        r = x.copy()
        for k in range(1, arc):
            r &= x >> np.uint32(k)
        return (r & np.uint32(0xFFFF)) != 0

    s = np.maximum(np.where(reaches(bm), sb, f32(0)), np.where(reaches(dm), sd, f32(0)))
    inside = np.zeros((H, W), bool)
    inside[3:H - 3, 3:W - 3] = True
    return np.where(inside, s, f32(0)).astype(f32)


def model_nms(s: np.ndarray, fault=None) -> np.ndarray:
    H, W = s.shape
    pad = np.pad(s, 1, constant_values=-np.inf)
    m = np.full((H, W), -np.inf, f32)
    for dy in range(3):
        for dx in range(3):
            if (dy, dx) != (1, 1):
                m = np.maximum(m, pad[dy:dy + H, dx:dx + W])
    keep = (s > m) if fault == "nms_gt" else (s >= m)
    return np.where(keep & (s > 0), s, f32(0)).astype(f32)


def ranks(v: np.ndarray, fault=None) -> np.ndarray:
    """Rank along the last axis: greater scores, then equal ones at lower
    indices (higher ones with the planted fault)."""
    i = np.arange(v.shape[-1])
    a, b = v[..., :, None], v[..., None, :]
    ties = (i[None, :] > i[:, None]) if fault == "ties_high" else (i[None, :] < i[:, None])
    return ((b > a) | ((b == a) & ties)).sum(-1)


KEY_SHIFT, NB = 20, 2048      # csrc/orb_extract.cu: a score's bucket is its bits >> 20
REFINE_AT = 128               # csrc/orb_extract.cu: a listed bucket's keys past which it splits


def model_select(scores: np.ndarray, budget: int, fault=None) -> np.ndarray:
    """The kernel's selection of a level (select_level): each candidate's
    slot, -1 where it owns none. A histogram of the nonzero scores' bits by
    bucket (bits >> KEY_SHIFT), the bucket b* holding rank budget - 1 (0
    when fewer nonzero scores than the budget); where a bucket at or above
    b* holds more than REFINE_AT keys, the listed buckets' range (from the
    lowest nonempty one at or above b* to the highest) split into up to NB
    finer buckets; then for each nonzero candidate in a bucket >= b* the
    keys in higher buckets plus those of its own bucket greater than its own
    or equal at a lower index (higher with the planted fault); then the zero
    scores in index order. (The kernel ranks each candidate in the block
    whose range of indices holds it: model_part_ranges.)"""
    keys = scores.astype(np.float32).view(np.uint32).astype(np.int64)
    nz = keys != 0
    coarse = keys >> KEY_SHIFT
    hist = np.bincount(coarse[nz], minlength=NB)
    above = np.concatenate([np.cumsum(hist[::-1])[::-1][1:], [0]])
    total = int(hist.sum())
    bstar = 0
    if total >= budget:
        bstar = int(np.flatnonzero((above < budget) & (budget <= above + hist))[0])
    listed = nz & (coarse >= bstar)
    shift, base = KEY_SHIFT, 0
    if hist[bstar:].max(initial=0) > REFINE_AT:
        filled = np.flatnonzero(hist)
        first = max(bstar, int(filled[0]))
        span = int(filled[-1]) + 1 - first
        finer = 0
        while finer < KEY_SHIFT and (span << (finer + 1)) <= NB:
            finer += 1
        shift, base = KEY_SHIFT - finer, first << finer
    bucket = (keys >> shift) - base
    assert (bucket[listed] >= 0).all() and (bucket[listed] < NB).all()
    hist = np.bincount(bucket[listed], minlength=NB)
    above = np.concatenate([np.cumsum(hist[::-1])[::-1][1:], [0]])
    slot = np.full(keys.size, -1, np.int64)
    for b in np.unique(bucket[listed]):
        idx = np.flatnonzero(listed & (bucket == b))
        k = keys[idx]
        later = idx[None, :] > idx[:, None] if fault == "ties_high" else idx[None, :] < idx[:, None]
        rank = above[b] + ((k[None, :] > k[:, None]) | ((k[None, :] == k[:, None]) & later)).sum(1)
        slot[idx[rank < budget]] = rank[rank < budget]
    if total < budget:
        zeros = np.flatnonzero(~nz)
        rank = total + np.arange(zeros.size)
        slot[zeros[rank < budget]] = rank[rank < budget]
    return slot


def model_part_ranges(n: int, parts: int) -> list[range]:
    """select_level's candidates of each part: [part * span, part * span +
    span) clipped to n, span = ceil(n / parts)."""
    span = -(-n // parts)
    return [range(min(p * span, n), min(p * span + span, n)) for p in range(parts)]


def model_bilinear(img: np.ndarray, x: np.ndarray, y: np.ndarray) -> np.ndarray:
    H, W = img.shape
    x0f = np.clip(np.floor(x), f32(0), f32(W - 2))
    y0f = np.clip(np.floor(y), f32(0), f32(H - 2))
    dx = np.clip(x - x0f, f32(0), f32(1))
    dy = np.clip(y - y0f, f32(0), f32(1))
    x0, y0 = x0f.astype(np.int64), y0f.astype(np.int64)
    top = img[y0, x0] * (f32(1) - dx) + img[y0, x0 + 1] * dx
    bot = img[y0 + 1, x0] * (f32(1) - dx) + img[y0 + 1, x0 + 1] * dx
    return (top * (f32(1) - dy) + bot * dy).astype(f32)


def model_angle(img: np.ndarray, u: np.ndarray, v: np.ndarray, fault=None) -> np.ndarray:
    """describe_kernel's moments in warp order, then atan2."""
    H, W = img.shape
    q = np.arange(31 * 32)
    oy, ox = q // 31 - 15, q % 31 - 15
    disk = (q < 961) & (ox * ox + oy * oy <= 225)
    y = np.clip(v[:, None] + oy[None], 0, H - 1)
    x = np.clip(u[:, None] + ox[None], 0, W - 1)
    vals = np.where(disk[None], img[y, x], f32(0))
    m = []
    for o in (ox, oy):
        terms = np.where(disk[None], vals * o.astype(f32)[None], f32(0)).reshape(-1, 31, 32)
        s = np.zeros((terms.shape[0], 32), f32)
        for it in range(31):
            s = s + terms[:, it]
        for sh in (1, 2, 4, 8, 16) if fault == "butterfly_up" else (16, 8, 4, 2, 1):
            s = s + s[:, np.arange(32) ^ sh]
        m.append(s[:, 0])
    # rounded from float64: numpy's float32 arctan2 is off by a few ulps
    return np.arctan2(m[1].astype(np.float64), m[0].astype(np.float64)).astype(f32)


def model_desc(img, u, v, ang, fault=None) -> np.ndarray:
    """describe_kernel's steered BRIEF: a lane a pair, the ballot's words."""
    pat = torb.brief_pattern()
    ca, sa = np.cos(ang)[:, None], np.sin(ang)[:, None]
    uf, vf = u.astype(f32)[:, None], v.astype(f32)[:, None]

    def sample(p):
        x = uf + (ca * p[None, :, 0] + (-sa) * p[None, :, 1])
        y = vf + (sa * p[None, :, 0] + ca * p[None, :, 1])
        return model_bilinear(img, x, y)

    bits = (sample(pat[:, 0]) < sample(pat[:, 1])).reshape(-1, 8, 32).astype(np.uint64)
    shift = np.arange(32, dtype=np.uint64)
    if fault == "msb_first":
        shift = shift[::-1].copy()
    return (bits << shift).sum(-1).astype(np.uint32).view(np.int32)


def model_extract(pyramid, budget: int, threshold: float, fault=None):
    """The kernel's outputs as numpy: OrbFeatures fields and the probe
    (every level's FAST map, flat)."""
    out = {k: [] for k in ("uv", "level", "angle", "score", "desc", "valid")}
    maps = []
    for l, img in enumerate(pyramid):
        H, W = img.shape
        Hc, Wc = H // 16, W // 16
        s = model_scores(img, threshold, fault)
        maps.append(s.ravel())
        nms = model_nms(s, fault)[:Hc * 16, :Wc * 16]
        cells = nms.reshape(Hc, 16, Wc, 16).transpose(0, 2, 1, 3).reshape(Hc * Wc, 256)
        r = ranks(cells, fault)
        cand_s = np.zeros((Hc * Wc, 4), f32)
        cand_u = np.zeros((Hc * Wc, 4), np.int64)
        cand_v = np.zeros((Hc * Wc, 4), np.int64)
        for c, k in zip(*np.nonzero(r < 4)):
            cand_s[c, r[c, k]] = cells[c, k]
            cand_u[c, r[c, k]] = (c % Wc) * 16 + k % 16
            cand_v[c, r[c, k]] = (c // Wc) * 16 + k // 16
        cand_s, cand_u, cand_v = cand_s.ravel(), cand_u.ravel(), cand_v.ravel()
        u = np.zeros(budget, np.int64)
        v = np.zeros(budget, np.int64)
        sc = np.zeros(budget, f32)
        rl = model_select(cand_s, budget, fault)
        take = rl >= 0
        u[rl[take]], v[rl[take]], sc[rl[take]] = cand_u[take], cand_v[take], cand_s[take]
        ang = model_angle(img, u, v, fault)
        out["desc"].append(model_desc(img, u, v, ang, fault))
        out["angle"].append(ang)
        scale = f32(2 ** l)
        out["uv"].append(np.stack([(u.astype(f32) + f32(0.5)) * scale - f32(0.5),
                                   (v.astype(f32) + f32(0.5)) * scale - f32(0.5)], -1))
        out["level"].append(np.full(budget, l, np.int32))
        out["score"].append(sc)
        out["valid"].append(sc > 0)
    return {k: np.concatenate(v) for k, v in out.items()}, np.concatenate(maps)


def _level_candidates(img: torch.Tensor, threshold: float) -> np.ndarray:
    """A level's candidate scores (each cell's top 4 after the NMS), from the
    plain form's pieces."""
    _, sc = torb._grid_topk(torb.nms_map(torb.fast_score_map(img, threshold)), 16, 4)
    return sc.numpy()


def _arrays_with_ties():
    """Candidate score arrays that stress the selection: float scores, each
    with many exact ties and zeros, scores straddling bucket edges, a tiny
    and a huge score."""
    rng = np.random.default_rng(7)
    out = {}
    s = rng.uniform(0, 300, 600).astype(f32)
    s[rng.random(600) < 0.3] = 0
    out["uniform_zeros"] = s
    out["integers"] = rng.integers(0, 12, 900).astype(f32)
    edge = np.float32(256.0)
    out["bucket_edges"] = np.array([edge, np.nextafter(edge, f32(0)), np.nextafter(edge, f32(1e9)),
                                    edge, 0, 1e-30, 3e38, edge, 1.0, 1.0], f32)
    out["all_zero"] = np.zeros(100, f32)
    out["one_value"] = np.full(100, 7.5, f32)
    # most keys in one bucket (the kernel splits it finer), with ties
    s = rng.uniform(2048, 2304, 3000).astype(f32)
    s[rng.random(3000) < 0.1] = 0
    s[rng.random(3000) < 0.2] = f32(2100.5)
    out["one_bucket"] = s
    out["one_bucket_integers"] = rng.integers(2048, 2304, 3000).astype(f32)
    return out


@pytest.mark.parametrize("budget", [1, 3, 50, 128, 300, 1000])
@pytest.mark.parametrize("name", ["uniform_zeros", "integers", "bucket_edges", "all_zero",
                                  "one_value", "one_bucket", "one_bucket_integers", "frame_b128",
                                  "blobs", "blobs_b50", "flat", "640x480_noise_b512",
                                  "640x480_whole_noise_b2000"])
def test_model_selection_equals_ranks(name, budget):
    """The kernel's selection by buckets gives every candidate the slot of
    its stable rank (ranks(): greater scores, then equal ones at lower
    indices) when that rank is under the budget, on arrays with ties at
    the budget's key, zeros, and each level of the card cases."""
    if name in _arrays_with_ties():
        levels = [_arrays_with_ties()[name]]
    else:
        pyr, _, threshold = orb_case(name)
        levels = [_level_candidates(img, threshold) for img in pyr]
    for s in levels:
        r = ranks(s)
        want = np.where(r < budget, r, -1)
        np.testing.assert_array_equal(model_select(s, budget), want)


@pytest.mark.parametrize("n", [8, 280, 1200, 4800, 43200])
@pytest.mark.parametrize("parts", [1, 4, 99, 132])
def test_part_ranges_cover_each_candidate_once(n, parts):
    """Every part of a level lists all the level's candidates in its own
    order, so each candidate must be ranked by exactly one part: the parts'
    ranges of indices partition [0, n)."""
    got = [i for r in model_part_ranges(n, parts) for i in r]
    assert got == list(range(n))


def test_noise_splits_its_fullest_bucket():
    """On 640x480 noise most of level 0's scores fall in one bucket, which
    the model (as the kernel) counts again in finer buckets: its selection
    still gives every candidate its stable rank."""
    pyr, budget, threshold = orb_case("640x480_noise_b2000")
    s = _level_candidates(pyr[0], threshold)
    keys = s.view(np.uint32).astype(np.int64)
    assert np.bincount(keys[keys != 0] >> KEY_SHIFT).max() > 10 * REFINE_AT
    np.testing.assert_array_equal(model_select(s, budget), np.where(ranks(s) < budget,
                                                                     ranks(s), -1))


def test_blobs_b50_cuts_a_group_of_equal_scores():
    """The card case for the selection's ties: at levels 0 and 1 the budget
    takes some candidates of a group of equal scores and leaves others."""
    pyr, budget, threshold = orb_case("blobs_b50")
    ties = oe.ties_at_budget(pyr, budget, threshold)
    assert all(t["taken"] > 0 and t["left"] > 0 for t in ties[:2]), ties
    s = _level_candidates(pyr[0], threshold)
    assert not np.array_equal(model_select(s, budget, "ties_high"), model_select(s, budget))


@pytest.mark.parametrize("name", ["frame_b128", "frame_b512", "blobs"])
def test_smoke_tie_budget_splits_a_nonzero_group(name):
    """chip_smoke.py's phase 17 runs the selection's tie fault on the
    rounded pyramid at nonzero_tie_budget: there some level's cut splits a
    group of equal nonzero scores, so that the fault's order (the model's
    "ties_high") takes other candidates than the kernel's; no larger budget
    up to the case's own does."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    pyr, budget, threshold = orb_case(name)
    rounded = tuple(torch.round(x) for x in pyr)
    b = chip_smoke.nonzero_tie_budget(rounded, budget, threshold)
    assert b is not None and 1 <= b <= budget
    split = [k for k, t in enumerate(oe.ties_at_budget(rounded, b, threshold))
             if t["taken"] and t["left"] and t["key"]]
    assert split
    s = _level_candidates(rounded[split[0]], threshold)
    assert set(np.flatnonzero(model_select(s, b) >= 0)) != set(
        np.flatnonzero(model_select(s, b, "ties_high") >= 0))
    for larger in range(b + 1, budget + 1):
        assert not any(t["taken"] and t["left"] and t["key"]
                       for t in oe.ties_at_budget(rounded, larger, threshold)), larger


def test_arc_test_doubling_equals_the_shift_loop():
    """csrc/orb_extract.cu arc_reaches (x & x >> 1, then >> 2, >> 4, and
    x >> 8) against the AND over shifts 0..8, on every 16-bit mask."""
    m = np.arange(1 << 16, dtype=np.uint32)
    x = m | (m << np.uint32(16))
    loop = x.copy()
    for k in range(1, 9):
        loop &= x >> np.uint32(k)
    r = x & (x >> np.uint32(1))
    r &= r >> np.uint32(2)
    r &= r >> np.uint32(4)
    r &= x >> np.uint32(8)
    np.testing.assert_array_equal((r & 0xFFFF) != 0, (loop & 0xFFFF) != 0)


@pytest.mark.parametrize("case", ["frame_b128", "frame_t8", "blobs", "odd_sides",
                                  "640x480_b512"])
def test_compass_test_keeps_every_corner(case):
    """csrc/orb_extract.cu scores only the pixels that pass may_be_corner
    (at least 2 of the 4 compass samples brighter, or 2 darker) and gives
    the rest 0: on every level every pixel it skips scores 0 in the model,
    and it skips most of them."""
    pyr, _, threshold = orb_case(case)
    for img in pyr:
        a = img.numpy()
        H, W = a.shape
        pad = np.pad(a, 3)
        hi, lo = a + f32(threshold), a - f32(threshold)
        compass = [pad[3 + dy:3 + dy + H, 3 + dx:3 + dx + W]
                   for dy, dx in ((-3, 0), (0, 3), (3, 0), (0, -3))]
        nb = sum((v > hi).astype(int) for v in compass)
        nd = sum((v < lo).astype(int) for v in compass)
        skipped = (nb < 2) & (nd < 2)
        assert (model_scores(a, threshold)[skipped] == 0).all()
        if case.startswith("640"):
            assert skipped.mean() > 0.3, skipped.mean()


def test_stage_marks_are_found_by_ba_stages(tmp_path):
    """Every `// stage:` mark of csrc/orb_extract.cu is one that
    tools/ba_stages.py's MARK finds (so instrument stamps it), with names
    that repeat nowhere, and the copy that instrument writes has a stamp for
    each."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
    import ba_stages

    text = oe.SOURCE.read_text()
    written = [ln.strip()[len("// stage: "):] for ln in text.splitlines()
               if ln.strip().startswith("// stage:")]
    found = [m.group(2) for m in ba_stages.MARK.finditer(text)]
    assert found == written and len(set(found)) == len(found) > 0, (written, found)

    class Tree:
        csrc = kb.CSRC

    copy, stages = ba_stages.instrument(Tree(), tmp_path / "orb_stages", prefix="orb_")
    stamped = (copy / oe.SOURCE.name).read_text()
    assert stages == found
    assert all(f"ba_stage({k});" in stamped for k in range(len(stages)))
    assert not any(ln.strip().startswith("// stage:") for ln in stamped.splitlines())


def _features(d: dict) -> torb.OrbFeatures:
    return torb.OrbFeatures(**{k: torch.as_tensor(v) for k, v in d.items()})


def _model_case(case: str, fault=None):
    pyr, budget, threshold = orb_case(case)
    got, maps = model_extract([x.numpy() for x in pyr], budget, threshold, fault)
    return pyr, budget, threshold, got, torch.as_tensor(maps)


def _desc_gaps(got: dict, want_desc: np.ndarray, pyr, budget: int) -> np.ndarray:
    """The plain sampling's |v_p - v_q| (at the model's pixels and angles) of
    every bit where got's words and want_desc differ."""
    bits = lambda d: np.unpackbits(d.view(np.uint8), bitorder="little").reshape(-1, 256)
    diff = bits(got["desc"]) != bits(want_desc)
    gaps = []
    for l, img in enumerate(pyr):
        sl = slice(l * budget, (l + 1) * budget)
        uv = (torch.as_tensor(got["uv"][sl]) + 0.5) / 2 ** l - 0.5
        vals = torb.brief_values(img, uv, torch.as_tensor(got["angle"][sl])).numpy()
        gaps.append(np.abs(vals[..., 0] - vals[..., 1])[diff[sl]])
    return np.concatenate(gaps)


def _assert_slots_equal(got: dict, want: dict, pyr, budget: int, exact_bits: bool) -> None:
    """uv, level and valid exactly; score within SCORE_RTOL; angle within
    ANGLE_TOL (wrapped); descriptor bits exactly, or, where `exact_bits` is
    off, except where the plain sampling's |v_p - v_q| is under DESC_EDGE."""
    np.testing.assert_array_equal(got["uv"], want["uv"])
    np.testing.assert_array_equal(got["level"], want["level"])
    np.testing.assert_array_equal(got["valid"], want["valid"])
    np.testing.assert_allclose(got["score"], want["score"], rtol=oe.SCORE_RTOL, atol=0)
    d = np.abs(np.remainder(got["angle"].astype(np.float64) - want["angle"] + np.pi,
                            2 * np.pi) - np.pi)
    assert d.max() <= oe.ANGLE_TOL, d.max()
    gaps = _desc_gaps(got, want["desc"], pyr, budget)
    if exact_bits:
        assert gaps.size == 0, gaps
    assert (gaps < oe.DESC_EDGE).all(), gaps.max()


@pytest.mark.parametrize("case", list(CASES))
def test_model_matches_plain_under_parity(case):
    pyr, budget, threshold, got, probe = _model_case(case)
    want = torb.extract_orb_plain(pyr, budget, threshold)
    rep = oe.parity(_features(got), pyr, budget, threshold, probe, want)
    assert rep["ok"], rep
    assert rep["differing_slots"] == 0 and rep["bits_differing_vs_plain"] == 0, rep
    _assert_slots_equal(got, {f: getattr(want, f).numpy() for f in got}, pyr, budget, True)


@pytest.mark.parametrize("case", list(CASES))
def test_model_matches_jax(case):
    pyr, budget, threshold, got, _ = _model_case(case)
    want = jorb.extract_orb(jbuild_pyramid(jnp.asarray(pyr[0].numpy()), len(pyr)),
                            budget_per_level=budget, threshold=threshold)
    want = {f: np.asarray(getattr(want, f)) for f in got}
    want["desc"] = want["desc"].view(np.int32)
    # XLA rounds the bilinear samples otherwise (contracted products): on the
    # flat and blob images, whose pairs often sample equal grey levels, a
    # bit then differs at a gap of a few ulps; rendered frames agree exactly
    _assert_slots_equal(got, want, pyr, budget, exact_bits=case not in ("flat", "blobs"))


@pytest.mark.parametrize("fault,case", [("arc8", "frame_b128"), ("nms_gt", "blobs"),
                                        ("ties_high", "blobs"), ("ties_high", "blobs_b50"),
                                        ("msb_first", "frame_b128"),
                                        ("butterfly_up", "frame_b128")])
def test_planted_faults_fail_parity(fault, case):
    pyr, budget, threshold, got, probe = _model_case(case, fault)
    rep = oe.parity(_features(got), pyr, budget, threshold, probe)
    assert not rep["ok"], (fault, rep)


def test_flat_and_blob_cases_exercise_their_ties():
    """The flat image has no corner (every slot a zero-score tie); the blob
    image's corners come in equal-score plateaus that fill whole cells."""
    pyr, budget, threshold = orb_case("flat")
    f = torb.extract_orb_plain(pyr, budget, threshold)
    assert not bool(f.valid.any())
    pyr, budget, threshold = orb_case("blobs")
    s = torb.fast_score_map(pyr[0], threshold)
    kept = torb.nms_map(s)
    vals, counts = torch.unique(kept[kept > 0], return_counts=True)
    assert len(vals) == 2 and bool((counts >= 6).all()), (vals, counts)


def test_cuda_checks_raise_before_any_build(monkeypatch):
    def no_build(*a, **k):
        raise AssertionError("the kernel was built")
    monkeypatch.setattr(kb, "build_many", no_build)
    monkeypatch.setattr(kb, "load", no_build)
    pyr, budget, threshold = orb_case("frame_b128")
    with pytest.raises(ValueError, match="CUDA"):
        oe.orb_extract_cuda(pyr, budget, threshold)
    for bad in (dict(cell=8), dict(per_cell=2), dict(budget_per_level=0),
                dict(budget_per_level=2.5), dict(threshold=float("nan"))):
        kw = {"budget_per_level": budget, "threshold": threshold, **bad}
        with pytest.raises(ValueError):
            oe.orb_extract_cuda(pyr, **kw)
    with pytest.raises(TypeError):
        oe.orb_extract_cuda(tuple(x.double() for x in pyr), budget, threshold)
    with pytest.raises(ValueError, match="contiguous"):
        oe.orb_extract_cuda((pyr[0].t(),), budget, threshold)
    with pytest.raises(ValueError, match="levels"):
        oe.orb_extract_cuda(pyr * 3, budget, threshold)
    with pytest.raises(ValueError):
        oe.orb_extract_cuda((pyr[0][:1],), budget, threshold)
    with pytest.raises(ValueError):
        oe.orb_extract_cuda(pyr, budget, threshold, probe=torch.zeros(5))


def test_cpu_pyramid_never_calls_the_wrapper(monkeypatch):
    def no_kernel(*a, **k):
        raise AssertionError("the wrapper was called for CPU tensors")
    monkeypatch.setattr(oe, "orb_extract_cuda", no_kernel)
    pyr, budget, threshold = orb_case("frame_b128")
    got = torb.extract_orb(pyr, budget_per_level=budget, threshold=threshold)
    want = torb.extract_orb_plain(pyr, budget, threshold)
    for f in ("uv", "level", "angle", "score", "desc", "valid"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f


def test_smoke_faults_name_lines_of_the_kernel():
    """chip_smoke.py's phase 17 plants each fault by one substitution in
    csrc/orb_extract.cu: each must find its line exactly once."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    text = oe.SOURCE.read_text()
    for name, (old, new) in chip_smoke.ORB_FAULTS.items():
        assert text.count(old) == 1 and new != old, name


def test_smoke_fault_sources_carry_their_headers(tmp_path):
    """Each planted fault's copy of the source sits beside the headers it
    includes, so that kernel_build can hash (and nvcc build) it."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    paths = chip_smoke.write_orb_faults(tmp_path)
    assert set(paths) == set(chip_smoke.ORB_FAULTS)
    libs = {kb.library_path(path).name for path in paths.values()}
    assert len(libs) == len(paths) and kb.library_path(oe.SOURCE).name not in libs
