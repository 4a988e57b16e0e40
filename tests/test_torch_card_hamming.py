"""The Hamming kernel (csrc/hamming_match.cu) on the card, held to its plain
version exactly: the resolution cases of tests/test_torch_indirect.py and
orb.match_ratio's cases.

This file imports only torch, numpy, pytest and the port, so that it runs on
the card machine (which has no JAX package):

    python -m pytest --noconftest -q tests/test_torch_card_*.py

Without a card every case skips. The numpy case generators live here and
tests/test_torch_indirect.py imports them.
"""

import numpy as np
import pytest
import torch

from libcml_tpu_torch import convert
from libcml_tpu_torch.models.indirect import orb
from libcml_tpu_torch.ops import hamming_match as hm
from libcml_tpu_torch.ops.image import build_pyramid

torch.set_num_threads(1)


def _t(x):
    return convert.tensor(np.asarray(x))


def resolve_case(name):
    """(dq, mq, dt, mt, pair mask or None) of one resolution case."""
    rng = np.random.default_rng(len(name))
    if name == "odd_sizes":
        N, M = 67, 301
        dq = rng.integers(0, 2**32, (N, 8), dtype=np.uint32)
        dt = rng.integers(0, 2**32, (M, 8), dtype=np.uint32)
        mq, mt = rng.random(N) > 0.2, rng.random(M) > 0.2
        pm = rng.random((N, M)) > 0.3
    elif name == "ties_and_masked":
        N, M = 40, 70
        dq = rng.integers(0, 2**32, (N, 8), dtype=np.uint32)
        dt = rng.integers(0, 2**32, (M, 8), dtype=np.uint32)
        dt[10] = dt[20] = dt[30] = dq[5]          # row 5: d1 == d2 == 0, three-way tie
        dt[40:50] = dt[0]                         # ten identical columns
        dq[6] = dq[7]                             # two rows tie for every column
        mq, mt = np.ones(N, bool), np.ones(M, bool)
        mq[3] = False                             # fully masked row
        mt[4] = False                             # fully masked column
        pm = rng.random((N, M)) > 0.5
        pm[:, 60] = False                         # column masked by the pair mask
        pm[8, :] = False                          # row masked by the pair mask
    elif name == "no_pair_small_alphabet":
        N, M = 64, 96
        # few distinct descriptors: distances tie everywhere
        base = rng.integers(0, 2**32, (4, 8), dtype=np.uint32)
        dq, dt = base[rng.integers(0, 4, N)], base[rng.integers(0, 4, M)]
        mq, mt, pm = rng.random(N) > 0.1, rng.random(M) > 0.1, None
    elif name == "single_column":
        N, M = 9, 1
        dq = rng.integers(0, 2**32, (N, 8), dtype=np.uint32)
        dt = rng.integers(0, 2**32, (M, 8), dtype=np.uint32)
        mq, mt, pm = rng.random(N) > 0.3, np.ones(M, bool), None
    elif name == "all_masked":
        N, M = 5, 300
        dq = rng.integers(0, 2**32, (N, 8), dtype=np.uint32)
        dt = rng.integers(0, 2**32, (M, 8), dtype=np.uint32)
        mq, mt, pm = np.zeros(N, bool), np.ones(M, bool), None
    elif name == "pair_all_false":
        N, M = 23, 50
        dq = rng.integers(0, 2**32, (N, 8), dtype=np.uint32)
        dt = rng.integers(0, 2**32, (M, 8), dtype=np.uint32)
        mq, mt, pm = rng.random(N) > 0.2, rng.random(M) > 0.2, np.zeros((N, M), bool)
    elif name == "one_live_per_row":
        N, M = 30, 64
        dq = rng.integers(0, 2**32, (N, 8), dtype=np.uint32)
        dt = rng.integers(0, 2**32, (M, 8), dtype=np.uint32)
        mq, mt = np.ones(N, bool), np.ones(M, bool)
        pm = np.zeros((N, M), bool)
        pm[np.arange(N), rng.integers(0, M, N)] = True
    else:   # m1, m16, m17 (pair mask), m301 (none, distances tie everywhere)
        N, M = {"m1": (40, 1), "m16": (37, 16), "m17": (70, 17), "m301": (45, 301)}[name]
        base = rng.integers(0, 2**32, (5, 8), dtype=np.uint32)
        dq, dt = base[rng.integers(0, 5, N)], base[rng.integers(0, 5, M)]
        mq, mt = rng.random(N) > 0.2, rng.random(M) > 0.2
        pm = None if name == "m301" else rng.random((N, M)) > 0.5
    return dq, mq, dt, mt, pm


RESOLVE_CASES = ["odd_sizes", "ties_and_masked", "no_pair_small_alphabet", "single_column",
                 "all_masked"]
NEW_CASES = ["pair_all_false", "one_live_per_row", "m1", "m16", "m17", "m301"]


def flip_bits(words: np.ndarray, n: int, rng) -> np.ndarray:
    """A copy of one (8,) uint32 descriptor with `n` of its bits flipped."""
    bits = np.unpackbits(words.astype(">u4").view(np.uint8))
    bits[rng.choice(256, n, replace=False)] ^= 1
    return np.packbits(bits).view(">u4").astype(np.uint32)


def ratio_case(name):
    """(da, db, valid_a, valid_b, kwargs) for match_ratio."""
    rng = np.random.default_rng(7)
    if name == "shift":
        # tests/test_indirect.py:85: ORB of a smoothed random image (a 3x3
        # box filter, reflected at the edges) and of the same image shifted
        # by 5 px, extracted by the port
        noise = np.pad(rng.uniform(0, 255, (120, 160)).astype(np.float32), 1, mode="symmetric")
        base = sum(noise[i:i + 120, j:j + 160] for i in range(3) for j in range(3)) / 9.0
        feats = [orb.extract_orb(build_pyramid(torch.tensor(im, dtype=torch.float32), 2),
                                 budget_per_level=128, threshold=8.0)
                 for im in (base, np.roll(base, (0, 5), axis=(0, 1)))]
        return (feats[0].desc.numpy().view(np.uint32), feats[1].desc.numpy().view(np.uint32),
                feats[0].valid.numpy(), feats[1].valid.numpy(), {})
    N, M = 40, 70
    da = rng.integers(0, 2**32, (N, 8), dtype=np.uint32)
    db = rng.integers(0, 2**32, (M, 8), dtype=np.uint32)
    va, vb = rng.random(N) > 0.2, rng.random(M) > 0.2
    if name in ("masked", "masked_no_mutual"):
        # near copies so that matches pass the gates; masked rows and columns
        for i in range(0, N, 2):
            da[i] = flip_bits(db[(3 * i) % M], int(rng.integers(0, 60)), rng)
        return da, db, va, vb, {} if name == "masked" else {"mutual": False}
    if name in ("one_live_column", "one_live_column_mutual"):
        # one live column: no second distance, where the reference counts
        # 10000 and the kernel 257 (the ratio gate of max_dist 200 sees the
        # difference for best distances in (0.75 * 257, 200])
        vb = np.zeros(M, bool)
        vb[3] = True
        va = np.ones(N, bool)
        for i, n in enumerate((150, 190, 193, 195, 199, 200, 201, 230)):
            da[i] = flip_bits(db[3], n, rng)
        return da, db, va, vb, {"max_dist": 200, "mutual": name.endswith("mutual")}
    if name == "no_live_column":
        # every column masked: each row's best is column 0 and each column's
        # best row is row 0; only a gate wide enough for the masked distance
        # lets row 0 through
        return da, db, np.ones(N, bool), np.zeros(M, bool), {"max_dist": 20000, "ratio": 1.0}
    if name == "no_live_row":
        return da, db, np.zeros(N, bool), np.ones(M, bool), {"max_dist": 20000, "ratio": 1.0}
    # ties: duplicate columns, duplicate rows, exact copies
    db[10] = db[20] = db[30] = da[5]
    db[40:50] = db[1]
    da[6] = da[7] = flip_bits(db[2], 3, rng)
    da[8] = db[1]
    va[:] = vb[:] = True
    vb[20] = False
    return da, db, va, vb, {"ratio": 1.0}


RATIO_CASES = ["shift", "masked", "masked_no_mutual", "one_live_column",
               "one_live_column_mutual", "no_live_column", "no_live_row", "ties"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("name", RESOLVE_CASES + NEW_CASES)
def test_cuda_kernel_matches_plain(cuda, name):
    args = [None if x is None else _t(x).to(cuda) for x in resolve_case(name)]
    before = hm.hamming_resolve_cuda.launches
    got = hm.hamming_resolve_cuda(*args)
    torch.cuda.synchronize()
    assert hm.hamming_resolve_cuda.launches == before + 1
    for g, w in zip(got, hm.hamming_resolve_plain(*args)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("name", RATIO_CASES)
def test_match_ratio_cuda_matches_plain(cuda, name):
    da, db, va, vb, kw = ratio_case(name)
    before = hm.hamming_resolve_cuda.launches
    got = orb.match_ratio(*(_t(x).to(cuda) for x in (da, db, va, vb)), **kw)
    torch.cuda.synchronize()
    assert hm.hamming_resolve_cuda.launches == before + 1
    want = orb.match_ratio(*(_t(x) for x in (da, db, va, vb)), **kw)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
