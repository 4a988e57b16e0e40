"""The ORB extraction kernel (csrc/orb_extract.cu) on the card, held to its
plain form extract_orb_plain under ops/orb_extract.parity: rendered 160x120
frames at budgets 128 and 512 (levels 1 and 2 pad at 512), a flat image
(every slot a zero-score tie), an integer image of small symmetric blobs
(equal-score corners: NMS plateaus, cell and level ties; at budget 50 the
budget splits a group of equal scores), a frame cropped to odd sides that
are not multiples of 16 (its rows copied 4 bytes at a time), a lower
threshold, a rendered 640x480 frame at budgets 512, 800 and 2000 and with 4
levels, and a 1920x1440 frame (a rendered one tiled 3 x 3) with more cells
than the kernel's grid has blocks; two runs bit for bit, one counted call
(one launch) a call, and each pass alone through the stage mask.

The cases are built with the port alone: this file imports only torch,
numpy, pytest and the port, so that it runs on the card machine (which has
no JAX package):

    python -m pytest --noconftest -q tests/test_torch_card_*.py

Without a card every case skips. tests/test_torch_orb_kernels.py imports the
cases from here.
"""

import functools

import numpy as np
import pytest
import torch

import libcml_tpu_torch.models.indirect.orb as torb
from libcml_tpu_torch.core.camera import PinholeCamera as TCam
from libcml_tpu_torch.data.synthetic import SyntheticScene, forward_trajectory
from libcml_tpu_torch.ops import kernel_build as kb
from libcml_tpu_torch.ops import orb_extract as oe
from libcml_tpu_torch.ops.image import build_pyramid

torch.set_num_threads(1)

CAM_ARGS = (110.0, 110.0, 79.5, 59.5, 160, 120)
# the smoke's full-width camera (workload.py)
FULL_CAM_ARGS = (520.0, 520.0, 319.5, 239.5, 640, 480)


@functools.lru_cache(maxsize=None)
def rendered(full: bool, k: int) -> np.ndarray:
    """Frame k of the synthetic forward sequence (scene seed 3)."""
    cam = TCam.make(*(FULL_CAM_ARGS if full else CAM_ARGS))
    scene = SyntheticScene.default(cam, seed=3)
    R, t = forward_trajectory(k + 1, step=0.08, yaw_rate=0.003)[k]
    return scene.render(R, t)[0]


def blob_image(H: int = 120, W: int = 160) -> np.ndarray:
    """Integer-valued blobs two pixels wide and three tall on a flat 40
    background, each symmetric about the vertical line between its two
    columns: its six pixels are FAST corners of exactly equal score (every
    circle sample darker), neighbours of each other (NMS plateaus), four
    of them in one cell (cell ties); two brightnesses repeat over the
    image (level ties across cells)."""
    img = np.full((H, W), 40.0, np.float32)
    for k, y in enumerate(range(6, H - 6, 13)):
        for j, x in enumerate(range(5 + (k % 2) * 3, W - 6, 11)):
            img[y - 1:y + 2, x:x + 2] = 200.0 if (j + k) % 2 else 150.0
    return img


def noise_image(whole: bool = False, H: int = 480, W: int = 640) -> np.ndarray:
    """Uniform noise in [0, 255) from seed 0 (whole grey levels with
    `whole`): a corner in nearly every cell, most of a level's scores in one
    or two buckets of the selection, and with `whole` many exact ties."""
    img = np.random.default_rng(0).uniform(0.0, 255.0, (H, W)).astype(np.float32)
    return np.floor(img) if whole else img


# name -> (image, levels, budget, threshold)
CASES = {
    "frame_b128": (lambda: rendered(False, 0), 3, 128, 12.0),
    "frame_b512": (lambda: rendered(False, 2), 3, 512, 12.0),
    "frame_t8": (lambda: rendered(False, 1), 3, 128, 8.0),
    "flat": (lambda: np.full((120, 160), 100.0, np.float32), 3, 128, 12.0),
    "blobs": (blob_image, 3, 128, 12.0),
    # a budget that splits a group of equal scores at levels 0 and 1
    "blobs_b50": (blob_image, 3, 50, 12.0),
    "odd_sides": (lambda: np.ascontiguousarray(rendered(False, 1)[:117, :153]), 3, 128, 12.0),
}
# at the main path's width (the smoke's 640x480 camera)
FULL_CASES = {
    "640x480_b512": (lambda: rendered(True, 0), 3, 512, 12.0),
    "640x480_b800": (lambda: rendered(True, 1), 3, 800, 12.0),
    "640x480_b2000": (lambda: rendered(True, 1), 3, 2000, 12.0),
    "640x480_4_levels": (lambda: rendered(True, 2), 4, 512, 12.0),
    "640x480_noise_b512": (noise_image, 3, 512, 12.0),
    "640x480_noise_b2000": (noise_image, 3, 2000, 12.0),
    "640x480_whole_noise_b2000": (lambda: noise_image(True), 3, 2000, 12.0),
}


def orb_case(name: str, dev="cpu") -> tuple[tuple[torch.Tensor, ...], int, float]:
    """(pyramid on dev, budget, threshold) of a case."""
    make, levels, budget, threshold = {**CASES, **FULL_CASES}[name]
    img = torch.tensor(make(), dtype=torch.float32, device=dev)
    return build_pyramid(img, levels), budget, threshold


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("case", list(CASES) + list(FULL_CASES))
def test_cuda_extract_orb_matches_plain(cuda, case):
    """One call through the dispatcher (one launch), then the wrapper with
    a probe, held to the plain form under parity; the integer images
    (exact sums) slot for slot, their angles within ANGLE_TOL of the plain
    form's and every bit that differs from it under DESC_EDGE in the plain
    form's own sampling; a second call gives the same bits."""
    pyr, budget, threshold = orb_case(case, cuda)
    calls = oe.orb_extract_cuda.launches
    got = torb.extract_orb(pyr, budget_per_level=budget, threshold=threshold)
    torch.cuda.synchronize()
    assert oe.orb_extract_cuda.launches == calls + 1
    probe = oe.new_probe(pyr)
    again = oe.orb_extract_cuda(pyr, budget, threshold, probe=probe)
    want = torb.extract_orb_plain(pyr, budget, threshold)
    rep = oe.parity(got, pyr, budget, threshold, probe, want)
    print(case, {k: v for k, v in rep.items() if k != "nms_flips"})
    assert rep["ok"], rep
    for f in ("uv", "level", "angle", "score", "desc", "valid"):
        assert torch.equal(getattr(got, f), getattr(again, f)), f
    assert got.uv.shape == (len(pyr) * budget, 2)
    if case in ("flat", "blobs", "blobs_b50"):
        # exact sums: the same slots and scores as the plain form; a bit may
        # still differ where a pair samples (nearly) equal grey levels, as
        # the two forms round the rotated pattern otherwise
        assert rep["differing_slots"] == 0, rep
        assert torch.equal(got.score, want.score)
        assert rep["max_angle_vs_plain"] <= oe.ANGLE_TOL, rep
        assert rep["bits_beyond_edge_vs_plain"] == 0, rep
    if case == "flat":
        assert not bool(got.valid.any())


def test_cuda_wrapper_raises_on_what_it_does_not_take(cuda):
    pyr, budget, threshold = orb_case("frame_b128", cuda)
    with pytest.raises(ValueError):
        oe.orb_extract_cuda(pyr, budget, threshold, cell=8)
    with pytest.raises(ValueError):
        oe.orb_extract_cuda((pyr[0].t(),), budget, threshold)      # not contiguous
    with pytest.raises(TypeError):
        oe.orb_extract_cuda(tuple(x.double() for x in pyr), budget, threshold)


def test_cuda_budget_splits_a_tie_group(cuda):
    """blobs_b50's budget takes part of a group of equal scores at levels 0
    and 1, and the kernel's slots there are the plain form's exactly."""
    pyr, budget, threshold = orb_case("blobs_b50", cuda)
    ties = oe.ties_at_budget(pyr, budget, threshold)
    assert all(t["taken"] > 0 and t["left"] > 0 for t in ties[:2]), ties
    got = oe.orb_extract_cuda(pyr, budget, threshold)
    want = torb.extract_orb_plain(pyr, budget, threshold)
    for f in ("uv", "score", "valid", "level"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f


def test_cuda_more_cells_than_blocks(cuda):
    """A 4-level pyramid of a 1920x1440 frame (a rendered 640x480 one tiled
    3 x 3): 10,800 level-0 cells, more than the grid's blocks, so every
    pass walks its work grid-stride; held to the plain form under parity,
    twice bit for bit."""
    img = torch.tensor(np.tile(rendered(True, 3), (3, 3)), dtype=torch.float32, device=cuda)
    pyr = build_pyramid(img, 4)
    assert (1440 // 16) * (1920 // 16) > oe.grid_blocks(cuda)
    for budget in (512, 2000):
        probe = oe.new_probe(pyr)
        got = oe.orb_extract_cuda(pyr, budget, 12.0, probe=probe)
        want = torb.extract_orb_plain(pyr, budget, 12.0)
        rep = oe.parity(got, pyr, budget, 12.0, probe, want)
        print(budget, {k: v for k, v in rep.items() if k != "nms_flips"})
        assert rep["ok"], rep
        again = oe.orb_extract_cuda(pyr, budget, 12.0)
        for f in ("uv", "level", "angle", "score", "desc", "valid"):
            assert torch.equal(getattr(got, f), getattr(again, f)), f


def test_cuda_odd_sides_copy_4_bytes_at_a_time(cuda):
    """The odd_sides case's levels whose width is not a multiple of 4 take
    the kernel's 4-byte copies; the 640x480 levels all take 16-byte ones."""
    pyr, _, _ = orb_case("odd_sides", cuda)
    assert oe.vector_levels(pyr) == [img.shape[1] % 4 == 0 for img in pyr]
    assert not all(oe.vector_levels(pyr))
    pyr, _, _ = orb_case("640x480_b512", cuda)
    assert all(oe.vector_levels(pyr))


def test_cuda_stage_mask_runs_each_pass_alone(cuda):
    """After a whole call, each pass alone (bit k of the stage mask) on what
    the scratch holds gives the whole call's outputs again."""
    pyr, budget, threshold = orb_case("640x480_b800", cuda)
    lib = kb.load(oe.SOURCE, "orb_extract_launch", oe.ARGTYPES)
    out, args, scratch = oe.launch_args(pyr, budget, threshold, None)
    stream = torch.cuda.current_stream().cuda_stream
    assert lib.orb_extract_launch(oe.ALL_STAGES, *args, stream) == 0
    whole = {f: getattr(out, f).clone() for f in ("uv", "level", "angle", "score", "desc",
                                                 "valid")}
    for f in whole:
        getattr(out, f).zero_()
    for k in range(len(oe.STAGES)):
        assert lib.orb_extract_launch(1 << k, *args, stream) == 0
    torch.cuda.synchronize()
    for f, x in whole.items():
        assert torch.equal(getattr(out, f), x), f
