"""The ORB extraction kernels (csrc/orb_extract.cu) on the card, held to their
plain form extract_orb_plain under ops/orb_extract.parity: rendered 160x120
frames at budgets 128 and 512 (levels 1 and 2 pad at 512), a flat image
(every slot a zero-score tie), an integer image of small symmetric blobs
(equal-score corners: NMS plateaus, cell and level ties), a frame cropped to
odd sides that are not multiples of 16, a lower threshold, and a rendered
640x480 frame at budgets 512, 800 and 2000 and with 4 levels; two runs bit
for bit and one counted call (three launches) a call.

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


# name -> (image, levels, budget, threshold)
CASES = {
    "frame_b128": (lambda: rendered(False, 0), 3, 128, 12.0),
    "frame_b512": (lambda: rendered(False, 2), 3, 512, 12.0),
    "frame_t8": (lambda: rendered(False, 1), 3, 128, 8.0),
    "flat": (lambda: np.full((120, 160), 100.0, np.float32), 3, 128, 12.0),
    "blobs": (blob_image, 3, 128, 12.0),
    "odd_sides": (lambda: np.ascontiguousarray(rendered(False, 1)[:117, :153]), 3, 128, 12.0),
}
# at the main path's width (the smoke's 640x480 camera)
FULL_CASES = {
    "640x480_b512": (lambda: rendered(True, 0), 3, 512, 12.0),
    "640x480_b800": (lambda: rendered(True, 1), 3, 800, 12.0),
    "640x480_b2000": (lambda: rendered(True, 1), 3, 2000, 12.0),
    "640x480_4_levels": (lambda: rendered(True, 2), 4, 512, 12.0),
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
    """One call through the dispatcher (three launches), then the wrapper with
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
    if case in ("flat", "blobs"):
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
