"""ORB features: oriented multi-scale FAST + steered binary descriptors.

PyTorch port of libcml_tpu/models/indirect/orb.py (the reference's ORB
extractor, src/cml/features/corner/ORB.h:21, ORB.cpp:97 compute). Per-cell
top-k on a fixed grid replaces the reference's octree spread; orientation
(intensity centroid) and steered BRIEF are batched bilinear gathers.
`extract_orb` runs the hand-written kernels of ops/orb_extract.py on the
card and `extract_orb_plain` (this module's tensor code) on the CPU.

Descriptors are (K, 8) 32-bit words holding the same bits as the JAX
package's uint32 words, stored as torch.int32 bit patterns (the CPU build of
torch has no shifts or subtraction on uint32). `popcount32` works on those
patterns in int64.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from libcml_tpu_torch.models.direct.selector import topk_stable
from libcml_tpu_torch.models.indirect.fast import _maxpool3, fast_score_map
from libcml_tpu_torch.ops.image import bilinear

_PATCH = 31
_HALF = _PATCH // 2


@functools.lru_cache(maxsize=1)
def brief_pattern() -> np.ndarray:
    """(256, 2, 2) float32: 256 (p, q) test-point pairs, Gaussian-distributed
    within the 31x31 patch (generated once, deterministic seed — the same
    table as the JAX package's, bit for bit)."""
    rng = np.random.default_rng(0x0B5EC0DE)
    sigma = _PATCH / 5.0
    pts = rng.normal(0.0, sigma, size=(256, 2, 2))
    return np.clip(pts, -_HALF + 1, _HALF - 1).astype(np.float32)


@functools.lru_cache(maxsize=8)
def _pattern_dev(device: torch.device) -> torch.Tensor:
    return torch.as_tensor(brief_pattern()).to(device)


@functools.lru_cache(maxsize=8)
def _ic_offsets(device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    r = _HALF
    dy, dx = np.mgrid[-r : r + 1, -r : r + 1]
    mask = (dx**2 + dy**2 <= r**2).astype(np.float32)
    offs = np.stack([dx.ravel(), dy.ravel()], -1).astype(np.float32)
    return torch.as_tensor(offs).to(device), torch.as_tensor(mask.ravel()).to(device)


@dataclasses.dataclass
class OrbFeatures:
    """Fixed-budget ORB feature set for one image."""

    uv: torch.Tensor       # (K, 2) level-0 pixel coords
    level: torch.Tensor    # (K,) int32 pyramid level
    angle: torch.Tensor    # (K,) radians
    score: torch.Tensor    # (K,) FAST response
    desc: torch.Tensor     # (K, 8) int32 bit patterns of the 256-bit descriptor
    valid: torch.Tensor    # (K,) bool

    def replace(self, **kw) -> "OrbFeatures":
        return dataclasses.replace(self, **kw)


def ic_angle(img: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Intensity-centroid orientation for corners uv (K, 2) on one level:
    batched circular-patch moments m01/m10 (reference: IC_Angle, ORB.cpp)."""
    offs, w = _ic_offsets(uv.device)                    # (M, 2), (M,)
    pts = uv[:, None, :] + offs[None, :, :]             # (K, M, 2)
    vals = bilinear(img, pts) * w                       # (K, M)
    m10 = torch.sum(vals * offs[None, :, 0], dim=1)
    m01 = torch.sum(vals * offs[None, :, 1], dim=1)
    return torch.atan2(m01, m10)


def _pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(K, 256) {0,1} -> (K, 8) int32 words, bit j of word w = bits[32w + j]."""
    words = bits.to(torch.int64).reshape(-1, 8, 32)
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    v = torch.sum(words << shifts, dim=-1)              # [0, 2^32)
    v = torch.where(v >= 2**31, v - 2**32, v)           # same bits as int32
    return v.to(torch.int32)


def brief_values(img: torch.Tensor, uv: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """The steered pattern's samples (K, 256, 2): each pair's (v_p, v_q)."""
    pat = _pattern_dev(uv.device)                       # (256, 2, 2)
    ca, sa = torch.cos(angle), torch.sin(angle)
    R = torch.stack([torch.stack([ca, -sa], -1), torch.stack([sa, ca], -1)], dim=-2)
    rot = torch.einsum("kij,ntj->knti", R, pat)         # (K, 256, 2, 2)
    pts = uv[:, None, None, :] + rot
    return bilinear(img, pts)


def brief_descriptor(img: torch.Tensor, uv: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Steered BRIEF: rotate the pattern by angle, sample, compare, pack.
    Returns (K, 8) int32 bit patterns."""
    vals = brief_values(img, uv, angle)
    return _pack_bits(vals[..., 0] < vals[..., 1])


def _grid_topk(score_map: torch.Tensor, cell: int, per_cell: int):
    """Per-cell top-k corner spread (replaces the reference's octree
    distribution, ORB.cpp:212) — fixed shapes, no recursion."""
    H, W = score_map.shape
    Hc, Wc = H // cell, W // cell
    cells = (
        score_map[: Hc * cell, : Wc * cell]
        .reshape(Hc, cell, Wc, cell)
        .permute(0, 2, 1, 3)
        .reshape(Hc * Wc, cell * cell)
    )
    top, arg = topk_stable(cells, per_cell)             # (C, per_cell)
    ar = torch.arange(Hc * Wc, device=score_map.device)
    cy, cx = ar // Wc, ar % Wc
    oy, ox = arg // cell, arg % cell
    u = (cx[:, None] * cell + ox).float()
    v = (cy[:, None] * cell + oy).float()
    return torch.stack([u, v], -1).reshape(-1, 2), top.reshape(-1)


def nms_map(score: torch.Tensor) -> torch.Tensor:
    """The FAST score where it is a 3x3 maximum and positive, else 0."""
    return torch.where((score >= _maxpool3(score)) & (score > 0), score, torch.zeros_like(score))


def select_level(score: torch.Tensor, budget: int, cell: int, per_cell: int):
    """A level's slots from its FAST score map: the NMS, the per-cell top
    `per_cell`, the stable top `budget` of those candidates, padded to
    `budget` (uv (0, 0), score 0). Returns (uv (budget, 2) level pixels,
    score (budget,), valid (budget,))."""
    uv, sc = _grid_topk(nms_map(score), cell, per_cell)
    # small pyramid levels can yield fewer candidates than the budget
    k = min(budget, sc.shape[0])
    top, idx = topk_stable(sc, k)
    uv = uv[idx]
    if k < budget:
        pad = budget - k
        uv = torch.cat([uv, torch.zeros((pad, 2), dtype=uv.dtype, device=uv.device)])
        top = torch.cat([top, torch.zeros((pad,), dtype=top.dtype, device=top.device)])
    return uv, top, top > 0.0


def _extract_level(img: torch.Tensor, threshold: float, budget: int, cell: int,
                   per_cell: int):
    uv, top, ok = select_level(fast_score_map(img, threshold), budget, cell, per_cell)
    ang = ic_angle(img, uv)
    desc = brief_descriptor(img, uv, ang)
    return uv, top, ok, ang, desc


def extract_orb_plain(
    pyramid: tuple[torch.Tensor, ...],
    budget_per_level: int = 512,
    threshold: float = 12.0,
    cell: int = 16,
    per_cell: int = 4,
) -> OrbFeatures:
    """Extract ORB features on every pyramid level; coords are reported at
    level 0 (scaled), levels recorded for scale-aware matching. The plain
    form: the CPU path, and the yardstick of the kernel on the card."""
    uvs, levels, angles, scores, descs, valids = [], [], [], [], [], []
    for l, img in enumerate(pyramid):
        uv, sc, ok, ang, desc = _extract_level(img, threshold, budget_per_level,
                                               cell, per_cell)
        scale = float(2**l)
        uvs.append((uv + 0.5) * scale - 0.5)
        levels.append(torch.full((budget_per_level,), l, dtype=torch.int32,
                                 device=img.device))
        angles.append(ang)
        scores.append(sc)
        descs.append(desc)
        valids.append(ok)
    return OrbFeatures(
        uv=torch.cat(uvs), level=torch.cat(levels), angle=torch.cat(angles),
        score=torch.cat(scores), desc=torch.cat(descs), valid=torch.cat(valids),
    )


def extract_orb(
    pyramid: tuple[torch.Tensor, ...],
    budget_per_level: int = 512,
    threshold: float = 12.0,
    cell: int = 16,
    per_cell: int = 4,
) -> OrbFeatures:
    """extract_orb_plain's features. A pyramid on the card goes to the
    hand-written kernel (ops/orb_extract.orb_extract_cuda: one launch, no
    host read), which raises where it cannot build or launch; one on the
    CPU to extract_orb_plain."""
    dev = pyramid[0].device
    if dev.type == "cuda":
        # imported here: ops.orb_extract imports this module
        from libcml_tpu_torch.ops.orb_extract import orb_extract_cuda

        return orb_extract_cuda(tuple(img.contiguous() for img in pyramid), budget_per_level,
                                threshold, cell, per_cell)
    if dev.type == "cpu":
        return extract_orb_plain(pyramid, budget_per_level, threshold, cell, per_cell)
    raise ValueError(f"extract_orb: unsupported device {dev}")


# ---------------------------------------------------------------------------
# Hamming matching
# ---------------------------------------------------------------------------


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Popcount of 32-bit words given as int32 (or int64) bit patterns:
    the SWAR bit trick, in int64 on the unsigned value."""
    x = x.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (((x * 0x01010101) & 0xFFFFFFFF) >> 24).to(torch.int32)


def hamming_matrix(da: torch.Tensor, db: torch.Tensor) -> torch.Tensor:
    """(N, 8) x (M, 8) 32-bit words -> (N, M) int32 Hamming distances."""
    x = torch.bitwise_xor(da[:, None, :], db[None, :, :])
    return torch.sum(popcount32(x), dim=-1, dtype=torch.int32)


# the reference's masked distance in match_ratio (libcml_tpu/models/indirect/orb.py:199)
_RATIO_MASKED = 10_000


def match_ratio(da: torch.Tensor, db: torch.Tensor, valid_a: torch.Tensor,
                valid_b: torch.Tensor, max_dist: int = 50, ratio: float = 0.75,
                mutual: bool = True):
    """Ratio-tested (optionally mutual) nearest-neighbour Hamming matching
    (reference: libcml_tpu/models/indirect/orb.py:189, BoWTracker.cpp:112).
    Returns (idx_b (N,) int32 match for each a, good (N,) bool).

    Resolved by `ops.hamming_match.hamming_resolve`: the hand-written kernel
    for CUDA tensors (no distance matrix is written), its plain version for
    CPU tensors. The kernel's d1, d2, idx and col_row are the reference's
    best, second, idx_b and back; its masked entries count 257 where the
    reference's count 10000, so a 257 is read as the reference's 10000 (a
    row with one live column has no second)."""
    # imported here: ops.hamming_match imports this module
    from libcml_tpu_torch.ops.hamming_match import hamming_resolve

    return ratio_gate(hamming_resolve(da, valid_a, db, valid_b), valid_a, max_dist, ratio,
                      mutual)


def ratio_gate(resolved, valid_a: torch.Tensor, max_dist: int = 50, ratio: float = 0.75,
               mutual: bool = True):
    """match_ratio's gates on a Hamming resolution (d1, d2, idx, col_row),
    the kernel's or its plain version's."""
    from libcml_tpu_torch.ops.hamming_match import MASKED

    d1, d2, idx_b, back = resolved
    big = torch.full_like(d1, _RATIO_MASKED)
    best = torch.where(d1 == MASKED, big, d1)
    second = torch.where(d2 == MASKED, big, d2)
    good = (best <= max_dist) & (best <= ratio * second) & valid_a
    if mutual:
        rows = torch.arange(d1.shape[0], dtype=torch.int32, device=d1.device)
        good = good & (back[idx_b.long()] == rows)
    return idx_b, good
