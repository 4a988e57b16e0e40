"""ORB extraction on the card: one cooperative launch of a hand-written
kernel a call.

  orb_extract_cuda  a hand-written sm_90a kernel (csrc/orb_extract.cu) in
                    three passes with a grid barrier between them: the
                    FAST-9 scores, the NMS and each cell's top 4 (two warps
                    a cell), each level's stable top `budget` (a selection
                    by score buckets, split finer where one is full, the
                    in-bucket counts spread over the grid's blocks), the
                    orientation and the steered BRIEF words of every slot
                    (a warp a slot, a level's pads described once a chunk);
                    no host read. It replaces the XLA fusion of the JAX
                    package's `extract_orb` (libcml_tpu/models/indirect/
                    orb.py:137, fast.py:46).

Its plain PyTorch form, the CPU path and the yardstick on the card, is
`models/indirect/orb.extract_orb_plain` (same arguments and results);
`orb.extract_orb` dispatches between the two by the pyramid's device. The
kernel builds with nvcc on first use (ops/kernel_build.py).

`parity` is the verdict on a call (the kernel's features and its FAST score
maps, written to an optional probe buffer, against the plain form on the
same pyramid); `warp_order_angle` is the kernel's orientation in torch, the
sums in the kernel's order, which parity holds every angle to.
"""

from __future__ import annotations

import ctypes
import math

import torch

from libcml_tpu_torch.models.indirect import orb
from libcml_tpu_torch.models.indirect.fast import fast_score_map
from libcml_tpu_torch.ops import kernel_build as kb
from libcml_tpu_torch.ops.kernel_build import KernelLaunchError

SOURCE = kb.CSRC / "orb_extract.cu"
CELL, PER_CELL = 16, 4          # csrc/orb_extract.cu CELL, PER_CELL
SELECT_PARTS = 4                # csrc/orb_extract.cu SELECT_PARTS: global lists a level too large for shared memory
MAX_LEVELS = 8                  # csrc/orb_extract.cu MAX_LEVELS
MAX_SIDE = 1 << 15              # a level pixel packs as (v << 16) | u
PATTERN_ALIGN = 16              # a lane loads a pattern pair as one float4
STAGES = ("cells", "select", "describe")   # bit k of the launch's mask: pass k
ALL_STAGES = 7

# How far the kernel may sit from its plain form on the same pyramid.
# SCORE_RTOL: a FAST score is a sum of up to 16 non-negative f32 terms that
# both forms round alike; any order of such a sum is within 15 ulp-units
# (15 x 2^-24) of the exact sum, so two orders differ by less than 2e-6 of
# it. DECISION_TOL: an NMS comparison (a score against its neighbours'
# maximum) can take the other side only where the two plain values sit
# within twice that of each other.
SCORE_RTOL = 2e-6
DECISION_TOL = 4e-6
# ANGLE_ULP: every angle equals warp_order_angle's (the kernel's sums in its
# own order, in float32 torch) within this many units in the last place
# (atan2f's last place may round otherwise). ANGLE_TOL: the difference
# from the plain form's ic_angle, whose ~709-term sums run in another order
# (tests/test_torch_indirect.py holds the port to JAX at 1e-5); where the
# moments nearly cancel the angle is ill-conditioned and the two orders
# differ by more: such a slot is counted with its condition kappa = (sum
# of |v dx| + |v dy|) / |(m10, m01)| (a float64 sum of the same samples).
ANGLE_ULP = 1
ANGLE_TOL = 1e-5
# DESC_EDGE: a descriptor bit may differ from the plain form's (sampled at
# the kernel's pixel and angle) only where the plain form's |v_p - v_q|, in
# grey levels, is under it: the two forms rotate the pattern with other
# roundings (a few 1e-6 px). PERF.md gives the kernel's and a planted
# fault's readings on the card.
DESC_EDGE = 1e-2

ARGTYPES = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p]


def _check(pyramid, budget: int, threshold: float, cell: int, per_cell: int,
           probe: torch.Tensor | None) -> torch.device:
    """Raise on what the kernel does not take (before anything is built)."""
    if not isinstance(pyramid, (tuple, list)) or not 0 < len(pyramid) <= MAX_LEVELS:
        raise ValueError(f"orb_extract_cuda takes 1-{MAX_LEVELS} pyramid levels")
    if cell != CELL or per_cell != PER_CELL:
        raise ValueError(f"orb_extract_cuda takes {CELL}-pixel cells and {PER_CELL} corners "
                         f"a cell, got {cell} and {per_cell}")
    if isinstance(budget, bool) or not isinstance(budget, int) or budget <= 0:
        raise ValueError(f"orb_extract_cuda needs a positive integer budget, got {budget!r}")
    if not math.isfinite(float(threshold)):
        raise ValueError(f"orb_extract_cuda needs a finite threshold, got {threshold}")
    dev = pyramid[0].device
    for l, img in enumerate(pyramid):
        if img.ndim != 2 or not (2 <= img.shape[0] < MAX_SIDE and 2 <= img.shape[1] < MAX_SIDE):
            raise ValueError(f"orb_extract_cuda: level {l} must be (H, W) with sides in "
                             f"[2, {MAX_SIDE}), got {tuple(img.shape)}")
        kb.check_tensor(f"level {l}", img, tuple(img.shape), torch.float32, dev)
    if len(pyramid) * budget * 8 >= 2 ** 31 or n_pixels(pyramid) >= 2 ** 31:
        raise ValueError("orb_extract_cuda indexes with 32-bit offsets: the pyramid or the "
                         "budget is too large")
    if probe is not None:
        kb.check_tensor("probe", probe, (n_pixels(pyramid),), torch.float32, dev)
    if dev.type != "cuda":
        raise ValueError(f"orb_extract_cuda needs CUDA tensors, got {dev}")
    return dev


def n_pixels(pyramid) -> int:
    return sum(int(img.shape[0]) * int(img.shape[1]) for img in pyramid)


def n_cells(pyramid) -> int:
    return sum((int(img.shape[0]) // CELL) * (int(img.shape[1]) // CELL) for img in pyramid)


def orb_extract_cuda(pyramid, budget_per_level: int = 512, threshold: float = 12.0,
                     cell: int = CELL, per_cell: int = PER_CELL,
                     probe: torch.Tensor | None = None) -> orb.OrbFeatures:
    """Launch the kernel on the current stream: extract_orb_plain's
    features. `pyramid`: 1-8 contiguous float32 (H, W) levels on one CUDA
    device. `probe`, when given, a float32 tensor of sum(H x W) elements
    (the levels' maps one after the other): the kernel writes each level's
    FAST score map (before the NMS) over its cropped cells and the pixel
    ring that its NMS reads; the rest is left as it was. Counts its calls
    in `orb_extract_cuda.launches` (one cooperative launch each)."""
    dev = _check(pyramid, budget_per_level, threshold, cell, per_cell, probe)
    lib = kb.load(SOURCE, "orb_extract_launch", ARGTYPES)
    out, args, scratch = launch_args(pyramid, budget_per_level, threshold, probe)
    with torch.cuda.device(dev):
        err = lib.orb_extract_launch(ALL_STAGES, *args,
                                     torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise KernelLaunchError(f"orb_extract kernel launch failed: CUDA error {err}")
    orb_extract_cuda.launches += 1
    return out


def launch_args(pyramid, budget: int, threshold: float, probe: torch.Tensor | None):
    """(outputs, C arguments less the stage mask and the stream, scratch) of
    a launch on checked inputs: new tensors, and the scratch tensors the
    arguments point into, which the caller holds until the launch is
    enqueued (the last, the grid barrier, is the device's own and lives
    on)."""
    dev = pyramid[0].device
    L, B, C = len(pyramid), budget, n_cells(pyramid)
    pattern = orb._pattern_dev(dev)
    if pattern.data_ptr() % PATTERN_ALIGN:
        raise ValueError("orb_extract_cuda: the BRIEF pattern must be 16-byte aligned")
    scratch = (torch.empty(max(C, 1) * PER_CELL, dtype=torch.float32, device=dev),
               torch.empty(max(C, 1) * PER_CELL, dtype=torch.int32, device=dev),
               torch.empty(L * B, dtype=torch.int32, device=dev),
               torch.empty(L * B, dtype=torch.float32, device=dev),
               torch.empty(max(C, 1) * PER_CELL * SELECT_PARTS * 2, dtype=torch.int32,
                           device=dev),
               kb.grid_barrier(dev, "orb_extract"))
    out = orb.OrbFeatures(
        uv=torch.empty((L * B, 2), dtype=torch.float32, device=dev),
        level=torch.empty(L * B, dtype=torch.int32, device=dev),
        angle=torch.empty(L * B, dtype=torch.float32, device=dev),
        score=torch.empty(L * B, dtype=torch.float32, device=dev),
        desc=torch.empty((L * B, 8), dtype=torch.int32, device=dev),
        valid=torch.empty(L * B, dtype=torch.bool, device=dev))
    outs = (out.uv, out.level, out.angle, out.score, out.desc, out.valid)
    args = (L, (ctypes.c_void_p * L)(*(img.data_ptr() for img in pyramid)),
            (ctypes.c_int * (2 * L))(*(int(d) for img in pyramid for d in img.shape)), B,
            float(threshold), pattern.data_ptr(), None if probe is None else probe.data_ptr(),
            (ctypes.c_void_p * len(scratch))(*(x.data_ptr() for x in scratch)),
            (ctypes.c_void_p * 6)(*(x.data_ptr() for x in outs)))
    return out, args, scratch


orb_extract_cuda.launches = 0


def vector_levels(pyramid) -> list[bool]:
    """Per level, whether the kernel copies its rows 16 bytes at a time (a
    16-byte aligned level whose width is a multiple of 4) rather than 4."""
    L = len(pyramid)
    lib = kb.load(SOURCE, "orb_extract_vector_levels",
                  [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p])
    out = (ctypes.c_int * L)()
    err = lib.orb_extract_vector_levels(
        L, (ctypes.c_void_p * L)(*(img.data_ptr() for img in pyramid)),
        (ctypes.c_int * (2 * L))(*(int(d) for img in pyramid for d in img.shape)), out)
    if err != 0:
        raise KernelLaunchError(f"orb_extract_vector_levels: CUDA error {err}")
    return [bool(v) for v in out]


def grid_blocks(dev: torch.device) -> int:
    """The blocks of the kernel's co-resident grid on CUDA device `dev`."""
    lib = kb.load(SOURCE, "orb_extract_grid_blocks", [ctypes.c_void_p])
    out = ctypes.c_int()
    with torch.cuda.device(dev):
        err = lib.orb_extract_grid_blocks(ctypes.byref(out))
    if err != 0:
        raise KernelLaunchError(f"orb_extract_grid_blocks: CUDA error {err}")
    return out.value


def new_probe(pyramid) -> torch.Tensor:
    """A probe buffer for orb_extract_cuda (zeros)."""
    return torch.zeros(n_pixels(pyramid), dtype=torch.float32, device=pyramid[0].device)


def probe_maps(probe: torch.Tensor, pyramid) -> list[torch.Tensor]:
    """The probe buffer as the levels' (H, W) maps (views)."""
    maps, at = [], 0
    for img in pyramid:
        H, W = img.shape
        maps.append(probe[at:at + H * W].view(H, W))
        at += H * W
    return maps


def level_candidate_scores(pyramid, threshold: float, cell: int = CELL,
                           per_cell: int = PER_CELL) -> list[torch.Tensor]:
    """Per level, from the plain form: its candidates' scores (each cell's
    top `per_cell` after the NMS), in candidate order."""
    return [orb._grid_topk(orb.nms_map(fast_score_map(img, threshold)), cell, per_cell)[1]
            for img in pyramid]


def ties_at_budget(pyramid, budget: int, threshold: float, cell: int = CELL,
                   per_cell: int = PER_CELL) -> list[dict]:
    """Per level, from the plain form: its candidates, the score of rank
    budget - 1 (the last that owns a slot; None where every candidate owns
    one), and how many candidates share that score above the cut (taken)
    and below it (left): both nonzero where the budget splits a group of
    equal scores."""
    out = []
    for sc in level_candidate_scores(pyramid, threshold, cell, per_cell):
        n = int(sc.shape[0])
        if n <= budget:
            out.append({"candidates": n, "key": None, "taken": 0, "left": 0})
            continue
        key = float(torch.sort(sc, descending=True).values[budget - 1])
        equal = int((sc == key).sum())
        taken = budget - int((sc > key).sum())
        out.append({"candidates": n, "key": key, "taken": taken, "left": equal - taken})
    return out


def _unpack(desc: torch.Tensor) -> torch.Tensor:
    """(K, 8) int32 words -> (K, 256) bool, bit j of word w = pair 32 w + j."""
    shifts = torch.arange(32, dtype=torch.int64, device=desc.device)
    return ((desc.to(torch.int64)[..., None] >> shifts) & 1).reshape(desc.shape[0], -1).bool()


def warp_order_angle(img: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """The kernel's angle at the level pixels uv (K, 2), in float32:
    lane k's sums of v dx and v dy over the 31 x 31 offsets q = k, k + 32,
    ... (0 outside the disk), in that order, a butterfly of 16, 8, 4, 2, 1,
    then atan2. One torch op a rounding, as the kernel's (no contraction)."""
    H, W = img.shape
    r = orb._HALF
    side = 2 * r + 1
    rounds = (side * side + 31) // 32
    q = torch.arange(32 * rounds, device=img.device)
    oy, ox = q // side - r, q % side - r
    disk = (q < side * side) & (ox * ox + oy * oy <= r * r)
    u, v = uv[:, 0].long(), uv[:, 1].long()
    y = (v[:, None] + oy).clamp(0, H - 1)
    x = (u[:, None] + ox).clamp(0, W - 1)
    vals = torch.where(disk, img[y, x], torch.zeros((), device=img.device))
    lanes = torch.arange(32, device=img.device)
    m = []
    for o in (ox, oy):
        terms = (vals * o.float()).view(-1, rounds, 32)
        s = torch.zeros_like(terms[:, 0])
        for k in range(rounds):
            s = s + terms[:, k]
        for sh in (16, 8, 4, 2, 1):
            s = s + s[:, lanes ^ sh]
        m.append(s[:, 0])
    return torch.atan2(m[1], m[0])


def _wrapped(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """|a - b| in float64, wrapped to [0, pi]."""
    d = torch.remainder(a.double() - b.double() + math.pi, 2 * math.pi)
    return (d - math.pi).abs()


def _kappa(img: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """The angle's condition kappa = (sum |v dx| + |v dy|) / |(m10, m01)| in
    float64, from the plain form's samples at the level pixels uv (K, 2)."""
    offs, w = orb._ic_offsets(uv.device)
    pts = uv[:, None, :] + offs[None, :, :]
    vals = (orb.bilinear(img, pts) * w).double()
    o = offs.double()
    m = torch.hypot((vals * o[:, 0]).sum(1), (vals * o[:, 1]).sum(1))
    s = (vals.abs() * (o[:, 0].abs() + o[:, 1].abs())).sum(1)
    return s / m


def parity(got: orb.OrbFeatures, pyramid, budget: int, threshold: float,
           probe: torch.Tensor, want: orb.OrbFeatures | None = None,
           cell: int = CELL, per_cell: int = PER_CELL) -> dict:
    """The kernel's features `got` and FAST maps `probe` (the buffer of its
    call) against the plain form on the same pyramid. `ok` when:
      - the maps: the same corners (score > 0) as fast_score_map's, each
        score within SCORE_RTOL of it, over the cropped cells and the ring
        their NMS reads;
      - where the NMS keeps a pixel in one map and not the other, the plain
        score and its neighbours' maximum sit within DECISION_TOL (each
        such pixel listed);
      - the slots: exactly select_level's (the NMS, the cells' and the
        level's stable top-k) on the kernel's own maps: pixel, score bits,
        validity and level (a slot can differ from the plain form's only
        through a map value, so only at such a tie);
      - every angle within ANGLE_ULP units in the last place of
        warp_order_angle's at its pixel;
      - each descriptor bit equal to the plain sampling's at its pixel and
        angle, except where |v_p - v_q| < DESC_EDGE (counted).
    `max_abs_err`: the largest angle difference from ic_angle at the
    kernel's pixel, over every slot; the slots beyond ANGLE_TOL of it are
    counted, with the least kappa among them and their largest angle
    difference over kappa. With `want` (extract_orb_plain's features) it
    also counts the slots whose pixel or validity differs from the plain
    form's, and of those that agree the largest angle difference and the
    bits that differ, with their largest |v_p - v_q| in the plain form's
    sampling at its own angle and how many reach DESC_EDGE."""
    B = budget
    maps = probe_maps(probe, pyramid)
    nms_flips, bad_flips = [], 0
    support, score_rel, select_equal = True, 0.0, True
    angle_err, off_model, vs_model = 0.0, 0, 0.0
    beyond_tol, min_kappa_beyond, per_kappa = 0, math.inf, 0.0
    bits_differ, max_gap, bits_beyond = 0, 0.0, 0
    differing_slots, angle_vs_plain, bits_vs_plain, gap_vs_plain, beyond_vs_plain = 0, 0.0, 0, 0.0, 0
    for l, img in enumerate(pyramid):
        H, W = img.shape
        Hc, Wc = H // cell, W // cell
        rh, rw = min(H, Hc * cell + 1), min(W, Wc * cell + 1)
        plain = fast_score_map(img, threshold)
        kmap = plain.clone()
        kmap[:rh, :rw] = maps[l][:rh, :rw]
        a, b = kmap[:rh, :rw], plain[:rh, :rw]
        support &= bool(torch.equal(a > 0, b > 0))
        rel = torch.where(b > 0, (a - b).abs() / b.clamp_min(1e-30), (a - b).abs())
        score_rel = max(score_rel, float(rel.max()) if rel.numel() else 0.0)
        keep_k = orb.nms_map(kmap)[: Hc * cell, : Wc * cell] > 0
        keep_p = orb.nms_map(plain)[: Hc * cell, : Wc * cell] > 0
        for y, x in (keep_k != keep_p).nonzero().tolist():
            s = float(plain[y, x])
            nb = plain[max(y - 1, 0):y + 2, max(x - 1, 0):x + 2].flatten().tolist()
            nb.remove(s)
            m = max(nb)
            near = abs(s - m) <= DECISION_TOL * max(abs(s), abs(m))
            bad_flips += not near
            nms_flips.append({"level": l, "pixel": [x, y], "kernel_keeps": bool(keep_k[y, x]),
                              "plain_score": s, "plain_neighbour_max": m, "near_tie": near})
        uv_l, top, ok = orb.select_level(kmap, B, cell, per_cell)
        sl = slice(l * B, (l + 1) * B)
        scale = float(2 ** l)
        select_equal &= bool(torch.equal(got.uv[sl], (uv_l + 0.5) * scale - 0.5)
                             and torch.equal(got.score[sl].view(torch.int32),
                                             top.view(torch.int32))
                             and torch.equal(got.valid[sl], ok)
                             and bool((got.level[sl] == l).all()))
        # the kernel's own pixels at this level
        uv_k = (got.uv[sl] + 0.5) / scale - 0.5
        ang = got.angle[sl]
        model = warp_order_angle(img, uv_k)
        ulp = torch.nextafter(model.abs(), torch.full_like(model, math.inf)) - model.abs()
        d_model = (ang - model).abs()
        off_model += int((~(d_model <= ANGLE_ULP * ulp)).sum())     # a NaN too
        vs_model = max(vs_model, float(torch.nan_to_num(d_model, nan=math.inf).max()))
        d = torch.nan_to_num(_wrapped(ang, orb.ic_angle(img, uv_k)), nan=math.inf)
        angle_err = max(angle_err, float(d.max()))
        far = d > ANGLE_TOL
        if bool(far.any()):
            kappa = _kappa(img, uv_k)[far]
            beyond_tol += int(far.sum())
            min_kappa_beyond = min(min_kappa_beyond, float(kappa.min()))
            per_kappa = max(per_kappa, float((d[far] / kappa).max()))
        vals = orb.brief_values(img, uv_k, ang)
        bits_k = _unpack(got.desc[sl])
        diff = (vals[..., 0] < vals[..., 1]) != bits_k
        gap = (vals[..., 0] - vals[..., 1]).abs()[diff]
        bits_differ += int(diff.sum())
        if gap.numel():
            max_gap = max(max_gap, float(gap.max()))
            bits_beyond += int((gap >= DESC_EDGE).sum())
        if want is not None:
            same = (got.uv[sl] == want.uv[sl]).all(1) & (got.valid[sl] == want.valid[sl])
            differing_slots += int((~same).sum())
            if bool(same.any()):
                angle_vs_plain = max(angle_vs_plain, float(
                    _wrapped(ang[same], want.angle[sl][same]).max()))
                vals_p = orb.brief_values(img, uv_k[same], want.angle[sl][same])
                diff_p = bits_k[same] != _unpack(want.desc[sl][same])
                gap_p = (vals_p[..., 0] - vals_p[..., 1]).abs()[diff_p]
                bits_vs_plain += int(diff_p.sum())
                if gap_p.numel():
                    gap_vs_plain = max(gap_vs_plain, float(gap_p.max()))
                    beyond_vs_plain += int((gap_p >= DESC_EDGE).sum())
    rep = {"ok": False, "support_equal": support, "max_score_rel": score_rel,
           "nms_flips": nms_flips, "nms_flips_off_tie": bad_flips,
           "selection_equal": select_equal, "angles_off_model": off_model,
           "max_angle_vs_model": vs_model, "max_abs_err": angle_err,
           "angles_beyond_tol": beyond_tol,
           "min_kappa_beyond_tol": min_kappa_beyond if beyond_tol else None,
           "max_angle_per_kappa": per_kappa,
           "bits_differing": bits_differ, "max_gap_differing_bit": max_gap,
           "bits_beyond_edge": bits_beyond}
    rep["ok"] = (support and score_rel <= SCORE_RTOL and bad_flips == 0 and select_equal
                 and off_model == 0 and bits_beyond == 0)
    if want is not None:
        rep.update({"differing_slots": differing_slots, "max_angle_vs_plain": angle_vs_plain,
                    "bits_differing_vs_plain": bits_vs_plain,
                    "max_gap_vs_plain": gap_vs_plain,
                    "bits_beyond_edge_vs_plain": beyond_vs_plain})
    return rep
