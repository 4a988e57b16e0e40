"""The direct path's keyframe programs on the card (csrc/kf_activate.cu,
csrc/kf_refresh.cu), held to their plain forms: `_activate_and_clear` and
`add_points` bit for bit (ops/kf_programs.activate_parity), and
`_refresh_after_kf` and its pieces by kf_programs.refresh_parity (the
arena and the selection bit for bit, the tracker reference within its
stated edges) and bit for bit where they take no point transform. Seeded
windows at 640x480 (the smoke's configuration) and 160x120: a window
after three keyframes with a third of its candidates matured, an arena
whose ready and waiting candidates interleave with fewer free point slots
than ready ones, an all-invalid window (the range's median 1.0), a flat
keyframe (every cell's score 0: the top k by index), a window whose points
crowd a few 4x4 cells of the keyframe (the z-buffer decides), a keyframe
flat below its top third (the top k's cut among equal scores, regions whose
quantile is 0), and a window of 1,500 point slots (no power of two: the
range's selection and the scans' runs); one launch a call, each piece alone
too (the seed and the reference of given points as plain launches, the
others on the grid their stage needs).

This file imports only torch, numpy, pytest and the port, so that it runs on
the card machine (which has no JAX package):

    python -m pytest --noconftest -q tests/test_torch_card_kf.py

Without a card every case skips. tests/test_torch_kf_programs.py imports
the case builders from here.
"""

import dataclasses

import numpy as np
import pytest
import torch

from libcml_tpu_torch.core.camera import PinholeCamera
from libcml_tpu_torch.core.lie import SE3
from libcml_tpu_torch.data.synthetic import SyntheticScene, forward_trajectory
from libcml_tpu_torch.models.direct import selector, tracer, tracker
from libcml_tpu_torch.models.direct import window as win
from libcml_tpu_torch.models.direct.config import DirectConfig
from libcml_tpu_torch.ops import kf_programs as kfp
from libcml_tpu_torch.ops.image import build_gradient_pyramid
from libcml_tpu_torch.runtime import odometry

torch.set_num_threads(1)

# the smoke's configuration (workload.BENCH_CFG) and a small one
SIZES = {"640x480": (640, 480, DirectConfig(num_levels=4, max_points=2048, points_per_kf=512,
                                            init_points=512, max_frames=7)),
         "160x120": (160, 120, DirectConfig(num_levels=3, max_points=256, points_per_kf=64,
                                            init_points=256, max_frames=4))}
CASES = ("window", "overflow", "all_invalid", "flat", "crowded", "half_flat", "p1500")
KF_FRAMES = (0, 2, 4)
REFRESH_FRAME = 6


def camera(W: int, H: int) -> PinholeCamera:
    f = 520.0 * W / 640
    return PinholeCamera.make(f, f, W / 2 - 0.5, H / 2 - 0.5, W, H)


@dataclasses.dataclass
class KfCase:
    window: win.Window
    immature: tracer.ImmatureArena
    kf_pyr: tuple
    slot: int
    cam: PinholeCamera
    cfg: DirectConfig

    def to(self, dev) -> "KfCase":
        mv = (lambda x: x.to(dev) if isinstance(x, torch.Tensor) else x)
        ba = self.window.ba
        ba = ba.replace(**{f.name: (SE3(R=mv(getattr(ba, f.name).R), t=mv(getattr(ba, f.name).t))
                                    if isinstance(getattr(ba, f.name), SE3)
                                    else mv(getattr(ba, f.name)))
                           for f in dataclasses.fields(ba)})
        return dataclasses.replace(
            self, window=self.window.replace(ba=ba, images=mv(self.window.images),
                                             frame_id=mv(self.window.frame_id)),
            immature=self.immature.map(mv), kf_pyr=tuple(mv(x) for x in self.kf_pyr))


def _frames(cam: PinholeCamera, n: int) -> dict:
    """The rendered keyframes (pyramid, inverse depth, pose) of frames
    KF_FRAMES and REFRESH_FRAME of an n-frame sequence (rendered on the card
    where there is one)."""
    scene = SyntheticScene.default(cam, seed=3)
    traj = forward_trajectory(n, step=0.05, yaw_rate=0.003)
    out = {}
    for i in (*KF_FRAMES, REFRESH_FRAME):
        R, t = traj[i]
        if torch.cuda.is_available():
            img, idep = (x.cpu() for x in scene.render_device(R, t, torch.device("cuda")))
        else:
            img, idep = (torch.tensor(np.asarray(x, np.float32)) for x in scene.render(R, t))
        out[i] = (build_gradient_pyramid(img.float(), 4), idep.float().numpy(), R, t)
    return out


_FRAMES: dict = {}


def kf_case(name: str, size: str = "160x120") -> KfCase:
    """A seeded keyframe-event state on the CPU, built with the plain forms
    (deterministic): keyframes at frames 0, 2, 4 (slots 0-2, poses a few
    mm and mrad off the truth), points of each at their true inverse depth,
    each slot's arena row seeded with a third of its candidates matured
    (an interval of +-2 % around the truth, 3 traces), then frame 6
    inserted as the keyframe of the refresh (slot 3). `name` picks the
    variant (CASES)."""
    W, H, cfg = SIZES[size]
    if name == "p1500":
        cfg = dataclasses.replace(cfg, max_points=1500)
    cam = camera(W, H)
    if size not in _FRAMES:
        _FRAMES[size] = _frames(cam, REFRESH_FRAME + 1)
    frames = _FRAMES[size]
    rng = np.random.default_rng(7)
    L = cfg.num_levels
    w = win.empty_window(cfg, H, W)
    imm = tracer.empty_immatures(cfg.max_frames, cfg.points_per_kf)
    n_pts = cfg.max_points // 8
    for i in KF_FRAMES:
        pyr, idep, R, t = frames[i]
        xi = rng.normal(0, 0.003, 6).astype(np.float32) if i else np.zeros(6, np.float32)
        T = SE3(R=torch.tensor(np.asarray(R, np.float32)),
                t=torch.tensor(np.asarray(t, np.float32) + xi[:3]))
        w, slot = win.add_keyframe(w, pyr[0], T, torch.zeros(2), i)
        uv, valid, _ = selector.select_points_plain(pyr[0], n_pts)
        ui = uv.long().numpy()
        rho = torch.tensor(idep[np.clip(ui[:, 1], 0, H - 1), np.clip(ui[:, 0], 0, W - 1)])
        ok = valid & (rho > 1e-3)
        if name == "all_invalid":
            ok = torch.zeros_like(ok)
        w = win.add_points_plain(w, int(slot), uv, rho, ok, cfg)
        cu, cv, _ = selector.select_points_plain(pyr[0], cfg.points_per_kf)
        imm = tracer.seed_immatures_plain(imm, int(slot), pyr[0], cu, cv, torch.tensor(0.05),
                                          torch.tensor(2.0))
        ci = cu.long().numpy()
        true = torch.tensor(idep[np.clip(ci[:, 1], 0, H - 1), np.clip(ci[:, 0], 0, W - 1)])
        mature = torch.tensor(rng.random(cfg.points_per_kf) < 1 / 3) & (true > 1e-3)
        s = int(slot)
        imm.rho_lo[s] = torch.where(mature, true * 0.98, imm.rho_lo[s])
        imm.rho_hi[s] = torch.where(mature, true * 1.02, imm.rho_hi[s])
        imm.n_ok[s] = torch.where(mature, 3, 1).int()
    if name == "all_invalid":
        imm = imm.replace(valid=torch.zeros_like(imm.valid))
    if name == "overflow":
        # ready and waiting candidates interleave; the arena's free slots
        # are scattered and fewer than the ready candidates
        P = cfg.max_points
        pv = torch.tensor(rng.random(P) < 0.75)
        w = w.replace(ba=w.ba.replace(point_valid=pv))
        K = cfg.points_per_kf
        rows = torch.tensor([s for s in range(len(KF_FRAMES))])
        alt = (torch.arange(K) % 3 != 1)
        imm.n_ok[rows] = torch.where(alt, 3, 0).int()
        imm.valid[rows] = True
        imm.rho_lo[rows] = 0.5
        imm.rho_hi[rows] = 0.51
    if name == "crowded":
        # a third of the points crowd 8 pixels of slot 0 at two depths: the
        # z-buffer keeps the near ones
        ba = w.ba
        m = torch.arange(ba.uv.shape[0]) % 3 == 0
        spots = torch.tensor([[W * 0.3 + 4 * (j % 4), H * 0.4 + 4 * (j // 4)]
                              for j in range(8)], dtype=torch.float32)
        uv = torch.where(m[:, None], spots[torch.arange(ba.uv.shape[0]) % 8], ba.uv)
        rho = torch.where(m, torch.where(torch.arange(ba.uv.shape[0]) % 2 == 0, 0.6, 0.3),
                          ba.idepth)
        w = w.replace(ba=ba.replace(uv=uv, idepth=rho, idepth_fej=rho,
                                    host=torch.where(m, 0, ba.host).int()))
    pyr, _, R, t = frames[REFRESH_FRAME]
    if name == "flat":
        pyr = tuple(torch.stack([torch.full_like(p[..., 0], 100.0), torch.zeros_like(p[..., 1]),
                                 torch.zeros_like(p[..., 2])], -1) for p in pyr)
    if name == "half_flat":
        pyr = tuple(p.clone() for p in pyr)
        for p in pyr:
            p[p.shape[0] // 3:] = torch.tensor([100.0, 0.0, 0.0])
    T = SE3(R=torch.tensor(np.asarray(R, np.float32)), t=torch.tensor(np.asarray(t, np.float32)))
    w, slot = win.add_keyframe(w, pyr[0], T, torch.zeros(2), REFRESH_FRAME)
    return KfCase(w, imm, pyr[:L], int(slot), cam, cfg)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no CPU mode")
    return torch.device("cuda")


_CUDA_CASES: dict = {}


def _case(name: str, size: str, dev) -> KfCase:
    key = (name, size)
    if key not in _CUDA_CASES:
        _CUDA_CASES[key] = kf_case(name, size).to(dev)
    return _CUDA_CASES[key]


@pytest.mark.parametrize("size", list(SIZES))
@pytest.mark.parametrize("name", CASES)
def test_cuda_activate_and_clear(cuda, name, size):
    c = _case(name, size, cuda)
    before = kfp.kf_activate_cuda.launches
    got = odometry._activate_and_clear(c.window, c.immature, c.cfg)
    assert kfp.kf_activate_cuda.launches == before + 1
    want = odometry._activate_and_clear_plain(c.window, c.immature, c.cfg)
    rep = kfp.activate_parity(got, want)
    assert rep["ok"], rep
    if name in ("window", "overflow"):
        assert int(got[0].ba.point_valid.sum()) > int(c.window.ba.point_valid.sum())
    if name == "overflow":
        assert int((~c.window.ba.point_valid).sum()) < int((c.immature.valid
                                                            & (c.immature.n_ok >= 2)).sum())


@pytest.mark.parametrize("slot_kind", ["tensor", "int"])
@pytest.mark.parametrize("size", list(SIZES))
def test_cuda_add_points(cuda, size, slot_kind):
    c = _case("overflow", size, cuda)
    K = c.cfg.points_per_kf
    g = torch.Generator().manual_seed(3)
    uv = (torch.rand((K, 2), generator=g) * torch.tensor([c.cam.width - 1.0,
                                                          c.cam.height - 1.0])).to(cuda)
    rho = (torch.rand(K, generator=g) * 2 - 0.2).to(cuda)     # some under idepth_min
    valid = (torch.rand(K, generator=g) < 0.6).to(cuda)
    slot = torch.tensor(2, device=cuda) if slot_kind == "tensor" else 2
    before = kfp.kf_activate_cuda.launches
    got = win.add_points(c.window, slot, uv, rho, valid, c.cfg)
    assert kfp.kf_activate_cuda.launches == before + 1
    want = win.add_points_plain(c.window, 2, uv, rho, valid, c.cfg)
    assert kfp.activate_parity((got, None), (want, None))["ok"]


@pytest.mark.parametrize("size", list(SIZES))
@pytest.mark.parametrize("name", CASES)
def test_cuda_refresh_after_kf(cuda, name, size):
    c = _case(name, size, cuda)
    before = kfp.kf_refresh_cuda.launches
    got = odometry._refresh_after_kf(c.window, c.slot, c.kf_pyr, c.immature, c.cam, c.cfg)
    assert kfp.kf_refresh_cuda.launches == before + 1
    want = odometry._refresh_after_kf_plain(c.window, c.slot, c.kf_pyr, c.immature, c.cam,
                                            c.cfg)
    rep = kfp.refresh_parity(got, want, c.window.ba, c.slot, c.cam, c.kf_pyr, c.cfg)
    assert rep["ok"], rep
    if name == "all_invalid":
        assert not bool(got[0].valid.any())
        lo, hi = odometry._working_rho_range(c.window.ba, c.cfg)
        assert float(lo) == float(np.float32(1.0 / 8)) and float(hi) == 8.0
    if name == "flat":   # every score 0: the first k cells in index order, none valid
        assert not bool(got[1].valid[c.slot].any())


@pytest.mark.parametrize("size", list(SIZES))
@pytest.mark.parametrize("name", CASES)
def test_cuda_refresh_pieces(cuda, name, size):
    """Each piece alone, one launch: the range and the selection bit for
    bit, the seed bit for bit, make_tracker_ref of given points bit for
    bit, the window's reference under refresh_parity's rules."""
    c = _case(name, size, cuda)
    ba = c.window.ba
    n = kfp.kf_refresh_cuda.launches
    lo, hi = odometry._working_rho_range(ba, c.cfg)
    plo, phi = odometry._working_rho_range_plain(ba, c.cfg)
    assert kfp._bits_equal(lo, plo) and kfp._bits_equal(hi, phi)
    for npts in (c.cfg.points_per_kf, c.cfg.init_points, 7):
        got = selector.select_points(c.kf_pyr[0], npts)
        want = selector.select_points_plain(c.kf_pyr[0], npts)
        assert all(kfp._bits_equal(a, b) for a, b in zip(got, want)), npts
    uv, valid, _ = got
    K = c.cfg.points_per_kf
    uv, valid, _ = selector.select_points_plain(c.kf_pyr[0], K)
    a = tracer.seed_immatures(c.immature, c.slot, c.kf_pyr[0], uv, valid, plo, phi)
    b = tracer.seed_immatures_plain(c.immature, c.slot, c.kf_pyr[0], uv, valid, plo, phi)
    assert all(kfp._bits_equal(getattr(a, f), getattr(b, f)) for f in kfp._ARENA_FIELDS)
    idepth = ba.idepth.clone()
    ra = tracker.make_tracker_ref(c.kf_pyr, c.cam, ba.uv, idepth, ba.point_valid, c.cfg)
    rb = tracker.make_tracker_ref_plain(c.kf_pyr, c.cam, ba.uv, idepth, ba.point_valid, c.cfg)
    assert all(kfp._bits_equal(getattr(ra, f), getattr(rb, f))
               for f in ("uv", "color", "weight", "valid"))
    rw = odometry._tracker_ref_in_frame(c.window, c.slot, c.kf_pyr, c.cam, c.cfg)
    rp = odometry._tracker_ref_in_frame_plain(c.window, c.slot, c.kf_pyr, c.cam, c.cfg)
    rep = kfp.refresh_parity((rw, a), (rp, a), ba, c.slot, c.cam, c.kf_pyr, c.cfg)
    assert rep["ok"], rep
    assert kfp.kf_refresh_cuda.launches == n + 1 + 3 + 1 + 1 + 1


def test_cuda_dispatch_raises_on_other_devices():
    """A tensor on neither the CPU nor a card raises (no fallback)."""
    meta = torch.empty((64, 64, 3), device="meta")
    with pytest.raises(ValueError):
        selector.select_points(meta, 8)
