"""The epipolar tracer's kernel modelled on the CPU and held to the plain form
and to the JAX package; its dispatch and its wrapper's checks; the card test
files' imports.

csrc/trace_epipolar.cu cannot run here. A torch model of it stands in: a
warp an arena entry with its 32 lanes written out (lane l holds hypothesis
l >> 1 and the pattern pixels of the parity of l), every op rounded on its
own as the kernel's __fmul_rn / __fadd_rn / __fdiv_rn, the relative pose
computed in the warp, the 3x3 products as the kernel's fused multiply-add
chains (emulated in float64), a division by a Python number taken as a
product with the float reciprocal, a hypothesis's SSD summed as
((0+4)+(2+6)) + ((1+5)+(3+7)), its two halves added by a shuffle, the
argmin as two redux.sync minima (over each SSD's bits, a NaN the least key,
then over the hypotheses that hold the least: the first occurrence), the
second best, the runner-up and the border margin as minima over bits, f0,
f1, f2 read from their lanes, lane 0's update; untraced
rows copied, a dead slot's and an invalid point's status update without a
sweep. The model is held to `trace_immatures_rows_plain` under the kernel's
own rule, `ops.trace_epipolar.parity` (statuses equal and intervals within
RHO_TOL, except where a deciding value sits within DECISION_TOL of its
threshold), and to the JAX package's `trace_immatures_rows` under the same
rule (the plain form's probes standing for JAX's deciding values), on the
seeded arenas of tests/test_torch_card_trace.py at 160x120: the recent rows,
padding, a dead slot, a NaN observer pose, all padding, intervals so wide
that a point's near hypotheses leave the image; three seeds each.
"""

import dataclasses
import re
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import libcml_tpu.models.direct.tracer as jtr
from libcml_tpu.core.camera import PinholeCamera as JCam
from libcml_tpu.core.lie import SE3 as JSE3
from libcml_tpu.models.direct.config import DirectConfig as JCfg

from libcml_tpu_torch import convert
from libcml_tpu_torch.models.direct import tracer
from libcml_tpu_torch.models.direct.residuals import PATTERN
from libcml_tpu_torch.ops import trace_epipolar as te
from libcml_tpu_torch.ops.image import bilinear
from test_torch_card_trace import CAM, CAM_ARGS, CASES, CFG, CFG_KW, SEEDS, trace_case

torch.set_num_threads(1)

JCAM, JCFG = JCam.make(*CAM_ARGS), JCfg(**CFG_KW)
LANES = torch.arange(32)
F32 = torch.float32
BIG = torch.tensor(1e12, dtype=F32)


def _f(x) -> torch.Tensor:
    return torch.tensor(x, dtype=F32)


def _fma(a, b, c):
    """a b + c rounded once to float32 (in float64: a b is exact there)."""
    return (a.double() * b.double() + c.double()).float()


def _dot3(a, b):
    """fma(a2, b2, fma(a1, b1, a0 b0)): the kernel's matrix-product dot."""
    return _fma(a[2], b[2], _fma(a[1], b[1], a[0] * b[0]))


def _mv3(a, b):
    """fma(a1, b1, a0 b0) + a2 b2: the kernel's matrix-vector dot."""
    return _fma(a[1], b[1], a[0] * b[0]) + a[2] * b[2]


def _shfl(x: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """x[..., src] along the lane axis: a shuffle, src (32,) a lane each."""
    return torch.gather(x, -1, src.expand(x.shape))


def _bits(x: torch.Tensor) -> torch.Tensor:
    """A float32 tensor's bits as non-negative int64 (__float_as_uint)."""
    return x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF


def _float(bits: torch.Tensor) -> torch.Tensor:
    """__uint_as_float."""
    return (bits & 0xFFFFFFFF).to(torch.int64).to(torch.int32).view(torch.float32)


def _redux_min(x: torch.Tensor) -> torch.Tensor:
    """__reduce_min_sync over the lane axis (every lane gets the least)."""
    return x.min(dim=-1, keepdim=True).values.expand(x.shape)


def _argmin_first(ssd: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """csrc/trace_epipolar.cu argmin_first: the least key (0 for a NaN, else
    the bits plus one), then the least hypothesis among the lanes that hold
    it; ssd (..., 32) >= 0 or NaN."""
    key = torch.where(torch.isnan(ssd), 0, _bits(ssd) + 1)
    kmin = _redux_min(key)
    return _redux_min(torch.where(key == kmin, s.expand(ssd.shape), torch.full_like(key, 16)))


def _warp_min_nan(x: torch.Tensor) -> torch.Tensor:
    """csrc/trace_epipolar.cu warp_min_nan: a NaN wins (x >= 0)."""
    kmin = _redux_min(torch.where(torch.isnan(x), 0, _bits(x) + 1))
    return torch.where(kmin == 0, _float(torch.full_like(kmin, 0x7FFFFFFF)), _float(kmin - 1))


def _warp_fmin(x: torch.Tensor) -> torch.Tensor:
    """csrc/trace_epipolar.cu warp_fmin: a NaN loses (x >= 0)."""
    kmin = _redux_min(torch.where(torch.isnan(x), 0xFFFFFFFF, _bits(x)))
    return torch.where(kmin == 0xFFFFFFFF, _float(torch.full_like(kmin, 0x7FFFFFFF)),
                       _float(kmin))


def _model_sweep(arena, f: int, T_host, T_obs, obs_grad, cam, cfg, fault=None):
    """One row's warps (K points x 32 lanes): (lo', hi', n_ok', n_fail',
    valid', probes (K, 7)) of a swept row whose points are all swept.
    `fault` plants a wrong kernel (FAULTS) for parity to catch."""
    R_h, t_h = T_host
    Rt = [[R_h[j, i] for j in range(3)] for i in range(3)]
    ti = [-_mv3(Rt[i], t_h) for i in range(3)]
    Ro = [[T_obs.R[i, j] for j in range(3)] for i in range(3)]
    Roh = [[_dot3(Ro[i], [Rt[0][j], Rt[1][j], Rt[2][j]]) for j in range(3)] for i in range(3)]
    toh = [_mv3(Ro[i], ti) + T_obs.t[i] for i in range(3)]

    dev = arena.uv.device
    lanes = LANES.to(dev)
    s, half = lanes >> 1, lanes & 1
    lo_in, hi_in = arena.rho_lo[f][:, None], arena.rho_hi[f][:, None]     # (K, 1)
    lo = torch.log(torch.clamp(lo_in, min=1e-6))
    hi = torch.log(torch.clamp(hi_in, min=2e-6))
    width = hi - lo
    frac = torch.where(s == 15, _f(1.0), s.to(F32) * _f(np.float32(1.0 / 15)))
    lg = lo + width * frac                                                  # (K, 32)
    depth = 1.0 / torch.clamp(torch.exp(lg), min=1e-12)
    u, v = arena.uv[f][:, 0:1], arena.uv[f][:, 1:2]
    ifx, ify = _f(1.0) / _f(cam.fx), _f(1.0) / _f(cam.fy)
    u_max, v_max = float(cam.width - 3), float(cam.height - 3)
    pat = torch.tensor(PATTERN, dtype=F32, device=dev)
    sq, ok, edge = [], torch.ones_like(lg, dtype=torch.bool), torch.full_like(lg, np.inf)
    for j in range(4):
        p = half + (0, 4, 2, 6)[j]                                          # (32,)
        x = ((u + pat[p, 0]) - cam.cx) * ifx
        y = ((v + pat[p, 1]) - cam.cy) * ify
        X = [x * depth, y * depth, depth]
        Y0, Y1, z = (_dot3(Roh[i], X) + toh[i] for i in range(3))
        iz = 1.0 / torch.where(torch.abs(z) < 1e-12, _f(1e-12), z)
        uo = (cam.fx * Y0) * iz + cam.cx
        vo = (cam.fy * Y1) * iz + cam.cy
        inside = (uo >= 2.0) & (uo <= u_max) & (vo >= 2.0) & (vo <= v_max)
        if fault == "border_flipped":
            inside = ~inside
        elif fault == "border_ignored":
            inside = torch.ones_like(inside)
        ok = ok & (z > 1e-6) & inside
        edge = torch.fmin(edge, torch.fmin(torch.fmin((uo - 2.0).abs(), (uo - u_max).abs()),
                                           torch.fmin((vo - 2.0).abs(), (vo - v_max).abs())))
        d = bilinear(obs_grad[..., 0], torch.stack([uo, vo], -1)) - arena.color[f][:, p]
        sq.append(d * d)
        if j == 0:
            u_p0, v_p0 = uo, vo
    part = (sq[0] + sq[1]) + (sq[2] + sq[3])
    other = _shfl(part, lanes ^ 1)
    pair_ok = ok & _shfl(ok, lanes ^ 1)
    ssd = torch.where(pair_ok, torch.where(half == 1, other + part, part + other), BIG)

    best = _argmin_first(ssd, s)
    best_ssd = _shfl(ssd, 2 * best[:, :1].expand(-1, 32))
    second = _warp_min_nan(torch.where((s - best).abs() <= 2, BIG, ssd))
    runner = _warp_fmin(torch.where(s == best, _f(np.inf), ssd))
    edge = _warp_fmin(edge)
    # lane 0 from here on
    best, best_ssd, second, runner, edge = (x[:, 0] for x in (best, best_ssd, second, runner,
                                                                edge))
    quality = second / torch.clamp(best_ssd, min=1e-6)
    bm = torch.clamp(best, 1, 14)
    f0, f1, f2 = (torch.gather(ssd, 1, (2 * (bm + d))[:, None])[:, 0] for d in (-1, 0, 1))
    lg_bm = torch.gather(lg, 1, (2 * bm)[:, None])[:, 0]
    denom = (f0 - 2.0 * f1) + f2
    delta = torch.where(denom.abs() > 1e-9, (0.5 * (f0 - f2)) / denom, _f(0.0))
    delta = torch.clamp(delta, -1.0, 1.0)
    dlog = width[:, 0] * (_f(1.0) / _f(15.0))
    log_best = lg_bm + delta * dlog
    if fault == "refine_off":
        log_best = log_best + _f(0.02) * dlog
    reach = _f(1.2) * dlog
    du = u_p0[:, 30] - u_p0[:, 0]
    dv = v_p0[:, 30] - v_p0[:, 0]
    span = torch.sqrt(du * du + dv * dv)
    good = (best_ssd < BIG) & (best_ssd < 1152.0) & (quality > np.float32(cfg.trace_min_quality))
    informative = good & (span > 1.0)
    lo_out = torch.where(informative, torch.clamp(torch.exp(log_best - reach), min=1e-5),
                         arena.rho_lo[f])
    hi_out = torch.where(informative, torch.exp(log_best + reach), arena.rho_hi[f])
    n_fail = torch.where(good, arena.n_fail[f], arena.n_fail[f] + 1)
    if fault == "border_flipped":
        edge = torch.full_like(edge, 1.4e-45)         # an int's bits in the edge probe
    probes = torch.stack([best.to(F32), best_ssd, runner, second, span, edge, dlog], -1)
    return lo_out, hi_out, arena.n_ok[f] + informative.int(), n_fail, n_fail < 4, probes


def _model_trace_rows(arena, rows, T_hosts, host_valid, obs_grad, T_obs, cam, cfg,
                      fault=None):
    """csrc/trace_epipolar.cu in torch: (the new arena, probes (R, K, 7),
    NaN where the kernel writes none)."""
    F, K = arena.valid.shape
    out = {f.name: getattr(arena, f.name).clone() for f in dataclasses.fields(arena)}
    probes = torch.full((rows.shape[0], K, 7), float("nan"), device=arena.uv.device)
    listed = rows.tolist()
    for f in range(F):
        if f not in listed:
            continue                                      # copied through
        r = listed.index(f)                               # the ballot's first lane
        valid = arena.valid[f]
        nf = arena.n_fail[f] + valid.int()                # without a sweep: ok is false
        upd = (arena.rho_lo[f], arena.rho_hi[f], arena.n_ok[f], nf, valid & (nf < 4))
        if bool(host_valid[f]):
            swept = _model_sweep(arena, f, (T_hosts.R[f], T_hosts.t[f]), T_obs, obs_grad,
                                 cam, cfg, fault)
            upd = tuple(torch.where(valid, a, b) for a, b in zip(swept[:5], upd))
            probes[r] = torch.where(valid[:, None], swept[5], probes[r])
        for name, x in zip(("rho_lo", "rho_hi", "n_ok", "n_fail", "valid"), upd):
            out[name][f] = x
    return type(arena)(**out), probes


def _plain(c: dict):
    probes = torch.full((len(c["rows"]), CFG.points_per_kf, 7), float("nan"))
    got = tracer.trace_immatures_rows_plain(c["arena"], c["rows"], c["T_hosts"],
                                            c["host_valid"], c["obs_grad"], c["T_obs"], CAM,
                                            CFG, probes=probes)
    return got, probes


def _jax(c: dict):
    aj = jtr.ImmatureArena(**{k: jnp.asarray(v) for k, v in convert.to_np(c["arena"]).items()})
    Th, To = (JSE3(R=jnp.asarray(T.R.numpy()), t=jnp.asarray(T.t.numpy()))
              for T in (c["T_hosts"], c["T_obs"]))
    out = jtr.trace_immatures_rows(aj, jnp.asarray(c["rows"].numpy()), Th,
                                   jnp.asarray(c["host_valid"].numpy()),
                                   jnp.asarray(c["obs_grad"].numpy()), To, JCAM, JCFG)
    return convert.from_np(tracer.ImmatureArena, convert.to_np(jax.device_get(out)))


# -- the model against the plain form and the JAX package -----------------------------------


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("case", list(CASES))
def test_kernel_model_within_parity_of_plain_and_jax(case, seed):
    """Statuses equal and intervals within RHO_TOL except at a decision's
    edge (counted); untraced rows, pixels and colours bit for bit; a swept
    point for every valid point of a live traced slot."""
    c = trace_case(case, seed)
    model, pm = _model_trace_rows(c["arena"], c["rows"], c["T_hosts"], c["host_valid"],
                                  c["obs_grad"], c["T_obs"], CAM, CFG)
    plain, pp = _plain(c)
    res = te.parity(model, plain, (pm, pp), c["rows"], CFG)
    assert res["ok"], res
    live = [f for f in set(c["rows"].tolist()) if f >= 0 and bool(c["host_valid"][f])]
    assert res["swept_points"] == int(sum(c["arena"].valid[f].sum() for f in live))
    res_j = te.parity(model, _jax(c), (pm, pp), c["rows"], CFG)
    assert res_j["ok"], res_j
    if case == "nan_pose":
        # nothing is in bounds: every swept point fails, no interval moves
        for f in live:
            assert torch.equal(model.rho_lo[f], c["arena"].rho_lo[f])
            assert torch.equal(model.n_fail[f], c["arena"].n_fail[f] + c["arena"].valid[f].int())
    if case in ("recent", "padding"):
        moved = sum(int((model.rho_lo[f] != c["arena"].rho_lo[f]).sum()) for f in live)
        assert moved > 0


REDUX_CASES = ("random", "ties", "nan", "nan_and_ties", "all_failed")


@pytest.mark.parametrize("case", REDUX_CASES)
def test_redux_reductions_take_argmins_order(case):
    """The kernel's reductions over bits, as modelled: argmin_first is
    torch.argmin (the first occurrence; a NaN the smallest, its first
    occurrence), warp_min_nan torch.amin (a NaN wins) and warp_fmin a
    minimum that skips NaN (NaN only when every lane holds one); over 16
    hypotheses held by lane pairs."""
    rng = np.random.default_rng(REDUX_CASES.index(case))
    x = rng.uniform(0.0, 3000.0, (256, 16)).astype(np.float32)
    if case in ("ties", "nan_and_ties"):
        x = np.round(x / 500.0).astype(np.float32) * 500.0      # few distinct values
    if case in ("nan", "nan_and_ties"):
        x[rng.random(x.shape) < 0.15] = np.nan
        x[0] = np.nan                                            # a row of NaN alone
    if case == "all_failed":
        x[:] = np.float32(1e12)
        x[::3, 5] = 0.0                                          # an exact zero
    v = torch.tensor(x)
    lanes = v.repeat_interleave(2, dim=1)                        # (P, 32): two lanes a hypothesis
    best = _argmin_first(lanes, LANES >> 1)
    assert torch.equal(best[:, 0], torch.argmin(v, dim=1)), case
    assert bool((best == best[:, :1]).all())
    amin = _warp_min_nan(lanes)[:, 0]
    assert torch.equal(torch.isnan(amin), torch.isnan(torch.amin(v, dim=1)))
    assert torch.equal(amin.nan_to_num(-1.0), torch.amin(v, dim=1).nan_to_num(-1.0))
    fmin = _warp_fmin(lanes)[:, 0]
    skip = torch.where(torch.isnan(v), torch.full_like(v, np.inf), v).amin(dim=1)
    skip = torch.where(torch.isnan(v).all(dim=1), torch.full_like(skip, np.nan), skip)
    assert torch.equal(fmin.nan_to_num(-1.0), skip.nan_to_num(-1.0)), case


# a wrong kernel planted in the model, the case that shows it, and whether the
# plain form's probes are spoilt too
FAULTS = {
    # every in-bounds hypothesis rejected, garbage in the kernel's edge probe
    "border_flipped": ("recent", False),
    # out-of-image hypotheses accepted: points the plain form fails wholly
    "border_ignored": ("wide", False),
    # the refine off by 0.02 of a grid step
    "refine_off": ("recent", False),
    # the first, with a denormal border margin in the plain form's probes
    "plain_probe_denormal": ("recent", True),
}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_parity_catches_a_planted_fault(fault):
    """parity fails a kernel that is wrong: its own probes excuse nothing,
    nor does a sweep the plain form failed wholly, nor a probe value that
    is not sound, and RHO_TOL fails a refine off by 0.02 of a step."""
    case, spoil = FAULTS[fault]
    c = trace_case(case, 0)
    model, pm = _model_trace_rows(c["arena"], c["rows"], c["T_hosts"], c["host_valid"],
                                  c["obs_grad"], c["T_obs"], CAM, CFG,
                                  "border_flipped" if spoil else fault)
    plain, pp = _plain(c)
    if spoil:
        pp[..., te.PROBE_FIELDS.index("edge")] = 1.4e-45
    res = te.parity(model, plain, (pm, pp), c["rows"], CFG)
    assert not res["ok"], res
    assert any(not d["within"] for d in res["edge_points"])


def test_probes_hold_the_plain_forms_deciding_values():
    """The plain form's probe rows are its own argmin, SSDs, span and step:
    a point is informative exactly where its probes pass the gates."""
    c = trace_case("recent", 0)
    plain, pp = _plain(c)
    for r, f in enumerate(c["rows"].tolist()):
        p, a = pp[r], c["arena"]
        q = p[:, 3] / torch.clamp(p[:, 1], min=1e-6)
        good = (a.valid[f] & (p[:, 1] < 1e12) & (p[:, 1] < 1152.0)
                & (q > np.float32(CFG.trace_min_quality)))
        assert torch.equal(plain.n_ok[f] - a.n_ok[f], (good & (p[:, 4] > 1.0)).int())
        assert bool((p[:, 2] >= p[:, 1]).all()) and bool((p[:, 0] >= 0).all())


# -- dispatch ------------------------------------------------------------------------------


def test_cpu_tensors_take_the_plain_form(monkeypatch):
    """CPU tensors run the plain form and never reach the kernel's wrapper,
    which refuses them and counts nothing; another device raises."""
    c = trace_case("recent", 0)
    args = [c[k] for k in ("arena", "rows", "T_hosts", "host_valid", "obs_grad", "T_obs")]
    te.trace_rows_cuda.launches = 0
    want = tracer.trace_immatures_rows_plain(*args, CAM, CFG)

    def boom(*a, **k):
        raise AssertionError("a CPU tensor reached the kernel's wrapper")

    monkeypatch.setattr(tracer, "trace_rows_cuda", boom)
    got = tracer.trace_immatures_rows(*args, CAM, CFG)
    for f in dataclasses.fields(got):
        assert torch.equal(getattr(got, f.name), getattr(want, f.name)), f.name
    monkeypatch.undo()
    with pytest.raises(ValueError, match="CUDA"):
        te.trace_rows_cuda(*args, CAM, CFG)
    meta = args[0].map(lambda x: x.to("meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        tracer.trace_immatures_rows(meta, *args[1:], CAM, CFG)
    assert te.trace_rows_cuda.launches == 0


def test_card_tensors_never_take_the_plain_form(monkeypatch):
    """With the device test answering "card" for these CPU tensors, the
    dispatcher reaches the kernel's wrapper, which refuses them: no plain
    form runs."""
    c = trace_case("recent", 0)

    def boom(*a, **k):
        raise AssertionError("the card's path took the plain form")

    for name in ("trace_immatures_rows_plain", "trace_immatures"):
        monkeypatch.setattr(tracer, name, boom)
    monkeypatch.setattr(tracer, "_on_card", lambda x: True)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        tracer.trace_immatures_rows(c["arena"], c["rows"], c["T_hosts"], c["host_valid"],
                                    c["obs_grad"], c["T_obs"], CAM, CFG)


@pytest.mark.parametrize("what", ["steps", "pattern", "frames", "rows", "dtype",
                                  "noncontiguous", "shape", "probes", "misaligned"])
def test_wrapper_rejects_what_the_kernel_does_not_take(monkeypatch, what):
    """Checked before anything is built or launched."""
    c = trace_case("recent", 0)
    a = dict(arena=c["arena"], rows=c["rows"], T_hosts=c["T_hosts"],
             host_valid=c["host_valid"], obs_grad=c["obs_grad"], T_obs=c["T_obs"], cam=CAM,
             cfg=CFG, probes=None)
    err, match = ValueError, None
    if what == "steps":
        a["cfg"], match = dataclasses.replace(CFG, trace_steps=8), "hypotheses"
    elif what == "pattern":
        monkeypatch.setattr(te, "PATTERN_N", 5)
        match = "pattern"
    elif what == "frames":
        a["arena"] = tracer.empty_immatures(33, 64)
        match = "frame slots"
    elif what == "rows":
        a["rows"] = torch.full((33,), -1, dtype=torch.int32)
        match = "traced rows"
    elif what == "dtype":
        a["rows"], err, match = c["rows"].long(), TypeError, "dtype"
    elif what == "noncontiguous":
        a["obs_grad"], match = c["obs_grad"].transpose(0, 1).contiguous().transpose(0, 1), \
            "contiguous"
    elif what == "shape":
        a["arena"] = c["arena"].replace(color=c["arena"].color[..., :4].contiguous())
        match = "shape"
    elif what == "misaligned":   # a contiguous colour tensor 4 bytes past a 16-byte line
        color = c["arena"].color
        buf = torch.zeros(color.numel() + 1)
        a["arena"] = c["arena"].replace(color=buf[1:].view(color.shape))
        match = "aligned"
    else:
        a["probes"], match = torch.zeros(3, 64, 5), "shape"
    before = te.trace_rows_cuda.launches
    with pytest.raises(err, match=match):
        te.trace_rows_cuda(**a)
    assert te.trace_rows_cuda.launches == before


# -- the card test files --------------------------------------------------------------------


def test_card_test_files_import_only_the_port():
    """The card machine has no JAX package: a card test file imports
    neither jax, flax nor the JAX package (libcml_tpu without _torch)."""
    files = sorted(Path(__file__).parent.glob("test_torch_card_*.py"))
    assert {p.name for p in files} >= {"test_torch_card_hamming.py", "test_torch_card_lm.py",
                                        "test_torch_card_ba.py", "test_torch_card_trace.py"}
    banned = re.compile(r"^\s*(import|from)\s+(jax|flax|libcml_tpu)(?!_torch)\b")
    for p in files:
        bad = [f"{p.name}:{i}: {line}" for i, line in enumerate(p.read_text().splitlines(), 1)
               if banned.match(line)]
        assert not bad, bad


# -- tools/trace_stages.py ------------------------------------------------------------------


def test_trace_stages_stamps_a_throwaway_copy(tmp_path):
    """tools/trace_stages.py stamps a copy: each `// stage: NAME` mark of
    csrc/trace_epipolar.cu becomes a stamp there, in order, the other
    sources are copied as they are, and the shipped source is untouched; a
    tree of another commit launches its own source, and `sources()` points
    the wrapper at a stamped copy only inside its block."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from tools import trace_stages as ts

    shipped = te.SOURCE.read_text()
    marks = re.findall(r"^\s*// stage: (\S+)\s*$", shipped, re.M)
    assert len(marks) >= 5 and len(set(marks)) == len(marks)
    tree = ts.TraceBuild("tree")
    copy, stages = ts.instrument(tree, tmp_path / "tree", prefix="trace_")
    assert te.SOURCE.read_text() == shipped
    assert stages == marks
    text = (copy / te.SOURCE.name).read_text()
    assert "// stage:" not in text
    assert [int(k) for k in re.findall(r"ba_stage\((\d+)\);", text)] == list(range(len(marks)))
    for other in ("ba_sweep.cu", "ba_common.cuh", "track_lm.cu"):
        assert (copy / other).read_text() == (te.SOURCE.parent / other).read_text()

    other = tmp_path / "other" / "libcml_tpu_torch"
    for sub, src in (("ops", Path(te.__file__)), ("csrc", te.SOURCE)):
        (other / sub).mkdir(parents=True)
        (other / sub / src.name).write_text(src.read_text())
    build = ts.TraceBuild("other", tmp_path / "other")
    assert build.bk is not te and build.bk.SOURCE == other / "csrc" / te.SOURCE.name
    with build.sources(copy):
        assert build.bk.SOURCE == copy / te.SOURCE.name
    assert build.bk.SOURCE == other / "csrc" / te.SOURCE.name
    assert te.SOURCE.read_text() == shipped

