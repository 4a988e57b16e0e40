"""Phase 14's float64 checks (chip_smoke.py) on the CPU: honest forms pass
them and planted faults fail them.

chip_smoke.py holds the BA kernels on the card to float64 evidence:
- every `_marg_pieces` call: the kernel's four sums and the plain float32
  form's against `_marg_pieces_plain` in float64, each within MARG_F64_TOL of
  the float64 sum's largest entry or the kernel no further than the plain
  form, and the same for marg_host_schur's packed result (`marg_check`);
- every run_ba / run_ba_mixed case over the plain form's bound with the same
  accept decisions: a float64 run of the window must take those decisions
  and the kernels' T and inverse depths must sit no further from it than the
  plain form's (`run_ba_verdict`).
Here the "kernel" role is played by the plain float32 form, by the float64
form rounded to float32, and by planted faults in the plain form's result,
on tests/test_torch_ba_kernels.py's 160x120 window (4 keyframes, 64 points
each): one b_pts entry dropped, H_corr scaled by 1 + 1e-2, a hosted bit
flipped, a pose off by 5e-4 and an inverse depth off by twice its bound
must fail; a plain form made noisy past the bound while the kernel holds
the float64 run must pass on the evidence alone.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
import libcml_tpu_torch.models.direct.ba as tba  # noqa: E402
from libcml_tpu_torch.core.lie import SE3  # noqa: E402
from libcml_tpu_torch.ops import ba_sweep as bk  # noqa: E402
from test_torch_card_ba import TCAM, TCFG, build_window  # noqa: E402
from test_torch_card_ba import build_factors as _factors  # noqa: E402

torch.set_num_threads(1)

SLOT = 1          # the marginalized slot: keyframe 2's, which hosts points


@pytest.fixture(scope="module")
def window():
    return build_window()


@pytest.fixture(scope="module")
def marg(window):
    """(the plain float32 pieces, the float64 pieces) of a marginalization."""
    st, images = window["ba"], window["images"]
    f32 = tba._marg_pieces_plain(st, images, TCAM, TCFG, SLOT)
    f64 = tba._marg_pieces_plain(cs._state64(st), images.double(), TCAM, TCFG, SLOT)
    return f32, f64


def _runs(window, mixed: bool):
    """The plain float32 run (state, E, indirect idepths or None, its
    (E, E_new) trace), and the float64 run."""
    st, images = window["ba"], window["images"]
    tr = []
    if mixed:
        ind = _factors(window)
        want, want_i, E = tba.run_ba_mixed_plain(st, images, TCAM, TCFG, ind, trace=tr)
        f64 = cs.run_ba_f64(st, images, TCAM, TCFG, ind)
        return (want, E, want_i.idepth, torch.stack(tr)), f64
    want, E = tba.run_ba_plain(st, images, TCAM, TCFG, trace=tr)
    return (want, E, None, torch.stack(tr)), cs.run_ba_f64(st, images, TCAM, TCFG)


@pytest.fixture(scope="module")
def runs(window):
    return {"run_ba": _runs(window, False), "run_ba_mixed": _runs(window, True)}


def _verdict(kernel, plain, f64, mixed: bool) -> dict:
    got, E, gi, trace = kernel
    want, E_want, wi, trace_p = plain
    dec = cs._decisions(trace, list(trace_p))
    tol = bk.MIXED_PARITY_TOL if mixed else bk.PARITY_TOL
    return cs.run_ba_verdict(got, E, want, E_want, dec, f64, tol,
                             None if gi is None else (gi, wi))


def _as_f32(f64: dict, trace) -> tuple:
    """The float64 run rounded to float32, as a kernel's result (with the
    plain form's trace: the same decisions)."""
    s = cs._map_fields(f64["state"], lambda v: v.float() if v.is_floating_point() else v)
    gi = None if f64["idepth_i"] is None else f64["idepth_i"].float()
    return s, f64["E"].float(), gi, trace


# -- honest forms pass -------------------------------------------------------------------------


@pytest.mark.parametrize("kernel", ["plain_f32", "f64"])
def test_marg_check_passes_honest_forms(marg, kernel):
    """The plain float32 form, and the float64 form rounded to float32, as
    the kernel's pieces: every sum and the packed result pass."""
    f32, f64 = marg
    k = f32 if kernel == "plain_f32" else tuple(
        x.float() if x.is_floating_point() else x for x in f64)
    row = cs.marg_check("window", {"kernel": k, "plain_f32": f32}, f64, SLOT, TCFG)
    assert row["ok"], row
    assert row["hosted_equal"] and int(f64[4].sum()) > 0
    # the float32 form's own distance from float64 is float32 noise
    assert max(row["from_f64"]["plain_f32"].values()) < 1e-3


@pytest.mark.parametrize("case", ["run_ba", "run_ba_mixed"])
@pytest.mark.parametrize("kernel", ["plain_f32", "f64"])
def test_run_ba_verdict_passes_honest_forms(runs, case, kernel):
    """The plain float32 run, and the float64 run rounded to float32, as the
    kernels' result: within the bound, and the float64 run takes the plain
    form's decisions."""
    plain, f64 = runs[case]
    k = plain if kernel == "plain_f32" else _as_f32(f64, plain[3])
    v = _verdict(k, plain, f64, case == "run_ba_mixed")
    assert v["ok"] and v["parity"]["ok"], v
    assert v["f64_evidence"]["f64_decisions_equal"], v


def test_run_ba_verdict_passes_on_float64_evidence(runs):
    """A plain form pushed past the T bound (3e-4 on every translation) while
    the kernels hold the float64 run: over the bound, every decision equal,
    the kernels nearer float64, so the case passes on the evidence alone."""
    plain, f64 = runs["run_ba"]
    want, E, gi, trace = plain
    noisy = (want.replace(T=SE3(R=want.T.R, t=want.T.t + 3e-4)), E, gi, trace)
    v = _verdict(_as_f32(f64, trace), noisy, f64, False)
    assert not v["parity"]["ok"] and not v["parity"]["within"]["T"], v
    assert v["f64_evidence"]["holds"] and v["ok"], v


# -- planted faults fail -----------------------------------------------------------------------

MARG_FAULTS = ["b_pts_entry_dropped", "H_corr_scaled", "hosted_bit_flipped"]
RUN_FAULTS = ["T_off_5e-4", "idepth_off_twice_its_bound"]


@pytest.mark.parametrize("fault", MARG_FAULTS + RUN_FAULTS)
def test_f64_checks_fail_a_planted_fault(marg, runs, fault):
    """A wrong kernel fails: its sum, mask or result sits further from
    float64 than the plain form's and past what float32 reaches."""
    if fault in MARG_FAULTS:
        f32, f64 = marg
        k = [x.clone() for x in f32]
        if fault == "b_pts_entry_dropped":
            k[1][int(k[1].abs().argmax())] = 0.0
        elif fault == "H_corr_scaled":
            k[2] = k[2] * (1.0 + 1e-2)
        else:
            hosted = k[4]
            hosted[int(torch.nonzero(~hosted)[0])] = True
        row = cs.marg_check("window", {"kernel": tuple(k), "plain_f32": f32}, f64, SLOT, TCFG)
        assert not row["ok"], row
        return
    plain, f64 = runs["run_ba"]
    want, E, gi, trace = plain
    if fault == "T_off_5e-4":
        t = want.T.t.clone()
        t[1, 0] += 5e-4
        bad = want.replace(T=SE3(R=want.T.R, t=t))
    else:
        i = int(torch.nonzero(want.point_valid)[0])
        idepth = want.idepth.clone()
        tol = bk.PARITY_TOL
        idepth[i] += 2.0 * (tol["idepth_abs"] + tol["idepth_rel"] * idepth[i].abs())
        bad = want.replace(idepth=idepth)
    v = _verdict((bad, E, gi, trace), plain, f64, False)
    assert not v["parity"]["ok"], v
    assert not v["f64_evidence"]["holds"] and not v["ok"], v


def test_mixed_faults_change_only_their_lines(tmp_path):
    """Phase 14's planted faults in the mixed BA's run kernel
    (cs.BA_MIXED_FAULTS): each copy of csrc/ differs from the shipped
    sources only in ba_common.cuh, there only by the fault's substitutions,
    each of whose lines the shipped header holds once; the shipped sources
    stay as they are."""
    shipped = {p.name: p.read_text() for p in bk.RUN_SOURCE.parent.glob("*.cu*")}
    paths = cs.write_ba_faults(tmp_path)
    assert set(paths) == set(cs.BA_MIXED_FAULTS)
    for name, path in paths.items():
        assert path.name == "ba_run.cu" and path.parent == tmp_path / name
        copy = {p.name: p.read_text() for p in path.parent.glob("*.cu*")}
        assert copy.keys() == shipped.keys()
        for fname, text in copy.items():
            want = shipped[fname]
            if fname == "ba_common.cuh":
                for old, new in cs.BA_MIXED_FAULTS[name]:
                    assert want.count(old) == 1
                    want = want.replace(old, new)
                assert text != shipped[fname]
            assert text == want, (name, fname)
    assert {p.name: p.read_text() for p in bk.RUN_SOURCE.parent.glob("*.cu*")} == shipped
