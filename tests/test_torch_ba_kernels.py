"""The window BA kernels' arithmetic modelled on the CPU and held to the plain
forms and to the JAX package; their dispatch; the kernels on the card.

csrc/ba_sweep.cu, ba_solve.cu and ba_run.cu cannot run here. A torch model of
their arithmetic (csrc/ba_common.cuh) stands in for them:
- the sweep: each (point, target) pair's Jacobians factored through z_k =
  (gx, gy, c_k, 1), so that the pair keeps Z = sum_k w z z^T, zr = sum_k w z r
  and its FEJ geometry (A_t, A_h, a, s0) and every normal-equation term is a
  form L Z L^T; a point group's partial sums in float64, each quarter's 4
  points in point order and then the quarters in order (H's slot blocks on
  and above the block diagonal whole, H_corr's upper triangle mirrored), the
  group's
  energy a tree over each warp's 32 pairs and then the warps in order; then
  phase D: each entry summed over the groups in group order (acc = 0, then
  groups 0..G-1), whichever block of the grid sums it; the marg mode's
  pairs (marg_pair) in float64 from the float32 inputs, rounded once, and
  held nearer a float64 _marg_pieces_plain than the plain float32 form;
- the solve: the damped system built in the kernel's order, elimination
  with the first row of largest magnitude as pivot and the multipliers
  scaled by the pivot's reciprocal (one warp, two rows a lane that stay in
  place while their positions are interchanged: each entry takes the same
  operations as in a block-wide elimination that swaps rows), the
  back-substitution
  by the reciprocals, the scale-gauge projection, the state update;
- run_ba's schedule: the energy at the start, then a system sweep, a solve
  and an energy sweep of the candidate a step, the accept test E_new < E,
  lambda x0.4 (floor 1e-7) or x5 (cap 1e2), the select (a rejected step
  keeps the state's bits);
- the mixed BA's reprojection factors: each (point, target) pair's
  linearization at the current state, its 2 x 6 products as the pair's
  forms (affine rows zero), a point's H_rho, b_rho and H_xr row in slot
  order, the group partials in point order and phase D as the photometric
  groups', the four sums kept apart and added to the solve's system in
  _solve_plain's order, the factors' back-substitution, and the energy,
  mixed_weight x the groups' tree sums, added last in the finish.
The model is held to the plain forms (`run_ba_plain`, `ba_step_plain`,
`update_residual_status_plain`, `_marg_pieces_plain`, `run_ba_mixed_plain`)
and to `libcml_tpu.models.direct.ba.run_ba` and `run_ba_mixed` at the bounds of
tests/test_torch_direct.py's run_ba test, on a 160x120 window of 4 keyframes
and 256 point slots (rejected steps, an all-invalid window, ba_iters 0, the
marginalization pieces and the mixed BA with its edge cases among the
cases), and its orders to
the one-block kernels' where they agree (the elimination, phase D's
per-entry order). The
kernels themselves are held to the plain forms on the card by
tests/test_torch_card_ba.py (skipped without CUDA: the one-launch run and
the split launches of a mesh's route on a world of one, and each to the
other bit for bit; it holds the window and the run comparison) and by
chip_smoke.py phase 14. Worker
time: about 25 s alone on one thread, half of it the JAX reference's
compile.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import libcml_tpu.models.direct.ba as jba
from libcml_tpu.core.camera import PinholeCamera as JCam
from libcml_tpu.core.lie import SE3 as JSE3
from libcml_tpu.models.direct.config import DirectConfig as JCfg

import libcml_tpu_torch.models.direct.ba as tba
from libcml_tpu_torch import convert
from libcml_tpu_torch.core.lie import SE3, se3_exp, skew
from libcml_tpu_torch.models.direct.config import DirectConfig as TDirectConfig
from libcml_tpu_torch.models.direct.residuals import huber_energy, huber_weight, pattern_uv
from libcml_tpu_torch.ops import ba_sweep as bk
from libcml_tpu_torch.ops.image import bilinear_stack
from test_torch_card_ba import (
    CAM_ARGS, CFG_KW, MIXED_TOL, REJECTING, TCAM, TCFG, assert_run_close, build_factors,
    build_window)

# The suite runs in several worker processes that share a few cores: one
# torch thread each, since with torch's default thread pool per process the
# workers' spinning threads slow each other down many times over.
torch.set_num_threads(1)

JCAM, JCFG = JCam.make(*CAM_ARGS), JCfg(**CFG_KW)
NPB = 16                          # csrc/ba_common.cuh: points a group
MIXED_POINTS = TDirectConfig().mixed_points   # the hybrid's factor points, 256


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture(scope="module")
def window():
    return build_window()


def _jax_state(st: tba.BAState) -> jba.BAState:
    d = convert.to_np(st)
    kw = {k: jnp.asarray(v) for k, v in d.items() if k not in ("T", "T_fej")}
    for k in ("T", "T_fej"):
        kw[k] = JSE3(R=jnp.asarray(d[k]["R"]), t=jnp.asarray(d[k]["t"]))
    return jba.BAState(**kw)


# -- the model of csrc/ba_sweep.cu --------------------------------------------------------


def _lrows(A: torch.Tensor, s0: torch.Tensor, host_side: bool) -> torch.Tensor:
    """(..., 8, 4) L_t or L_h of the pairs: row d maps z to J[k][d]."""
    L = torch.zeros(A.shape[:-2] + (8, 4), dtype=A.dtype)
    L[..., :6, 0] = A[..., 0, :]
    L[..., :6, 1] = A[..., 1, :]
    L[..., 6, 2] = s0 if host_side else -s0
    L[..., 7, 3] = s0 if host_side else -1.0
    return L


def _state64(st: tba.BAState) -> tba.BAState:
    """The state with every float tensor in float64."""
    out = {}
    for f in dataclasses.fields(st):
        v = getattr(st, f.name)
        out[f.name] = (SE3(R=v.R.double(), t=v.t.double()) if isinstance(v, SE3)
                       else v.double() if v.is_floating_point() else v)
    return tba.BAState(**out)


def _pairs(st: tba.BAState, images, cam, cfg, mode: str, slot=None) -> dict:
    """Phase A for every (point, target) pair: the mask, the energy, and
    for the system modes the FEJ geometry and the sums Z, zr. The marg
    mode's (csrc/ba_common.cuh marg_pair) in float64 from the float32
    inputs, rounded once into the pair's float32 values."""
    if mode == "marg" and st.uv.dtype == torch.float32:
        q = _pairs(_state64(st), images.double(), cam, cfg, mode, slot)
        return {k: v.float() if v.is_floating_point() else v for k, v in q.items()}
    P, F = st.num_points, st.num_frames
    host = st.host.long()
    rel, relf = tba._pairwise_rel(st.T), tba._pairwise_rel(st.T_fej)
    Rc, tc = rel.R[host], rel.t[host]
    Rf, tf = relf.R[host], relf.t[host]
    Xp = cam.unproject(pattern_uv(st.uv), st.idepth[:, None])               # (P, 8, 3)
    Y = torch.einsum("pfij,pkj->pfki", Rc, Xp) + tc[:, :, None, :]
    uvj, vz = cam.project(Y)
    geo = torch.all(vz & cam.in_bounds(uvj, border=2.0), dim=-1)
    smp = bilinear_stack(images, uvj)                                         # (P, F, 8, 3)
    ab = st.ab
    s_ji = torch.exp(ab[None, :, 0] - ab[host, 0][:, None])
    r = (smp[..., 0] - ab[None, :, 1, None]) - s_ji[..., None] * (
        st.color[:, None, :] - ab[host, 1][:, None, None])
    pv = st.point_valid if mode != "marg" else st.point_valid & (st.host == slot)
    fv = st.frame_valid
    act = (st.res_active & pv[:, None] & fv[None, :] & fv[host][:, None]
           & (host[:, None] != torch.arange(F)[None, :]) & geo)
    e = torch.where(act, torch.sum(st.weight[:, None, :] * huber_energy(r, cfg.huber_intensity),
                                   -1), torch.zeros(()))
    out = {"act": act, "e": e, "host": host}
    if mode not in ("system", "marg"):
        return out
    Xi = cam.unproject(st.uv, st.idepth_fej)                                  # (P, 3)
    Xj = torch.einsum("pfij,pj->pfi", Rf, Xi) + tf
    iz = 1.0 / torch.clamp(Xj[..., 2], min=1e-8)
    zero = torch.zeros_like(iz)
    Juv = torch.stack([torch.stack([cam.fx * iz, zero, (-cam.fx * Xj[..., 0]) * iz * iz], -1),
                       torch.stack([zero, cam.fy * iz, (-cam.fy * Xj[..., 1]) * iz * iz], -1)],
                      -2)                                                     # (P, F, 2, 3)
    eye = torch.eye(3).expand(P, F, 3, 3)
    At = Juv @ torch.cat([eye, -skew(Xj)], -1)
    Ah = Juv @ -(Rf @ torch.cat([eye[:, 0], -skew(Xi)], -1)[:, None])
    a = (Juv @ (-(Xj - tf) / torch.clamp(st.idepth_fej, min=1e-8)[:, None, None])[..., None])[..., 0]
    s0 = torch.exp(st.ab_fej[None, :, 0] - st.ab_fej[host, 0][:, None])
    c0 = (st.color[:, None, :] - st.ab_fej[host, 1][:, None, None]).expand(P, F, 8)
    z = torch.stack([smp[..., 1], smp[..., 2], c0, torch.ones_like(c0)], -1)  # (P, F, 8, 4)
    Lt, Lh = _lrows(At, s0, False), _lrows(Ah, s0, True)
    w = torch.where(act[..., None], huber_weight(r, cfg.huber_intensity) * st.weight[:, None, :],
                    torch.zeros(()))
    rr = r
    if mode == "marg":
        Jt = torch.einsum("pfdm,pfkm->pfkd", Lt, z)
        Jh = torch.einsum("pfdm,pfkm->pfkd", Lh, z)
        jr = z[..., 0] * a[..., None, 0] + z[..., 1] * a[..., None, 1]
        rr = ((r - torch.sum(Jt * st.delta[None, :, None, :], -1))
              - torch.sum(Jh * st.delta[host][:, None, None, :], -1)
              - jr * (st.idepth - st.idepth_fej)[:, None, None])
    out.update(Lt=Lt, Lh=Lh, a=a, Z=torch.einsum("pfk,pfkm,pfkn->pfmn", w, z, z),
               zr=torch.einsum("pfk,pfkm,pfk->pfm", w, z, rr))
    return out


def _tree(e: torch.Tensor) -> torch.Tensor:
    """A group's energy as the kernel sums it: a tree over each warp's 32
    pairs (lane l takes lane l + o at o = 1, 2, ..., 16), then the warps in
    order; `e` float64, a multiple of 32 long."""
    w = e.reshape(-1, 32)
    while w.shape[1] > 1:
        w = w[:, 0::2] + w[:, 1::2]
    acc = w[0, 0]
    for k in range(1, w.shape[0]):
        acc = acc + w[k, 0]
    return acc


def _phase_d(parts: list) -> torch.Tensor:
    """Phase D: every entry summed over the groups in group order, acc = 0
    and then groups 0..G-1."""
    acc = torch.zeros_like(parts[0])
    for part in parts:
        acc = acc + part
    return acc


def _upper_mirrored(M: torch.Tensor) -> torch.Tensor:
    """The matrix the kernel stores from its upper-triangle entries."""
    return torch.triu(M) + torch.triu(M, 1).T


def _sweep(st: tba.BAState, images, cam, cfg, mode: str, lam=0.0, slot=None) -> dict:
    """csrc/ba_sweep.cu (and ba_run.cu's sweeps) on the CPU: phases A, F, B
    and C of each 16-point group, the group partials in float64 (the
    quarters' in point order, then the quarters in order), then phase D."""
    acc = torch.float64
    P, F = st.num_points, st.num_frames
    D = 8 * F
    q = _pairs(st, images, cam, cfg, mode, slot)
    out = {}
    groups = range(0, P, NPB)
    e_pad = torch.zeros(len(groups) * NPB, 8, dtype=acc)
    e_pad[:P, :F] = q["e"].to(acc)
    e_parts = [_tree(e_pad[b:b + NPB].reshape(-1)) for b in groups]
    out["e_photo"] = _phase_d(e_parts).float()
    if mode == "status":
        good = q["act"] & (q["e"] < cfg.outlier_energy)
        out["res_active"] = st.res_active & (good | ~q["act"])
        out["point_valid"] = st.point_valid & (good.sum(1) >= 1)
    if mode not in ("system", "marg"):
        return out
    Lt, Lh, Z, zr, act, host = q["Lt"], q["Lh"], q["Z"], q["zr"], q["act"], q["host"]
    a4 = torch.cat([q["a"], torch.zeros(P, F, 2)], -1)
    Za = (Z @ a4[..., None])[..., 0]
    X = (Lt @ Za[..., None])[..., 0].reshape(P, D).clone()                   # H_xr target blocks
    hx = (Lh @ Za[..., None])[..., 0]
    H_rho = torch.zeros(P)
    b_rho = torch.zeros(P)
    for g in range(F):   # phase B: a point's pairs in slot order
        H_rho = H_rho + torch.sum(a4[:, g] * Za[:, g], -1)
        b_rho = b_rho + torch.sum(a4[:, g] * zr[:, g], -1)
    hsum = torch.zeros(P, 8)
    for g in range(F):
        hsum = hsum + hx[:, g]
    for p in range(P):
        h = int(host[p])
        X[p, 8 * h:8 * h + 8] += hsum[p]
    valid = st.point_valid if mode == "system" else st.point_valid & (st.host == slot)
    eps = 1e-10 if mode == "system" else 1e-12
    H_rho_d = torch.where(valid, H_rho * (1.0 + torch.tensor(lam, dtype=torch.float32)) + eps,
                          torch.ones(()))
    scale = torch.where(valid, 1.0 / H_rho_d, torch.zeros(()))
    Ftt = Lt @ Z @ Lt.transpose(-1, -2)
    Fhh = Lh @ Z @ Lh.transpose(-1, -2)
    Fth = Lt @ Z @ Lh.transpose(-1, -2)
    bt = (Lt @ zr[..., None])[..., 0]
    bh = (Lh @ zr[..., None])[..., 0]
    parts = []
    for b0 in groups:
        quarters = []
        for q0 in range(b0, b0 + NPB, 4):   # a quarter's points in point order
            quarters.append(_partial(range(q0, min(q0 + 4, P)), F, D, act, host, Ftt, Fth,
                                     Fhh, bt, bh, X, scale, b_rho))
        parts.append(((quarters[0] + quarters[1]) + quarters[2]) + quarters[3])
    total = _phase_d(parts)
    H, b = total[:D * D].reshape(D, D), total[D * D:D * D + D]
    H_corr = _upper_mirrored(total[D * D + D:2 * D * D + D].reshape(D, D))
    b_corr = total[2 * D * D + D:]
    if mode == "system":   # the Schur complement's differences in double, rounded once
        out.update(H=(H - H_corr).float(), b=(b - b_corr).float(), H_rho_d=H_rho_d,
                   b_rho=b_rho, H_xr=X)
    else:
        out.update(H=H.float(), b=b.float(), H_corr=H_corr.float(), b_corr=b_corr.float())
    return out


def _partial(points, F, D, act, host, Ftt, Fth, Fhh, bt, bh, X, scale, b_rho) -> torch.Tensor:
    """The float64 sums of `points` in point order: H (F x F blocks), b,
    H_corr, b_corr, flattened."""
    acc = torch.float64
    H = torch.zeros(F, F, 8, 8, dtype=acc)
    bv = torch.zeros(F, 8, dtype=acc)
    Hc = torch.zeros(D, D, dtype=acc)
    bc = torch.zeros(D, dtype=acc)
    for p in points:
        h = int(host[p])
        for f in range(F):
            if act[p, f]:
                H[f, f] += Ftt[p, f].to(acc)
                H[f, h] += Fth[p, f].to(acc)
                H[h, f] += Fth[p, f].T.to(acc)
                bv[f] += bt[p, f].to(acc)
        for g in range(F):
            if act[p, g]:
                H[h, h] += Fhh[p, g].to(acc)
                bv[h] += bh[p, g].to(acc)
        Hc += ((X[p] * scale[p])[:, None] * X[p][None, :]).to(acc)
        bc += (X[p] * (b_rho[p] * scale[p])).to(acc)
    return torch.cat([H.permute(0, 2, 1, 3).reshape(-1), bv.reshape(-1), Hc.reshape(-1), bc])


def _ind_forms(st: tba.BAState, ind: tba.IndirectFactors, cam, cfg) -> dict:
    """Phases A and F of the factor groups (csrc/ba_common.cuh ind_pair,
    ind_target_forms, ind_host_forms) for every (point, target) pair: the
    mask, the energy before mixed_weight, and the pair's forms J^T W J,
    J^T W r, its shares of H_rho, b_rho and the H_xr row, lifted to the
    8-dof slot layout (affine rows and columns zero), zeros when inactive."""
    r, w, Jt, Jh, Jr, act, _ = tba._linearize_indirect(st, ind, cam, cfg)
    chi2 = torch.sum(r * r, -1) / ind.sigma2
    e = torch.where(chi2 <= tba._CHI2_2D, chi2,
                    2.0 * torch.sqrt(tba._CHI2_2D * torch.clamp(chi2, min=1e-12)) - tba._CHI2_2D)
    zero = torch.zeros(())
    e = torch.where(act, e, zero)
    Jt8, Jh8 = torch.nn.functional.pad(Jt, (0, 2)), torch.nn.functional.pad(Jh, (0, 2))
    wJt, wJh, wJr = w[..., None, None] * Jt8, w[..., None, None] * Jh8, w[..., None] * Jr

    def outer(a, b):   # sum over u of a[u][d] b[u][e], u = 0 then 1
        return a[..., 0, :, None] * b[..., 0, None, :] + a[..., 1, :, None] * b[..., 1, None, :]

    def vec(a, v):     # sum over u of a[u][d] v[u]
        return a[..., 0, :] * v[..., 0, None] + a[..., 1, :] * v[..., 1, None]

    on, on2 = act[..., None], act[..., None, None]
    return {"act": act, "e": e, "host": ind.host.long(),
            "Ftt": torch.where(on2, outer(wJt, Jt8), zero),
            "Fth": torch.where(on2, outer(wJt, Jh8), zero),
            "Fhh": torch.where(on2, outer(wJh, Jh8), zero),
            "bt": torch.where(on, vec(wJt, r), zero), "bh": torch.where(on, vec(wJh, r), zero),
            "hr": torch.where(act, wJr[..., 0] * Jr[..., 0] + wJr[..., 1] * Jr[..., 1], zero),
            "br": torch.where(act, wJr[..., 0] * r[..., 0] + wJr[..., 1] * r[..., 1], zero),
            "hx": torch.where(on, vec(Jh8, wJr), zero), "xt": torch.where(on, vec(Jt8, wJr), zero)}


def _ind_sweep(st: tba.BAState, ind: tba.IndirectFactors, cam, cfg, mode: str,
               lam=0.0) -> dict:
    """The factor groups of a system or energy sweep on the CPU: phases A
    and F (_ind_forms), phase B (a point's terms over its pairs in slot
    order, the damped Schur scale), phase C (each group's partials in
    float64, the quarters' points in point order, then the quarters) and
    phase D (the groups in group order), the four sums apart, each rounded
    once: "system" gives Hi, bi, Hi_corr, bi_corr, Hi_rho_d, bi_rho, Hi_xr;
    "energy" e_ind, mixed_weight x the groups' tree sums rounded."""
    acc = torch.float64
    Q, F = ind.num_points, st.num_frames
    D = 8 * F
    q = _ind_forms(st, ind, cam, cfg)
    groups = range(0, Q, NPB)
    if mode == "energy":
        e_pad = torch.zeros(len(groups) * NPB, 8, dtype=acc)
        e_pad[:Q, :F] = q["e"].to(acc)
        e = _phase_d([_tree(e_pad[b:b + NPB].reshape(-1)) for b in groups]) if Q else 0.0
        return {"e_ind": torch.tensor(cfg.mixed_weight, dtype=torch.float32)
                * torch.as_tensor(e, dtype=acc).float()}
    X = q["xt"].reshape(Q, D).clone()
    H_rho, b_rho, hsum = torch.zeros(Q), torch.zeros(Q), torch.zeros(Q, 8)
    for g in range(F):   # phase B: a point's pairs in slot order
        H_rho = H_rho + q["hr"][:, g]
        b_rho = b_rho + q["br"][:, g]
        hsum = hsum + q["hx"][:, g]
    for p in range(Q):
        h = int(q["host"][p])
        X[p, 8 * h:8 * h + 8] += hsum[p]
    valid = ind.point_valid
    lam_t = torch.tensor(lam, dtype=torch.float32)
    H_rho_d = torch.where(valid, H_rho * (1.0 + lam_t) + 1e-10, torch.ones(()))
    scale = torch.where(valid, 1.0 / H_rho_d, torch.zeros(()))
    parts = []
    for b0 in groups:
        quarters = [_partial(range(q0, min(q0 + 4, Q)), F, D, q["act"], q["host"], q["Ftt"],
                             q["Fth"], q["Fhh"], q["bt"], q["bh"], X, scale, b_rho)
                    for q0 in range(b0, b0 + NPB, 4)]
        parts.append(((quarters[0] + quarters[1]) + quarters[2]) + quarters[3])
    total = _phase_d(parts) if Q else torch.zeros(2 * D * D + 2 * D, dtype=acc)
    return {"Hi": total[:D * D].reshape(D, D).float(), "bi": total[D * D:D * D + D].float(),
            "Hi_corr": _upper_mirrored(total[D * D + D:2 * D * D + D].reshape(D, D)).float(),
            "bi_corr": total[2 * D * D + D:].float(), "Hi_rho_d": H_rho_d, "bi_rho": b_rho,
            "Hi_xr": X}


# -- the model of csrc/ba_solve.cu and of run_ba's schedule ------------------------------


def _pivot(col: torch.Tensor, k: int) -> int:
    """The row the solve kernel's warp picks at column k: the first of
    largest magnitude among rows >= k (LAPACK's isamax); a NaN never wins,
    unless row k itself is NaN."""
    v = torch.abs(col[k:])
    if torch.isnan(v[0]):
        return k
    v = torch.where(torch.isnan(v), torch.full_like(v, -1.0), v)
    return k + int(torch.argmax(v))


def _eliminate(M: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, list]:
    """Elimination of [A | g] with partial pivoting, as a block that swaps
    rows and the warp both do it: at column k the pivot row swapped with row
    k (columns k on), rcp_k = 1 / a_kk, and a_ij -= (a_ik rcp_k) a_kj below
    and right of the pivot. Returns (M, the reciprocals, the pivot rows)."""
    M = M.clone()
    D = M.shape[0]
    rcp, piv = torch.zeros(D), []
    for k in range(D):
        p = _pivot(M[:, k], k)
        piv.append(p)
        if p != k:
            M[[k, p], k:] = M[[p, k], k:]
        rcp[k] = 1.0 / M[k, k]
        M[k + 1:, k + 1:] -= (M[k + 1:, k:k + 1] * rcp[k]) * M[k:k + 1, k + 1:]
    return M, rcp, piv


def _solve(system: dict, st: tba.BAState, lam, cfg, extra=None) -> tuple[tba.BAState, torch.Tensor]:
    """csrc/ba_solve.cu on the CPU: the damped system, LU with the first row
    of largest magnitude as pivot and reciprocal multipliers, the
    back-substitution, the gauge projection, the state update."""
    F = st.num_frames
    D = 8 * F
    lam = torch.tensor(lam, dtype=torch.float32)
    fvd = st.frame_valid.repeat_interleave(8)
    k8 = torch.arange(D) % 8
    pw = torch.where(k8 == 6, torch.tensor(cfg.ba_prior_a, dtype=torch.float32),
                     torch.where(k8 == 7, torch.tensor(cfg.ba_prior_b, dtype=torch.float32),
                                 torch.zeros(())))
    H = system["H"] if extra is None else system["H"] + extra[0]
    A = H + st.H_m   # H: the system sweep's H - H_corr
    A = A + torch.diag(torch.where(fvd, pw, torch.ones(())))
    if extra is not None:
        A = A - extra[2]
    A = A + torch.diag(lam * torch.diag(A)) + 1e-6 * torch.eye(D)
    g = system["b"] if extra is None else system["b"] + extra[1]
    g = (g + st.b_m) + st.H_m @ st.delta.reshape(-1)
    g = g + torch.where(fvd, pw * tba._ab_flat(st.ab), torch.zeros(()))
    if extra is not None:
        g = g - extra[3]
    M, rcp, _ = _eliminate(torch.cat([A, g[:, None]], 1))
    x = torch.zeros(D)
    for k in range(D - 1, -1, -1):
        x[k] = (M[k, D] - torch.sum(M[k, k + 1:D] * x[k + 1:])) * rcp[k]
    n = torch.zeros(F, 8)
    n[:, :3] = st.T.t * st.frame_valid[:, None].float()
    n = n.reshape(D)
    x = x - n * (torch.sum(n * x) / (torch.sum(n * n) + 1e-6))
    dxf = torch.where(st.frame_valid[:, None], x.reshape(F, 8), torch.zeros(()))
    T_new = tba.se3_select(st.frame_valid, se3_exp(-dxf[:, :6]).compose(st.T), st.T)
    d_rho = (system["b_rho"] - system["H_xr"] @ x) / system["H_rho_d"]
    d_rho = torch.where(st.point_valid, d_rho, torch.zeros(()))
    new = st.replace(T=T_new, ab=st.ab - dxf[:, 6:], delta=st.delta - dxf,
                     idepth=torch.clamp(st.idepth - d_rho, cfg.idepth_min, cfg.idepth_max))
    return new, x


def _energy(st: tba.BAState, images, cam, cfg, e_extra=None) -> torch.Tensor:
    """The energy sweep and the finish of total_energy."""
    e = _sweep(st, images, cam, cfg, "energy")["e_photo"]
    d = st.delta.reshape(-1)
    e_ab = 0.5 * torch.sum(torch.where(
        st.frame_valid, cfg.ba_prior_a * st.ab[:, 0] ** 2 + cfg.ba_prior_b * st.ab[:, 1] ** 2,
        torch.zeros(())))
    E = (e + (torch.dot(st.b_m, d) + 0.5 * torch.dot(d, st.H_m @ d))) + e_ab
    return E if e_extra is None else E + e_extra


def _ind_energy(st, ind, cam, cfg):
    """The factors' energy as the finish adds it (None without factors)."""
    return None if ind is None else _ind_sweep(st, ind, cam, cfg, "energy")["e_ind"]


def _model_run_ba(st, images, cam, cfg, ind=None):
    """run_ba (run_ba_mixed with `ind`) on the model: E0, then a system
    sweep (with the factors' groups), a solve (their four sums joining the
    system in _solve_plain's order) and their back-substitution, and an
    energy sweep a step, the reprojection energy added last; the accept
    test, lambda's update and the select. Returns (state, ind idepth or
    None, E, the accept decisions with E and E_new)."""
    E = _energy(st, images, cam, cfg, _ind_energy(st, ind, cam, cfg))
    lam = torch.tensor(cfg.ba_lambda_init, dtype=torch.float32)
    steps = []
    for _ in range(cfg.ba_iters):
        system = _sweep(st, images, cam, cfg, "system", lam=float(lam))
        isys = None if ind is None else _ind_sweep(st, ind, cam, cfg, "system", float(lam))
        extra = None if ind is None else tuple(isys[k] for k in ("Hi", "bi", "Hi_corr",
                                                                 "bi_corr"))
        cand, dx = _solve(system, st, float(lam), cfg, extra)
        cand_i = None
        if ind is not None:
            d = (isys["bi_rho"] - isys["Hi_xr"] @ dx) / isys["Hi_rho_d"]
            d = torch.where(ind.point_valid, d, torch.zeros(()))
            cand_i = ind.replace(idepth=torch.clamp(ind.idepth - d, cfg.idepth_min,
                                                    cfg.idepth_max))
        E_new = _energy(cand, images, cam, cfg, _ind_energy(cand, cand_i, cam, cfg))
        accept = bool(E_new < E)
        steps.append((accept, float(E), float(E_new)))
        if accept:
            st, E = cand, E_new
            ind = cand_i
        lam = (torch.clamp(lam * 0.4, min=1e-7) if accept else torch.clamp(lam * 5.0, max=1e2))
    return st, None if ind is None else ind.idepth, E, steps


# -- the tests ------------------------------------------------------------------------------


@pytest.mark.parametrize("lam", [1e-3, 1e2], ids=["lam_init", "lam_cap"])
def test_sweep_model_equals_plain_assemble(window, lam):
    """The factored, block-ordered sums equal linearize + _assemble +
    _schur_terms at run_ba's first and largest lambda: the Schur-complemented
    system (the system sweep's H, b: H - H_corr and b - b_corr) to 1e-4 of
    its largest entry, the per-point terms to 1e-4, the energy to 1e-5 (the
    four sums apart: the marg mode's test)."""
    st, images = window["ba"], window["images"]
    got = _sweep(st, images, TCAM, TCFG, "system", lam=lam)
    lin = tba.linearize(st, images, TCAM, TCFG)
    H, b, H_rho, b_rho, H_xr = tba._assemble(lin, st, TCFG)
    H_corr, b_corr, H_rho_d = tba._schur_terms(H_rho, b_rho, H_xr, torch.tensor(lam),
                                               st.point_valid)
    assert "H_corr" not in got and "b_corr" not in got
    got["H_sc"], got["b_sc"] = got["H"], got["b"]
    for name, want in (("H_sc", H - H_corr), ("b_sc", b - b_corr),
                       ("H_rho_d", H_rho_d), ("b_rho", b_rho), ("H_xr", H_xr)):
        ref = _np(want)
        np.testing.assert_allclose(_np(got[name]), ref, rtol=1e-4,
                                   atol=1e-4 * max(1.0, float(np.abs(ref).max())), err_msg=name)
    np.testing.assert_allclose(_np(got["e_photo"]), _np(torch.sum(lin.energy)), rtol=1e-5)
    assert int(lin.active.sum()) > 500


def test_run_ba_model_matches_plain_and_jax(window):
    """4 LM steps of the model from the window's state, held to run_ba_plain and to the JAX package's
    run_ba at the run_ba parity test's bounds; with 12 steps (steps that
    are rejected, and lambda growing) to run_ba_plain."""
    st, images = window["ba"], window["images"]
    got, _, E, steps = _model_run_ba(st, images, TCAM, TCFG)
    want, E_want = tba.run_ba(st, images, TCAM, TCFG)
    assert_run_close(got, E, want, E_want)
    bj, Ej = jba.run_ba(_jax_state(st), jnp.asarray(_np(images)), JCAM, JCFG)
    jst = convert.from_np(tba.BAState, convert.to_np(jax.device_get(bj)))
    assert_run_close(got, E, jst, torch.tensor(np.asarray(Ej)))
    assert steps[0][0], "the first step is accepted"
    cfg12 = dataclasses.replace(TCFG, ba_iters=12)
    got, _, E, steps = _model_run_ba(st, images, TCAM, cfg12)
    want, E_want = tba.run_ba(st, images, TCAM, cfg12)
    assert_run_close(got, E, want, E_want)
    assert not all(s[0] for s in steps), f"no step rejected: {steps}"


@pytest.mark.parametrize("case", ["all_invalid", "iters0", "big_lambda", "rejected"])
def test_run_ba_model_edge_cases(window, case):
    """An all-invalid window (the identity guard keeps the solve regular and
    nothing moves), ba_iters 0 (the state and its energy), run_ba's largest
    lambda, and steps that are all rejected (the candidates' inverse depths
    clamped to 1e-3, points near infinity, raise the energy; the select
    keeps the state's bits): the model equals the plain form."""
    st, images = window["ba"], window["images"]
    cfg = TCFG
    if case == "all_invalid":
        st = st.replace(frame_valid=torch.zeros_like(st.frame_valid))
    elif case == "iters0":
        cfg = dataclasses.replace(TCFG, ba_iters=0)
    elif case == "big_lambda":
        cfg = dataclasses.replace(TCFG, ba_lambda_init=1e2, ba_iters=2)
    else:
        cfg = REJECTING
    got, _, E, steps = _model_run_ba(st, images, TCAM, cfg)
    want, E_want = tba.run_ba(st, images, TCAM, cfg)
    assert_run_close(got, E, want, E_want)
    assert torch.isfinite(got.T.t).all() and torch.isfinite(E)
    if case == "all_invalid":
        assert float(E) == float(E_want)
        np.testing.assert_array_equal(_np(got.T.t), _np(st.T.t))
    if case == "iters0":
        assert steps == []
    if case == "rejected":   # every step rejected: the select keeps the state's bits
        assert steps and not any(s[0] for s in steps)
        for x, y, z in ((got.T.R, want.T.R, st.T.R), (got.T.t, want.T.t, st.T.t),
                        (got.ab, want.ab, st.ab), (got.delta, want.delta, st.delta),
                        (got.idepth, want.idepth, st.idepth)):
            assert torch.equal(x, z) and torch.equal(y, z)
        assert float(E) == float(_energy(st, images, TCAM, cfg))


def test_status_and_marg_modes_equal_plain(window):
    """update_residual_status' masks exactly; _marg_pieces' four sums to
    1e-3 of their largest entry (the sums of ~1e8 the host Schur takes in
    f64), slot as an int and as a 0-d tensor."""
    st, images = window["ba"], window["images"]
    st = tba.run_ba(st, images, TCAM, TCFG)[0]
    got = _sweep(st, images, TCAM, TCFG, "status")
    want = tba.update_residual_status(st, images, TCAM, TCFG)
    assert torch.equal(got["res_active"], want.res_active)
    assert torch.equal(got["point_valid"], want.point_valid)
    for slot in (1, torch.tensor(2)):
        got = _sweep(st, images, TCAM, TCFG, "marg", slot=slot)
        want = tba._marg_pieces(st, images, TCAM, TCFG, slot)
        for k, name in enumerate(("H", "b", "H_corr", "b_corr")):
            ref = _np(want[k])
            np.testing.assert_allclose(_np(got[name]), ref, rtol=1e-3,
                                       atol=1e-3 * max(1.0, float(np.abs(ref).max())),
                                       err_msg=name)


def _rel(x: torch.Tensor, ref: torch.Tensor) -> float:
    """chip_smoke.py's marg measure: the largest error over the reference's
    largest entry (at least 1)."""
    return float((x.double() - ref.double()).abs().max()
                 / ref.double().abs().max().clamp_min(1.0))


@pytest.mark.parametrize("slot", [1, 2, 3])
def test_marg_model_nearer_float64_than_plain(window, slot):
    """The marg mode's phase A in double (marg_pair): each of the four sums
    sits nearer _marg_pieces_plain in float64 than the plain float32 form
    does, and within float32 rounding of its pair sums (2e-7 of the largest
    entry here, where the plain form sits at up to ~1.5e-6)."""
    st, images = window["ba"], window["images"]
    st = tba.run_ba(st, images, TCAM, TCFG)[0]
    got = _sweep(st, images, TCAM, TCFG, "marg", slot=slot)
    plain = tba._marg_pieces_plain(st, images, TCAM, TCFG, slot)
    ref = tba._marg_pieces_plain(_state64(st), images.double(), TCAM, TCFG, slot)
    for k, name in enumerate(("H", "b", "H_corr", "b_corr")):
        e_model, e_plain = _rel(got[name], ref[k]), _rel(plain[k], ref[k])
        assert e_model <= e_plain and e_model <= 2e-7, (name, e_model, e_plain)


def test_mixed_model_matches_plain(window):
    """run_ba_mixed on the model (the reprojection terms as an additive
    system and a second Schur pair in the solve, the reprojection energy
    added to the finish) against run_ba_mixed_plain: energies to 3e-3,
    poses to 5e-4, inverse depths to 1e-2 (tests/test_torch_hybrid.py's
    bounds)."""
    st, images = window["ba"], window["images"]
    ind = build_factors(window)
    got, rho_i, E, _ = _model_run_ba(st, images, TCAM, TCFG, ind=ind)
    want, ind_w, E_w = tba.run_ba_mixed(st, images, TCAM, TCFG, ind)
    np.testing.assert_allclose(_np(E), _np(E_w), rtol=3e-3)
    np.testing.assert_allclose(_np(got.T.t), _np(want.T.t), atol=5e-4)
    np.testing.assert_allclose(_np(got.T.R), _np(want.T.R), atol=5e-4)
    np.testing.assert_allclose(_np(got.idepth), _np(want.idepth), rtol=1e-2, atol=1e-3)
    np.testing.assert_allclose(_np(rho_i), _np(ind_w.idepth), rtol=1e-2, atol=1e-3)


def _jax_factors(ind: tba.IndirectFactors) -> jba.IndirectFactors:
    return jba.IndirectFactors(**{k: jnp.asarray(v) for k, v in convert.to_np(ind).items()})


def test_mixed_model_matches_jax(window):
    """run_ba_mixed on the model against the JAX package's run_ba_mixed on
    the same numpy inputs, at bk.MIXED_PARITY_TOL (tests/test_torch_hybrid.py's
    run_ba_mixed bounds: E 3e-3 relative, T 5e-4, inverse depths 1e-2
    relative above 1e-3), the factors' inverse depths held like idepth."""
    st, images = window["ba"], window["images"]
    ind = build_factors(window)
    got, rho_i, E, steps = _model_run_ba(st, images, TCAM, TCFG, ind=ind)
    bj, ij, Ej = jba.run_ba_mixed(_jax_state(st), jnp.asarray(_np(images)), JCAM, JCFG,
                                  _jax_factors(ind))
    jst = convert.from_np(tba.BAState, convert.to_np(jax.device_get(bj)))
    assert_run_close(got, E, jst, torch.tensor(np.asarray(Ej)), MIXED_TOL,
                     (rho_i, torch.tensor(np.asarray(ij.idepth))))
    assert steps[0][0], "the first step is accepted"


def _edge_factors(window, case: str):
    """(state, factors, what the case must show) for test_mixed_model_edge_cases."""
    st = window["ba"]
    ind = build_factors(window)
    Q = ind.num_points
    if case == "no_factors":
        ind = build_factors(window, Q=0)
    elif case == "all_invalid":
        ind = ind.replace(point_valid=torch.zeros(Q, dtype=torch.bool))
    elif case == "own_host_slot":   # observations in the host slot, far off: masked
        ok = ind.obs_valid.clone()
        ok[:, 0] = True
        ind = ind.replace(obs_valid=ok, obs_uv=torch.where(
            torch.arange(4)[None, :, None] == 0, ind.obs_uv + 40.0, ind.obs_uv))
    elif case == "behind_target":   # 8 points at depth 0.05: behind slots 1-3
        rho = ind.idepth.clone()
        rho[:8] = 20.0
        ind = ind.replace(idepth=rho)
    elif case == "chi2_above":      # 3 px of noise at sigma2 1: most chi2 over 5.991
        ind = build_factors(window, noise=3.0)
    elif case == "invalid_host_slot":   # 8 points hosted in slot 3, made invalid
        host = ind.host.clone()
        host[:8] = 3
        fv = st.frame_valid.clone()
        fv[3] = False
        st, ind = st.replace(frame_valid=fv), ind.replace(host=host)
    elif case == "capacity":
        ind = build_factors(window, Q=MIXED_POINTS, seed=7)
    return st, ind


@pytest.mark.parametrize("case", ["no_factors", "all_invalid", "own_host_slot", "behind_target",
                                  "chi2_above", "invalid_host_slot", "capacity"])
def test_mixed_model_edge_cases(window, case, monkeypatch):
    """The model's run_ba_mixed against run_ba_mixed_plain (E, T, the
    inverse depths and the factors' at bk.MIXED_PARITY_TOL) where the
    factors' masks and Huber branch decide: no factor points or none valid
    (then the model's run is its run_ba's, bit for bit, and the factors keep
    their inverse depths), observations in a point's own host slot, points
    behind their targets (depth 0.05 against slots 0.16-0.48 ahead), chi2
    over 5.991, an invalid host slot, and Q at the hybrid's mixed_points
    (256), with the run wrapper's refusal of one factor group more than a
    card's capacity (run_max_groups, planted here: the CPU has no card)."""
    st, images = window["ba"], window["images"]
    st, ind = _edge_factors(window, case)
    got, rho_i, E, _ = _model_run_ba(st, images, TCAM, TCFG, ind=ind)
    want, ind_w, E_w = tba.run_ba_mixed(st, images, TCAM, TCFG, ind)
    assert_run_close(got, E, want, E_w, MIXED_TOL, (rho_i, ind_w.idepth))
    r, w, *_, act, _ = tba._linearize_indirect(st, ind, TCAM, TCFG)
    chi2 = torch.sum(r * r, -1) / ind.sigma2
    if case in ("no_factors", "all_invalid"):
        plain, _, E_p, _ = _model_run_ba(st, images, TCAM, TCFG)
        assert float(E) == float(E_p) and torch.equal(got.T.t, plain.T.t)
        assert torch.equal(rho_i, ind.idepth)
    elif case == "own_host_slot":
        assert ind.obs_valid[:, 0].all() and not act[:, 0].any()
    elif case == "behind_target":
        seen = ind.obs_valid[:8] & ind.point_valid[:8, None]
        assert seen.any() and not act[:8].any()
    elif case == "chi2_above":
        assert int((act & (chi2 > tba._CHI2_2D)).sum()) > int((act & (chi2 <= tba._CHI2_2D)).sum())
    elif case == "invalid_host_slot":
        assert not act[:8].any() and act[8:].any()
    elif case == "capacity":
        assert ind.num_points == MIXED_POINTS and int(act.sum()) > 300
        cuda, P = torch.device("cuda"), st.uv.shape[0]
        most = -(-P // NPB) + MIXED_POINTS // NPB
        monkeypatch.setitem(bk._RUN_MAX_GROUPS, cuda, most)
        bk._check_run_groups(P, MIXED_POINTS, cuda)
        with pytest.raises(ValueError, match=f"at most {most} point groups"):
            bk._check_run_groups(P, MIXED_POINTS + 1, cuda)


@pytest.mark.parametrize("lam", [1e-3, 1e2], ids=["lam_init", "lam_cap"])
def test_ind_sweep_model_equals_plain_terms(window, lam):
    """The factor groups' block-ordered sums equal _indirect_terms (the
    additive system, the damped Schur pair, each point's rows) at run_ba's
    first and largest lambda, to 1e-4 of each sum's largest entry, and the
    energy indirect_energy's to 1e-5."""
    st = window["ba"]
    ind = build_factors(window)
    lam_t = torch.tensor(lam)
    got = _ind_sweep(st, ind, TCAM, TCFG, "system", lam)
    (Hi, bi, Hc, bc), (b_rho, H_xr, H_rho_d) = tba._indirect_terms(st, ind, TCAM, TCFG, lam_t)
    for name, want in (("Hi", Hi), ("bi", bi), ("Hi_corr", Hc), ("bi_corr", bc),
                       ("bi_rho", b_rho), ("Hi_xr", H_xr), ("Hi_rho_d", H_rho_d)):
        ref = _np(want)
        np.testing.assert_allclose(_np(got[name]), ref, rtol=1e-4,
                                   atol=1e-4 * max(1.0, float(np.abs(ref).max())), err_msg=name)
    e = _ind_sweep(st, ind, TCAM, TCFG, "energy")["e_ind"]
    np.testing.assert_allclose(_np(e), _np(tba.indirect_energy(st, ind, TCAM, TCFG)), rtol=1e-5)
    assert float(torch.abs(Hi).max()) > 0 and int(ind.point_valid.sum()) > 20


def test_lu_pivot_rule_and_reciprocals():
    """The solve's elimination picks the first row of largest magnitude (a
    tie goes to the first; a NaN below never wins; a NaN on the diagonal
    stays), and solves a well-conditioned system to f32 accuracy."""
    col = torch.tensor([1.0, 2.0, -50.0, 50.0, float("nan"), 3.0])
    assert _pivot(col, 0) == 2 and _pivot(col, 3) == 3 and _pivot(col, 4) == 4
    assert _pivot(torch.tensor([float("nan"), 2.0, 9.0]), 1) == 2
    rng = np.random.default_rng(0)
    B = rng.normal(size=(8, 8)).astype(np.float32) + 8 * np.eye(8, dtype=np.float32)
    cfg = dataclasses.replace(TCFG, max_frames=1, max_points=2, ba_prior_a=0.0, ba_prior_b=0.0)
    st = tba.empty_state(cfg).replace(frame_valid=torch.ones(1, dtype=torch.bool))
    system = {"H": torch.tensor(B), "b": torch.ones(8), "H_rho_d": torch.ones(2),
              "b_rho": torch.zeros(2), "H_xr": torch.zeros(2, 8)}
    _, x = _solve(system, st, 0.0, cfg)
    want = np.linalg.solve(B.astype(np.float64) + 1e-6 * np.eye(8), np.ones(8))
    np.testing.assert_allclose(_np(x), want, rtol=1e-4, atol=1e-5)


def _eliminate_warp(M: np.ndarray) -> tuple[np.ndarray, np.ndarray, list]:
    """csrc/ba_common.cuh warp_solve's elimination in float32: rows stay where
    they are (a lane holds two), each with its position in LAPACK's row
    order; the pivot from the candidates' magnitudes as ordered integers
    (+1; 0 for a NaN or a row already eliminated), the warp's max of them
    and then the least position holding it; an interchange swaps two rows'
    positions; every row below the pivot updated column by column with the
    pivot row's entries. Returns the factors in position order, the
    reciprocals and the pivots."""
    M = M.astype(np.float32).copy()
    D = M.shape[0]
    pos = list(range(D))
    rcp, piv = np.zeros(D, np.float32), []
    for k in range(D):
        keys = {}
        for r in range(D):
            v = np.float32(abs(M[r, k]))
            keys[r] = 0 if pos[r] < k or np.isnan(v) else int(v.view(np.uint32)) + 1
        m = max(keys.values())
        q = min((pos[r] for r in range(D) if m and keys[r] == m), default=64)
        first = abs(M[pos.index(k), k])
        best = np.uint32(max(m, 1) - 1).view(np.float32)
        p = k if (np.isnan(first) or m == 0 or not best > first) else q
        piv.append(p)
        if p != k:
            rk_, rp_ = pos.index(k), pos.index(p)
            pos[rk_], pos[rp_] = p, k
        owner = pos.index(k)
        rk = np.float32(1.0) / M[owner, k]
        rcp[k] = rk
        for r in range(D):
            if pos[r] > k:
                m_r = M[r, k] * rk
                for c in range(k + 1, D + 1):
                    M[r, c] = M[r, c] - m_r * M[owner, c]
    return M[[pos.index(i) for i in range(D)]], rcp, piv


@pytest.mark.parametrize("case", ["random", "pivoting", "window"])
def test_warp_lu_keeps_the_elimination_bits(window, case):
    """The warp's elimination (rows held in place, their positions
    interchanged, the pivot from integer reductions) gives every entry the
    operations of a block-wide elimination with row interchanges (the
    model's _eliminate): the same pivots, reciprocals and factors, bit for
    bit, on a random system, one that pivots at every step, and the window's
    damped system at run_ba's first lambda."""
    rng = np.random.default_rng(4)
    if case == "window":
        st = window["ba"]
        system = _sweep(st, window["images"], TCAM, TCFG, "system", lam=1e-3)
        A = system["H"] + st.H_m
        A = A + torch.diag(1e-3 * torch.diag(A)) + 1e-6 * torch.eye(A.shape[0])
        M = torch.cat([A, system["b"][:, None]], 1).numpy()
    else:
        D = 24
        M = rng.normal(size=(D, D + 1)).astype(np.float32)
        if case == "pivoting":
            M[:, :D] = M[:, :D][::-1] * (1.0 + np.arange(D)[:, None])
    want, rcp, piv = _eliminate(torch.tensor(M))
    got, rcp_w, piv_w = _eliminate_warp(M)
    assert piv == piv_w
    np.testing.assert_array_equal(rcp_w, rcp.numpy())
    D = M.shape[0]
    upper = np.triu(np.ones((D, D + 1), bool))
    np.testing.assert_array_equal(got[upper], want.numpy()[upper])


@pytest.mark.parametrize("blocks", [1, 3, 16, 128])
def test_phase_d_order_does_not_depend_on_the_grid(blocks):
    """Phase D as the kernels split it (chunk c of 32 entries to block c mod
    the grid, warp c div the grid, then every 8 warps' worth): every entry
    is summed once, over the groups in group order, so the reduced sums are
    the serial order's bits (a last block's: acc = 0, then blocks in
    order) whatever the grid."""
    rng = np.random.default_rng(2)
    G, total = 37, 3305
    part = rng.normal(size=(G, total)) * 10.0 ** rng.integers(-3, 10, size=(G, total))
    serial = np.zeros(total)
    for g in range(G):
        serial = serial + part[g]
    got, seen = np.full(total, np.nan), np.zeros(total, int)
    for b in range(blocks):
        for w in range(8):
            c = b + blocks * w
            while c * 32 < total:
                for lane in range(32):
                    task = c * 32 + lane
                    if task < total:
                        acc = 0.0
                        for g in range(G):
                            acc = acc + part[g, task]
                        got[task] = acc
                        seen[task] += 1
                c += blocks * 8
    assert (seen == 1).all()
    np.testing.assert_array_equal(got, serial)


# -- dispatch ---------------------------------------------------------------------------------


def test_cpu_tensors_take_the_plain_forms(window, monkeypatch):
    """CPU tensors run the plain forms and never reach the kernels'
    wrappers; the wrappers refuse CPU tensors and count nothing."""
    st, images = window["ba"], window["images"]
    bk.ba_sweep_cuda.launches = bk.ba_solve_cuda.launches = 0

    def boom(*a, **k):
        raise AssertionError("a CPU tensor reached a kernel wrapper")

    monkeypatch.setattr(bk, "ba_sweep_cuda", boom)
    monkeypatch.setattr(bk, "ba_solve_cuda", boom)
    cfg1 = dataclasses.replace(TCFG, ba_iters=1)
    tba.run_ba(st, images, TCAM, cfg1)
    tba.update_residual_status(st, images, TCAM, TCFG)
    tba._marg_pieces(st, images, TCAM, TCFG, 1)
    monkeypatch.undo()
    with pytest.raises(ValueError, match="CUDA"):
        bk.ba_sweep_cuda(st, images, TCAM, TCFG, "energy")
    with pytest.raises(ValueError, match="unsupported device"):
        tba.run_ba(st.replace(uv=st.uv.to("meta")), images, TCAM, TCFG)
    assert bk.ba_sweep_cuda.launches == 0 and bk.ba_solve_cuda.launches == 0


@pytest.mark.parametrize("fn", ["run_ba", "ba_step", "total_energy", "update_residual_status",
                                "_marg_pieces", "run_ba_mixed", "run_ba_mixed_one_launch",
                                "ba_step_mixed", "total_energy_mixed"])
def test_card_tensors_never_take_the_plain_forms(window, monkeypatch, fn):
    """The card's path launches the kernels or raises: with the device test
    answering "card" for these CPU tensors, every entry point reaches a
    kernel wrapper, which refuses them, and no plain form runs, the
    reprojection terms' PyTorch forms neither; run_ba_mixed without a mesh
    reaches the run kernel's wrapper (the one launch) and no other."""
    st, images = window["ba"], window["images"]

    def boom(*a, **k):
        raise AssertionError("the card's path took a plain form")

    for name in ("run_ba_plain", "ba_step_plain", "total_energy_plain",
                 "update_residual_status_plain", "_marg_pieces_plain", "run_ba_mixed_plain",
                 "linearize", "_assemble", "_linearize_indirect", "_assemble_indirect",
                 "_indirect_terms", "_indirect_idepth", "indirect_energy", "_schur_terms"):
        monkeypatch.setattr(tba, name, boom)
    monkeypatch.setattr(tba, "_on_card", lambda s: True)
    ind = build_factors(window, Q=4)
    if fn == "run_ba_mixed_one_launch":
        class OneLaunch(Exception):
            pass

        def run_kernel(state, images_, cam, cfg, trace=None, ind=None):
            assert ind is not None and ind.num_points == 4
            raise OneLaunch

        monkeypatch.setattr(bk, "ba_run_cuda", run_kernel)
        monkeypatch.setattr(bk, "ba_sweep_cuda", boom)
        monkeypatch.setattr(bk, "ba_solve_cuda", boom)
        with pytest.raises(OneLaunch):
            tba.run_ba_mixed(st, images, TCAM, TCFG, ind)
        return
    lam = torch.tensor(1e-3)
    calls = {"run_ba": lambda: tba.run_ba(st, images, TCAM, TCFG),
             "ba_step": lambda: tba.ba_step(st, images, TCAM, TCFG, lam),
             "total_energy": lambda: tba.total_energy(st, images, TCAM, TCFG),
             "update_residual_status": lambda: tba.update_residual_status(st, images, TCAM, TCFG),
             "_marg_pieces": lambda: tba._marg_pieces(st, images, TCAM, TCFG, 1),
             "run_ba_mixed": lambda: tba.run_ba_mixed(st, images, TCAM, TCFG, ind),
             "ba_step_mixed": lambda: tba.ba_step(st, images, TCAM, TCFG, lam, ind),
             "total_energy_mixed": lambda: tba.total_energy(st, images, TCAM, TCFG, ind)}
    with pytest.raises(ValueError, match="need CUDA tensors"):
        calls[fn]()


@pytest.mark.parametrize("what", ["frames", "dtype", "noncontiguous"])
def test_sweep_wrapper_rejects_what_the_kernel_does_not_take(window, what):
    st, images = window["ba"], window["images"]
    if what == "frames":
        with pytest.raises(ValueError, match="frame slots"):
            bk._check_state(st.replace(ab=torch.zeros(9, 2)), images, TCAM,
                            torch.device("cuda"))
        return
    bad, err, match = ((st.replace(idepth=st.idepth.double()), TypeError, "dtype")
                       if what == "dtype" else
                       (st.replace(color=st.color.T.contiguous().T), ValueError, "contiguous"))
    with pytest.raises(err, match=match):
        bk._check_state(bad, images, TCAM, torch.device("cpu"))
    with pytest.raises(ValueError, match="need CUDA tensors"):
        bk._check_state(st, images, TCAM, torch.device("cpu"))
