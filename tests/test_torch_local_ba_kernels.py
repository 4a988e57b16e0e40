"""The local BA kernel's arithmetic modelled on the CPU and held to the plain
form and to the JAX package; its dispatch; its wrapper's checks.

csrc/local_ba.cu cannot run here. A numpy model of its arithmetic stands in
for it:
- the observations grouped by point (a stable counting sort: each point's
  list in observation order);
- every observation's residual, chi2, weight and Jacobians in float64 from
  the float32 state;
- each stage's first energy and each candidate's: every observation's
  Huber term added in float64 per point group of 16 points,
  lane l of a warp taking the group's list positions l, l + 32, ... in
  order, then a tree over the 32 lanes; the groups' sums the same way;
- the system: a (point, frame slot) pair's H_cc, b_c, H_pp, b_p and W in
  float64 over its observations in list order; a point's H_pp and b_p over
  its pairs in slot order, damped (lambda, the 1e-8 guard) and inverted in
  closed form; V = W H_pp^-1; each entry of the group's partial Schur
  system over the group's points in point order; the entries over the
  groups in group order;
- the solve: the damped, frozen system rounded to float32 once and padded
  to a multiple of 8 with identity rows, csrc/local_ba.cu lu_solve's
  elimination (eliminate_lu: the pivot from two integer reductions, the
  reciprocal multipliers) and its back-substitution (back_substitute: each
  row's sum a tree over the lanes' strided partial sums), held bit for bit
  to ba_common.cuh warp_solve's elimination (the window BA's LU, which
  this kernel ran before it had a solve sized to its system;
  tests/test_torch_ba_kernels.py _eliminate_warp) at every size M 1-8;
- the schedule: the candidate poses exp(-dx) o T, the points X -
  H_pp^-1 (b_p - sum_m W_m^T dx_m) in float64 rounded once, the accept test
  E_new < E with the finiteness rule, lambda x0.4 (floor 1e-9) or x5 (cap
  1e3) from 1e-5 each stage, the chi2 prune after each stage.
The model is held to run_local_ba_plain and to
libcml_tpu.models.indirect.indirect_ba.run_local_ba at
tests/test_torch_hybrid.py's local-BA bounds (ops/local_ba.py parity: with a
float64 run of the plain form where a bound is exceeded or an observation
is pruned otherwise), on that test's problems (seeds 0 and 1), on the edge
cases of tests/test_torch_card_local_ba.py, which holds the kernel itself to
the plain form on the card, and on two problems of a full-hybrid call's
size with one fixed frame. The same parity refuses the model with a fault
planted (FAULTS). Worker time: about 60 s alone on one thread.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import libcml_tpu.models.indirect.indirect_ba as jiba
from libcml_tpu.core.camera import PinholeCamera as JCam
from libcml_tpu.core.lie import SE3 as JSE3

import libcml_tpu_torch.models.indirect.indirect_ba as tiba
from libcml_tpu_torch.core.lie import SE3, se3_exp
from libcml_tpu_torch.ops import local_ba as lba
from test_torch_ba_kernels import _eliminate_warp
from test_torch_card_local_ba import (EDGE_CASES, FULL_CAM, TCAM, edge_case,
                                      hybrid_shaped_problem, local_problem, problem_from)
from test_torch_hybrid import _local_problem

torch.set_num_threads(1)

NPG, MAX_M = 16, 8          # csrc/local_ba.cu: points a group, frame slots
CHI2 = 5.991


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# -- the model of csrc/local_ba.cu ----------------------------------------------------------


def lane_tree(values: np.ndarray) -> float:
    """Warp 0's sum of `values` (float64, in order): lane l adds positions l,
    l + 32, ... in order, then a tree over the lanes (lane l and lane l ^ o,
    o = 16, 8, 4, 2, 1)."""
    acc = np.zeros(32)
    for i, v in enumerate(values):
        acc[i % 32] = acc[i % 32] + v
    for o in (16, 8, 4, 2, 1):
        acc = acc + acc[np.arange(32) ^ o]
    return float(acc[0])


def group_lists(pt: np.ndarray, N: int) -> tuple[np.ndarray, np.ndarray]:
    """The kernel's lists: each point's observations in observation order
    (offsets (N + 1,), order (K,))."""
    order = np.argsort(pt, kind="stable")
    off = np.r_[0, np.cumsum(np.bincount(pt, minlength=N))]
    return off, order


def eliminate_lu(A: np.ndarray, steps: int | None = None,
                 keep: dict | None = None) -> tuple[np.ndarray, np.ndarray, list]:
    """csrc/local_ba.cu lu_solve's elimination of the (Dp, Dp + 1) system
    A in float32: rows stay where they are, each with its position in
    LAPACK's row order; the pivot of column k from two integer reductions:
    the largest key (a row's magnitude as an ordered integer + 1 at
    positions k and on, 0 for a NaN; the largest possible for a NaN at
    position k), then the least position holding it; an interchange swaps
    two rows' positions; every row below the pivot updated with the pivot
    row's entries (its multiplier a_ik rcp_k, rcp_k = 1 / a_kk). Returns
    the factors in position order, the reciprocals and the pivots. With
    `steps`, only the first that many columns are eliminated (the kernel
    stops at the real rows, D, of a padded system). With `keep` (a dict),
    what the kernel keeps for a second right-hand side (LuKeep): each step's
    multiplier of every row by its place ("m", 0 for a row not below the
    pivot) and its pivot row's place ("owner")."""
    M = A.astype(np.float32).copy()
    D = M.shape[0]
    pos = np.arange(D)
    rcp, piv = np.zeros(D, np.float32), []
    if keep is not None:
        keep["m"], keep["owner"] = np.zeros((D, D), np.float32), []
    with np.errstate(all="ignore"):
        for k in range(D if steps is None else steps):
            a = np.abs(M[:, k])
            key = np.where(np.isnan(a) | (pos < k), 0, a.view(np.uint32).astype(np.int64) + 1)
            key = np.where(np.isnan(a) & (pos == k), 2 ** 32 - 1, key)
            p = int(pos[key == key.max()].min())
            piv.append(p)
            if p != k:
                rk_, rp_ = np.flatnonzero(pos == k)[0], np.flatnonzero(pos == p)[0]
                pos[rk_], pos[rp_] = p, k
            owner = np.flatnonzero(pos == k)[0]
            rk = np.float32(1.0) / M[owner, k]
            rcp[k] = rk
            below = pos > k
            m = M[below, k] * rk
            M[below, k + 1:] = M[below, k + 1:] - m[:, None] * M[owner, k + 1:][None, :]
            if keep is not None:
                keep["m"][k, below] = m
                keep["owner"].append(int(owner))
    return M[np.argsort(pos)], rcp, piv


def resolve_lu(U: np.ndarray, rcp: np.ndarray, keep: dict, rhs: np.ndarray, n: int) -> np.ndarray:
    """csrc/local_ba.cu lu_resolve: the system that eliminate_lu factored
    (U, rcp and its `keep`) at another right-hand side `rhs` (by row): the
    elimination's updates of the right-hand side replayed (each step's
    pivot row's value into U's last column, then every row less its
    multiplier times it), then back_substitute."""
    y = np.asarray(rhs, np.float32).copy()
    U = U.copy()
    with np.errstate(all="ignore"):
        for k in range(n):
            uy = y[keep["owner"][k]]
            U[k, -1] = uy
            y = y - keep["m"][k] * uy
    return back_substitute(U, rcp, n)


def back_substitute(U: np.ndarray, rcp: np.ndarray, n: int | None = None) -> np.ndarray:
    """The solve's back-substitution in position order in float32 over the
    first n unknowns (all by default): x_k = (y_k - sum_j>k u_kj x_j) rcp_k,
    lane l of the warp adding the terms j = k + 1 + l, k + 33 + l in order,
    then a tree over the lanes."""
    Dp = U.shape[0]
    n = Dp if n is None else n
    x = np.zeros(Dp, np.float32)
    with np.errstate(all="ignore"):
        for k in range(n - 1, -1, -1):
            lanes = np.zeros(32, np.float32)
            for j in range(k + 1, n):
                lanes[(j - k - 1) % 32] = lanes[(j - k - 1) % 32] + U[k, j] * x[j]
            for o in (16, 8, 4, 2, 1):
                lanes = lanes + lanes[np.arange(32) ^ o]
            x[k] = (U[k, Dp] - lanes[0]) * rcp[k]
    return x


# faults planted in the model (and, on the card, in copies of the kernel by
# tools/local_ba_witness.py), which lba.parity must not pass: no step ever
# accepted, the Huber weight dropped (every weight 1 / sigma^2), the last
# frame slot's H_cc left out of the reduced system
FAULTS = ("never_accepts", "no_huber", "last_hcc_dropped")


class Model:
    """csrc/local_ba.cu's run on numpy arrays of an IndirectBAProblem (with
    `fault`, one of FAULTS planted)."""

    def __init__(self, prob, cam, fault: str | None = None):
        self.fault = fault
        self.fx, self.fy, self.cx, self.cy = (float(np.float32(v)) for v in (
            cam.fx, cam.fy, cam.cx, cam.cy))
        self.M, self.N = prob.T.t.shape[0], prob.Xw.shape[0]
        self.fv = _np(prob.frame_valid).astype(bool)
        self.free = self.fv & ~_np(prob.frame_fixed).astype(bool)
        self.pv = _np(prob.point_valid).astype(bool)
        self.f = _np(prob.obs_frame).astype(np.int64)
        self.p = _np(prob.obs_point).astype(np.int64)
        self.uv = _np(prob.obs_uv).astype(np.float32).astype(np.float64)
        self.s2 = _np(prob.obs_sigma2).astype(np.float32).astype(np.float64)
        self.off, self.order = group_lists(self.p, self.N)
        self.G = -(-self.N // NPG)
        self.R = _np(prob.T.R).astype(np.float32).copy()
        self.t = _np(prob.T.t).astype(np.float32).copy()
        self.X = _np(prob.Xw).astype(np.float32).copy()
        self.ov = _np(prob.obs_valid).astype(bool).copy()
        self.trace = []

    def residual(self, R, t, X, k):
        f, p = self.f[k], self.p[k]
        with np.errstate(all="ignore"):
            Xc = (np.einsum("kij,kj->ki", R[f].astype(np.float64), X[p].astype(np.float64))
                  + t[f].astype(np.float64))
            z = Xc[:, 2]
            inv_z = 1.0 / np.where(np.abs(z) < 1e-12, 1e-12, z)
            u = (self.fx * Xc[:, 0]) * inv_z + self.cx
            v = (self.fy * Xc[:, 1]) * inv_z + self.cy
            r = np.stack([u - self.uv[k, 0], v - self.uv[k, 1]], -1)
            chi2 = (r[:, 0] * r[:, 0] + r[:, 1] * r[:, 1]) / self.s2[k]
        active = self.ov[k] & (z > 1e-6) & self.fv[f] & self.pv[p]
        return Xc, r, chi2, active

    def group_range(self, g):
        return self.off[g * NPG], self.off[min(self.N, (g + 1) * NPG)]

    def energy(self, R, t, X) -> float:
        parts = []
        for g in range(self.G):
            j0, j1 = self.group_range(g)
            k = self.order[j0:j1]
            _, _, chi2, act = self.residual(R, t, X, k)
            with np.errstate(all="ignore"):
                e = np.where(chi2 <= CHI2, chi2, 2.0 * np.sqrt(CHI2 * np.maximum(chi2, 1e-12))
                             - CHI2)
            parts.append(lane_tree(np.where(act, e, 0.0)))
        return lane_tree(np.asarray(parts))

    def system(self, lam):
        """The reduced system (float64 upper triangle, then b) and, per point,
        W (M, 6, 3), H_pp^-1 (3, 3), b_p."""
        M, N, D = self.M, self.N, 6 * self.M
        iu = np.triu_indices(D)
        nU = iu[0].size
        W = np.zeros((N, MAX_M, 6, 3))
        Hcc = np.zeros((N, MAX_M, 6, 6))
        bc = np.zeros((N, MAX_M, 6))
        Hpp = np.zeros((N, MAX_M, 3, 3))
        bpt = np.zeros((N, MAX_M, 3))
        k = self.order
        Xc, r, chi2, act = self.residual(self.R, self.t, self.X, k)
        with np.errstate(all="ignore"):
            hub = np.where(chi2 > CHI2, np.sqrt(CHI2 / np.maximum(chi2, 1e-12)), 1.0)
            if self.fault == "no_huber":
                hub = np.ones_like(chi2)
            w = np.where(act, hub / self.s2[k], 0.0)
            x, y, z = Xc[:, 0], Xc[:, 1], Xc[:, 2]
            iz = 1.0 / np.maximum(z, 1e-9)
            iz2 = iz * iz
            p00, p02 = self.fx * iz, ((-self.fx) * x) * iz2
            p11, p12 = self.fy * iz, ((-self.fy) * y) * iz2
            zero = np.zeros_like(x)
            Jc = np.stack([np.stack([p00, zero, p02, p02 * y, p00 * z - p02 * x, -(p00 * y)], -1),
                           np.stack([zero, p11, p12, -(p11 * z) + p12 * y, -(p12 * x), p11 * x],
                                    -1)], 1)                                    # (K, 2, 6)
            Rf = self.R[self.f[k]].astype(np.float64)
            Jp = np.stack([p00[:, None] * Rf[:, 0] + p02[:, None] * Rf[:, 2],
                           p11[:, None] * Rf[:, 1] + p12[:, None] * Rf[:, 2]], 1)  # (K, 2, 3)
            rd = r
            hcc = w[:, None, None] * np.einsum("kud,kue->kde", Jc, Jc)
            bcc = w[:, None] * np.einsum("kud,ku->kd", Jc, rd)
            Wk = w[:, None, None] * np.einsum("kud,kue->kde", Jc, Jp)
            hpp = w[:, None, None] * np.einsum("kud,kue->kde", Jp, Jp)
            bpp = w[:, None] * np.einsum("kud,ku->kd", Jp, rd)
        # each pair's observations in list order (np.add.at adds in index order)
        idx = (self.p[k], self.f[k])
        for acc, term in ((W, Wk), (Hcc, hcc), (bc, bcc), (Hpp, hpp), (bpt, bpp)):
            np.add.at(acc, idx, term)
        # each point: over its slots in order, damped, inverted in closed form
        H = np.zeros((N, 3, 3))
        bp = np.zeros((N, 3))
        for m in range(MAX_M):
            H, bp = H + Hpp[:, m], bp + bpt[:, m]
        A = H.copy()
        for i in range(3):
            A[:, i, i] = (H[:, i, i] + np.float64(lam) * H[:, i, i]) + 1e-8
        a, b_, c, d, e, f = A[:, 0, 0], A[:, 0, 1], A[:, 0, 2], A[:, 1, 1], A[:, 1, 2], A[:, 2, 2]
        c00, c01, c02 = d * f - e * e, c * e - b_ * f, b_ * e - c * d
        c11, c12, c22 = a * f - c * c, b_ * c - a * e, a * d - b_ * b_
        with np.errstate(all="ignore"):
            det = (a * c00 + b_ * c01) + c * c02
            Hinv = np.stack([np.stack([c00, c01, c02], -1), np.stack([c01, c11, c12], -1),
                             np.stack([c02, c12, c22], -1)], -2) / det[:, None, None]
        Hinv = np.where(self.pv[:, None, None], Hinv, 0.0)
        with np.errstate(all="ignore"):
            V = np.einsum("nmde,nef->nmdf", W, Hinv)
            bpr = bc - np.einsum("nmdf,nf->nmd", V, bp)
        # each group's partial system over its points in order, then the groups
        part = np.zeros((self.G, nU + D))
        fi, ai, fj, bj = iu[0] // 6, iu[0] % 6, iu[1] // 6, iu[1] % 6
        diag = fi == fj
        if self.fault == "last_hcc_dropped":
            diag = diag & (fi != M - 1)
        for g in range(self.G):
            acc = np.zeros(nU + D)
            for pl in range(NPG):
                n = g * NPG + pl
                if n >= N:
                    continue   # zeros: x + 0 is x
                with np.errstate(all="ignore"):
                    red = np.einsum("ec,ec->e", V[n, fi, ai], W[n, fj, bj])
                    h = np.where(diag, Hcc[n, fi, ai, bj], 0.0)
                    acc[:nU] = acc[:nU] + (h - red)
                acc[nU:] = acc[nU:] + bpr[n, :M].reshape(-1)
            part[g] = acc
        sys = np.zeros(nU + D)
        for g in range(self.G):
            sys = sys + part[g]
        return sys, W, Hinv, bp

    def solve(self, sys, lam) -> np.ndarray:
        """The kernel's solve_step: the damped system rounded to float32,
        padded, solved by the warp's LU; then one step of iterative
        refinement, the damped system's residual in double solved by the
        same LU's factors (resolve_lu) and added in double, the sum rounded
        once."""
        D = 6 * self.M
        Dp = 8 * (-(-D // 8))
        iu = np.triu_indices(D)
        S = np.zeros((D, D))
        S[iu] = sys[:iu[0].size]
        S = S + np.triu(S, 1).T
        fd = np.repeat(self.free, 6)
        A = np.eye(Dp + 1, dtype=np.float32)[:Dp]
        A64 = np.zeros((D, D))
        A[:, Dp] = 0
        g = np.zeros(D)
        with np.errstate(all="ignore"):
            for r in range(D):
                for c in range(D):
                    if fd[r] and fd[c]:
                        h = S[r, c]
                        if r == c:
                            h = (h + np.float64(lam) * h) + 1e-7
                        A[r, c], A64[r, c] = np.float32(h), h
                    elif r == c:
                        A[r, c] = (np.float32(1) + np.float32(lam)) + np.float32(1e-7)
                        A64[r, c] = A[r, c]
                    else:
                        A[r, c] = 0
                g[r] = sys[iu[0].size + r] if fd[r] else 0.0
            A[:D, Dp] = g.astype(np.float32)
            keep = {}
            U, rcp, _ = eliminate_lu(A, D, keep)
            x0 = back_substitute(U, rcp, D)[:D].astype(np.float64)
            res = np.zeros(Dp, np.float32)
            res[:D] = (g - A64 @ x0).astype(np.float32)
            x = x0 + resolve_lu(U, rcp, keep, res, D)[:D]
        return x.astype(np.float32)

    def candidate(self, dx, W, Hinv, bp):
        M = self.M
        xi = torch.tensor(-dx.reshape(M, 6))
        Tn = se3_exp(xi).compose(SE3(R=torch.tensor(self.R), t=torch.tensor(self.t)))
        R = np.where(self.free[:, None, None], _np(Tn.R), self.R).astype(np.float32)
        t = np.where(self.free[:, None], _np(Tn.t), self.t).astype(np.float32)
        with np.errstate(all="ignore"):
            u = bp - np.einsum("nmdc,md->nc", W[:, :M], dx.reshape(M, 6).astype(np.float64))
            d = np.einsum("nce,ne->nc", Hinv, u)
            X = (self.X.astype(np.float64) - d).astype(np.float32)
        return R, t, np.where(self.pv[:, None], X, self.X)

    def prune(self):
        k = self.order
        _, _, chi2, act = self.residual(self.R, self.t, self.X, k)
        self.ov[k] = act & (chi2 < CHI2)

    def run(self, iters=(5, 10)):
        mid = None
        for stage, n in enumerate(iters):
            if n:
                E = self.energy(self.R, self.t, self.X)
                lam = np.float32(1e-5)
            for _ in range(n):
                sys, W, Hinv, bp = self.system(lam)
                dx = self.solve(sys, lam)
                R, t, X = self.candidate(dx, W, Hinv, bp)
                E_new = self.energy(R, t, X)
                fin = bool(np.isfinite(R).all() and np.isfinite(t).all() and np.isfinite(X).all())
                self.trace.append((E, E_new, fin))
                if fin and E_new < E and self.fault != "never_accepts":
                    self.R, self.t, self.X, E = R, t, X, E_new
                    lam = max(lam * np.float32(0.4), np.float32(1e-9))
                else:
                    lam = min(lam * np.float32(5), np.float32(1e3))
            self.prune()
            if stage == 0:
                mid = self.ov.copy()
        return mid

    def result(self, prob):
        return prob.replace(T=SE3(R=torch.tensor(self.R), t=torch.tensor(self.t)),
                            Xw=torch.tensor(self.X), obs_valid=torch.tensor(self.ov))


def model_run(prob, cam, iters=(5, 10), fault: str | None = None):
    m = Model(prob, cam, fault)
    mid = m.run(iters)
    return m.result(prob), m, torch.tensor(mid)


def _jax_result(pt, cam, iters):
    d = {k: jnp.asarray(_np(getattr(pt, k))) for k in (
        "frame_valid", "frame_fixed", "Xw", "point_valid", "obs_frame", "obs_point", "obs_uv",
        "obs_valid", "obs_sigma2")}
    pj = jiba.IndirectBAProblem(T=JSE3(R=jnp.asarray(_np(pt.T.R)), t=jnp.asarray(_np(pt.T.t))),
                                **d)
    oj = jiba.run_local_ba(pj, JCam.make(cam.fx, cam.fy, cam.cx, cam.cy, cam.width, cam.height),
                           *iters)
    return pt.replace(T=SE3(R=torch.tensor(np.asarray(oj.T.R)), t=torch.tensor(np.asarray(oj.T.t))),
                      Xw=torch.tensor(np.asarray(oj.Xw)),
                      obs_valid=torch.tensor(np.asarray(oj.obs_valid)))


def _against_plain(got, mid_g, prob, iters, cam=TCAM):
    """lba.parity of a result of the model against the plain form, a float64
    run of the plain form behind it; the plain form's trace; that run."""
    tr_p, mid_p = [], []
    want = tiba.run_local_ba_plain(prob, cam, *iters, trace=tr_p, mid=mid_p)
    ref = lba.f64_run(prob, cam, *iters)
    return lba.parity(got, want, prob, cam, ref, (mid_g, mid_p[0].obs_valid)), tr_p, ref


def _hold(got, mid_g, prob, iters, ref_jax: bool = True, cam=TCAM):
    """The model's result held to the plain form (lba.parity, a float64 run
    of the plain form behind it) and, with `ref_jax`, to the JAX package."""
    rep, tr_p, ref = _against_plain(got, mid_g, prob, iters, cam)
    assert rep["ok"], rep
    if ref_jax:
        rj = lba.parity(got, _jax_result(prob, cam, iters), prob, cam, ref)
        assert rj["ok"], rj
    return rep, tr_p


# -- the model against the plain form and the JAX package ------------------------------------


@pytest.mark.parametrize("seed", [0, 1])
def test_model_matches_plain_and_jax(seed):
    """tests/test_torch_hybrid.py's seeded problems (frames 0 and 1 fixed):
    the model within that test's bounds of the plain form and of the JAX
    package; a step accepted otherwise than in the plain form only where
    the plain form's accept test sits within lba.DECISION_TOL of 0."""
    _, pt = _local_problem(seed)
    got, m, mid = model_run(pt, TCAM)
    rep, tr_p = _hold(got, mid, pt, (5, 10))
    assert rep["within"] and not rep["edge_obs"]
    k = torch.tensor([[float(e), float(en), float(f)] for e, en, f in m.trace],
                     dtype=torch.float64)
    assert all(d["within"] for d in lba.decisions(k, tr_p))
    assert lba.chi2_np(got, TCAM)[_np(got.obs_valid)].max() < 5.991


@pytest.mark.parametrize("name", EDGE_CASES)
def test_model_edge_cases(name):
    """Every observation invalid, a valid point without a valid
    observation, a step whose candidate is NaN (the JAX package takes it,
    the port does not), a two-view problem with frame 0 fixed and sigma^2 =
    1, no iterations, six frames: the model held to the plain form (and,
    but for the NaN step, to the JAX package)."""
    d, iters = edge_case(name)
    prob = problem_from(d)
    got, m, mid = model_run(prob, TCAM, iters)
    _hold(got, mid, prob, iters, ref_jax=name != "nonfinite_step")
    if name in ("all_invalid", "no_iterations"):
        assert torch.equal(got.T.t, prob.T.t) and torch.equal(got.Xw, prob.Xw)
    if name == "all_invalid":
        assert not bool(got.obs_valid.any())
    if name == "point_without_obs":
        assert torch.equal(got.Xw[3], prob.Xw[3])
    if name == "nonfinite_step":
        tr = np.asarray(m.trace[:iters[0]], dtype=np.float64)
        assert (tr[:, 2] == 0).all() and (tr[:, 1] < tr[:, 0]).all()


@pytest.mark.parametrize("seed", [0, 1])
def test_model_on_hybrid_shaped_problems(seed):
    """A problem of a full-hybrid local BA's size and kind (one fixed frame,
    640x480, M 6, N 654, K 1,656): with one fixed frame the scale is a free
    gauge, and the float32 plain form and the JAX package may drift from a
    float64 run (seed 1: the plain form 3e-2 in T) where the model stays
    within lba.F64_TOL of it. The model held to the plain form and to the
    JAX package by lba.parity."""
    prob = problem_from(hybrid_shaped_problem(seed))
    got, _, mid = model_run(prob, FULL_CAM)
    rep, _ = _hold(got, mid, prob, (5, 10), cam=FULL_CAM)
    assert not rep["unexplained_obs"]
    assert all(rep["kernel_vs_f64"][m] <= lba.F64_TOL[m] for m in lba.MEASURES)


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("case", ["seed0", "seed1", "hybrid0", "hybrid1"])
def test_parity_fails_planted_faults(case, fault):
    """lba.parity refuses the model with a fault planted (FAULTS), on
    tests/test_torch_hybrid.py's problems (two fixed frames) and on the
    hybrid-shaped ones (one fixed frame, where the plain form may drift from
    float64 and "no further from float64 than the plain form" alone may not
    refuse it): there the fault lies beyond lba.F64_TOL of the float64 run
    in some measure."""
    if case.startswith("seed"):
        _, prob = _local_problem(int(case[4:]))
        cam = TCAM
    else:
        prob, cam = problem_from(hybrid_shaped_problem(int(case[6:]))), FULL_CAM
    got, _, mid = model_run(prob, cam, fault=fault)
    rep, _, _ = _against_plain(got, mid, prob, (5, 10), cam)
    assert not rep["ok"]
    if case.startswith("hybrid"):
        assert not all(rep["within_f64"].values()), rep["kernel_vs_f64"]


def test_model_lists_are_the_plain_forms_point_table():
    """The kernel's lists (a stable counting sort by point) hold each point's
    observations in the order of the plain form's point table (segments)."""
    pt = problem_from(local_problem(0))
    N = pt.Xw.shape[0]
    off, order = group_lists(_np(pt.obs_point).astype(np.int64), N)
    table = _np(tiba.segments(pt.obs_point.long(), N))
    K = pt.obs_point.shape[0]
    for n in range(N):
        assert order[off[n]:off[n + 1]].tolist() == [k for k in table[n] if k < K]


@pytest.mark.parametrize("D", [12, 30, 36, 42])
def test_identity_padding_keeps_the_elimination(D):
    """The kernel pads the (6M)^2 system to a multiple of 8 with identity
    rows for the warp's LU: the real rows take the same pivots, reciprocals
    and factors, bit for bit, as the unpadded elimination, and the padding's
    unknowns stay 0."""
    rng = np.random.default_rng(D)
    A = rng.normal(size=(D, D + 1)).astype(np.float32)
    A[:, :D] += np.float32(D) * np.eye(D, dtype=np.float32) * rng.random(D).astype(np.float32)
    Dp = 8 * (-(-D // 8))
    P = np.zeros((Dp, Dp + 1), np.float32)
    P[:D, :D], P[:D, Dp] = A[:, :D], A[:, D]
    P[np.arange(D, Dp), np.arange(D, Dp)] = 1.0
    U, rcp, piv = _eliminate_warp(A)
    Up, rcpp, pivp = _eliminate_warp(P)
    assert pivp[:D] == piv and pivp[D:] == list(range(D, Dp))
    np.testing.assert_array_equal(rcpp[:D], rcp)
    np.testing.assert_array_equal(Up[:D, :D], U[:, :D])
    np.testing.assert_array_equal(Up[:D, Dp], U[:, D])
    np.testing.assert_array_equal(Up[:D, D:Dp], 0.0)


def _padded(A: np.ndarray) -> np.ndarray:
    """A (D, D + 1) system padded to Dp = 8 ceil(D / 8) with identity rows,
    as the kernel pads the (6M)^2 system."""
    D = A.shape[0]
    Dp = 8 * (-(-D // 8))
    P = np.zeros((Dp, Dp + 1), np.float32)
    P[:D, :D], P[:D, Dp] = A[:, :D], A[:, D]
    P[np.arange(D, Dp), np.arange(D, Dp)] = 1.0
    return P


def _bits(x: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(x, np.float32).view(np.uint32)


@pytest.mark.parametrize("case", ["random", "ties", "nan_column"])
@pytest.mark.parametrize("M", range(1, 9))
def test_sized_solve_keeps_warp_solve_bits(M, case):
    """lu_solve (sized to Dp = 8 ceil(6M / 8), one row a lane up to Dp 32,
    the pivot from two integer reductions, its steps and back-substitution
    stopped at the real rows D = 6M) takes the same pivots, reciprocals,
    factors and x on the real rows as warp_solve's full elimination of the
    same padded system, bit for bit (a NaN by its bits): a damped random system,
    one of small integers (ties for the pivot in most columns, the first
    row of largest magnitude taken), and one with a NaN column (from a row
    below the diagonal, and a NaN on the diagonal itself, which stays its
    own pivot)."""
    D = 6 * M
    rng = np.random.default_rng(100 + M)
    A = rng.normal(size=(D, D + 1)).astype(np.float32)
    if case == "ties":
        A = rng.integers(-3, 4, size=(D, D + 1)).astype(np.float32)
    A[:, :D] += np.float32(D) * np.eye(D, dtype=np.float32) * rng.random(D).astype(np.float32)
    if case == "nan_column":
        c = D // 3
        A[D // 2:, c] = np.nan
        A[min(c + 1, D - 1), min(c + 1, D - 1)] = np.nan
    P = _padded(A)
    U, rcp, piv = eliminate_lu(P, D)
    Uw, rcpw, pivw = _eliminate_warp(P)
    Dp = P.shape[0]
    upper = np.triu(np.ones((Dp, Dp + 1), bool))[:D]
    assert piv == pivw[:D]
    np.testing.assert_array_equal(_bits(rcp[:D]), _bits(rcpw[:D]))
    np.testing.assert_array_equal(_bits(U[:D][upper]), _bits(Uw[:D][upper]))
    np.testing.assert_array_equal(_bits(back_substitute(U, rcp, D)[:D]),
                                  _bits(back_substitute(Uw, rcpw)[:D]))
    if case == "ties":
        assert any(p != k for k, p in enumerate(piv))


@pytest.mark.parametrize("case", ["random", "ties"])
@pytest.mark.parametrize("M", range(1, 9))
def test_resolve_keeps_a_second_eliminations_bits(M, case):
    """The refinement's solve (lu_resolve: the first elimination's
    multipliers and pivots replayed on a new right-hand side) gives the x
    that eliminating the same padded system again at that right-hand side
    gives, bit for bit, so keeping the factors changes no step: a damped
    random system and one of small integers (ties for the pivot)."""
    D = 6 * M
    rng = np.random.default_rng(200 + M)
    A = rng.normal(size=(D, D + 1)).astype(np.float32)
    if case == "ties":
        A = rng.integers(-3, 4, size=(D, D + 1)).astype(np.float32)
    A[:, :D] += np.float32(D) * np.eye(D, dtype=np.float32) * rng.random(D).astype(np.float32)
    P = _padded(A)
    keep = {}
    U, rcp, piv = eliminate_lu(P, D, keep)
    rhs = np.zeros(P.shape[0], np.float32)
    rhs[:D] = rng.normal(size=D).astype(np.float32) * np.float32(1e-3)
    P2 = P.copy()
    P2[:, -1] = rhs
    U2, rcp2, piv2 = eliminate_lu(P2, D)
    assert piv2 == piv and len(keep["owner"]) == D
    np.testing.assert_array_equal(_bits(resolve_lu(U, rcp, keep, rhs, D)[:D]),
                                  _bits(back_substitute(U2, rcp2, D)[:D]))
    if case == "ties":
        assert any(p != k for k, p in enumerate(piv))


def test_lane_tree_is_one_fixed_order():
    """The energies' sum order: the same values in the same positions give
    the same bits; it is within float64 rounding of the exact sum."""
    rng = np.random.default_rng(3)
    v = rng.random(300) * 10.0 ** rng.integers(-3, 3, 300)
    assert lane_tree(v) == lane_tree(v.copy())
    assert abs(lane_tree(v) - float(np.sum(v.astype(np.longdouble)))) <= 1e-12 * v.sum()


# -- dispatch and the wrapper ---------------------------------------------------------------


def test_cpu_problems_take_the_plain_form(monkeypatch):
    """A problem on the CPU runs run_local_ba_plain and never reaches the
    kernel's wrapper."""
    pt = problem_from(local_problem(0))

    def boom(*a, **k):
        raise AssertionError("a CPU problem reached the kernel's wrapper")

    monkeypatch.setattr(tiba, "local_ba_cuda", boom)
    calls = []
    plain = tiba.run_local_ba_plain
    monkeypatch.setattr(tiba, "run_local_ba_plain", lambda *a, **k: calls.append(1) or plain(*a))
    out = tiba.run_local_ba(pt, TCAM, 1, 1)
    assert calls == [1] and out.Xw.shape == pt.Xw.shape


def test_card_problems_never_take_the_plain_form(monkeypatch):
    """With the device test answering "card", run_local_ba reaches the
    kernel's wrapper once, with the stages' iterations, and never the plain
    loop or ba_step; the wrapper refuses these CPU tensors."""
    pt = problem_from(local_problem(0))

    def boom(*a, **k):
        raise AssertionError("the card's path took the plain form")

    for name in ("run_local_ba_plain", "ba_step", "group_observations", "ba_energy"):
        monkeypatch.setattr(tiba, name, boom)
    monkeypatch.setattr(tiba, "_on_card", lambda p: True)
    seen = []
    monkeypatch.setattr(tiba, "local_ba_cuda", lambda p, cam, s1, s2: seen.append((s1, s2)) or p)
    tiba.run_local_ba(pt, TCAM, 3, 7)
    assert seen == [(3, 7)]
    monkeypatch.undo()
    monkeypatch.setattr(tiba, "_on_card", lambda p: True)
    before = lba.local_ba_cuda.launches
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        tiba.run_local_ba(pt, TCAM)
    assert lba.local_ba_cuda.launches == before
    monkeypatch.undo()
    with pytest.raises(ValueError, match="unsupported device"):
        tiba.run_local_ba(pt.replace(Xw=pt.Xw.to("meta")), TCAM)


@pytest.mark.parametrize("what", ["frames", "dtype", "shape"])
def test_wrapper_refuses_what_the_kernel_does_not_take(what):
    pt = problem_from(local_problem(0))
    before = lba.local_ba_cuda.launches
    if what == "frames":
        bad, err, match = (pt.replace(T=SE3(R=torch.eye(3).expand(9, 3, 3).contiguous(),
                                            t=torch.zeros(9, 3))), ValueError, "frame slots")
    elif what == "dtype":
        bad, err, match = pt.replace(obs_frame=pt.obs_frame.long()), TypeError, "dtype"
    else:
        bad, err, match = pt.replace(obs_uv=pt.obs_uv[:-1]), ValueError, "shape"
    with pytest.raises(err, match=match):
        lba.local_ba_cuda(bad, TCAM)
    assert lba.local_ba_cuda.launches == before
