"""Indirect (reprojection) local bundle adjustment: batched LM with a Schur
complement over 3D points.

PyTorch port of libcml_tpu/models/indirect/indirect_ba.py (the reference's
g2o local BA, src/cml/optimization/g2o/IndirectBundleAdjustment.cpp:7
localOptimize: local keyframes + fixed frames, Huber on the chi2, 5 + 10
iterations with a chi2 prune between them). The graph is flat observation
arrays (frame, point, pixel) with validity masks. One linearization is one
batched sweep of (K, 2, 6) pose and (K, 2, 3) point Jacobians, summed into
the frame and point blocks through fixed group tables (`segments`: the same
sums on every run, where float atomics would not be); the point blocks (3x3
each) are inverted in a batch and eliminated, leaving a dense (6M, 6M)
camera system.
The LM loop is fixed-length with accept/reject by torch.where, so no
iteration reads the host (the group tables read their sizes once a run).
On the card `run_local_ba` is one launch of a hand-written kernel
(ops/local_ba.py, csrc/local_ba.cu); `run_local_ba_plain` is the loop.
"""

from __future__ import annotations

import dataclasses

import torch

from libcml_tpu_torch.core.camera import PinholeCamera
from libcml_tpu_torch.core.lie import SE3, se3_exp, se3_select, skew
from libcml_tpu_torch.ops.local_ba import local_ba_cuda

_CHI2_2D = 5.991


@dataclasses.dataclass
class IndirectBAProblem:
    """Flat local-BA problem (M frame slots, N point slots, K observations)."""

    T: SE3                       # (M,) world-to-camera poses
    frame_valid: torch.Tensor    # (M,) bool
    frame_fixed: torch.Tensor    # (M,) bool: poses held constant
    Xw: torch.Tensor             # (N, 3) world points
    point_valid: torch.Tensor    # (N,) bool
    obs_frame: torch.Tensor      # (K,) int32
    obs_point: torch.Tensor      # (K,) int32
    obs_uv: torch.Tensor         # (K, 2)
    obs_valid: torch.Tensor      # (K,) bool
    obs_sigma2: torch.Tensor     # (K,) measurement variance in px^2 (per level)

    def replace(self, **kw) -> "IndirectBAProblem":
        return dataclasses.replace(self, **kw)


def _residuals(prob: IndirectBAProblem, cam: PinholeCamera):
    f, p = prob.obs_frame.long(), prob.obs_point.long()
    Xc = (prob.T.R[f] @ prob.Xw[p][..., None])[..., 0] + prob.T.t[f]      # (K, 3)
    pred, z_ok = cam.project(Xc)
    r = pred - prob.obs_uv
    active = prob.obs_valid & z_ok & prob.frame_valid[f] & prob.point_valid[p]
    return r, Xc, active


def _jacobians(prob: IndirectBAProblem, Xc: torch.Tensor, cam: PinholeCamera):
    """(K, 2, 6) pose (left perturbation) and (K, 2, 3) point Jacobians."""
    x, y, z = Xc[..., 0], Xc[..., 1], Xc[..., 2]
    iz = 1.0 / torch.clamp(z, min=1e-9)
    iz2 = iz * iz
    zero = torch.zeros_like(x)
    J_proj = torch.stack([
        torch.stack([cam.fx * iz, zero, -cam.fx * x * iz2], -1),
        torch.stack([zero, cam.fy * iz, -cam.fy * y * iz2], -1),
    ], dim=-2)                                                            # (K, 2, 3)
    eye = torch.eye(3, dtype=Xc.dtype, device=Xc.device).expand(Xc.shape[0], 3, 3)
    J_pose = J_proj @ torch.cat([eye, -skew(Xc)], dim=-1)                # (K, 2, 6)
    J_pt = J_proj @ prob.T.R[prob.obs_frame.long()]                      # (K, 2, 3)
    return J_pose, J_pt


def _chi2(r: torch.Tensor, sigma2: torch.Tensor) -> torch.Tensor:
    return torch.sum(r * r, -1) / sigma2


def ba_energy(prob: IndirectBAProblem, cam: PinholeCamera) -> torch.Tensor:
    """Robust (Huber-on-chi2) total energy."""
    r, _, active = _residuals(prob, cam)
    chi2 = _chi2(r, prob.obs_sigma2)
    e = torch.where(chi2 <= _CHI2_2D, chi2,
                    2.0 * torch.sqrt(_CHI2_2D * torch.clamp(chi2, min=1e-12)) - _CHI2_2D)
    return torch.sum(torch.where(active, e, torch.zeros_like(e)))


def segments(index: torch.Tensor, n: int) -> torch.Tensor:
    """(n, C) table of the positions k of `index` (K,) in each group 0..n-1,
    in increasing order, padded with K; C is the largest group. Built once
    per problem (a host read per table, C), it turns every grouped sum of an LM
    step into a gather and a sum over a fixed-length axis: the same additions
    in the same order on every run, where a float index_add on CUDA adds in
    the order its atomics land."""
    K = index.shape[0]
    dev = index.device
    order = torch.argsort(index, stable=True)
    key = index[order]
    counts = torch.bincount(index, minlength=n)
    start = torch.cumsum(counts, 0) - counts
    rank = torch.arange(K, device=dev) - start[key]
    C = int(counts.max()) if K else 0
    table = torch.full((n, max(C, 1)), K, dtype=torch.long, device=dev)
    table[key, rank] = order
    return table


def _sum_into(table: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """(n, ...) sums of `values` (K, ...) over the groups of `table`
    (segments), each group's terms added in a fixed order."""
    padded = torch.cat([values, values.new_zeros((1,) + values.shape[1:])])
    return padded[table].sum(dim=1)


@dataclasses.dataclass
class Groups:
    """The observations' groups for the grouped sums of ba_step: by frame,
    by point and by (frame, point) pair."""

    frame: torch.Tensor
    point: torch.Tensor
    pair: torch.Tensor


def group_observations(prob: IndirectBAProblem) -> Groups:
    """The plain form's three group tables (segments): a host read per
    table. The kernel groups the observations by point itself."""
    M, N = prob.T.t.shape[0], prob.Xw.shape[0]
    f, p = prob.obs_frame.long(), prob.obs_point.long()
    return Groups(frame=segments(f, M), point=segments(p, N), pair=segments(f * N + p, M * N))


def ba_step(prob: IndirectBAProblem, cam: PinholeCamera,
            lam: torch.Tensor, groups: Groups | None = None) -> IndirectBAProblem:
    """One LM iteration with Schur elimination of the point block."""
    M, N = prob.T.t.shape[0], prob.Xw.shape[0]
    D = M * 6
    dev = prob.Xw.device
    g = groups if groups is not None else group_observations(prob)

    r, Xc, active = _residuals(prob, cam)
    chi2 = _chi2(r, prob.obs_sigma2)
    hub = torch.where(chi2 > _CHI2_2D, torch.sqrt(_CHI2_2D / torch.clamp(chi2, min=1e-12)),
                      torch.ones_like(chi2))
    w = torch.where(active, hub / prob.obs_sigma2, torch.zeros_like(chi2))
    J_c, J_p = _jacobians(prob, Xc, cam)
    free = prob.frame_valid & ~prob.frame_fixed

    Jc_w = J_c * w[:, None, None]
    Jp_w = J_p * w[:, None, None]
    H_cc = _sum_into(g.frame, Jc_w.transpose(1, 2) @ J_c)                  # (M, 6, 6)
    b_c = _sum_into(g.frame, (Jc_w.transpose(1, 2) @ r[..., None])[..., 0])  # (M, 6)
    H_pp = _sum_into(g.point, Jp_w.transpose(1, 2) @ J_p)                  # (N, 3, 3)
    b_p = _sum_into(g.point, (Jp_w.transpose(1, 2) @ r[..., None])[..., 0])  # (N, 3)
    # cross blocks W[m, n] = sum_k J_c^T w J_p over the observations of (m, n)
    W = _sum_into(g.pair, Jc_w.transpose(1, 2) @ J_p).reshape(M, N, 6, 3)

    # LM damping + a small guard, then the batched 3x3 inverse
    eye3 = torch.eye(3, dtype=H_pp.dtype, device=dev)
    H_pp_d = H_pp + lam * torch.diag_embed(torch.diagonal(H_pp, dim1=-2, dim2=-1)) + 1e-8 * eye3
    pv = prob.point_valid[:, None, None]
    H_pp_d = torch.where(pv, H_pp_d, eye3.expand(N, 3, 3))
    H_pp_inv, _ = torch.linalg.inv_ex(H_pp_d)
    H_pp_inv = torch.where(pv, H_pp_inv, torch.zeros_like(H_pp_inv))

    # Schur: H_sc = H_cc - W Hpp^-1 W^T (couples frame pairs through points)
    WHinv = torch.einsum("mnde,nef->mndf", W, H_pp_inv)                # (M, N, 6, 3)
    H_red = torch.einsum("mndf,lngf->mldg", WHinv, W)                  # (M, M, 6, 6)
    b_red = torch.einsum("mndf,nf->md", WHinv, b_p)                    # (M, 6)
    H_full = -H_red
    idx = torch.arange(M, device=dev)
    H_full[idx, idx] += H_cc
    b_full = (b_c - b_red).reshape(D)
    H_dense = H_full.permute(0, 2, 1, 3).reshape(D, D)

    # damping; fixed and invalid frames frozen through identity rows
    free_d = torch.repeat_interleave(free, 6)
    keep = free_d[:, None] & free_d[None, :]
    H_dense = torch.where(keep, H_dense, torch.zeros_like(H_dense)) + torch.diag(
        torch.where(free_d, torch.zeros_like(b_full), torch.ones_like(b_full)))
    H_dense = H_dense + lam * torch.diag(torch.diag(H_dense)) + 1e-7 * torch.eye(
        D, dtype=H_dense.dtype, device=dev)
    b_full = torch.where(free_d, b_full, torch.zeros_like(b_full))
    dx, _ = torch.linalg.solve_ex(H_dense, b_full)
    dx_f = dx.reshape(M, 6)

    # back-substitute the points: dX = Hpp^-1 (b_p - W^T dx)
    Wt_dx = torch.einsum("mnde,md->ne", W, dx_f)
    dX = (H_pp_inv @ (b_p - Wt_dx)[..., None])[..., 0]
    dX = torch.where(prob.point_valid[:, None], dX, torch.zeros_like(dX))

    T_new = se3_exp(-dx_f).compose(prob.T)
    return prob.replace(T=se3_select(free, T_new, prob.T), Xw=prob.Xw - dX)


def _select(accept: torch.Tensor, a: IndirectBAProblem,
            b: IndirectBAProblem) -> IndirectBAProblem:
    """where(accept, a, b) over the fields an LM step changes (T, Xw)."""
    return b.replace(T=se3_select(accept, a.T, b.T), Xw=torch.where(accept, a.Xw, b.Xw))


def _prune(prob: IndirectBAProblem, cam: PinholeCamera) -> IndirectBAProblem:
    """Drop observations whose un-robustified chi2 fails the 95 % test."""
    r, _, active = _residuals(prob, cam)
    return prob.replace(obs_valid=prob.obs_valid & active
                        & (_chi2(r, prob.obs_sigma2) < _CHI2_2D))


def run_local_ba_plain(prob: IndirectBAProblem, cam: PinholeCamera, stage1_iters: int = 5,
                       stage2_iters: int = 10, trace: list | None = None,
                       mid: list | None = None) -> IndirectBAProblem:
    """Two-stage local BA with a chi2 observation prune between the stages
    and after them (reference: localOptimize, 5 iterations, prune chi2 >
    5.991, 10 more), as a Python loop of PyTorch ops: run_local_ba's form on
    the CPU, and the reference the kernel is held to on the card.

    A step whose solve went singular (with one fixed frame the scale is a
    free gauge, and the damping falls to ~1e-7) is rejected. The JAX
    package accepts it: ba_energy masks the non-finite residuals, so the
    NaN state scores 0 (ROADMAP.md section 3). With `trace` (a list), each
    step appends its (E, E_new, finite) as 0-d tensors; with `mid`, the
    problem after the first stage and its prune is appended."""

    groups = group_observations(prob)

    def lm_loop(prob, iters):
        E = ba_energy(prob, cam)
        lam = torch.full((), 1e-5, dtype=torch.float32, device=prob.Xw.device)
        for _ in range(iters):
            cand = ba_step(prob, cam, lam, groups)
            E_new = ba_energy(cand, cam)
            finite = torch.isfinite(cand.Xw).all() & torch.isfinite(cand.T.t).all() \
                & torch.isfinite(cand.T.R).all()
            if trace is not None:
                trace.append((E, E_new, finite))
            accept = (E_new < E) & finite
            prob = _select(accept, cand, prob)
            E = torch.where(accept, E_new, E)
            lam = torch.where(accept, torch.clamp(lam * 0.4, min=1e-9),
                              torch.clamp(lam * 5.0, max=1e3))
        return prob

    prob = _prune(lm_loop(prob, stage1_iters), cam)
    if mid is not None:
        mid.append(prob)
    return _prune(lm_loop(prob, stage2_iters), cam)


def _on_card(prob: IndirectBAProblem) -> bool:
    """True for a problem on a CUDA device (the kernel), False on the CPU
    (the plain form); any other device raises."""
    kind = prob.Xw.device.type
    if kind not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {prob.Xw.device}")
    return kind == "cuda"


def _contiguous(prob: IndirectBAProblem) -> IndirectBAProblem:
    return prob.replace(
        T=SE3(R=prob.T.R.contiguous(), t=prob.T.t.contiguous()),
        **{f.name: getattr(prob, f.name).contiguous() for f in dataclasses.fields(prob)
           if f.name != "T"})


def run_local_ba(prob: IndirectBAProblem, cam: PinholeCamera, stage1_iters: int = 5,
                 stage2_iters: int = 10) -> IndirectBAProblem:
    """run_local_ba_plain's two LM stages and prunes. A problem on the card
    runs them in one launch of the hand-written kernel (ops/local_ba.py,
    csrc/local_ba.cu: no host read; a failed build or launch raises, and
    nothing falls back to the plain form); a problem on the CPU runs the
    plain form."""
    if not _on_card(prob):
        return run_local_ba_plain(prob, cam, stage1_iters, stage2_iters)
    return local_ba_cuda(_contiguous(prob), cam, stage1_iters, stage2_iters)
