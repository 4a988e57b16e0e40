"""Motion-only PnP: pose optimization over 3D-2D matches with Huber + covariance.

PyTorch port of libcml_tpu/models/indirect/pnp.py (the reference's g2o
IndirectCameraOptimizer, src/cml/optimization/g2o/
IndirectCameraOptimizer.cpp:4,201 — 4 rounds x 10 LM iterations with chi2
outlier re-classification between rounds, 6x6 pose covariance). Every edge
is unary, so the normal equations are one (N, 2, 6) Jacobian batch reduced
by einsum (`pnp_lm_plain`); the accept/reject tests stay on the device. On
the card the whole solve is one launch of a hand-written kernel
(ops/pnp_lm.py, csrc/pnp_lm.cu).
"""

from __future__ import annotations

import dataclasses

import torch

from libcml_tpu_torch.core.camera import PinholeCamera
from libcml_tpu_torch.core.lie import SE3, se3_exp, se3_select, skew
from libcml_tpu_torch.ops.pnp_lm import pnp_lm_cuda

_CHI2_2D = 5.991  # 95% chi2 with 2 dof (the reference's threshold)


@dataclasses.dataclass
class PnPResult:
    T: SE3                    # optimized world-to-camera pose
    inlier: torch.Tensor      # (N,) bool final inlier classification
    num_inliers: torch.Tensor
    cov: torch.Tensor         # (6, 6) pose covariance (inverse Hessian)
    chi2: torch.Tensor        # total inlier chi2


def _residuals(T: SE3, Xw: torch.Tensor, uv: torch.Tensor, cam: PinholeCamera):
    Xc = Xw @ T.R.T + T.t
    pred, z_ok = cam.project(Xc)
    return pred - uv, Xc, z_ok


def _jacobian(Xc: torch.Tensor, cam: PinholeCamera) -> torch.Tensor:
    """(N, 2, 6) d(reproj)/d(xi) for the left-multiplied update exp(xi) T."""
    x, y, z = Xc[..., 0], Xc[..., 1], Xc[..., 2]
    iz = 1.0 / torch.clamp(z, min=1e-9)
    iz2 = iz * iz
    zero = torch.zeros_like(x)
    J_proj = torch.stack(
        [
            torch.stack([cam.fx * iz, zero, -cam.fx * x * iz2], -1),
            torch.stack([zero, cam.fy * iz, -cam.fy * y * iz2], -1),
        ],
        dim=-2,
    )
    eye = torch.eye(3, dtype=Xc.dtype, device=Xc.device).expand(*Xc.shape[:-1], 3, 3)
    J_X = torch.cat([eye, -skew(Xc)], dim=-1)
    return J_proj @ J_X


def _robust_energy(chi2: torch.Tensor, ok: torch.Tensor) -> torch.Tensor:
    e = torch.minimum(chi2, _CHI2_2D * torch.sqrt(torch.clamp(chi2 / _CHI2_2D, min=1.0)))
    return torch.sum(torch.where(ok, e, torch.zeros_like(e)))


def pnp_lm_plain(Xw: torch.Tensor, uv: torch.Tensor, valid: torch.Tensor,
                 sigma2: torch.Tensor, R0: torch.Tensor, t0: torch.Tensor,
                 cam: PinholeCamera, rounds: int, iters: int):
    """The plain PyTorch form of the PnP kernel (ops/pnp_lm.py,
    csrc/pnp_lm.cu): the same arguments (sigma2 (N,)) and outputs (R, t,
    inlier, num_inliers, cov, chi2, trace (rounds, iters, 2): each step's E
    and E_new)."""
    dev = Xw.device
    w_meas = 1.0 / sigma2
    eye6 = torch.eye(6, dtype=torch.float32, device=dev)

    T, inlier = SE3(R=R0, t=t0), valid
    trace = []
    for _ in range(rounds):
        lam = torch.full((), 1e-4, dtype=torch.float32, device=dev)
        for _ in range(iters):
            r, Xc, z_ok = _residuals(T, Xw, uv, cam)
            ok = inlier & z_ok
            chi2 = torch.sum(r * r, -1) * w_meas
            # Huber on the chi2 (reference: RobustKernelHuber, delta^2 = 5.991)
            hub = torch.where(chi2 > _CHI2_2D,
                              torch.sqrt(_CHI2_2D / torch.clamp(chi2, min=1e-12)),
                              torch.ones_like(chi2))
            w = torch.where(ok, w_meas * hub, torch.zeros_like(chi2))
            J = _jacobian(Xc, cam)
            H = torch.einsum("nud,n,nue->de", J, w, J)
            b = torch.einsum("nud,n,nu->d", J, w, r)
            H = H + lam * torch.diag(torch.diag(H)) + 1e-8 * eye6
            dx, _ = torch.linalg.solve_ex(H, b)
            T_new = se3_exp(-dx).compose(T)
            r_new, _, _ = _residuals(T_new, Xw, uv, cam)
            E = _robust_energy(chi2, ok)
            E_new = _robust_energy(torch.sum(r_new * r_new, -1) * w_meas, ok)
            accept = E_new < E
            T = se3_select(accept, T_new, T)
            lam = torch.where(accept, torch.clamp(lam * 0.5, min=1e-9),
                              torch.clamp(lam * 4.0, max=1e3))
            trace.append(torch.stack([E, E_new]))
        # re-classify on the UN-robustified chi2 (reference does exactly this
        # between its 4 optimize() calls)
        r, _, z_ok = _residuals(T, Xw, uv, cam)
        chi2 = torch.sum(r * r, -1) * w_meas
        inlier = valid & z_ok & (chi2 < _CHI2_2D)

    r, Xc, _ = _residuals(T, Xw, uv, cam)
    J = _jacobian(Xc, cam)
    w = torch.where(inlier, w_meas, torch.zeros_like(w_meas))
    H = torch.einsum("nud,n,nue->de", J, w, J) + 1e-6 * eye6
    cov, _ = torch.linalg.inv_ex(H)
    chi2 = torch.sum(torch.where(inlier, torch.sum(r * r, -1) * w_meas,
                                 torch.zeros_like(w_meas)))
    trace = (torch.stack(trace) if trace else torch.zeros((0, 2), device=dev)).reshape(
        rounds, iters, 2)
    return T.R, T.t, inlier, torch.sum(inlier), cov, chi2, trace


def solve_pnp(
    Xw: torch.Tensor,          # (N, 3) world points
    uv: torch.Tensor,          # (N, 2) observed pixels
    valid: torch.Tensor,       # (N,) candidate mask
    T_init: SE3,
    cam: PinholeCamera,
    sigma2: torch.Tensor | float = 1.0,   # per-match measurement variance (px^2)
    rounds: int = 4,
    iters_per_round: int = 10,
) -> PnPResult:
    """Motion-only PnP with per-round chi2 outlier reclassification: the
    kernel (one launch, no host read) for CUDA tensors, `pnp_lm_plain` for
    CPU tensors."""
    dev = Xw.device
    sigma2 = torch.as_tensor(sigma2, dtype=torch.float32)
    sigma2 = (sigma2 if sigma2.device == dev else sigma2.to(dev)).expand(Xw.shape[:1])
    args = (Xw, uv, valid, sigma2, T_init.R, T_init.t)
    if dev.type == "cuda":
        out = pnp_lm_cuda(*(x.contiguous() for x in args), cam, rounds, iters_per_round)
    elif dev.type == "cpu":
        out = pnp_lm_plain(*args, cam, rounds, iters_per_round)
    else:
        raise ValueError(f"solve_pnp: unsupported device {dev}")
    R, t, inlier, num_inliers, cov, chi2, _ = out
    return PnPResult(T=SE3(R=R, t=t), inlier=inlier, num_inliers=num_inliers, cov=cov,
                     chi2=chi2)


def triangulate_linear(uv0: torch.Tensor, uv1: torch.Tensor, T_10: SE3,
                       cam: PinholeCamera) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched linear two-view triangulation (DLT normal equations;
    reference: Triangulation.h:116). Points in frame-0 coordinates.
    Returns (X0 (N, 3), valid (N,) — positive depth in both views)."""
    x0 = cam.normalized(uv0)
    x1 = cam.normalized(uv1)
    R, t = T_10.R, T_10.t

    def rows(x, P_R, P_t):
        r1 = x[..., 0:1] * P_R[None, 2, :] - P_R[None, 0, :]
        r2 = x[..., 1:2] * P_R[None, 2, :] - P_R[None, 1, :]
        b1 = P_t[0] - x[..., 0] * P_t[2]
        b2 = P_t[1] - x[..., 1] * P_t[2]
        return torch.stack([r1, r2], -2), torch.stack([b1, b2], -1)

    A0, b0 = rows(x0, torch.eye(3, dtype=x0.dtype, device=x0.device),
                  torch.zeros(3, dtype=x0.dtype, device=x0.device))
    A1, b1 = rows(x1, R, t)
    A = torch.cat([A0, A1], dim=-2)                    # (N, 4, 3)
    b = torch.cat([b0, b1], dim=-1)                    # (N, 4)
    AtA = A.transpose(-1, -2) @ A + 1e-9 * torch.eye(3, dtype=A.dtype, device=A.device)
    Atb = (A.transpose(-1, -2) @ b[..., None])[..., 0]
    X0 = torch.linalg.solve_ex(AtA, Atb[..., None])[0][..., 0]
    X1 = X0 @ R.T + t
    valid = (X0[..., 2] > 1e-4) & (X1[..., 2] > 1e-4)
    return X0, valid
