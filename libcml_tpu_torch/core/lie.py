"""SO(3)/SE(3) Lie-group operations on tensors with any leading batch dims.

PyTorch port of libcml_tpu/core/lie.py (the reference's rotation algebra and
pose type, src/cml/maths/Rotation.h:12-113, src/cml/map/Camera.h:27).

Conventions (unchanged from the JAX package):
  - Rotations are (..., 3, 3) matrices; tangents are (..., 3) axis-angle.
  - SE(3) elements are (R, t) pairs in the `SE3` dataclass; the action is
    x_out = R @ x + t.
  - `se3_exp` uses the twist convention xi = (v, w) with the V-matrix
    coupling translation and rotation.
All ops guard small angles with Taylor expansions, selected with where (no
data-dependent control flow).
"""

from __future__ import annotations

import dataclasses
import math

import torch

_EPS = 1e-8


def _eye3(like: torch.Tensor, shape) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device).expand(*shape, 3, 3)


def _mv(M: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Batched matrix-vector product (..., n, m) x (..., m) -> (..., n)."""
    return (M @ x.unsqueeze(-1)).squeeze(-1)


def skew(w: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) cross-product matrix."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zero = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([zero, -wz, wy], dim=-1),
            torch.stack([wz, zero, -wx], dim=-1),
            torch.stack([-wy, wx, zero], dim=-1),
        ],
        dim=-2,
    )


def _sinc_coeffs(theta2: torch.Tensor):
    """A = sin(t)/t, B = (1-cos(t))/t^2, C = (t-sin(t))/t^3 with Taylor
    fallbacks for small t (t2 = t^2)."""
    theta = torch.sqrt(torch.clamp(theta2, min=_EPS * _EPS))
    small = theta2 < 1e-8
    A = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    B = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2)
    C = torch.where(small, 1.0 / 6.0 - theta2 / 120.0, (1.0 - A) / theta2)
    return A, B, C


def _skew_sq(w: torch.Tensor) -> torch.Tensor:
    """K(w) @ K(w) computed analytically as w w^T - |w|^2 I."""
    theta2 = torch.sum(w * w, dim=-1)
    outer = w[..., :, None] * w[..., None, :]
    return outer - theta2[..., None, None] * _eye3(w, outer.shape[:-2])


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Axis-angle (..., 3) -> rotation matrix (..., 3, 3) (Rodrigues)."""
    theta2 = torch.sum(w * w, dim=-1)
    A, B, _ = _sinc_coeffs(theta2)
    K = skew(w)
    return (_eye3(w, K.shape[:-2]) + A[..., None, None] * K
            + B[..., None, None] * _skew_sq(w))


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> axis-angle (..., 3); the theta ~ 0 and
    theta ~ pi branches are both computed and selected with where."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    theta = torch.arccos(cos_t)
    vee = torch.stack(
        [
            R[..., 2, 1] - R[..., 1, 2],
            R[..., 0, 2] - R[..., 2, 0],
            R[..., 1, 0] - R[..., 0, 1],
        ],
        dim=-1,
    )
    sin_t = torch.sin(theta)
    small = theta < 1e-5
    factor = torch.where(
        small,
        0.5 + theta * theta / 12.0,
        theta / torch.clamp(2.0 * sin_t, min=_EPS),
    )
    w_generic = factor[..., None] * vee

    # near-pi branch: axis from the diagonal of (R + I)/2, signs relative to
    # the largest-magnitude component
    near_pi = theta > math.pi - 1e-3
    B = (R + torch.eye(3, dtype=R.dtype, device=R.device)) * 0.5
    diag = torch.stack([B[..., 0, 0], B[..., 1, 1], B[..., 2, 2]], dim=-1)
    axis_abs = torch.sqrt(torch.clamp(diag, min=0.0))
    k = torch.argmax(axis_abs, dim=-1)
    off = torch.stack(
        [
            0.5 * (B[..., 0, 1] + B[..., 1, 0]),
            0.5 * (B[..., 0, 2] + B[..., 2, 0]),
            0.5 * (B[..., 1, 2] + B[..., 2, 1]),
        ],
        dim=-1,
    )  # (xy, xz, yz)
    ax, ay, az = axis_abs[..., 0], axis_abs[..., 1], axis_abs[..., 2]
    xy, xz, yz = off[..., 0], off[..., 1], off[..., 2]
    a0 = torch.stack([ax, torch.sign(xy) * ay, torch.sign(xz) * az], dim=-1)
    a1 = torch.stack([torch.sign(xy) * ax, ay, torch.sign(yz) * az], dim=-1)
    a2 = torch.stack([torch.sign(xz) * ax, torch.sign(yz) * ay, az], dim=-1)
    sel = torch.stack([a0, a1, a2], dim=-2)  # (..., 3, 3)
    idx = k[..., None, None].expand(*k.shape, 1, 3)
    axis = torch.gather(sel, -2, idx)[..., 0, :]
    norm = torch.linalg.norm(axis, dim=-1, keepdim=True)
    axis = axis / torch.clamp(norm, min=_EPS)
    w_pi = theta[..., None] * axis
    return torch.where(near_pi[..., None], w_pi, w_generic)


def so3_V(w: torch.Tensor) -> torch.Tensor:
    """Left Jacobian V of SO(3): exp(xi)_t = V(w) @ v."""
    theta2 = torch.sum(w * w, dim=-1)
    _, B, C = _sinc_coeffs(theta2)
    K = skew(w)
    return (_eye3(w, K.shape[:-2]) + B[..., None, None] * K
            + C[..., None, None] * _skew_sq(w))


def so3_V_inv(w: torch.Tensor) -> torch.Tensor:
    """Inverse left Jacobian of SO(3)."""
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(torch.clamp(theta2, min=_EPS * _EPS))
    K = skew(w)
    small = theta2 < 1e-8
    half_theta = 0.5 * theta
    cot = torch.where(
        small,
        1.0 / 12.0 + theta2 / 720.0,
        (1.0 - half_theta * torch.cos(half_theta)
         / torch.clamp(torch.sin(half_theta), min=_EPS))
        / torch.clamp(theta2, min=_EPS),
    )
    return _eye3(w, K.shape[:-2]) - 0.5 * K + cot[..., None, None] * _skew_sq(w)


@dataclasses.dataclass
class SE3:
    """Rigid transform x -> R @ x + t, batched over leading dims."""

    R: torch.Tensor  # (..., 3, 3)
    t: torch.Tensor  # (..., 3)

    def replace(self, **kw) -> "SE3":
        return dataclasses.replace(self, **kw)

    @classmethod
    def identity(cls, batch_shape=(), dtype=torch.float32,
                 device: str | torch.device = "cpu") -> "SE3":
        R = torch.eye(3, dtype=dtype, device=device).expand(*batch_shape, 3, 3)
        t = torch.zeros((*batch_shape, 3), dtype=dtype, device=device)
        return cls(R=R.clone(), t=t)

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        """Transform points x (..., 3)."""
        return _mv(self.R, x) + self.t

    def compose(self, other: "SE3") -> "SE3":
        """self ∘ other: first apply `other`, then `self`."""
        return SE3(R=self.R @ other.R, t=_mv(self.R, other.t) + self.t)

    def inverse(self) -> "SE3":
        Rt = self.R.transpose(-1, -2)
        return SE3(R=Rt, t=-_mv(Rt, self.t))

    def to(self, other: "SE3") -> "SE3":
        """Relative transform self ∘ other^-1 (both world-to-camera)."""
        return self.compose(other.inverse())

    def normalized(self) -> "SE3":
        """Project R back onto SO(3) (nearest rotation by SVD); load-bearing
        for any pose fed back through itself (the constant-velocity model
        squares the pose every frame, doubling R's orthonormality defect).
        U @ Vt is unique for a rotation, so the SVD's sign conventions do not
        matter."""
        U, _, Vt = torch.linalg.svd(self.R)
        d = torch.linalg.det(U @ Vt)
        one = torch.ones_like(d[..., None])
        fix = torch.cat([one, one, d[..., None]], dim=-1)
        R = (U * fix[..., None, :]) @ Vt
        return SE3(R=R, t=self.t)

    def matrix34(self) -> torch.Tensor:
        return torch.cat([self.R, self.t[..., None]], dim=-1)

    def adjoint(self) -> torch.Tensor:
        """(..., 6, 6) adjoint for twists ordered (v, w)."""
        tK = skew(self.t)
        top = torch.cat([self.R, tK @ self.R], dim=-1)
        bottom = torch.cat([torch.zeros_like(self.R), self.R], dim=-1)
        return torch.cat([top, bottom], dim=-2)

    def index(self, i) -> "SE3":
        """Batch element(s) i of a batched pose."""
        return SE3(R=self.R[i], t=self.t[i])


def se3_select(pred: torch.Tensor, a: SE3, b: SE3) -> SE3:
    """Elementwise where(pred, a, b) over a pose (pred broadcasts over the
    leading batch dims)."""
    p = torch.as_tensor(pred, device=a.R.device)
    return SE3(R=torch.where(p[..., None, None], a.R, b.R),
               t=torch.where(p[..., None], a.t, b.t))


def se3_stack(poses: list[SE3]) -> SE3:
    return SE3(R=torch.stack([p.R for p in poses]),
               t=torch.stack([p.t for p in poses]))


def se3_exp(xi: torch.Tensor) -> SE3:
    """Twist (..., 6) ordered (v, w) -> SE3."""
    v, w = xi[..., :3], xi[..., 3:]
    return SE3(R=so3_exp(w), t=_mv(so3_V(w), v))


def se3_log(T: SE3) -> torch.Tensor:
    """SE3 -> twist (..., 6) ordered (v, w)."""
    w = so3_log(T.R)
    v = _mv(so3_V_inv(w), T.t)
    return torch.cat([v, w], dim=-1)


def se3_retract(T: SE3, xi: torch.Tensor) -> SE3:
    """Left-multiplicative retraction exp(xi) ∘ T."""
    return se3_exp(xi).compose(T)


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Quaternion (..., 4) (w, x, y, z) -> rotation matrix."""
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack(
        [
            torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
            torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
            torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
        ],
        dim=-2,
    )


def matrix_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> quaternion (..., 4) (w, x, y, z), branch-free: four
    candidate constructions, the best-conditioned picked by max pivot."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def den(x):
        return torch.clamp(4 * x, min=_EPS)

    qw0 = torch.sqrt(torch.clamp(1.0 + tr, min=0.0)) * 0.5
    q0 = torch.stack([qw0, (m21 - m12) / den(qw0), (m02 - m20) / den(qw0),
                      (m10 - m01) / den(qw0)], dim=-1)
    qx1 = torch.sqrt(torch.clamp(1.0 + m00 - m11 - m22, min=0.0)) * 0.5
    q1 = torch.stack([(m21 - m12) / den(qx1), qx1, (m01 + m10) / den(qx1),
                      (m02 + m20) / den(qx1)], dim=-1)
    qy2 = torch.sqrt(torch.clamp(1.0 - m00 + m11 - m22, min=0.0)) * 0.5
    q2 = torch.stack([(m02 - m20) / den(qy2), (m01 + m10) / den(qy2), qy2,
                      (m12 + m21) / den(qy2)], dim=-1)
    qz3 = torch.sqrt(torch.clamp(1.0 - m00 - m11 + m22, min=0.0)) * 0.5
    q3 = torch.stack([(m10 - m01) / den(qz3), (m02 + m20) / den(qz3),
                      (m12 + m21) / den(qz3), qz3], dim=-1)
    pivots = torch.stack([tr, m00 - m11 - m22, -m00 + m11 - m22, -m00 - m11 + m22], dim=-1)
    k = torch.argmax(pivots, dim=-1)
    qs = torch.stack([q0, q1, q2, q3], dim=-2)
    q = torch.gather(qs, -2, k[..., None, None].expand(*k.shape, 1, 4))[..., 0, :]
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def slerp(q0: torch.Tensor, q1: torch.Tensor, alpha) -> torch.Tensor:
    """Spherical interpolation between quaternions."""
    dot = torch.sum(q0 * q1, dim=-1, keepdim=True)
    q1 = torch.where(dot < 0, -q1, q1)
    dot = torch.abs(dot)
    theta = torch.arccos(torch.clamp(dot, -1.0, 1.0))
    sin_t = torch.sin(theta)
    small = sin_t < 1e-6
    w0 = torch.where(small, 1.0 - alpha,
                     torch.sin((1 - alpha) * theta) / torch.clamp(sin_t, min=_EPS))
    w1 = torch.where(small, torch.as_tensor(alpha, dtype=q0.dtype, device=q0.device),
                     torch.sin(alpha * theta) / torch.clamp(sin_t, min=_EPS))
    q = w0 * q0 + w1 * q1
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)
