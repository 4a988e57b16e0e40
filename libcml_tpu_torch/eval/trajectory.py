"""Trajectory evaluation: Umeyama/Horn alignment, ATE, RPE, and export.

Copied from libcml_tpu/eval/trajectory.py (the reference's evaluation layer
(reference: src/cml/evaluation/Alignment.h:8 Horn alignment,
src/cml/evaluation/Evaluation.h:37-41 absoluteTrajectoryError /
relativePoseError, and Map::exportResults TUM/KITTI/CSV writers,
src/cml/map/Map.cpp:597). The metric definitions match the evo APE/RPE used
by the reference harness (evaluation/evaluator.py:30-41): Umeyama alignment
with optional scale correction (monocular SLAM is scale-ambiguous), then RMSE
over translation errors.

Runs on host NumPy — trajectories are tiny and this keeps the eval path
dependency-free of device state.
"""

from __future__ import annotations

import numpy as np


def umeyama_alignment(
    src: np.ndarray, dst: np.ndarray, with_scale: bool = True
) -> tuple[np.ndarray, np.ndarray, float]:
    """Least-squares similarity transform aligning src (N, 3) onto dst (N, 3).

    Returns (R, t, s) with dst ~= s * R @ src + t (Umeyama 1991)."""
    assert src.shape == dst.shape and src.shape[1] == 3
    mu_s = src.mean(axis=0)
    mu_d = dst.mean(axis=0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / src.shape[0]
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1.0
    R = U @ S @ Vt
    if with_scale:
        var_s = (xs**2).sum() / src.shape[0]
        s = float(np.trace(np.diag(D) @ S) / max(var_s, 1e-12))
    else:
        s = 1.0
    t = mu_d - s * R @ mu_s
    return R, t, s


def ate_rmse(
    est_xyz: np.ndarray, gt_xyz: np.ndarray, with_scale: bool = True
) -> float:
    """Absolute trajectory error RMSE after Umeyama alignment (meters).
    Matches evo APE translation_part with align + correct_scale
    (reference harness: evaluation/evaluator.py:30-35)."""
    if len(est_xyz) < 3:
        return float("inf")
    R, t, s = umeyama_alignment(est_xyz, gt_xyz, with_scale)
    aligned = (s * (R @ est_xyz.T)).T + t
    err = np.linalg.norm(aligned - gt_xyz, axis=1)
    return float(np.sqrt(np.mean(err**2)))


def rpe_rmse(
    est_poses: np.ndarray, gt_poses: np.ndarray, delta: int = 1
) -> float:
    """Relative pose error RMSE over frame pairs `delta` apart.

    est_poses / gt_poses: (N, 4, 4) camera-to-world homogeneous matrices.
    Matches evo RPE translation_part (evaluation/evaluator.py:36-41)."""
    n = len(est_poses)
    if n <= delta:
        return float("inf")
    errs = []
    for i in range(n - delta):
        de = np.linalg.inv(est_poses[i]) @ est_poses[i + delta]
        dg = np.linalg.inv(gt_poses[i]) @ gt_poses[i + delta]
        e = np.linalg.inv(dg) @ de
        errs.append(np.linalg.norm(e[:3, 3]))
    return float(np.sqrt(np.mean(np.square(errs))))


def poses_to_tum(
    timestamps: np.ndarray, poses_c2w: np.ndarray
) -> str:
    """Serialize camera-to-world poses to TUM format lines
    `ts tx ty tz qx qy qz qw` (reference: Map::exportResults TUM writer)."""
    import torch

    from libcml_tpu_torch.core.lie import matrix_to_quat

    lines = []
    q = matrix_to_quat(torch.as_tensor(np.asarray(poses_c2w[:, :3, :3], np.float32))).numpy()
    for i, ts in enumerate(timestamps):
        tx, ty, tz = poses_c2w[i, :3, 3]
        w, x, y, z = q[i]
        lines.append(f"{ts:.6f} {tx:.6f} {ty:.6f} {tz:.6f} {x:.6f} {y:.6f} {z:.6f} {w:.6f}")
    return "\n".join(lines) + "\n"


def poses_to_kitti(poses_c2w: np.ndarray) -> str:
    """Serialize to KITTI format: 12 floats per line, row-major 3x4
    (reference: Map::exportResults KITTI writer, Map.cpp:597)."""
    lines = []
    for P in poses_c2w:
        lines.append(" ".join(f"{v:.9e}" for v in P[:3, :4].reshape(-1)))
    return "\n".join(lines) + "\n"


def load_tum_trajectory(path: str) -> tuple[np.ndarray, np.ndarray]:
    """Read a TUM trajectory file -> (timestamps (N,), poses_c2w (N, 4, 4))."""
    import torch

    from libcml_tpu_torch.core.lie import quat_to_matrix

    data = np.loadtxt(path, comments="#").reshape(-1, 8)
    ts = data[:, 0]
    t = data[:, 1:4]
    qxyzw = data[:, 4:8]
    q_wxyz = np.concatenate([qxyzw[:, 3:4], qxyzw[:, :3]], axis=1)
    R = quat_to_matrix(torch.as_tensor(q_wxyz, dtype=torch.float64)).numpy()
    poses = np.tile(np.eye(4), (len(ts), 1, 1))
    poses[:, :3, :3] = R
    poses[:, :3, 3] = t
    return ts, poses
