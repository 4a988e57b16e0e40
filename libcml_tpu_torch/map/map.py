"""Global SLAM map: SoA frame/point tables with group bitmasks,
covisibility, the deform-graph trajectory, groundtruth error tracking and
TUM/KITTI/CSV export.

TPU-native replacement for the reference's map layer (reference:
src/cml/map/Map.{h,cpp} — Map.h:31 thread-safe frame/point container with 32
frame-groups + 32 point-groups bitmask taxonomy GroupsManager.h:8, slab SoA
render buffers Map.cpp:188-219, covisibility processIndirectCovisiblity
Map.cpp:449, groundtruth error refresh Map.cpp:578, exportResults Map.cpp:597;
Frame.h:21 — deform graph Frame.h:58-68 / setCameraAndDeform Frame.cpp:51-92;
MapObject.h:28 map points; GroupsManager.h:10).

Design: the reference builds a mutex-guarded pointer graph with epoch-GC so
reader threads survive concurrent deletion; under the TPU architecture the
device holds fixed-capacity working arenas (direct window / indirect local
map) and THIS host-side map is the single-writer system of record — plain
growable SoA numpy arrays (the reference's own render path already flattens
to SoA slabs, Map.cpp:188-219). Group taxonomy stays a uint32 bitmask per
frame/point: one vectorized mask-compare replaces per-group mirrored sets.

Frames store either an ABSOLUTE world-to-camera pose (keyframes) or a pose
RELATIVE to a reference keyframe (everything else): composing on read is the
deform graph — when optimization moves a keyframe, every frame anchored to
it moves along without being touched (reference: Frame::setCameraAndDeform /
computeNewCameraFromDeforms; single-anchor form)."""

from __future__ import annotations

import dataclasses

import numpy as np


class Groups:
    """Named bitmask groups, up to 32 each for frames and points
    (reference: GroupsManager.h:10, built-in groups Map.h:284-293)."""

    FRAME_BUILTINS = (
        "VALIDFRAME", "KEYFRAME", "INITFRAME", "ORBTRACKED", "DSOTRACKED",
        "RECOVERED", "INDIRECTKEYFRAME", "DIRECTKEYFRAME",
    )
    POINT_BUILTINS = (
        "MAPPED", "INDIRECTGROUP", "DIRECTGROUP", "IMMATUREINDIRECT",
        "ACTIVEINDIRECT", "OUTLIER",
    )

    def __init__(self):
        self._frame: dict[str, int] = {}
        self._point: dict[str, int] = {}
        for name in self.FRAME_BUILTINS:
            self.frame_group(name)
        for name in self.POINT_BUILTINS:
            self.point_group(name)

    def _alloc(self, table: dict[str, int], name: str) -> int:
        if name not in table:
            if len(table) >= 32:
                raise RuntimeError("out of group bits (32 max)")
            table[name] = 1 << len(table)
        return table[name]

    def frame_group(self, name: str) -> int:
        return self._alloc(self._frame, name)

    def point_group(self, name: str) -> int:
        return self._alloc(self._point, name)


def _grow(arr: np.ndarray, n: int) -> np.ndarray:
    out = np.zeros((max(n, int(arr.shape[0] * 2)),) + arr.shape[1:], arr.dtype)
    out[: arr.shape[0]] = arr
    return out


@dataclasses.dataclass
class SlamMap:
    """System-of-record map. Single-writer host structure."""

    cap_frames: int = 1024
    cap_points: int = 65536

    def __post_init__(self):
        self.groups = Groups()
        C = self.cap_frames
        self.n_frames = 0
        self.f_timestamp = np.zeros(C)
        self.f_group = np.zeros(C, np.uint32)
        self.f_pose = np.tile(np.eye(4), (C, 1, 1))      # w2c (abs or rel)
        self.f_ref = np.full(C, -1, np.int64)            # deform anchor (-1 = absolute)
        self.f_ab = np.zeros((C, 2))
        self.f_gt = np.full((C, 4, 4), np.nan)           # groundtruth c2w

        P = self.cap_points
        self.n_points = 0
        self.p_xyz = np.zeros((P, 3))
        self.p_color = np.zeros(P)
        self.p_group = np.zeros(P, np.uint32)
        self.p_uncertainty = np.zeros(P)

        # observations: (frame, point) pairs for covisibility — growable
        # numpy arrays with periodic dedup compaction (duplicate pairs add
        # nothing to covisibility counts but previously grew unboundedly)
        self._obs = np.zeros((0, 2), np.int64)
        self._obs_n = 0

    # -- frames --------------------------------------------------------------

    def add_frame(self, timestamp: float, pose_w2c: np.ndarray,
                  ref_frame: int = -1, gt_c2w: np.ndarray | None = None,
                  groups: int = 0) -> int:
        if self.n_frames >= self.f_pose.shape[0]:
            for name in ("f_timestamp", "f_group", "f_pose", "f_ref", "f_ab",
                         "f_gt"):
                setattr(self, name, _grow(getattr(self, name), self.n_frames + 1))
        i = self.n_frames
        self.n_frames += 1
        self.f_timestamp[i] = timestamp
        self.f_pose[i] = pose_w2c
        self.f_ref[i] = ref_frame
        self.f_group[i] = np.uint32(groups | self.groups.frame_group("VALIDFRAME"))
        if gt_c2w is not None:
            self.f_gt[i] = gt_c2w
        return i

    def set_keyframe(self, i: int, is_kf: bool = True):
        bit = np.uint32(self.groups.frame_group("KEYFRAME"))
        if is_kf:
            self.f_group[i] |= bit
        else:
            self.f_group[i] &= ~bit

    def set_pose(self, i: int, pose_w2c: np.ndarray, ref_frame: int = -1):
        """Update a frame pose (deform anchors of other frames follow
        automatically because composition happens on read)."""
        self.f_pose[i] = pose_w2c
        self.f_ref[i] = ref_frame

    def frames_in_group(self, name: str) -> np.ndarray:
        bit = np.uint32(self.groups.frame_group(name))
        return np.flatnonzero(self.f_group[: self.n_frames] & bit)

    def pose_w2c(self, i: int) -> np.ndarray:
        """Resolved world-to-camera pose (composing the deform chain)."""
        T = self.f_pose[i]
        ref = int(self.f_ref[i])
        hops = 0
        while ref >= 0:
            T = T @ self.f_pose[ref]
            ref = int(self.f_ref[ref])
            hops += 1
            if hops > 64:
                raise RuntimeError("deform chain loop")
        return T

    def trajectory_c2w(self) -> tuple[np.ndarray, np.ndarray]:
        """All frame poses as camera-to-world, deform chains resolved in a
        BATCHED fixed-point sweep: each iteration composes every
        still-anchored pose with its anchor in one einsum, so the cost is
        O(n * max_chain_depth) array ops instead of a Python loop per frame
        (the reference's per-frame computeNewCameraFromDeforms equivalent,
        Frame.cpp:352, done arena-wide)."""
        n = self.n_frames
        T = self.f_pose[:n].copy()                  # (n, 4, 4) w2c
        ref = self.f_ref[:n].copy()                 # (n,)
        for _ in range(64):
            m = ref >= 0
            if not m.any():
                break
            r = ref[m]
            T[m] = np.einsum("nij,njk->nik", T[m], self.f_pose[r])
            ref[m] = self.f_ref[r]
        else:
            raise RuntimeError("deform chain loop")
        # batched analytic SE3 inverse ([R^T | -R^T t]; np.linalg.inv would
        # raise on degenerate poses)
        R = T[:, :3, :3]
        out = np.tile(np.eye(4), (n, 1, 1))
        out[:, :3, :3] = np.transpose(R, (0, 2, 1))
        out[:, :3, 3] = -np.einsum("nji,nj->ni", R, T[:, :3, 3])
        return self.f_timestamp[:n].copy(), out

    # -- points --------------------------------------------------------------

    def add_points(self, xyz: np.ndarray, color: np.ndarray | None = None,
                   groups: int = 0) -> np.ndarray:
        k = xyz.shape[0]
        while self.n_points + k > self.p_xyz.shape[0]:
            for name in ("p_xyz", "p_color", "p_group", "p_uncertainty"):
                setattr(self, name, _grow(getattr(self, name), self.n_points + k))
        idx = np.arange(self.n_points, self.n_points + k)
        self.n_points += k
        self.p_xyz[idx] = xyz
        if color is not None:
            self.p_color[idx] = color
        self.p_group[idx] = np.uint32(groups | self.groups.point_group("MAPPED"))
        return idx

    def points_in_group(self, name: str) -> np.ndarray:
        bit = np.uint32(self.groups.point_group(name))
        return np.flatnonzero(self.p_group[: self.n_points] & bit)

    # -- covisibility ---------------------------------------------------------

    def add_observations(self, frame: int, points: np.ndarray):
        k = len(points)
        if k == 0:
            return
        if self._obs_n + k > self._obs.shape[0]:
            self._obs = _grow(self._obs, self._obs_n + k)
        self._obs[self._obs_n:self._obs_n + k, 0] = frame
        self._obs[self._obs_n:self._obs_n + k, 1] = np.asarray(points)
        self._obs_n += k
        # amortized dedup compaction: duplicate (frame, point) pairs carry
        # no covisibility information; compacting at 2x growth keeps the
        # log linear in the number of DISTINCT observations
        if self._obs_n > 4096 and self._obs_n > 2 * getattr(
                self, "_obs_last_compact", 2048):
            self._compact_obs()

    def _compact_obs(self):
        obs = np.unique(self._obs[:self._obs_n], axis=0)
        self._obs = obs
        self._obs_n = len(obs)
        self._obs_last_compact = self._obs_n

    def covisibility(self, min_shared: int = 1) -> dict[int, dict[int, int]]:
        """Keyframe covisibility counts from shared observed points
        (reference: processIndirectCovisiblity, Map.cpp:449 — there
        maintained incrementally per frame pair, Frame.h:502-554; here
        recomputed on demand, fully vectorized: dedupe pairs, sort by point,
        expand each point's frame-set into its pairwise products with
        repeat/tile index algebra, then one bincount over pair keys. Cost is
        O(sum k_p^2) array work with no Python loop over points."""
        if self._obs_n == 0:
            return {}
        obs = np.unique(self._obs[:self._obs_n], axis=0)   # sorted by (f, p)
        f, p = obs[:, 0], obs[:, 1]
        order = np.argsort(p, kind="stable")
        f, p = f[order], p[order]
        # segment bookkeeping per point
        seg_id = np.concatenate([[0], np.cumsum(p[1:] != p[:-1])])
        k = np.bincount(seg_id)                    # frames per point
        seg_start = np.concatenate([[0], np.cumsum(k[:-1])])
        # pair expansion: element i (in segment s, local index w) pairs with
        # all k[s] members of its segment
        reps = k[seg_id]                           # pairs per element
        A = np.repeat(f, reps)                     # left frame of each pair
        pair_seg = np.repeat(seg_id, reps)         # segment of each pair
        # local index of the right partner cycles 0..k-1 within each block
        block_start = np.concatenate([[0], np.cumsum(reps[:-1])])
        within = np.arange(reps.sum()) - np.repeat(block_start, reps)
        B = f[seg_start[pair_seg] + within]        # right frame of each pair
        keep = A != B
        A, B = A[keep], B[keep]
        if len(A) == 0:
            return {}
        # count (A, B) pairs with one bincount over compressed keys
        fu, inv = np.unique(np.stack([A, B]), return_inverse=True)
        inv = inv.reshape(2, -1)
        nf = len(fu)
        counts = np.bincount(inv[0] * nf + inv[1], minlength=nf * nf)
        C = counts.reshape(nf, nf)
        ai, bi = np.nonzero(C >= min_shared)
        out: dict[int, dict[int, int]] = {}
        for a, b, c in zip(fu[ai].tolist(), fu[bi].tolist(),
                           C[ai, bi].tolist()):
            out.setdefault(a, {})[b] = c
        return out

    # -- groundtruth error (live ATE/RPE) -------------------------------------

    def refresh_error_from_groundtruth(self) -> dict[str, float] | None:
        """Scale-corrected ATE + RPE vs stored GT (reference:
        Map::refreshErrorFromGroundtruth, Map.cpp:578)."""
        from libcml_tpu_torch.eval.trajectory import ate_rmse, rpe_rmse

        n = self.n_frames
        have = ~np.isnan(self.f_gt[:n, 0, 0])
        if have.sum() < 3:
            return None
        _, est = self.trajectory_c2w()
        est = est[have]
        gt = self.f_gt[:n][have]
        return {
            "ate_rmse": float(ate_rmse(est[:, :3, 3], gt[:, :3, 3],
                                       with_scale=True)),
            "rpe_rmse": float(rpe_rmse(est, gt)),
        }

    # -- export ---------------------------------------------------------------

    def export_results(self, out_dir: str, prefix: str = "result"):
        """TUM + KITTI + CSV trajectories (x {estimate, groundtruth when
        available}), mirroring the reference's five-file export
        (reference: Map::exportResults, Map.cpp:597; modslam.cpp:393-410)."""
        import os

        from libcml_tpu_torch.eval.trajectory import poses_to_kitti, poses_to_tum

        os.makedirs(out_dir, exist_ok=True)
        ts, est = self.trajectory_c2w()
        with open(os.path.join(out_dir, f"{prefix}_tum.txt"), "w") as fh:
            fh.write(poses_to_tum(ts, est))
        with open(os.path.join(out_dir, f"{prefix}_kitti.txt"), "w") as fh:
            fh.write(poses_to_kitti(est))
        with open(os.path.join(out_dir, f"{prefix}.csv"), "w") as fh:
            fh.write("timestamp,tx,ty,tz\n")
            for t, M in zip(ts, est):
                fh.write(f"{t},{M[0,3]},{M[1,3]},{M[2,3]}\n")
        n = self.n_frames
        have = ~np.isnan(self.f_gt[:n, 0, 0])
        if have.any():
            gt = self.f_gt[:n][have]
            with open(os.path.join(out_dir, f"{prefix}_gt_tum.txt"), "w") as fh:
                fh.write(poses_to_tum(ts[have], gt))
            with open(os.path.join(out_dir, f"{prefix}_gt_kitti.txt"), "w") as fh:
                fh.write(poses_to_kitti(gt))
