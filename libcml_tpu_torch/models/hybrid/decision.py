"""MOD-SLAM decision logic: per-frame pose-estimation and BA mode choice.

A copy of libcml_tpu/models/hybrid/decision.py (host numpy only; the
reference's "Research" decision module, src/cml/slam/modslam/Research.cpp:3
poseEstimationDecision and :126 bundleAdjustmentDecision). The decisions are
tiny scalar logic over statistics the device programs already produce
(tracker covariance, PnP covariance, saturation ratio, match counts), so
they run on the host.
"""

from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np


class Mode:
    DIRECT = "DIRECT"
    INDIRECT = "INDIRECT"


@dataclasses.dataclass(frozen=True)
class DecisionConfig:
    """Thresholds mirroring the reference's trackcond*/bacond* parameters
    (reference: Hybrid.h:344-407)."""

    # pose estimation decision
    window: int = 10                 # covariance accumulation window
    orb_weight: float = 1.0          # trackcondUncertaintyWeight analogue
    min_orb_matches: int = 30        # below this, ORB tracking is unusable
    flow_force_direct: float = 0.0   # 0 = disabled
    force: str | None = None         # "DIRECT"/"INDIRECT" force flags
    force_kf_match_ratio: float = 0.25   # force an indirect keyframe when
                                         # matches drop below this fraction
                                         # of the reference keyframe's
                                         # (indirectNeedNewKeyFrame rule;
                                         # 0 disables)

    # BA decision
    ba_force: str | None = None
    ba_min_indirect_points: int = 60     # bacondMinimumOrbPoint analogue
    ba_saturated_ratio: float = 0.15     # bacondSaturatedRatio
    ba_score_weight: float = 0.75        # bacondScoreWeight
    ba_uncertainty_weight: float = 1.0


class PoseEstimationDecision:
    """Sliding-window covariance comparison (Research.cpp:3).

    Each frame, push the translational covariance diagonals of both
    trackers; the chosen mode is the one whose window-normalized
    uncertainty norm is smaller. Overrides: too few ORB matches forces
    DIRECT; force flags win outright."""

    def __init__(self, cfg: DecisionConfig = DecisionConfig()):
        self.cfg = cfg
        self._orb: deque[np.ndarray] = deque(maxlen=cfg.window)
        self._dso: deque[np.ndarray] = deque(maxlen=cfg.window)

    def push(self, cov_orb: np.ndarray | None, cov_dso: np.ndarray | None):
        """Covariance tails: the (3,) diagonal of each tracker's rotational
        block — the reference uses .tail(3) of the 6-dof diagonal."""
        if cov_orb is not None and np.all(np.isfinite(cov_orb)):
            self._orb.append(np.asarray(cov_orb, np.float64))
        if cov_dso is not None and np.all(np.isfinite(cov_dso)):
            self._dso.append(np.asarray(cov_dso, np.float64))

    def decide(self, num_orb_matches: int, flow: float = 0.0) -> str:
        cfg = self.cfg
        if cfg.force in (Mode.DIRECT, Mode.INDIRECT):
            return cfg.force
        if num_orb_matches < cfg.min_orb_matches:
            return Mode.DIRECT
        if cfg.flow_force_direct > 0 and flow > cfg.flow_force_direct:
            return Mode.DIRECT
        if not self._orb or not self._dso:
            return Mode.DIRECT   # bootstrap preference (reference: DSO-first)
        # both tails are pose covariances in the same units (rad^2), so the
        # window means compare directly; orb_weight biases the choice
        # (Research.cpp's weighted norm compare)
        o_n = np.linalg.norm(np.stack(self._orb).mean(axis=0))
        d_n = np.linalg.norm(np.stack(self._dso).mean(axis=0))
        return Mode.INDIRECT if cfg.orb_weight * o_n < d_n else Mode.DIRECT


class BundleAdjustmentDecision:
    """Choose which backend refines the map this keyframe
    (Research.cpp:126)."""

    def __init__(self, cfg: DecisionConfig = DecisionConfig()):
        self.cfg = cfg
        self._tracked_hist: deque[float] = deque(maxlen=cfg.window)

    def decide(
        self,
        num_indirect_points: int,
        num_tracked: int,
        num_robust: int,
        saturated_ratio: float,
    ) -> str:
        cfg = self.cfg
        if cfg.ba_force in (Mode.DIRECT, Mode.INDIRECT):
            return cfg.ba_force
        if num_indirect_points < cfg.ba_min_indirect_points:
            return Mode.DIRECT
        # direct tracking saturating (many residuals at the Huber cutoff)
        # means the photometric model is failing -> prefer indirect BA
        if saturated_ratio > cfg.ba_saturated_ratio:
            return Mode.INDIRECT
        self._tracked_hist.append(float(num_tracked))
        hist = np.mean(self._tracked_hist) if self._tracked_hist else 1.0
        # weighted score: recent tracked count vs robust (inlier) count
        score = cfg.ba_score_weight * (num_tracked / max(hist, 1.0)) + (
            1.0 - cfg.ba_score_weight
        ) * (num_robust / max(num_tracked, 1))
        # direct BA is the default spine (reference: DSO-first); indirect
        # takes over only when tracking quality clearly collapses
        return Mode.DIRECT if score >= 0.8 else Mode.INDIRECT
