"""Static configuration for the direct (DSO-style) pipeline (copied from
libcml_tpu/models/direct/config.py: same fields, same defaults).

Point/frame budgets are the capacities of fixed-shape arenas; validity masks
do the dynamic work (SURVEY.md §7
"dynamic sparsity under static shapes"). Defaults mirror the reference presets
(evaluation/dso2000.yaml:7-10 point budgets; DSOBundleAdjustment.h:239,271
window<=6 keyframes + 4 LM iterations; DSOTracker.cpp:23 per-level iterations).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class DirectConfig:
    # pyramid
    num_levels: int = 4

    # point budgets (static capacities)
    max_points: int = 2048        # active points in the BA window
    max_immature: int = 2048      # immature (tracing) points per keyframe
    points_per_kf: int = 512      # new immature points created per keyframe

    # window
    max_frames: int = 8           # keyframe slots (reference: 6 active + slack)
    target_frames: int = 7        # marginalize down to this when exceeded

    # tracker
    tracker_iters: int = 12       # GN/LM iterations per pyramid level
    tracker_converge_eps: float = 1e-4  # |dx| below which an accepted LM
                                  # step ends the level (reference:
                                  # DSOTracker.cpp:101-110 per-level break)
    huber_intensity: float = 9.0  # Huber threshold on intensity residual
    tracker_cutoff: float = 20.0  # hard zero-weight residual cutoff
                                  # (reference: setting_coarseCutoffTH)
    outlier_energy: float = 12.0 * 12.0  # per-pattern outlier threshold
    gradient_weight_c2: float = 50.0 * 50.0  # gradient-dependent weighting

    # bundle adjustment
    ba_iters: int = 6             # LM iterations (reference uses 4)
    ba_lambda_init: float = 1e-5
    idepth_min: float = 1e-4
    idepth_max: float = 50.0
    # Affine brightness anchors. The (a, b) states have global nullspaces
    # (a constant added to every b, or every a, leaves residuals invariant);
    # if weakly pinned they drift, and the drifted deltas exert spurious
    # prior forces on the GEOMETRIC dofs through H_m cross terms after
    # marginalization. The reference pins affine hard when photometric
    # calibration is available (setting_affineOptModeA/B ~1e8-1e12 in DSO's
    # scaled units) and only relaxes for uncalibrated footage.
    ba_prior_a: float = 1e4       # per-frame affine-a anchor weight
    ba_prior_b: float = 1e2       # per-frame affine-b anchor weight
    marg_weight: float = 0.5      # weight of freshly marginalized info
                                  # (reference: setting_margWeightFac)

    # mixed bundle adjustment (MOD-SLAM's joint photometric + reprojection
    # window solve; reference: DSOBundleAdjustment.h:161 addIndirectToProblem)
    mixed_ba: bool = True
    mixed_always: bool = False    # fire at every indirect keyframe instead
                                  # of only under a BAINDIRECT decision
                                  # (reference: enableHybridPoint standing
                                  # mode vs bacond* gating)
    mixed_points: int = 256       # indirect-factor capacity in the window
    mixed_weight: float = 10.0    # information scale of reprojection terms
    mixed_photo_guard: float = 1.25   # rollback when the joint solve grows
                                  # the photometric-only energy beyond this
                                  # factor (the tracking reference lives in
                                  # this window; see _mixed_ba_dispatch)
                                  # relative to photometric units (the
                                  # reference exposes the analogous knob as a
                                  # Hybrid parameter). Photometric terms are
                                  # implicitly sigma_I = 1 intensity unit;
                                  # ~1 px corner noise at these gradients
                                  # makes O(10) the calibrated ratio — large
                                  # values let noisy corners drag poses off
                                  # the photometric optimum

    # initializer
    init_iters: int = 24
    init_points: int = 1024
    init_reg_weight: float = 0.8
    init_coupling: float = 1.0
    init_alpha_w: float = 0.4        # gauge anchor weight while not snapped
    init_min_translation: float = 0.02  # parallax (|t| * mean rho) to snap
    init_snapped_age: int = 3        # consecutive snapped frames to succeed
    init_smooth_blend: float = 0.0  # per-iteration idepth smoothing blend

    # tracer (epipolar search)
    trace_steps: int = 16         # discretized epipolar samples
    trace_recent_rows: int = 3    # only the R most-recently-seeded immature
                                  # rows are traced each frame (candidates
                                  # mature or die within a few keyframes of
                                  # seeding; tracing the full F-row arena
                                  # costs F/R x for masked-dead work)
    trace_gn_iters: int = 3
    trace_min_quality: float = 1.5  # best/second-best SSD ratio

    # immature lifecycle (activation gates; reference: activatePoints)
    activate_min_traces: int = 2        # successful traces before activation
    activate_max_relwidth: float = 0.25  # idepth interval width / idepth

    # state scaling (conditioning of the 8-dof frame state, DSO-style)
    scale_trans: float = 1.0
    scale_rot: float = 1.0
    scale_a: float = 10.0
    scale_b: float = 1000.0

    # failure handling (reference: Hybrid.cpp:214-222 tracking-failure
    # counter -> restartOrStop, AbstractSlam.cpp:98-104)
    max_track_fails: int = 3      # consecutive failures before recovery
    fail_saturated: float = 0.45  # saturated-residual ratio above which a
                                  # track counts as failed (reference:
                                  # dsoTracker.saturatedThreshold: 0.45,
                                  # evaluation/modslam.yaml)
    lost_grace_frames: int = 8    # frames spent in LOST retrying
                                  # relocalization before a blind restart
    stop_on_lost: bool = False    # reference stops after >=60 frames; a
                                  # library runtime restarts a new segment
                                  # unless asked to stop
    memory_limit_mb: int = 0      # host-RSS kill switch, 0 = off
                                  # (reference: AbstractSlam.cpp:150-154
                                  # stops the run when memoryLimit is hit)

    # keyframe decision (direct/Tracking.cpp:4 flow+brightness criterion).
    # Score mirrors the reference's resolution-normalized form:
    #   0.04*(640+480)*flow_T/(w+h) + 0.02*(640+480)*flow_RT/(w+h)
    #   + 2*|log a_rel|  >  kf_flow_threshold (the dsoKeyframeWeight knob)
    # (direct/Tracking.cpp:28-41) — without the (w+h) normalization a VGA
    # run keyframes every frame (VGA flow of ~14 px/frame against an
    # unnormalized threshold of 1).
    kf_flow_weight: float = 1.0       # legacy scale on the flow score
    kf_flow_threshold: float = 1.0    # = reference dsoKeyframeWeight
    kf_shift_weight_t: float = 0.04 * 1120.0
    kf_shift_weight_rt: float = 0.02 * 1120.0
    kf_affine_weight: float = 2.0
    kf_brightness_weight: float = 0.5
    kf_point_ratio: float = 0.55  # new KF when tracked points fall below
                                  # this fraction of the reference set

    # priors (gauge fixing). The first-frame anchor must NOT dwarf the
    # photometric information (~1e9-1e10 in intensity^2 px^2 units): f32
    # Schur complements at the anchor's magnitude lose the photometric
    # signal beneath roundoff once the anchored frame is marginalized.
    pose_prior_first: float = 3e4
    ab_prior: float = 1e4
