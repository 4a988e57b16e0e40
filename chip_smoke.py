"""Smoke run of libcml_tpu_torch on one CUDA card (an NVIDIA H100).

    python3 chip_smoke.py [--save-local-ba FILE] [--save-tri FILE]

Phases (any failure exits non-zero, and no result line is printed):
  0. the card: `nvidia-smi` name and power limit, torch's device name;
     exits non-zero without CUDA.
  1. build the twelve hand-written kernel sources (csrc/hamming_match.cu,
     track_lm.cu, pnp_lm.cu, ba_sweep.cu, ba_solve.cu, ba_run.cu,
     trace_epipolar.cu, local_ba.cu, orb_extract.cu, triangulate.cu,
     kf_activate.cu, kf_refresh.cu) from the sources in this checkout, one
     nvcc each, all started together.
  2. the kernel against its plain PyTorch version on the card, at the
     main path's shapes (random masks and frame 1's real phase-4 masks)
     and at edge cases, exact equality required; kernel times with CUDA
     events, cold L2 and warm, the plain version's (cold), the launches
     and device operations a call makes (torch.profiler), and the kernel's bound
     (HBM bytes or popcounts at the card's highest SM clock, whichever
     takes longer) with the share of it that the cold time reaches; a
     share above 1 fails the run.
  3. direct path at full width: DirectOdometry with bench.py's config on 60
     rendered 640x480 frames; fps, ATE < 0.1, no lost segment.
  4. hybrid tracking programs at full width: ORB (512 per level, 3 levels)
     on the same frames, a 4096-slot map from frame 0, then per frame
     _project_match_pnp and _local_map_pass2; every frame must launch the
     Hamming kernel twice, keep >= 12 PnP inliers and stay within the
     two-view pose budget (0.04 translation, 0.01 rad).
  5. the full sequential HybridOdometry (bench.py's hybrid) on the same 60
     frames, after building the BoW vocabulary (timed apart): fps, ATE,
     keyframes, indirect keyframes, map points, modes, mixed-BA events and
     rollbacks, local-BA events, and the kernel's launches per call site;
     ATE < 0.1, no lost segment, and at least one indirect keyframe that
     triangulated points and completed a local BA.
  6. relocalization at full width: 24 frames, 4 black frames, then frame
     20 again (tests/test_recovery.py's run, one stored keyframe later:
     workload.py says why); it must relocalize within 3 frames, within 0.15
     of frame 20's earlier estimate.
  7. the entry points: the corridor of the port's bench (data/corridor.py),
     its first 60 frames written at 640x480 as a KITTI layout by the port's
     writer, then `libcml_tpu_torch.cli.main` on it with presets/modslam.yaml
     (ORB 800 per level: the kernel meets 4096x2400): the five-file export,
     stats.csv and run.json, ATE < 0.1, no lost segment, kernel launches,
     and the first match_projection resolution of the run as a real-input
     kernel case.
  8. repeatability and resume, on that sequence read back through
     KittiCapture: bench.py's hybrid over 24 frames twice (the second saves
     its state before frame 16 and goes on), then a fresh instance loads the
     file and runs frames 16-23; trajectories, map arena and modes must be
     bit-identical, and the same for DirectOdometry (trajectory and window).
     The card's checkpoint must load into an instance on the CPU. Before it,
     a probe runs the hybrid and the direct path under
     torch.use_deterministic_algorithms(True, warn_only=True) and lists the
     operations torch warns about.
  9. the pipelined direct mode (DirectOdometry(pipelined=True), the lag-1
     finalize) on phase 3's frames: fps, ATE < 0.1, no lost segment, its
     keyframe frames beside phase 3's, and the host's stream/event syncs and
     memcpys a frame of both modes (torch.profiler, frames 15-19 of a fresh
     run each).
 10. the hybrid pipelined (every keyframe postprocess tick staged over later
     frames) and sequential with staged BA ticks (staged_indpost=True), each
     on phase 5's 60 frames: ATE < 0.1, no lost segment, an indirect keyframe
     event that triangulated and completed its local BA through the ticks,
     a tick that ran after its keyframe's frame, nothing left in flight, and
     the kernel's launches per call site; the pipelined run's first
     keyframe-postprocess match_projection with a live map row (whose
     results the staged tick reads) becomes a real-input kernel case.
 11. CalibSlam on 24 frames rendered through radtan distortion (k1 -0.12,
     k2 0.02, yaw 0.02 a frame): the fitted k1 negative and the fitted remap
     closer to the true one than the identity; then DirectOdometry on phase
     3's frames initialized from a depth-prior callable that returns the
     renderer's inverse depth (ATE < 0.1).
 12. sharded BA and the last modules: DirectOdometry(mesh=make_mesh()) and
     the hybrid with the same mesh (a world of one, NCCL) on phase 3's and
     phase 5's 60 frames; trajectories, windows and maps bit-identical to
     phases 3 and 5 (a world of one is the unsharded arithmetic plus
     identity collectives); fps and the all-reduces and all-gathers a frame.
     Then orb.match_ratio on frames 0 and 1's real ORB features (1536x1536):
     idx_b and good equal to its plain version on the card, one launch, and
     its resolution as a phase-2 kernel case.
 13. the LM kernels: track_lm (the tracker's coarse-to-fine LM, one launch
     a solve) and pnp_lm (motion-only PnP, one launch a solve) against their
     plain forms on the card (track_lm.parity, pnp_lm.parity: outputs within
     PARITY_TOL, and a start whose steps differ, or a match classified
     otherwise, only where its first differing decision sits within
     DECISION_TOL of its threshold; every such case is printed) on inputs
     captured in phases 3, 5 and 6: two `track` launches of phase 3, the
     recovery battery about the first (15 starts, an exact tie among them),
     the first battery the runs made, phase 5's two PnP passes of one frame
     (`_project_match_pnp`, `_local_map_pass2`), relocalization's EPnP refine,
     the all-invalid cases, and a `track` and a PnP pass with every point
     three times (past the points a thread holds in registers); one launch
     a call (counted and profiled), cold and warm ms (median of 30),
     microseconds an LM step, the plain form's ms (median of 5), the bound
     (bytes, or f32 operations of the sweeps and systems the run's steps
     need) and its share. Then
     `track` on the card with every point invalid (finite, no valid point,
     zero energy), `track_multi` (2 track_lm launches), and the host waits
     of a track, track_multi and PnP call, which must be none (no sync, no
     copy); the starts whose levels took other steps than the plain form,
     counted; last, the kernels' cluster size (8) and the clusters the card
     holds at once (cudaOccupancyMaxActiveClusters).
 14. the BA kernels: ba_sweep (the window BA's residual sweep, reduced to
     the Schur-ready camera system, or the energy, or the residual status,
     or the marginalization pieces), ba_solve (the rest of an LM step) and
     ba_run (a whole run_ba or run_ba_mixed in one launch, from the same
     device functions)
     against their plain forms on the card, on the inputs of every run_ba
     call of phase 3 (the initial BA included), an all-invalid window,
     ba_iters 0 and a run whose steps are all rejected: E, T and idepth
     within bk.PARITY_TOL of run_ba_plain (point_valid equal), each step's
     accept decision beside the plain form's (a differing one within
     bk.DECISION_TOL of its threshold), the launches of a run_ba (1 ba_run;
     on a world of one, the mesh's route, 2 + 3 x ba_iters sweep and FINISH
     launches and ba_iters solves, whose result must have the one launch's
     bits), and update_residual_status on
     both forms at the plain result (res_active and point_valid equal);
     every run_ba_mixed call of phase 5 against run_ba_mixed_plain (E, T,
     idepth and the indirect idepths within bk.MIXED_PARITY_TOL, the
     decisions compared alike and the float64 run beside them), its
     launches (1 ba_run, and no other kernel, copy or wait inside the call)
     and on a world of one (the split route, with the one launch's bits);
     two faults planted in copies of the run kernel (the reprojection Huber
     threshold at 4, the factors' Schur pair left out) each refused by the
     same verdict on a phase-5 call, their readings printed; each captured
     step's accept-test value from the same states in float32 (plain,
     kernels) against float64 (the witness behind bk.DECISION_TOL); phase
     3's first _marg_pieces call (the four sums within 1e-3, hosted equal);
     the system sweep's H - H_corr (the kernel's float64 group partials and
     the plain form's float32) against float64 from the same states, the
     scale curvature's error at most the plain form's recorded worst (3.18 %);
     on the last window, the host waits inside run_ba (none), cold and warm
     ms of a run_ba, a system sweep, an energy sweep and a solve (and of
     the last phase-5 run_ba_mixed call), the plain
     forms' ms, torch.linalg.solve_ex's ms on the damped system, and each
     kernel's bound and share (a run_ba's: its inputs and texels read once,
     its result written once, its sweeps' and solves' operations).
 15. the tracer's kernel: trace_epipolar (the whole trace_immatures_rows,
     one launch a call) against trace_immatures_rows_plain on the card
     (te.parity: untraced rows, pixels and colours bit for bit; statuses
     equal and intervals within te.RHO_TOL, a point differing only where a
     deciding value sits within te.DECISION_TOL of its threshold, every
     such point counted and printed) on every trace_immatures_rows call of
     phase 3 and of phase 5's direct spine, then on the phase-3 call that
     sweeps the most points with every row padding, with a dead host slot
     and with a NaN observer pose (no interval moves); one launch a call
     (counted and profiled), no sync and no memcpy inside; on that call cold
     and warm ms (median of 30), the plain form's, the bound (bytes: the
     arena in and out, the texels read once; or the swept points' f32
     operations) and its share.
 16. the local BA's kernel: local_ba (the whole run_local_ba, one launch a
     call) against run_local_ba_plain on the card on every run_local_ba
     call of phases 5, 7, 10 and 12 (lba.parity: T, the points with two or
     more valid observations and the other points' pixels within
     lba.PARITY_TOL, obs_valid equal; or, beyond those bounds, the kernel
     within lba.F64_TOL of a float64 run of the plain form in every measure
     and no further from it than the plain form in each measure beyond its
     bound; an observation pruned otherwise only where that run prunes
     it as the kernel does, or where that run's chi2 sits within
     lba.CHI2_EDGE_REL of 5.991; every such observation, and every step
     whose accept decision differs, printed); two runs of the kernel bit
     for bit; no path of phases 3-12 reaches run_local_ba_plain or ba_step;
     one launch a call (counted and profiled), no sync and no memcpy
     inside; on the heaviest call cold and warm ms beside the launch floor,
     the plain form's, the bound (bytes: the problem read once, the result
     written once; or the plain form's f32 operations for its observations,
     points and frame pairs over the steps run) and its share.
 17. the ORB kernel: orb_extract (FAST scores, NMS and each cell's top 4;
     each level's stable top-k by a selection; orientation and steered
     BRIEF: three passes of one cooperative launch a call) against
     extract_orb_plain on the card on every
     extract_orb call of phases 4, 5, 6 (budget 512) and 7 (the preset's
     800) (oe.parity: the kernels' FAST maps within oe.SCORE_RTOL of
     fast_score_map's, an NMS decided otherwise only at a tie within
     oe.DECISION_TOL, the slots exactly select_level's on the kernels' own
     maps, every angle within oe.ANGLE_ULP units in the last place of
     oe.warp_order_angle's (the kernel's sums in its own order; the
     largest difference from ic_angle printed), descriptor bits equal
     except where |v_p - v_q| < oe.DESC_EDGE; each such slot printed);
     each call's features bit for bit again; every extract_orb call of
     phases 4-12 one kernel call, none reaching extract_orb_plain; four
     planted faults (a copy of the source with one substitution each)
     refused, the last on the call's pyramid rounded to whole grey levels
     at the largest budget whose cut splits a group of equal nonzero scores,
     where the kernel is held to the plain form too (and at the call's own
     budget, whose cut falls among the zero scores); at budgets 512 and 800
     one host launch a call, no sync and no memcpy, cold and warm ms of the call and of
     each of its three passes alone (the stage mask) beside the launch
     floor, the plain form's, the
     bound (bytes: the levels read
     once, the slots written once; or the plain form's f32 operations for
     the pixels' FAST and NMS and the slots' moments and BRIEF samples) and
     its share; the kernel's stage stamps on those two calls (its `// stage:`
     marks made %globaltimer stamps in a copy of the source by
     tools/ba_stages.py's instrument: when the last block passed each mark,
     when the first did, and the gap before each launch's first mark); one
     sha256 over the six outputs of every captured call, in order.
 18. the pair tests computed in the Hamming kernel and the triangulation
     kernel: every match_projection call of phases 4-12 (PairCapture) as
     one launch of hamming_match.cu's projection test against the mask
     mode fed projection_pair_mask's mask and _finish (hm.pair_parity: bit
     for bit except rows and columns touching a pair whose float64 squared
     distance lies within hm.EDGE_REL of r^2, or a row at a visibility
     edge; the projected pixels within 1e-3 px); every _epipolar_triangulate
     call (two launches: the epipolar test with T_10 and F made in the
     match's launch, then csrc/triangulate.cu) against the plain form: the
     match by the same rule, the triangulation kernel on the plain form's
     match against plain_triangulate, its numpy model and the plain form in
     float64 (tr.tri_parity: corrected pixels, X0's pixel in keyframe 0 and
     its inverse depth; basin flips and depth edges counted), ok equal where
     the matches agree; the edges by run; the launches of every kernel by
     call site in phases 5, 6, 7 and 10 (one projection launch a projection
     site call, two a triangulation); no plain form on card tensors; three
     planted faults (the grid's last index on ties and the asymptote left
     out, on triangulate.FAULT_PENCILS; the level window widened to 2, on
     phase 4's first match) refused; one _epipolar_triangulate call with no
     sync and no memcpy; cold and warm ms of the three entry points beside
     the launch floor, their plain forms', bounds and shares.
 19. the direct keyframe programs (csrc/kf_activate.cu, csrc/kf_refresh.cu)
     on every call that phases 3, 5 and 9 made of _activate_and_clear and
     _refresh_after_kf (the keyframe events) and of their pieces at start-up
     (add_points, _tracker_ref_in_frame, _working_rho_range, select_points
     with the keyframe's and the initializer's budgets, seed_immatures),
     each through its dispatcher against its plain form on the same inputs
     (kf_programs.activate_parity and the range, selection and seed bit for
     bit; refresh_parity and ref_parity: the arena bit for bit, the tracker
     reference's pixels within UV_TOL, its samples the plain form's bits at
     the kernel's pixels, a validity that differs only within EDGE_REL of
     its threshold, each such point printed); one launch a call (at most
     three allowed for _refresh_after_kf); three planted faults (a row's
     positions one free slot further, the top k's ties to the highest index
     on the first refresh's keyframe flat below its top third, the region
     quantile's low rank one too high on it striped) refused;
     both programs' cold and warm ms beside the launch floor, their host
     waits (none) and enqueues (one), plain ms, bounds and shares, and each
     refresh stage alone through its entry point.
Every phase from 3 on reports every kernel's launches of its run (counted
from 0 just before it and read just after); phase 3 must launch track_lm on
every tracked frame, the BA kernels, trace_epipolar once on every frame
whose pose is good, and the keyframe kernels at least once a keyframe;
phase 4 the projection test and pnp_lm twice a frame and orb_extract once
for frame 0 and each tracked frame, phases 5 and 7 both LM kernels, phase 5
local_ba and the keyframe kernels.
Then phase 2's real-input cases captured in phases 5, 6 and 10 (the first
keyframe's epipolar band, a relocalization match_descriptors call, the
staged tick's match_projection; the masks made by the plain forms from the
calls' arguments) and 12 (match_ratio), held to the plain version exactly;
the phases' results, the card's name and power limit, the kernel table
({"kernels": [...]}: for hamming_resolve its launches in the paths' runs,
phases 4-8, 10, 11 and 12, each counted from 0 just before its run and read
just after, with each path's count beside them; times and
bound of the phase-4 masks case, cold, and of the staged-tick and
match_ratio cases; for track_lm and pnp_lm the launches of every path's run
and the times and bound of phase 13's first case, each case beside them;
for ba_sweep, ba_solve and ba_run the launches of every path's run and
phase 14's times and bounds; for trace_epipolar the launches of every
path's run and phase 15's times and bound; for local_ba the launches of
every path's run and phase 16's times and bound; for orb_extract the
launches of every path's run and phase 17's times and bound; for
hamming_projection, hamming_epipolar and triangulate the launches of every
path's run and phase 18's times and bounds; for kf_activate and kf_refresh
the launches of every path's run and phase 19's times and bounds), and the
result line
{"ok": true, "device": {...}} last.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import hashlib
import importlib.util
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import warnings
from collections import Counter
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from libcml_tpu_torch import cli
from libcml_tpu_torch import workload as wl
from libcml_tpu_torch.data import corridor
from libcml_tpu_torch.data.kitti import KittiCapture
from libcml_tpu_torch.eval.trajectory import ate_rmse
from libcml_tpu_torch.core.lie import SE3, skew
from libcml_tpu_torch.models.direct import ba, initializer, residuals, selector, tracer, tracker
from libcml_tpu_torch.models.direct import window as win_mod
from libcml_tpu_torch.models.indirect import indirect_ba as iba
from libcml_tpu_torch.models.indirect import matching, orb
from libcml_tpu_torch.models.indirect import pnp as pnp_mod
from libcml_tpu_torch.models.indirect.bow import default_vocabulary
from libcml_tpu_torch.models.indirect.triangulation import fundamental
from libcml_tpu_torch.ops import ba_sweep as bk
from libcml_tpu_torch.ops import hamming_match as hm
from libcml_tpu_torch.ops import kernel_build, pnp_lm, track_lm
from libcml_tpu_torch.ops import kf_programs as kfp
from libcml_tpu_torch.ops import local_ba as lba
from libcml_tpu_torch.ops import orb_extract as oe
from libcml_tpu_torch.ops import trace_epipolar as te
from libcml_tpu_torch.ops import triangulate as tr
from libcml_tpu_torch.parallel.sharding import make_mesh
from libcml_tpu_torch.runtime import hybrid, odometry
from libcml_tpu_torch.runtime.odometry import DirectOdometry

# published H100 SXM memory rate at 700 W (NVIDIA's data sheet)
HBM_BYTES_PER_S = 3.35e12
# published H100 SXM float32 rate outside the tensor cores at 700 W
F32_FLOP_PER_S = 67e12
# population count issues 16 per clock and SM on sm_90 (CUDA C++ Programming
# Guide, arithmetic instruction throughput, compute capability 9.0); the
# XOR and the adds of an entry go to the 64-per-clock integer pipe and take
# at most half as long, so popcount is the operations floor
POPC_PER_SM_CLOCK = 16

N_DIRECT = 60
WARMUP = 10                  # frames before the steady-state clock starts
HYBRID_FRAMES = range(1, 21)


class SmokeFailure(RuntimeError):
    pass


# every kernel's wrapper, whose launch counts each path's run reports: the
# Hamming kernel's three entry points (the mask modes; the projection and
# epipolar pair tests computed in the kernel), the triangulation, the LM,
# BA, tracer, local BA and ORB kernels, and the direct keyframe programs'
PATH_KERNELS = {"hamming_resolve": hm.hamming_resolve_cuda,
                "hamming_projection": hm.match_projection_cuda,
                "hamming_epipolar": hm.match_epipolar_cuda, "triangulate": tr.triangulate_cuda,
                "track_lm": track_lm.track_lm_cuda, "pnp_lm": pnp_lm.pnp_lm_cuda,
                "ba_sweep": bk.ba_sweep_cuda, "ba_solve": bk.ba_solve_cuda,
                "ba_run": bk.ba_run_cuda, "trace_epipolar": te.trace_rows_cuda,
                "local_ba": lba.local_ba_cuda, "orb_extract": oe.orb_extract_cuda,
                "kf_activate": kfp.kf_activate_cuda, "kf_refresh": kfp.kf_refresh_cuda}
HAMMING_MODES = ("hamming_resolve", "hamming_projection", "hamming_epipolar")


def reset_launches() -> None:
    """Every kernel's launch count to 0 (just before a path's run)."""
    for fn in PATH_KERNELS.values():
        fn.launches = 0


def path_launches() -> dict:
    """Every kernel's launch count since the last reset_launches()."""
    return {name: fn.launches for name, fn in PATH_KERNELS.items()}


def hamming_launches() -> int:
    """Launches of csrc/hamming_match.cu in any mode since the last
    reset_launches()."""
    return sum(PATH_KERNELS[k].launches for k in HAMMING_MODES)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def nvidia_smi(query: str, *fmt: str) -> str:
    cmd = ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader" + "".join(fmt)]
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def popc_per_s() -> float:
    """The card's popcount rate: SMs x 16 per clock x its highest SM clock."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock_mhz = float(nvidia_smi("clocks.max.sm", ",nounits"))
    rate = sms * POPC_PER_SM_CLOCK * clock_mhz * 1e6
    print(f"popcount rate {rate:.6g}/s ({sms} SMs x {POPC_PER_SM_CLOCK} x {clock_mhz:g} MHz)")
    return rate


# a buffer larger than the 50 MB L2: writing it before a call evicts the
# call's inputs, so the call reads them from device memory
FLUSH_BYTES = 128 * 2**20
_flush: torch.Tensor | None = None


def cuda_ms(fn, reps: int = 30, warmup: int = 3, cold: bool = True) -> float:
    """Median device milliseconds of one call of `fn`, CUDA events around
    each call alone. Cold (the default): a 128 MB buffer is written before
    each call, outside the events, so the call finds its inputs out of L2;
    warm: the calls run back to back on the same inputs. A spin kernel first
    holds the card while the host queues every call, so the host's launch
    overhead stays out of the events' intervals."""
    global _flush
    if cold and _flush is None:
        _flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.int32, device="cuda")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
          for _ in range(reps)]
    torch.cuda._sleep(100_000_000)
    for i, (a, b) in enumerate(ev):
        if cold:
            _flush.fill_(i)
        a.record()
        fn()
        b.record()
    ev[-1][1].synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in ev)


# The smallest launch through the kernels' own route (nvcc into a library
# with a plain C interface, launched through ctypes on PyTorch's stream): an
# empty kernel of one warp, written beside the builds at run time. Its
# cuda_ms is the fixed cost inside every kernel time taken here.
FLOOR_SOURCE = kernel_build.BUILD_DIR / "launch_floor" / "launch_floor.cu"
FLOOR_CODE = """// an empty kernel: the launch floor (chip_smoke.py launch_floor)
#include <cuda_runtime.h>
__global__ void empty_kernel() {}
extern "C" int launch_floor(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}
"""


def floor_source() -> Path:
    """The empty kernel's source, written if missing (or stale)."""
    if not FLOOR_SOURCE.exists() or FLOOR_SOURCE.read_text() != FLOOR_CODE:
        FLOOR_SOURCE.parent.mkdir(parents=True, exist_ok=True)
        FLOOR_SOURCE.write_text(FLOOR_CODE)
    return FLOOR_SOURCE


def launch_floor() -> dict:
    """Cold and warm cuda_ms of one launch of the empty kernel."""
    lib = kernel_build.load(floor_source(), "launch_floor", [ctypes.c_void_p])

    def empty():
        err = lib.launch_floor(torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise kernel_build.KernelLaunchError(f"the empty kernel: CUDA error {err}")

    return {"floor_ms": cuda_ms(empty), "floor_warm_ms": cuda_ms(empty, cold=False)}


# CUDA runtime and driver calls that put work on the device
ENQUEUE_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
                 "cudaLaunchCooperativeKernel", "cudaMemsetAsync", "cudaMemcpyAsync")


def launches_per_call(fn, calls: int = 10) -> tuple[float, float]:
    """(runtime calls that enqueue device work, device operations) per call
    of `fn`, from torch.profiler: the host's kernel launches, fills and
    copies (the ctypes library's launch included), and the kernels, fills
    and copies on the device timeline."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = prof.events()
    host = sum(e.device_type.name == "CPU" and e.name in ENQUEUE_CALLS for e in events)
    device = sum(e.device_type.name != "CPU" for e in events)
    return host / calls, device / calls


# -- phase 2 ------------------------------------------------------------------


def hamming_bound(args, popc_rate: float) -> tuple[float, str, int]:
    """Least time for one resolution, in milliseconds: the larger of the bytes
    over the HBM rate and the popcounts over the card's popcount rate. Bytes:
    the pair-mask rows of the query rows whose mask_q is true (a masked row
    needs none of its row), both masks, the descriptors of the rows and
    columns that have a live entry, each read once, and d1/d2/idx/col_row
    written once. Popcounts: 8 for each live entry (one that all three masks
    leave). Also returns the number of live entries."""
    dq, mq, dt, mt, pm = args
    N, M = dq.shape[0], dt.shape[0]
    live = mq[:, None] & mt[None, :]
    if pm is not None:
        live &= pm
    pair_bytes = int(mq.sum()) * M if pm is not None else 0
    desc_bytes = (int(live.any(1).sum()) + int(live.any(0).sum())) * 32
    nbytes = pair_bytes + N + M + desc_bytes + N * 12 + M * 4
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    n_live = int(live.sum())
    t_ops = 8.0 * n_live / popc_rate * 1e3
    return (t_ops, "operations", n_live) if t_ops >= t_bytes else (t_bytes, "bytes", n_live)


def _dev(dev, *arrays):
    return tuple(None if a is None else torch.as_tensor(a).to(dev) for a in arrays)


def random_case(rng, N, M, dev, p_mask=0.2, pair="random"):
    dq = rng.integers(-2**31, 2**31, (N, 8), dtype=np.int64).astype(np.int32)
    dt = rng.integers(-2**31, 2**31, (M, 8), dtype=np.int64).astype(np.int32)
    mq = rng.random(N) > p_mask
    mt = rng.random(M) > p_mask
    if pair == "random":
        pm = rng.random((N, M)) > 0.3
    elif pair == "radius":
        # corners of a 640x480 frame vs projected points, 15 px * 1.5^level
        uq = rng.uniform([0, 0], [wl.W, wl.H], (N, 2))
        ut = rng.uniform([0, 0], [wl.W, wl.H], (M, 2))
        lq = rng.integers(0, 3, N)
        lt = rng.integers(0, 3, M)
        r = 15.0 * 1.5 ** lq
        d2 = ((uq[:, None] - ut[None]) ** 2).sum(-1)
        pm = (d2 <= (r * r)[:, None]) & (np.abs(lq[:, None] - lt[None]) <= 1)
    elif pair == "epipolar":
        # match_epipolar's test: squared distance of the train corner to the
        # query's epipolar line F [u, v, 1] within epi_tol; a sideways
        # translation gives near-horizontal lines, and epi_tol = 2.4^2 px^2
        # leaves a band of about 1 % of the frame
        uq = rng.uniform([0, 0], [wl.W, wl.H], (N, 2))
        ut = rng.uniform([0, 0], [wl.W, wl.H], (M, 2))
        F = np.array([[0.0, -0.1, 0.0], [0.1, 0.0, -1.0], [0.0, 1.0, 0.0]])
        lines = np.c_[uq, np.ones(N)] @ F.T
        num = lines @ np.c_[ut, np.ones(M)].T
        d2 = num ** 2 / np.maximum(lines[:, 0] ** 2 + lines[:, 1] ** 2, 1e-9)[:, None]
        pm = d2 <= 2.4 ** 2
    else:
        pm = None
    return _dev(dev, dq, mq, dt, mt, pm)


def edge_case(rng, dev):
    """All-masked row and column, exact distance ties (duplicate train
    descriptors), a query identical to two train columns."""
    N, M = 40, 70
    dq, mq, dt, mt, pm = (x.cpu().numpy() for x in random_case(rng, N, M, "cpu"))
    dt[10] = dt[20] = dt[30] = dq[5]          # d1 == d2 == 0 for row 5, ties
    dt[40:50] = dt[0]                          # many exact ties
    dq[6] = dq[7]                              # two rows tie for each column
    mq[:] = True
    mt[:] = True
    mq[3] = False                              # fully masked row
    mt[4] = False                              # fully masked column
    pm[:, 60] = False                          # column masked by the pair mask
    pm[8, :] = False                           # row masked by the pair mask
    return _dev(dev, dq, mq, dt, mt, pm)


PHASE4_CASE = "4096x1536 phase-4 masks (frame 1, match_projection)"


def kernel_vs_plain(dev, card: str, popc_rate: float, phase4_args) -> tuple[list[dict], float]:
    rng = np.random.default_rng(11)
    cases = [
        ("67x301 random masks + pair", random_case(rng, 67, 301, dev)),
        ("4096x1536 radius pair (match_projection)", random_case(rng, 4096, 1536, dev,
                                                                pair="radius")),
        ("1536x1536 radius pair (match_window)", random_case(rng, 1536, 1536, dev,
                                                            pair="radius")),
        ("1536x1536 no pair (match_descriptors)", random_case(rng, 1536, 1536, dev,
                                                             pair=None)),
        ("edge cases: masked row/column, ties", edge_case(rng, dev)),
        (PHASE4_CASE, phase4_args),
        ("1536x1536 epipolar band (match_epipolar)", random_case(rng, 1536, 1536, dev,
                                                                pair="epipolar")),
        ("1x1", random_case(rng, 1, 1, dev, p_mask=0.0, pair=None)),
        ("4096x17 unaligned M", random_case(rng, 4096, 17, dev)),
    ]
    # the fixed cost of any call timed this way: one one-element PyTorch
    # kernel between the same events
    tiny = torch.zeros(1, device=dev)
    print(json.dumps({"launch_floor_ms": cuda_ms(lambda: tiny.add_(1)),
                      "launch_floor_warm_ms": cuda_ms(lambda: tiny.add_(1), cold=False),
                      "card": card}))
    rows = [kernel_case(name, args, card, popc_rate) for name, args in cases]
    return rows, max(r["max_abs_err"] for r in rows)


def kernel_case(name: str, args, card: str, popc_rate: float) -> dict:
    """One phase-2 case: the kernel's outputs equal to the plain version's
    (else the run fails), its times, launches and bound."""
    got = hm.hamming_resolve_cuda(*args)
    want = hm.hamming_resolve_plain(*args)
    torch.cuda.synchronize()
    max_err = 0.0
    for g, w_, what in zip(got, want, ("d1", "d2", "idx", "col_row")):
        max_err = max(max_err, float((g.long() - w_.long()).abs().max()))
        require(torch.equal(g, w_), f"hamming kernel != plain on {name}: {what}")
    N, M = args[0].shape[0], args[2].shape[0]
    bound, by, n_live = hamming_bound(args, popc_rate)
    kernel_ms = cuda_ms(lambda: hm.hamming_resolve_cuda(*args))
    launches, device_ops = launches_per_call(lambda: hm.hamming_resolve_cuda(*args))
    pm = args[4]
    row = {"case": name, "N": N, "M": M,
           "kernel_ms": kernel_ms,
           "kernel_warm_ms": cuda_ms(lambda: hm.hamming_resolve_cuda(*args), cold=False),
           "plain_ms": cuda_ms(lambda: hm.hamming_resolve_plain(*args), reps=20),
           "bound_ms": bound, "bound_by": by, "bound_share": bound / kernel_ms,
           "launches_per_call": launches, "device_ops_per_call": device_ops,
           "live_rows": int(args[1].sum()), "live_entries": n_live,
           "pair_density": None if pm is None else float(pm.float().mean()),
           # the popcounts of all N * M entries (a kernel that skips no entry)
           "dense_popc_ms": 8.0 * N * M / popc_rate * 1e3,
           "equal": True, "max_abs_err": max_err, "card": card}
    print(json.dumps(row))
    require(row["bound_share"] <= 1.0,
            f"{name}: {kernel_ms} ms is under its bound {bound} ms: the bound is wrong")
    return row


# -- phases 3 and 4 -----------------------------------------------------------


def direct_phase(dev, cam, traj, frames) -> tuple[dict, dict]:
    odo = DirectOdometry(cam, wl.BENCH_CFG)         # default device: the card
    imgs = [f[0].cpu().numpy() for f in frames[:N_DIRECT]]
    gt = []
    kf = lost = good = 0
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    for i, img in enumerate(imgs):
        if i == WARMUP:
            torch.cuda.synchronize()
            t_steady = time.perf_counter()
        out = odo.process(img, float(i))
        kf += int(bool(out.get("kf", False)))
        lost += int(out.get("state") == "LOST")
        good += int("flow" in out and bool(out["ok"]))    # a tracked frame, its pose good
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    wall = t_end - t0
    launches = hamming_launches()   # the direct path runs no Hamming kernel
    lm = path_launches()
    for R, t in traj[:N_DIRECT]:
        M = np.eye(4)
        M[:3, :3], M[:3, 3] = R, t
        gt.append(np.linalg.inv(M))
    _, est = odo.trajectory_c2w()
    ate = ate_rmse(est[:, :3, 3], np.asarray(gt)[:, :3, 3], with_scale=True)
    # host milliseconds per stage (enqueue plus the syncs inside the stage)
    host_ms = {name: statistics.mean(odo.sheet.stat(name).series()[1])
               for name in ("time_preprocess", "time_track", "time_keyframe")}
    res = {"phase": "direct", "frames": len(imgs), "fps": len(imgs) / wall,
           "steady_fps": (len(imgs) - WARMUP) / (t_end - t_steady),
           "wall_s": wall, "ate": ate, "segments": odo.segments, "lost_frames": lost,
           "keyframes": kf, "keyframe_frames": _keyframe_frames(odo), "good_pose_frames": good,
           "host_ms_per_stage": host_ms,
           "kernel_launches": {"hamming_resolve": launches, **lm}}
    print(json.dumps(res))
    require(np.isfinite(ate) and ate < 0.1, f"direct ATE {ate} >= 0.1")
    require(lm["track_lm"] >= len(imgs) - WARMUP and lm["pnp_lm"] == 0,
            f"the direct path's LM launches {lm}")
    require(lm["ba_run"] > 0 and lm["ba_sweep"] > 0 and lm["ba_solve"] == 0,
            f"the direct path's BA launches {lm}")
    require(good > 0 and lm["trace_epipolar"] == good,
            f"the tracer launched {lm['trace_epipolar']} times over {good} good-pose frames")
    require(lm["kf_activate"] >= kf and lm["kf_refresh"] >= kf,
            f"the keyframe programs' launches {lm['kf_activate']}, {lm['kf_refresh']} over "
            f"{kf} keyframes")
    require(odo.segments == 0 and lost == 0, "direct path lost tracking")
    return res, _snapshot(odo)


def hybrid_phase(dev, cam, traj, frames) -> dict:
    orb_before = oe.orb_extract_cuda.launches
    map_, n_map = wl.build_map(cam, traj, frames, dev)
    feats = {i: wl.extract(frames[i]) for i in HYBRID_FRAMES}
    torch.cuda.synchronize()
    orb_launches = oe.orb_extract_cuda.launches - orb_before
    reset_launches()
    per_frame = []
    for i in HYBRID_FRAMES:
        before = hamming_launches()
        proj_before = hm.match_projection_cuda.launches
        pnp_before = pnp_lm.pnp_lm_cuda.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res, bundle, bundle2 = wl.track_frame(map_, cam, traj, feats[i], i, dev)
        b1, b2 = bundle.cpu().numpy(), bundle2.cpu().numpy()
        ms = (time.perf_counter() - t0) * 1e3
        R_gt, t_gt = traj[i]
        R_est = res.T.R.cpu().numpy().astype(np.float64)
        t_err = float(np.linalg.norm(res.T.t.cpu().numpy() - t_gt))
        r_err = float(np.arccos(np.clip((np.trace(R_est @ R_gt.T) - 1) / 2, -1, 1)))
        launched = hamming_launches() - before
        proj_launched = hm.match_projection_cuda.launches - proj_before
        pnp_launched = pnp_lm.pnp_lm_cuda.launches - pnp_before
        row = {"frame": i, "matches": int(b1[0]), "inliers": int(b1[1]),
               "pass2_matches": int(b2[0]), "pass2_inliers": int(b2[1]),
               "t_err": t_err, "r_err": r_err, "ms": ms, "kernel_launches": launched,
               "pnp_lm_launches": pnp_launched}
        per_frame.append(row)
        print(json.dumps(row))
        require(launched == 2 and proj_launched == 2,
                f"frame {i}: {launched} Hamming launches ({proj_launched} with the projection "
                "test), expected 2 and 2")
        require(pnp_launched == 2, f"frame {i}: {pnp_launched} PnP kernel launches, expected 2")
        require(b1[2] > 0.5 and b1[1] >= 12 and b2[1] >= 12,
                f"frame {i}: PnP failed ({b1[1]} / {b2[1]} inliers)")
        require(t_err < 0.04 and r_err < 0.01,
                f"frame {i}: pose error {t_err:.4f} / {r_err:.4f} rad out of budget")
    launches = hamming_launches()
    res = {"phase": "hybrid_tracking", "frames": len(per_frame), "map_points": n_map,
           "launches": launches, "lm_launches": path_launches(), "orb_launches": orb_launches,
           "ms_per_frame": statistics.median(r["ms"] for r in per_frame),
           "min_inliers": min(r["inliers"] for r in per_frame),
           "max_t_err": max(r["t_err"] for r in per_frame),
           "max_r_err": max(r["r_err"] for r in per_frame)}
    print(json.dumps(res))
    require(launches == 2 * len(per_frame), "kernel launch count off")
    require(orb_launches == 1 + len(per_frame),
            f"ORB of frame 0 and {len(per_frame)} frames made {orb_launches} kernel calls")
    return res


# -- phases 5 and 6 ------------------------------------------------------------

# the hybrid's six Hamming call sites, functions of runtime/hybrid.py that
# HybridOdometry looks up at call time (runtime/hybrid.py, "Device programs")
CALL_SITES = ("_project_match_pnp", "_local_map_pass2", "_epipolar_triangulate",
              "_map_projection_match", "match_window", "match_descriptors")


def _clone_arg(x):
    """A tensor or pose argument cloned (anything else as it is)."""
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, SE3):
        return SE3(R=x.R.clone(), t=x.t.clone())
    return x


class CallSites:
    """Counts the Hamming kernel's launches (every mode) inside each call
    site, and every kernel's launches by site (`kernels`); keeps (cloned) the
    arguments of the first match_projection (the hybrid's name),
    _epipolar_triangulate or mask-mode resolution (matching.hamming_resolve)
    call of the sites named in `capture_at`, as (args, kwargs), for phase 2's
    real-input cases (mask_case builds the plain form's mask from the
    first two)."""

    def __init__(self):
        self.launches = Counter()
        self.kernels: dict[str, Counter] = {}
        self.calls = Counter()
        self.captured: dict[str, tuple] = {}
        self.capture_at: set[str] = set()
        self.capture_live = False    # capture only a call with a valid map point
        self._site: str | None = None
        self._saved = {name: getattr(hybrid, name) for name in CALL_SITES}
        self._match_projection = hybrid.match_projection
        self._resolve = matching.hamming_resolve

    def _wrap(self, name, fn):
        def run(*args, **kw):
            before, outer = path_launches(), self._site
            self._site = name
            if name == "_epipolar_triangulate":
                self._keep(name, args, kw)
            try:
                return fn(*args, **kw)
            finally:
                self._site = outer
                after = path_launches()
                d = Counter({k: after[k] - before[k] for k in after if after[k] > before[k]})
                self.kernels.setdefault(name, Counter()).update(d)
                self.launches[name] += sum(d[k] for k in HAMMING_MODES)
                self.calls[name] += 1
        return run

    def _keep(self, site, args, kw):
        if (site in self.capture_at and site not in self.captured
                and (not self.capture_live or bool(args[2].any()))):
            self.captured[site] = (tuple(_clone_arg(a) for a in args),
                                   {k: _clone_arg(v) for k, v in kw.items()})

    def _projection(self, *args, **kw):
        if self._site is not None:
            self._keep(self._site, args, kw)
        return self._match_projection(*args, **kw)

    def _resolution(self, *args):
        if (self._site in self.capture_at and self._site not in self.captured
                and (not self.capture_live or bool(args[1].any()))):
            self.captured[self._site] = (tuple(_clone_arg(a) for a in args), {"mask": True})
        return self._resolve(*args)

    def __enter__(self):
        for name, fn in self._saved.items():
            setattr(hybrid, name, self._wrap(name, fn))
        hybrid.match_projection = self._projection
        matching.hamming_resolve = self._resolution
        return self

    def __exit__(self, *exc):
        for name, fn in self._saved.items():
            setattr(hybrid, name, fn)
        hybrid.match_projection = self._match_projection
        matching.hamming_resolve = self._resolve


def _site_table(sites: CallSites) -> tuple[dict, Counter]:
    """A copy of a run's launches by site and kernel, and its calls by site."""
    return {k: Counter(v) for k, v in sites.kernels.items()}, Counter(sites.calls)


def _radius(kw: dict, args: tuple) -> float:
    return kw.get("radius", args[10] if len(args) > 10 else 15.0)


def mask_case(site: str, captured: tuple) -> tuple:
    """The mask mode's arguments (desc_q, mask_q, desc_t, mask_t, pair) for a
    captured call: its plain form's (N, M) mask, made on the card."""
    args, kw = captured
    if kw.get("mask"):
        return args
    if site == "_epipolar_triangulate":
        desc0, uv0, valid0, _, desc1, uv1, valid1, _, T_new, T0, cam = args[:11]
        F = fundamental(T_new.compose(T0.inverse()), cam)
        return desc0, valid0, desc1, valid1, matching.epipolar_pair_mask(uv0, uv1, F)
    Xw, desc_p, valid_p, level_p, T, cam, desc_f, uv_f, level_f, valid_f = args[:10]
    vis, pair, _ = matching.projection_pair_mask(Xw, valid_p, level_p, T, cam, uv_f, level_f,
                                                 _radius(kw, args))
    return desc_p, vis, desc_f, valid_f, pair


def gt_centres(traj) -> np.ndarray:
    out = []
    for R, t in traj:
        M = np.eye(4)
        M[:3, :3], M[:3, 3] = R, t
        out.append(np.linalg.inv(M)[:3, 3])
    return np.asarray(out)


def watch_hybrid(odo) -> Counter:
    """Counts the hybrid's keyframe events on `odo`: indirect keyframes, the
    points each triangulated, mixed-BA completions, local-BA write-backs, and the kernel launches inside the keyframe postprocess.
    `ok_kf` counts the indirect keyframes that triangulated points and then
    completed a local BA."""
    ev = Counter()
    cur = {}

    def wrap(name, before=None, after=None):
        fn = getattr(odo, name)

        def run(*args, **kw):
            if before:
                before(*args)
            out = fn(*args, **kw)
            if after:
                after(*args)
            return out
        setattr(odo, name, run)

    def kf_start(*_):
        ev["indirect_keyframes"] += 1
        cur.update(tri=0, lba=False, launches=hamming_launches())

    def kf_end(*_):
        ev["kf_launches"] += hamming_launches() - cur["launches"]
        ev["ok_kf"] += int(cur["tri"] > 0 and cur["lba"])

    def added(Xw, desc, level, ok):
        cur["tri"] = cur.get("tri", 0) + int(np.sum(ok))
        ev["triangulated"] += int(np.sum(ok))

    def lba(lb, fetched):
        if np.isfinite(fetched[0]).all():
            cur["lba"] = True
            ev["local_ba"] += 1

    def mixed(*_):
        ev["mixed_ba"] += 1

    wrap("_indirect_postprocess", kf_start, kf_end)
    wrap("_add_map_points", added)
    wrap("_complete_indirect_local_ba", lba)
    wrap("_complete_mixed_window_ba", mixed)
    return ev


def full_hybrid_phase(dev, cam, traj, frames, sites: CallSites) -> tuple[dict, dict]:
    t0 = time.perf_counter()
    voc = default_vocabulary()
    voc_s = time.perf_counter() - t0
    print(f"BoW vocabulary: {voc.num_words} words in {voc_s:.1f} s (before the timed loop)")
    odo = wl.hybrid_odometry(cam, dev=dev)
    ev = watch_hybrid(odo)
    imgs = [f[0].cpu().numpy() for f in frames[:N_DIRECT]]
    kf = lost = 0
    sites.capture_at = {"_epipolar_triangulate"}
    torch.cuda.synchronize()
    reset_launches()
    sites.launches.clear()
    sites.kernels.clear()
    sites.calls.clear()
    t0 = time.perf_counter()
    for i, img in enumerate(imgs):
        if i == WARMUP:
            torch.cuda.synchronize()
            t_steady = time.perf_counter()
        out = odo.process(img, float(i))
        kf += int(bool(out.get("kf", False)))
        lost += int(out.get("state") == "LOST")
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    launches = hamming_launches()
    lm = path_launches()
    wall = t_end - t0
    _, est = odo.trajectory_c2w()
    ate = ate_rmse(est[:, :3, 3], gt_centres(traj[:N_DIRECT]), with_scale=True)
    host_ms = {name: statistics.mean(odo.sheet.stat(name).series()[1])
               for name in ("time_preprocess", "time_orb", "time_pnp", "time_track",
                            "time_keyframe", "time_ind_post", "time_mixed_ba", "time_local_ba")
               if odo.sheet.stat(name).series()[1]}
    n = len(imgs)
    res = {"phase": "hybrid", "frames": n, "fps": n / wall,
           "steady_fps": (n - WARMUP) / (t_end - t_steady), "wall_s": wall,
           "vocabulary_s": voc_s, "ate": ate, "segments": odo.segments, "lost_frames": lost,
           "keyframes": kf, "indirect_keyframes": ev["indirect_keyframes"],
           "indirect_keyframe_frames": [k["frame"] for k in odo._ind_kfs],
           "map_points": int(odo._pt_valid.sum()), "triangulated": ev["triangulated"],
           "modes": dict(Counter(odo.mode_history)),
           "mixed_ba": ev["mixed_ba"],
           "mixed_ba_rollbacks": len(odo.sheet.stat("mixed_ba_rollback").series()[1]),
           "local_ba": ev["local_ba"], "keyframes_triangulated_and_local_ba": ev["ok_kf"],
           "kernel_launches": launches, "kernel_launches_per_frame": launches / n,
           "kernel_launches_per_indirect_keyframe":
               ev["kf_launches"] / max(ev["indirect_keyframes"], 1),
           "launches_per_site": dict(sites.launches),
           "launches_per_site_per_frame": {k: v / n for k, v in sites.launches.items()},
           "calls_per_site": dict(sites.calls), "host_ms_per_stage": host_ms,
           "lm_launches": lm, "lm_launches_per_frame": {k: v / n for k, v in lm.items()}}
    print(json.dumps(res))
    require(np.isfinite(ate) and ate < 0.1, f"hybrid ATE {ate} >= 0.1")
    require(lm["track_lm"] > 0 and lm["pnp_lm"] > 0, f"the hybrid's LM launches {lm}")
    require(lm["local_ba"] > 0, f"the hybrid launched no local BA kernel: {lm}")
    require(lm["kf_activate"] > 0 and lm["kf_refresh"] > 0,
            f"the hybrid launched no keyframe-program kernel: {lm}")
    require(odo.segments == 0 and lost == 0, "hybrid lost tracking")
    require(ev["ok_kf"] >= 1, "no indirect keyframe triangulated points and completed a local BA")
    require(launches == sum(sites.launches.values()),
            "kernel launched outside the six call sites")
    # the four sites a tracked run reaches (match_window serves the bootstrap,
    # match_descriptors the relocalization of phase 6)
    for site in CALL_SITES[:4]:
        require(sites.launches[site] > 0, f"the hybrid launched no kernel at {site}")
    return res, _snapshot(odo)


def relocalization_phase(dev, cam, traj, frames, sites: CallSites) -> dict:
    odo = wl.hybrid_odometry(cam, wl.RELOC_CFG, dev=dev)
    seq = wl.relocalization_frames(frames)
    sites.capture_at = {"match_descriptors"}
    torch.cuda.synchronize()
    reset_launches()
    sites.launches.clear()
    sites.kernels.clear()
    sites.calls.clear()
    states, at, view_before = [], None, None
    t0 = time.perf_counter()
    for k, (view, img) in enumerate(seq):
        out = odo.process(img, float(k))
        states.append(out.get("state"))
        if k == wl.RELOC_SEEN - 1:
            require(odo.state == "TRACKING", f"not tracking before the blackout: {odo.state}")
            _, est = odo.trajectory_c2w()
            view_before = est[wl.RELOC_VIEW, :3, 3].copy()
        if out.get("relocalized"):
            at = k
            break
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = hamming_launches()
    lm = path_launches()
    require(at is not None, f"never relocalized (states {states})")
    _, est = odo.trajectory_c2w()
    err = float(np.linalg.norm(est[-1, :3, 3] - view_before))
    res = {"phase": "relocalization", "frames": len(states), "relocalized_at": at,
           "black_frames": wl.RELOC_BLACK, "error": err, "states": states,
           "segments": odo.segments, "map_points": int(odo._pt_valid.sum()),
           "stored_keyframes": len(odo._kf_store), "wall_s": wall,
           "kernel_launches": launches, "launches_per_site": dict(sites.launches),
           "lm_launches": lm}
    print(json.dumps(res))
    require(err < 0.15, f"relocalized pose off by {err:.3f}")
    require(sites.launches["match_descriptors"] >= 1, "relocalization ran no descriptor match")
    return res


# -- phases 7 and 8 -------------------------------------------------------------

CLI_FRAMES = 60
CLI_PRESET = "presets/modslam.yaml"
EXPORT_FILES = ("result_tum.txt", "result_kitti.txt", "result.csv", "result_gt_tum.txt",
                "result_gt_kitti.txt", "stats.csv", "run.json")
CLI_CASE = "4096x2400 real match_projection (phase 7, modslam preset)"


def entry_points_phase(dev, work: str, sites: CallSites) -> tuple[dict, str]:
    """Phase 7: the corridor written by the port's writer, then the CLI on it
    with the modslam preset. Returns (result, the sequence directory)."""
    t0 = time.perf_counter()
    seq = corridor.write_sequence(os.path.join(work, "kitti"), CLI_FRAMES, device=dev)
    torch.cuda.synchronize()
    write_s = time.perf_counter() - t0
    out_dir = os.path.join(work, "cli_out")
    log_path = os.path.join(work, "cli.log")
    sites.capture_at = {"_project_match_pnp"}
    sites.launches.clear()
    sites.kernels.clear()
    sites.calls.clear()
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    with open(log_path, "w") as log, contextlib.redirect_stdout(log):
        rc = cli.main(["-d", seq, "-c", CLI_PRESET, "-r", out_dir, "-f", "all", "-z"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = hamming_launches()
    lm = path_launches()
    with open(log_path) as f:
        lines = f.read().splitlines()
    missing = [n for n in EXPORT_FILES if not os.path.isfile(os.path.join(out_dir, n))]
    run = {}
    if os.path.isfile(os.path.join(out_dir, "run.json")):
        with open(os.path.join(out_dir, "run.json")) as f:
            run = json.load(f)
    res = {"phase": "entry_points", "frames": run.get("frames"), "rc": rc,
           "sequence_write_s": write_s, "cli_wall_s": wall, "fps": run.get("fps"),
           "ate": run.get("ate_rmse"), "rpe": run.get("rpe_rmse"),
           "segments": run.get("segments"), "device": run.get("device"),
           "missing_files": missing, "stat_lines": sum(l.startswith("STAT ") for l in lines),
           "cli_tail": [l for l in lines if not l.startswith("STAT ")][-4:],
           "kernel_launches": launches, "launches_per_site": dict(sites.launches),
           "calls_per_site": dict(sites.calls), "lm_launches": lm}
    print(json.dumps(res))
    require(lm["track_lm"] > 0 and lm["pnp_lm"] > 0, f"the CLI run's LM launches {lm}")
    require(rc == 0 and not missing, f"the CLI failed (rc {rc}, missing {missing})")
    require(run.get("frames") == CLI_FRAMES, f"the CLI ran {run.get('frames')} frames")
    ate = run.get("ate_rmse", float("nan"))
    require(np.isfinite(ate) and ate < 0.1, f"CLI ATE {ate} >= 0.1")
    require(run.get("segments") == 0, "the CLI run lost tracking")
    require(launches > 0, "the CLI run launched no Hamming kernel")
    require("_project_match_pnp" in sites.captured, "no match_projection captured")
    shape = (sites.captured["_project_match_pnp"][0][0].shape[0],
             sites.captured["_project_match_pnp"][0][6].shape[0])
    require(shape == (4096, 2400), f"the modslam preset's match_projection is {shape}")
    return res, seq


def _same(a, b) -> bool:
    """Bit-identical: numpy arrays, tensors, lists of either."""
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return np.array_equal(np.asarray(a), np.asarray(b))


def _snapshot(odo) -> dict:
    """What two runs must agree on bit for bit."""
    require(odo._window is not None, "the run never initialized")
    _, est = odo.trajectory_c2w()
    out = {"trajectory": est}
    if isinstance(odo, hybrid.HybridOdometry):
        out.update(pt_valid=odo._pt_valid.copy(), pt_Xw=odo._pt_Xw.copy(),
                   mode_history=list(odo.mode_history))
    else:
        ba = odo._window.ba
        out.update(idepth=ba.idepth, point_valid=ba.point_valid, T_R=ba.T.R, T_t=ba.T.t)
    return out


REPEAT_FRAMES, SAVE_AT = 24, 16


def repeat_and_resume(make, imgs, work: str, name: str) -> dict:
    """Run `make()` over the frames twice (the second saves its state before
    frame SAVE_AT and goes on), then a fresh instance from the file over
    frames SAVE_AT..: everything in _snapshot must be bit-identical. The
    file must also load into an instance on the CPU."""
    ckpt = os.path.join(work, f"{name}.ckpt")
    reset_launches()
    t0 = time.perf_counter()
    a = make("cuda")
    for i, img in enumerate(imgs):
        a.process(img, i * 0.1)
    snap_a = _snapshot(a)
    b = make("cuda")
    for i, img in enumerate(imgs):
        if i == SAVE_AT:
            pending = getattr(b, "_pending_marg", None) is not None
            b.save_state(ckpt)
        b.process(img, i * 0.1)
    snap_b = _snapshot(b)
    c = make("cuda")
    c.load_state(ckpt)
    loaded_R = c._window.ba.T.R.cpu()
    for i in range(SAVE_AT, len(imgs)):
        c.process(imgs[i], i * 0.1)
    snap_c = _snapshot(c)
    torch.cuda.synchronize()
    launches = hamming_launches()
    lm = path_launches()
    wall = time.perf_counter() - t0
    cpu = make("cpu")
    cpu.load_state(ckpt)
    cpu_ok = (cpu._window.ba.T.R.device.type == "cpu"
              and torch.equal(cpu._window.ba.T.R, loaded_R))
    repeat = {k: _same(snap_a[k], snap_b[k]) for k in snap_a}
    resume = {k: _same(snap_a[k], snap_c[k]) for k in snap_a}
    res = {"phase": f"repeat_resume_{name}", "frames": len(imgs), "save_at": SAVE_AT,
           "pending_marg_at_save": pending, "repeat_identical": repeat,
           "resume_identical": resume, "cpu_load": cpu_ok,
           "max_abs_traj_diff_repeat": float(np.abs(snap_a["trajectory"]
                                                    - snap_b["trajectory"]).max()),
           "max_abs_traj_diff_resume": float(np.abs(snap_a["trajectory"]
                                                    - snap_c["trajectory"]).max()),
           "kernel_launches": launches, "lm_launches": lm, "wall_s": wall}
    print(json.dumps(res))
    require(all(repeat.values()), f"{name}: two runs differ: {repeat}")
    require(all(resume.values()), f"{name}: the resumed run differs: {resume}")
    require(cpu_ok, f"{name}: the card's checkpoint did not load on the CPU")
    return res


def determinism_probe(cam, imgs) -> dict:
    """The hybrid (24 frames, its direct spine included) and the direct path
    (12 frames) under torch.use_deterministic_algorithms(True,
    warn_only=True): the distinct warnings torch raises, with their counts.
    It names the operations torch knows to be order-dependent on CUDA and
    has no deterministic form of; the ones it has a form of switch silently,
    and phase 8's bit-identity checks catch those."""
    seen: Counter = Counter()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            odo = wl.hybrid_odometry(cam, dev="cuda")
            for i, img in enumerate(imgs[:24]):
                odo.process(img, i * 0.1)
            odo = DirectOdometry(cam, wl.BENCH_CFG)
            for i, img in enumerate(imgs[:12]):
                odo.process(img, i * 0.1)
            torch.cuda.synchronize()
        for w in caught:
            seen[str(w.message).splitlines()[0][:160]] += 1
    finally:
        torch.use_deterministic_algorithms(False)
    res = {"phase": "determinism_probe", "warnings": dict(seen)}
    print(json.dumps(res))
    return res


def repeatability_phase(seq: str, work: str) -> dict:
    """Phase 8 on the phase-7 sequence, read back through KittiCapture."""
    cap = KittiCapture(seq)
    cam = cap.calibration.pinhole
    imgs = []
    for frame in cap.frames():
        if len(imgs) == REPEAT_FRAMES:
            break
        imgs.append(frame.image)
    t0 = time.perf_counter()
    probe = determinism_probe(cam, imgs)
    probe_s = time.perf_counter() - t0
    hyb = repeat_and_resume(lambda d: wl.hybrid_odometry(cam, dev=d), imgs, work, "hybrid")
    direct = repeat_and_resume(lambda d: DirectOdometry(cam, wl.BENCH_CFG, device=d), imgs,
                               work, "direct")
    return {"probe": probe, "probe_s": probe_s, "hybrid": hyb, "direct": direct}


# -- phases 9 to 11 ------------------------------------------------------------

# CUDA runtime calls that make the host wait for the device, and copies
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize")
COPY_CALLS = ("cudaMemcpyAsync", "cudaMemcpy")
SYNC_WINDOW = range(15, 20)      # frames profiled for the host waits of a mode


def host_waits(make, imgs) -> dict:
    """Stream/event syncs and memcpys a frame (torch.profiler's CUDA runtime
    calls) of a fresh `make()` run over SYNC_WINDOW (it holds a keyframe of
    phase 3), after the frames before it; the window's end includes the
    in-flight frame's finalize."""
    odo = make()
    for i in range(SYNC_WINDOW.start):
        odo.process(imgs[i], float(i))
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for i in SYNC_WINDOW:
            odo.process(imgs[i], float(i))
        torch.cuda.synchronize()
    counts = Counter()
    for e in prof.events():
        if e.device_type.name == "CPU" and e.name in SYNC_CALLS + COPY_CALLS:
            counts[e.name] += 1
    n = len(SYNC_WINDOW)
    return {"syncs_per_frame": sum(counts[k] for k in SYNC_CALLS) / n,
            "memcpys_per_frame": sum(counts[k] for k in COPY_CALLS) / n,
            "calls_per_frame": {k: v / n for k, v in counts.items()}}


def _keyframe_frames(odo) -> list[int]:
    return [int(f) for f in odo.sheet.stat("time_keyframe").series()[0]]


def timed_run(odo, imgs) -> dict:
    """Drive `odo` over the frames on the card: wall and steady clocks, the
    kernel launches of the run (counted from 0), lost frames."""
    lost = 0
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    t_steady = t0
    for i, img in enumerate(imgs):
        if i == WARMUP:
            torch.cuda.synchronize()
            t_steady = time.perf_counter()
        out = odo.process(img, float(i))
        lost += int(out.get("state") == "LOST")
    _, est = odo.trajectory_c2w()
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    return {"wall_s": t_end - t0, "fps": len(imgs) / (t_end - t0),
            "steady_fps": (len(imgs) - WARMUP) / (t_end - t_steady),
            "kernel_launches": hamming_launches(), "lm_launches": path_launches(),
            "lost_frames": lost, "est": est}


def pipelined_direct_phase(cam, traj, frames, direct: dict) -> dict:
    """Phase 9: DirectOdometry(pipelined=True) on phase 3's frames."""
    imgs = [f[0].cpu().numpy() for f in frames[:N_DIRECT]]
    odo = DirectOdometry(cam, wl.BENCH_CFG, pipelined=True)
    run = timed_run(odo, imgs)
    ate = ate_rmse(run.pop("est")[:, :3, 3], gt_centres(traj[:N_DIRECT]), with_scale=True)
    waits = {"sequential": host_waits(lambda: DirectOdometry(cam, wl.BENCH_CFG), imgs),
             "pipelined": host_waits(lambda: DirectOdometry(cam, wl.BENCH_CFG, pipelined=True),
                                     imgs)}
    res = {"phase": "pipelined_direct", "frames": len(imgs), **run, "ate": ate,
           "segments": odo.segments, "keyframe_frames": _keyframe_frames(odo),
           "sequential_keyframe_frames": direct["keyframe_frames"],
           "sequential_ate": direct["ate"], "sequential_steady_fps": direct["steady_fps"],
           "host_waits": waits}
    print(json.dumps(res))
    require(np.isfinite(ate) and ate < 0.1, f"pipelined direct ATE {ate} >= 0.1")
    require(odo.segments == 0 and run["lost_frames"] == 0, "pipelined direct lost tracking")
    return res


def watch_events(odo) -> tuple[Counter, Counter, set]:
    """watch_hybrid for the staged postprocess: the points each keyframe
    event triangulated and whether its local BA completed are booked to the
    event (the in-flight tick's frame) whichever frame its ticks run in.
    Returns (event counts, points triangulated by event, events whose local
    BA completed)."""
    ev = Counter()
    tri, lba = Counter(), set()

    def wrap(name, after):
        fn = getattr(odo, name)

        def run(*args, **kw):
            out = fn(*args, **kw)
            after(*args)
            return out
        setattr(odo, name, run)

    def added(Xw, desc, level, ok):
        tri[odo._indpost["frame_idx"]] += int(np.sum(ok))
        ev["triangulated"] += int(np.sum(ok))

    def local(lb, fetched):
        if np.isfinite(fetched[0]).all():
            lba.add(odo._indpost["frame_idx"])
            ev["local_ba"] += 1

    wrap("_add_map_points", added)
    wrap("_complete_indirect_local_ba", local)
    wrap("_complete_mixed_window_ba", lambda *_: ev.update(mixed_ba=1))
    return ev, tri, lba


STAGED_CASE = "4096x1536 real staged-tick match_projection (phase 10, pipelined hybrid)"
STAGED_FRAMES = 60          # phase 5's 60 frames


def staged_hybrid_phase(cam, traj, frames, sites: CallSites, mode: str) -> dict:
    """Phase 10: the hybrid pipelined (every postprocess tick staged) or
    sequential with staged BA ticks, on phase 5's frames."""
    kw = {"pipelined": True} if mode == "pipelined" else {"staged_indpost": True}
    odo = hybrid.HybridOdometry(cam, wl.BENCH_CFG, orb_budget=wl.ORB_BUDGET,
                                orb_levels=wl.ORB_LEVELS, **kw)
    ev, tri, lba = watch_events(odo)
    imgs = [f[0].cpu().numpy() for f in frames[:STAGED_FRAMES]]
    sites.capture_at = {"_map_projection_match"}
    sites.capture_live = True
    sites.launches.clear()
    sites.kernels.clear()
    sites.calls.clear()
    run = timed_run(odo, imgs)
    ate = ate_rmse(run.pop("est")[:, :3, 3], gt_centres(traj[:STAGED_FRAMES]), with_scale=True)
    events = [int(f) for f in odo.sheet.stat("time_ind_post").series()[0]]
    ticks = [int(f) for f in odo.sheet.stat("time_ind_tick").series()[0]]
    ok_kf = sorted(f for f in lba if tri[f] > 0)
    n = len(imgs)
    res = {"phase": f"hybrid_{mode}", "frames": n, **run, "ate": ate, "segments": odo.segments,
           "keyframe_frames": _keyframe_frames(odo), "indirect_keyframe_events": events,
           "tick_frames": ticks, "map_points": int(odo._pt_valid.sum()),
           "triangulated": ev["triangulated"], "mixed_ba": ev["mixed_ba"],
           "local_ba": ev["local_ba"], "events_triangulated_and_local_ba": ok_kf,
           "modes": dict(Counter(odo.mode_history)),
           "kernel_launches_per_frame": run["kernel_launches"] / n,
           "launches_per_site": dict(sites.launches), "calls_per_site": dict(sites.calls)}
    print(json.dumps(res))
    require(np.isfinite(ate) and ate < 0.1, f"{mode} hybrid ATE {ate} >= 0.1")
    require(odo.segments == 0 and run["lost_frames"] == 0, f"{mode} hybrid lost tracking")
    require(ok_kf, f"{mode} hybrid: no indirect keyframe triangulated and completed a local BA")
    require(odo._indpost is None, f"{mode} hybrid: a postprocess tick left in flight")
    require(run["kernel_launches"] == sum(sites.launches.values()),
            "kernel launched outside the call sites")
    for site in CALL_SITES[:4]:
        require(sites.launches[site] > 0, f"the {mode} hybrid launched no kernel at {site}")
    later = [t for t in ticks if t not in events]
    require(later, f"{mode} hybrid: no postprocess tick ran after its keyframe's frame")
    return res


CALIB_FRAMES = 24
CALIB_K1, CALIB_K2 = -0.12, 0.02


def calib_phase(cam, traj, frames) -> dict:
    """Phase 11: CalibSlam on frames rendered through radtan distortion, and
    DirectOdometry initialized from a depth-prior callable."""
    from libcml_tpu_torch.core.camera import build_remap, invert_distortion, radtan_distort
    from libcml_tpu_torch.data.synthetic import SyntheticScene, forward_trajectory
    from libcml_tpu_torch.runtime.calib import CalibSlam

    def distort(xn):
        return radtan_distort(xn, CALIB_K1, CALIB_K2, 0.0, 0.0)

    sc = SyntheticScene.default(cam, seed=3)
    sc_d = SyntheticScene(sc.planes, cam, tex3d=sc.tex3d,
                          undistort_xn=lambda xn: invert_distortion(distort, xn))
    calib_traj = forward_trajectory(CALIB_FRAMES, step=0.08, yaw_rate=0.02)
    t0 = time.perf_counter()
    imgs = [sc_d.render_device(R, t, "cuda")[0].cpu().numpy() for R, t in calib_traj]
    render_s = time.perf_counter() - t0
    odo = CalibSlam(cam, wl.BENCH_CFG, orb_budget=wl.ORB_BUDGET, orb_levels=wl.ORB_LEVELS)
    run = timed_run(odo, imgs)
    est = run.pop("est")
    ate = ate_rmse(est[:, :3, 3], gt_centres(calib_traj), with_scale=True)
    params = odo.fit_distortion()
    require(params is not None, "CalibSlam harvested too few correspondences")
    cal = odo.finalize()
    true_remap = build_remap(cam, np.asarray(cam.K()), distort)
    H, W = cam.height, cam.width
    u, v = np.meshgrid(np.arange(W, dtype=np.float32), np.arange(H, dtype=np.float32))
    sl = np.s_[H // 6: -H // 6, W // 6: -W // 6]
    err_fit = float(np.linalg.norm(cal.remap[sl] - true_remap[sl], axis=-1).mean())
    err_id = float(np.linalg.norm(np.stack([u, v], -1)[sl] - true_remap[sl], axis=-1).mean())

    # the depth prior: the renderer's inverse depth of the first frame
    prior_calls = []

    def prior(image, frame_idx, path):
        prior_calls.append(frame_idx)
        return frames[0][1].cpu().numpy()

    direct = DirectOdometry(cam, wl.BENCH_CFG, depth_prior=prior)
    d_imgs = [f[0].cpu().numpy() for f in frames[:CALIB_FRAMES]]
    direct.process(d_imgs[0], 0.0)
    seeded = direct._init_state.idepth.cpu().numpy()
    for i, img in enumerate(d_imgs[1:], 1):
        direct.process(img, float(i))
    _, d_est = direct.trajectory_c2w()
    d_ate = ate_rmse(d_est[:, :3, 3], gt_centres(traj[:len(d_imgs)]), with_scale=True)
    res = {"phase": "calib", "frames": len(imgs), "render_s": render_s, **run, "ate": ate,
           "segments": odo.segments, "fitted": [float(p) for p in params],
           "true": [CALIB_K1, CALIB_K2, 0.0, 0.0],
           "geometric_correspondences": int(sum(len(a) for a in odo._geo_Xc)),
           "remap_err_px": err_fit, "identity_err_px": err_id,
           "prior": {"calls": prior_calls, "seeded_idepth_std": float(np.std(seeded)),
                     "frames": len(d_imgs), "ate": d_ate, "segments": direct.segments,
                     "state": direct.state}}
    print(json.dumps(res))
    require(params[0] < 0, f"fitted k1 {params[0]} is not negative")
    require(err_fit < err_id, f"the fitted remap ({err_fit} px) is no closer than the identity "
            f"({err_id} px)")
    require(prior_calls == [0] and np.std(seeded) > 0.01,
            "the depth prior did not seed the initializer")
    require(direct.state == "TRACKING" and direct.segments == 0 and d_ate < 0.1,
            f"DirectOdometry from the prior: {direct.state}, ATE {d_ate}")
    return res


# -- phase 12 ---------------------------------------------------------------------

RATIO_CASE = "1536x1536 real match_ratio (phase 12, frames 0-1 ORB)"


def sharded_phase(cam, traj, frames, direct_snap: dict, hybrid_snap: dict) -> dict:
    """Phase 12: DirectOdometry and HybridOdometry with mesh=make_mesh() (a
    world of one, NCCL) on phase 3's and phase 5's frames: bit-identical to
    the unsharded runs, with fps and the collectives a frame."""
    mesh = make_mesh()
    require(dist.get_backend() == "nccl" and mesh.world_size == 1,
            f"mesh: {dist.get_backend()} over {mesh.world_size} ranks")
    imgs = [f[0].cpu().numpy() for f in frames[:N_DIRECT]]
    out = {"phase": "sharded", "backend": dist.get_backend(), "world_size": mesh.world_size,
           "device": str(mesh.device)}
    per_call = {"run_ba": [], "run_ba_mixed": []}

    def counted(name, fn):
        def call(*args, **kw):
            before = path_launches()
            out = fn(*args, **kw)
            per_call[name].append(_ba_launches(before))
            return out
        return call

    for name, make, want in (
            ("direct", lambda: DirectOdometry(cam, wl.BENCH_CFG, mesh=mesh), direct_snap),
            ("hybrid", lambda: wl.hybrid_odometry(cam, mesh=mesh), hybrid_snap)):
        odo = make()
        mesh.all_reduces = mesh.all_gathers = 0
        orig = {n: getattr(ba, n) for n in per_call}
        for n, fn in orig.items():
            setattr(ba, n, counted(n, fn))
        try:
            run = timed_run(odo, imgs)
        finally:
            for n, fn in orig.items():
                setattr(ba, n, fn)
        ate = ate_rmse(run.pop("est")[:, :3, 3], gt_centres(traj[:N_DIRECT]), with_scale=True)
        got = _snapshot(odo)
        same = {k: _same(want[k], got[k]) for k in want}
        n = len(imgs)
        out[name] = {**run, "frames": n, "ate": ate, "segments": odo.segments,
                     "identical_to_unsharded": same,
                     "all_reduces": mesh.all_reduces, "all_gathers": mesh.all_gathers,
                     "all_reduces_per_frame": mesh.all_reduces / n,
                     "all_gathers_per_frame": mesh.all_gathers / n}
        require(all(same.values()), f"sharded {name} differs from the unsharded run: {same}")
        require(mesh.all_reduces > 0, f"sharded {name}: no all-reduce ran")
    dist.destroy_process_group()
    iters = wl.BENCH_CFG.ba_iters
    out["launches_per_run_ba"] = {n: v[0] if v else None for n, v in per_call.items()}
    print(json.dumps(out))
    require(out["hybrid"]["kernel_launches"] > 0, "the sharded hybrid launched no kernel")
    split = {"ba_sweep": 2 + 3 * iters, "ba_solve": iters, "ba_run": 0}
    require(per_call["run_ba"] and all(v == split for v in per_call["run_ba"])
            and per_call["run_ba_mixed"] and all(v == split for v in per_call["run_ba_mixed"]),
            f"a run_ba with a mesh: launches {per_call}")
    return out


def match_ratio_phase(frames, card: str, popc_rate: float) -> tuple[dict, dict]:
    """Phase 12's match_ratio: frames 0 and 1's real ORB features on the card
    against the plain version on the card (idx_b and good exactly), and the
    resolution it runs as a phase-2 kernel case."""
    f0, f1 = wl.extract(frames[0]), wl.extract(frames[1])
    torch.cuda.synchronize()
    reset_launches()
    idx_b, good = orb.match_ratio(f0.desc, f1.desc, f0.valid, f1.valid)
    torch.cuda.synchronize()
    launches = hm.hamming_resolve_cuda.launches
    want = orb.ratio_gate(hm.hamming_resolve_plain(f0.desc, f0.valid, f1.desc, f1.valid),
                          f0.valid)
    equal = torch.equal(idx_b, want[0]) and torch.equal(good, want[1])
    res = {"phase": "match_ratio", "N": f0.desc.shape[0], "M": f1.desc.shape[0],
           "good": int(good.sum()), "launches": launches, "equal_to_plain": equal}
    print(json.dumps(res))
    require(equal, "match_ratio on the card differs from its plain version")
    require(launches == 1, f"match_ratio launched the kernel {launches} times")
    require(int(good.sum()) > 0, "match_ratio matched nothing between frames 0 and 1")
    row = kernel_case(RATIO_CASE, (f0.desc, f0.valid, f1.desc, f1.valid, None), card, popc_rate)
    return res, row


# -- phase 13 ----------------------------------------------------------------------

# arithmetic a point costs in each sweep, counted from the kernels' sources
# (an FMA as 2): track_lm.cu's energy sweep (unproject, transform, project,
# bilinear of 3 channels, residual, Huber, cap), linear sweep (that, the
# 2x6 projection Jacobian, the 8-vector J and the 44 sums) and statistics
# sweep (the linear sweep without b, a rotation-only warp, 5 sums); pnp_lm.cu's
# linear sweep (transform, project, chi2, Huber weight, 2x6 J, 27 sums and
# the robust energy), energy sweep (two transforms and projections),
# re-classification and final sweep
TRACK_ENERGY_FLOPS, TRACK_LINEAR_FLOPS, TRACK_STATS_FLOPS = 73, 253, 265
PNP_LINEAR_FLOPS, PNP_ENERGY_FLOPS, PNP_RECLASS_FLOPS, PNP_FINAL_FLOPS = 227, 64, 32, 219
TRACK_FROM = 12     # phase 3's track launches kept for phase 13: two from this one on
PNP_FROM = 20       # phase 5's PnP launches: a frame's two passes from this one on


def _clone(x):
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, (list, tuple)):
        return type(x)(_clone(v) for v in x)
    return x


class LMCapture:
    """Keeps (cloned) the inputs of chosen calls while the paths run: two
    single-start track_lm launches from launch `start["track_lm"]` on (counted
    from arming), a frame's two solve_pnp passes from launch
    `start["pnp_lm"]` on (pass 1, `_project_match_pnp`, and the launch right
    after it, pass 2, `_local_map_pass2`, named by the active CallSites), the
    first track_lm launch of more than one start (a recovery battery), the
    first solve_pnp launch off the map arena (relocalization's EPnP refine),
    and the odometry's first `track` call from `start["track_lm"]` on."""

    def __init__(self):
        self.saved: dict[str, list] = {"track_lm": [], "pnp_lm": [], "battery": [],
                                       "epnp_refine": [], "track": []}
        self.start: dict[str, int | None] = {"track_lm": None, "pnp_lm": None}
        self.count = Counter()
        self.sites: CallSites | None = None
        self._orig = (tracker.track_lm_cuda, pnp_mod.pnp_lm_cuda, odometry.track)

    def arm(self, name: str, start: int) -> None:
        self.count[name] = 0
        self.start[name] = start

    def _armed(self, name: str, k: int) -> bool:
        return self.start[name] is not None and k >= self.start[name]

    def _track_lm(self, *args):
        k = self.count["track_lm"]
        self.count["track_lm"] += 1
        got = self.saved["track_lm"]
        if self._armed("track_lm", k) and len(got) < 2 and args[7].shape[0] == 1:
            got.append((k, _clone(args)))
        if args[7].shape[0] > 1 and not self.saved["battery"]:
            self.saved["battery"].append(_clone(args))
        return self._orig[0](*args)

    def _pnp_lm(self, *args):
        k = self.count["pnp_lm"]
        self.count["pnp_lm"] += 1
        site = None if self.sites is None else self.sites._site
        got = self.saved["pnp_lm"]
        if self._armed("pnp_lm", k) and len(got) < 2:
            pair = len(got) == 1 and k == got[0][0] + 1 and site == "_local_map_pass2"
            if not pair:
                got.clear()
            if pair or site == "_project_match_pnp":
                got.append((k, site, _clone(args)))
        if args[0].shape[0] != hybrid.MAP_CAP and not self.saved["epnp_refine"]:
            self.saved["epnp_refine"].append(_clone(args))
        return self._orig[1](*args)

    def _track(self, *args, **kw):
        if not self.saved["track"] and self._armed("track_lm", self.count["track_lm"]):
            self.saved["track"].append(_clone(args))
        return self._orig[2](*args, **kw)

    def __enter__(self):
        tracker.track_lm_cuda, pnp_mod.pnp_lm_cuda = self._track_lm, self._pnp_lm
        odometry.track = self._track
        return self

    def __exit__(self, *exc):
        tracker.track_lm_cuda, pnp_mod.pnp_lm_cuda, odometry.track = self._orig


def _texels(grad: torch.Tensor, cam, uv, idepth, R, t) -> int:
    """Distinct texels the bilinear sampler gathers for the points warped by
    each pose (R (B, 3, 3), t (B, 3)), as ops/image.py clamps them."""
    H, W = grad.shape[0], grad.shape[1]
    X = cam.unproject(uv, idepth)
    Xj = torch.einsum("bij,pj->bpi", R, X) + t[:, None]
    uvj, _ = cam.project(Xj)
    x0 = torch.nan_to_num(torch.clamp(torch.floor(uvj[..., 0]), 0, W - 2), nan=0.0).long()
    y0 = torch.nan_to_num(torch.clamp(torch.floor(uvj[..., 1]), 0, H - 2), nan=0.0).long()
    base = (y0 * W + x0).reshape(-1)
    ids = torch.cat([base, base + 1, base + W, base + W + 1])
    return int(torch.unique(ids).numel())


def _systems(trace: torch.Tensor, steps: torch.Tensor) -> torch.Tensor:
    """The normal equations an LM loop needs, from its per-step trace (...,
    steps, >= 2: E, E_new) and the steps it ran (...): one at its start when
    it takes a step, and one at each accepted pose a later step starts from.
    After a rejected step the pose, and so its system, is the one held."""
    n = trace.shape[-2]
    acc = (trace[..., 1] < trace[..., 0]) & (torch.arange(n) < (steps[..., None] - 1))
    return (steps > 0).long() + acc.long().sum(-1)


def track_bound(args, got) -> tuple[float, str, dict]:
    """Least time of one track_lm call, in ms: the larger of its bytes over
    the HBM rate and its arithmetic over the f32 rate. Bytes: each level's
    point data and idepth read once, the texels gathered at the final pose
    of every hypothesis (12 bytes each), the starts, and the outputs written
    once. Arithmetic, from the kernel's trace: an energy sweep at each trial
    pose (at the start of a level that takes no step, one at its pose), a
    linear sweep (which includes the energy's work) for each system the
    level needs (_systems), and track's statistics sweep when the call
    runs it."""
    grads, cams, uv, color, weight, valid, idepth, R0, t0, ab0, abc, cfg = args[:12]
    stats = len(args) > 12 and args[12]
    L, P, B = len(grads), idepth.numel(), R0.shape[0]
    its = got[4].long().cpu()
    systems = _systems(got[5].cpu(), its)
    texels = sum(_texels(grads[l], cams[l], uv[l], idepth, got[0], got[1]) for l in range(L))
    nbytes = (L * P * (8 + 4 + 4 + 1) + P * 4 + 12 * texels + B * 14 * 4 + 8
              + B * 15 * 4 + B * L * 4 + B * L * cfg.tracker_iters * 12
              + (B * (4 * 4 + 8 + 36 * 4) if stats else 0))
    # E0 is the start's linear sweep's; an accepted pose's energy sweep is
    # part of the linear sweep there
    energy = its + (its == 0).long() - (systems - (its > 0).long())
    flops = P * float((TRACK_ENERGY_FLOPS * energy + TRACK_LINEAR_FLOPS * systems).sum()
                      + (B * TRACK_STATS_FLOPS if stats else 0))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    detail = {"bytes": nbytes, "flops": flops, "texels": texels,
              "steps": its.tolist() if B <= 2 else int(its.sum()),
              "systems": systems.tolist() if B <= 2 else int(systems.sum())}
    return (t_ops, "operations", detail) if t_ops >= t_bytes else (t_bytes, "bytes", detail)


def pnp_bound(args, got) -> tuple[float, str, dict]:
    """Least time of one pnp_lm call, in ms: matches, starts and outputs
    read or written once. Arithmetic, from the kernel's trace: an energy
    sweep at each trial pose, a linear sweep for each system a round needs
    (_systems: its first step's, and the accepted poses a later step starts
    from; the projection it shares with the energy at that pose counted
    twice), the re-classifications and the final sweep."""
    Xw, rounds, iters = args[0], args[7], args[8]
    N = Xw.shape[0]
    trace = got[6].cpu()
    systems = int(_systems(trace, torch.full(trace.shape[:1], iters)).sum())
    nbytes = N * (12 + 8 + 1 + 4) + 48 + N + 48 + 8 + 144 + 4 + rounds * iters * 8
    flops = float(N * (systems * PNP_LINEAR_FLOPS + rounds * iters * PNP_ENERGY_FLOPS
                       + rounds * PNP_RECLASS_FLOPS + PNP_FINAL_FLOPS))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    detail = {"bytes": nbytes, "flops": flops, "systems": systems}
    return (t_ops, "operations", detail) if t_ops >= t_bytes else (t_bytes, "bytes", detail)


def _lm_times(kernel, plain, bound: float, steps: int) -> dict:
    """A kernel's launches a call (torch.profiler), cold and warm times
    (median of 30), microseconds an LM step (cold, over the `steps` of the
    longest start), the plain form's time (median of 5) and the share of
    its bound that the cold time reaches."""
    host, device_ops = launches_per_call(kernel)
    ms = cuda_ms(kernel)
    return {"kernel_ms": ms, "kernel_warm_ms": cuda_ms(kernel, cold=False),
            "us_per_step": ms * 1e3 / max(steps, 1),
            "plain_ms": cuda_ms(plain, reps=5, warmup=1), "launches_per_call": host,
            "device_ops_per_call": device_ops, "bound_share": bound / ms}


def track_case(name: str, args, card: str) -> dict:
    """One phase-13 tracker case: the kernel against track_levels_plain on
    the card (track_lm.parity), one launch a call, its times and bound."""
    before = track_lm.track_lm_cuda.launches
    got = track_lm.track_lm_cuda(*args)
    torch.cuda.synchronize()
    calls = track_lm.track_lm_cuda.launches - before
    want = tracker.track_levels_plain(*args)
    rep = track_lm.parity(got, want, args[11])
    bound, by, detail = track_bound(args, got)
    row = {"case": name, "B": args[7].shape[0], "levels": len(args[0]), "P": args[6].numel(),
           "stats": got[6] is not None,
           "parity": rep, "steps": got[4].cpu().tolist() if args[7].shape[0] <= 2 else None,
           "plain_steps": want[4].cpu().tolist() if args[7].shape[0] <= 2 else None,
           **_lm_times(lambda: track_lm.track_lm_cuda(*args),
                       lambda: tracker.track_levels_plain(*args), bound,
                       int(got[4].sum(-1).max())),
           "bound_ms": bound, "bound_by": by, "bound_detail": detail,
           "max_abs_err": max(rep["max_err"]["R"], rep["max_err"]["t"]), "card": card}
    print(json.dumps(row))
    for c in rep["diverged"]:
        print(f"  {name}: hypothesis {c['hypothesis']} took steps {c['steps']} against the "
              f"plain form's {c['plain_steps']}: first differing decision {c}")
    require(calls == 1 and row["launches_per_call"] == 1,
            f"{name}: {calls} counted / {row['launches_per_call']} profiled launches a call")
    require(rep["ok"], f"track_lm != plain on {name}: {rep}")
    require(row["bound_share"] <= 1.0, f"{name}: under its bound: the bound is wrong")
    return row


def pnp_case(name: str, args, card: str) -> dict:
    """One phase-13 PnP case: the kernel against pnp_lm_plain on the card
    (pnp_lm.parity), one launch a call, its times and bound."""
    before = pnp_lm.pnp_lm_cuda.launches
    got = pnp_lm.pnp_lm_cuda(*args)
    torch.cuda.synchronize()
    calls = pnp_lm.pnp_lm_cuda.launches - before
    want = pnp_mod.pnp_lm_plain(*args)
    rep = pnp_lm.parity(got, want, *args[:4], args[6])
    bound, by, detail = pnp_bound(args, got)
    row = {"case": name, "N": args[0].shape[0], "valid": int(args[2].sum()),
           "inliers": int(got[3]), "plain_inliers": int(want[3]), "parity": rep,
           **_lm_times(lambda: pnp_lm.pnp_lm_cuda(*args),
                       lambda: pnp_mod.pnp_lm_plain(*args), bound, args[7] * args[8]),
           "bound_ms": bound, "bound_by": by, "bound_detail": detail,
           "max_abs_err": max(rep["max_err"]["R"], rep["max_err"]["t"]), "card": card}
    print(json.dumps(row))
    if rep["first_step_differing"] or rep["classes_differing"]:
        print(f"  {name}: differs at a decision: {rep['first_step_differing']}, "
              f"classes {rep['classes_differing']}")
    require(calls == 1 and row["launches_per_call"] == 1,
            f"{name}: {calls} counted / {row['launches_per_call']} profiled launches a call")
    require(rep["ok"], f"pnp_lm != plain on {name}: {rep}")
    require(row["bound_share"] <= 1.0, f"{name}: under its bound: the bound is wrong")
    return row


def _syncs(fn) -> dict:
    """Host waits, copies and enqueued device operations of one call of
    `fn` (torch.profiler), less those of profiling an empty call (the
    profiler synchronizes the device when it stops)."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]

    def count(f) -> Counter:
        f()
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            f()
        return Counter(e.name for e in prof.events()
                       if e.device_type.name == "CPU" and e.name in SYNC_CALLS + COPY_CALLS
                       + ENQUEUE_CALLS)

    counts = count(fn)
    counts.subtract(count(lambda: None))
    return {"syncs": sum(counts[k] for k in SYNC_CALLS),
            "memcpys": sum(counts[k] for k in COPY_CALLS),
            "enqueues": sum(counts[k] for k in ENQUEUE_CALLS)}


def lm_phase(cap: LMCapture, card: str) -> tuple[list[dict], list[dict], dict]:
    """Phase 13: the two LM kernels against their plain forms on the card, at
    inputs captured in phases 3, 5 and 6, and the all-invalid cases; the
    public track / track_multi on a captured frame (the all-invalid probe
    finite; host waits a call)."""
    require(len(cap.saved["track_lm"]) == 2, "phase 3's track calls not captured")
    require(len(cap.saved["pnp_lm"]) == 2, "phase 5's two PnP passes of a frame not captured")
    require(cap.saved["track"], "no odometry track call captured")
    t_rows, p_rows = [], []
    for k, args in cap.saved["track_lm"]:
        t_rows.append(track_case(f"track, phase-3 launch {k} ({len(args[0])} levels, B 1)",
                                 args, card))
    # the recovery battery of _frame_step about the first captured start:
    # motion_hypotheses(T_init, T_zero = T_init, T_extra = T_init), the two
    # coarse levels (starts 0, 5 and 6 identical: an exact energy tie)
    k0, args = cap.saved["track_lm"][0]
    T0 = SE3(R=args[7][0], t=args[8][0])
    H = tracker.motion_hypotheses(T0, T0, T_extra=T0)
    B = H.t.shape[0]
    battery = (*(a[:2] for a in args[:6]), args[6], H.R.contiguous(), H.t.contiguous(),
               args[9][:1].expand(B, 2).contiguous(), args[10], args[11], False)
    row = track_case(f"track_multi battery about phase-3 launch {k0} (2 levels, B {B})",
                     battery, card)
    E = tracker.track_levels_plain(*battery)[3]
    row["tie"] = {"E0": float(E[0]), "E5": float(E[5]), "E6": float(E[6])}
    t_rows.append(row)
    if cap.saved["battery"]:
        t_rows.append(track_case("track_multi battery, the first run in phases 3-6",
                                 cap.saved["battery"][0], card))
    dead = (*args[:5], [torch.zeros_like(v) for v in args[5]], *args[6:])
    t_rows.append(track_case("track, all points invalid", dead, card))
    # every point three times (P 6144): the points past those a thread
    # holds in registers are read from memory each sweep
    tripled = (*args[:2], *([torch.cat([v] * 3) for v in a] for a in args[2:6]),
               torch.cat([args[6]] * 3), *args[7:])
    t_rows.append(track_case("track, every point three times (P 6144)", tripled, card))
    for (k, site, args), name in zip(cap.saved["pnp_lm"], ("pass 1", "pass 2")):
        p_rows.append(pnp_case(f"solve_pnp {name} ({site}), phase-5 launch {k} "
                               f"(N {args[0].shape[0]})", args, card))
    args = cap.saved["pnp_lm"][0][2]
    p_rows.append(pnp_case("solve_pnp, all matches invalid",
                           (*args[:2], torch.zeros_like(args[2]), *args[3:]), card))
    p_rows.append(pnp_case("solve_pnp, every match three times (N 12288)",
                           (*(torch.cat([v] * 3) for v in args[:4]), *args[4:]), card))
    if cap.saved["epnp_refine"]:
        args = cap.saved["epnp_refine"][0]
        p_rows.append(pnp_case(f"EPnP refine, phase 6 (N {args[0].shape[0]})", args, card))

    # the public entry points on the captured frame, on the card
    grad_pyr, cam, ref, T_init, ab0, cfg = cap.saved["track"][0]
    probe = tracker.track(grad_pyr, cam, ref.replace(valid=torch.zeros_like(ref.valid)),
                          T_init, ab0, cfg)
    finite = bool(torch.isfinite(probe.T_ji.t).all() and torch.isfinite(probe.T_ji.R).all())
    require(finite and int(probe.num_valid) == 0 and float(probe.energy) == 0.0,
            "the all-invalid probe is not finite on the card")
    Hs = tracker.motion_hypotheses(T_init, T_init, T_extra=T_init)
    before = track_lm.track_lm_cuda.launches
    tracker.track_multi(grad_pyr, cam, ref, Hs, ab0, cfg)
    torch.cuda.synchronize()
    multi_launches = track_lm.track_lm_cuda.launches - before
    public = {"all_invalid_finite": finite, "track_multi_launches": multi_launches,
              "track": _syncs(lambda: tracker.track(grad_pyr, cam, ref, T_init, ab0, cfg)),
              "track_multi": _syncs(lambda: tracker.track_multi(grad_pyr, cam, ref, Hs, ab0,
                                                                cfg)),
              "solve_pnp": _syncs(lambda: pnp_lm.pnp_lm_cuda(*cap.saved["pnp_lm"][0][2]))}
    # starts whose levels took other steps than the plain form, over the
    # captured converging cases (the all-invalid ones take the same steps)
    converging = [r for r in t_rows if not any(w in r["case"] for w in ("invalid", "three"))]
    public["starts_taking_other_steps"] = {
        "starts": sum(r["B"] for r in converging),
        "differ": sum(len(r["parity"]["diverged"]) for r in converging)}
    # the cluster size and the clusters the card holds at once
    public["cluster"] = {"track_lm": track_lm.cluster_info(), "pnp_lm": pnp_lm.cluster_info()}
    print(json.dumps({"phase": "lm_public", **public}))
    print(f"phase 13: {public['starts_taking_other_steps']['differ']} of "
          f"{public['starts_taking_other_steps']['starts']} starts took other steps than "
          f"the plain form; clusters {public['cluster']}; microseconds an LM step: "
          + ", ".join(f"{r['case']} {r['us_per_step']:.3f}" for r in t_rows + p_rows))
    require(multi_launches == 2, f"track_multi made {multi_launches} track_lm launches")
    for name in ("track", "track_multi", "solve_pnp"):
        require(public[name]["syncs"] == 0 and public[name]["memcpys"] == 0,
                f"{name} waits for the device: {public[name]}")
    return t_rows, p_rows, public


# -- phase 14 ----------------------------------------------------------------------

# arithmetic the sweep's function needs, in FMAs, counted from csrc/ba_sweep.cu:
# a residual of an active pair (the pattern pixel's unprojection, transform,
# projection and bounds, the 3-channel bilinear sample, residual, Huber
# weight and energy, and the 14 sums of Z and zr); an active pair's FEJ
# geometry (its relative transform, projection Jacobian, A_t, A_h, a, s0);
# an active pair's share of the camera system (its 8x8 blocks on and above the
# diagonal, 100 entries, each a form of at most 4 terms, and 16 gradient
# entries); and, per valid point, the upper triangle of its Schur outer
# product and its gradient correction
BA_RESIDUAL_FMA, BA_PAIR_FEJ_FMA, BA_PAIR_SYSTEM_FMA = 40, 70, 100 * 4 + 16 * 2
# an energy sweep's residual: the same less the 14 sums of Z and zr
BA_ENERGY_RESIDUAL_FMA = BA_RESIDUAL_FMA - 14
# the mixed BA's reprojection pair, counted from csrc/ba_common.cuh ind_pair
# and ind_*_forms: its residual (unprojection, transform, projection, chi2,
# the Huber weight and energy); its Jacobians J_uv, J_t, J_h, J_rho; and its
# share of the camera system (three 6x6 products of two terms, the two
# 6-vectors J^T W r, its H_rho, b_rho and H_xr shares); its valid points'
# Schur outer products are counted as the photometric points' are
BA_IND_RESIDUAL_FMA, BA_IND_JACOBIAN_FMA = 36, 99
BA_IND_PAIR_SYSTEM_FMA = 3 * 36 * 2 + 2 * 6 * 2 + 16 * 2
BA_KERNELS = ("ba_sweep", "ba_solve", "ba_run")
# faults planted in a copy of csrc/ba_common.cuh (ba_run.cu beside it) that
# phase 14 builds and runs on a run_ba_mixed call of phase 5: the
# reprojection Huber threshold moved to 4, and the factors' Schur pair left
# out of the damped system; the mixed case's verdict must refuse each
BA_MIXED_FAULTS = {
    "huber_threshold_4": (("constexpr float CHI2_2D = 5.991f;",
                           "constexpr float CHI2_2D = 4.0f;"),),
    "schur_pair_left_out": (("      if (a.Hi_corr) h = h - ldcg(a.Hi_corr + i);\n", ""),
                            ("    if (a.bi_corr) g = g - ldcg(a.bi_corr + tid);\n", "")),
}
# the worst error of the scale curvature of H - H_corr against float64 over
# phase 3's windows recorded for the one-block sweep with float64 partials
# and for the plain form (PERF.md)
SCALE_REL_RECORDED = {"kernel": 0.0107, "plain_f32": 0.0318}


class BACapture:
    """Keeps (cloned) the positional inputs of the BA calls that a run makes
    (runtime/odometry.py and runtime/hybrid.py look up ba.run_ba,
    ba._marg_pieces and ba.run_ba_mixed at call time): of every call of
    each name in `every`, of the first call of each name in `first`. The
    mesh (the last argument) is not kept: the captured runs are unsharded."""

    ARGS = {"run_ba": 4, "_marg_pieces": 5, "run_ba_mixed": 5}

    def __init__(self, every: tuple = (), first: tuple = ()):
        self.calls: dict[str, list[tuple]] = {n: [] for n in (*every, *first)}
        self._first = set(first)
        self._orig = {n: getattr(ba, n) for n in self.calls}

    def _wrap(self, name: str):
        orig, seen = self._orig[name], self.calls[name]

        def call(*args):
            if name not in self._first or not seen:
                seen.append(tuple(_clone_fields(a) for a in args[:self.ARGS[name]]))
            return orig(*args)
        return call

    def __enter__(self):
        for name in self.calls:
            setattr(ba, name, self._wrap(name))
        return self

    def __exit__(self, *exc):
        for name, fn in self._orig.items():
            setattr(ba, name, fn)


def _map_fields(x, fn):
    """`x` with `fn` applied to every tensor inside it: a tensor, or the
    fields of a dataclass (a BAState, a Window, an SE3, ...) and the items
    of a tuple or list, recursively; anything else as it is."""
    if isinstance(x, torch.Tensor):
        return fn(x)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        kw = {f.name: _map_fields(getattr(x, f.name), fn) for f in dataclasses.fields(x)}
        # one without tensors (a camera, a config) stays the same object
        same = all(v is getattr(x, k) for k, v in kw.items())
        return x if same else dataclasses.replace(x, **kw)
    if isinstance(x, (tuple, list)):
        return type(x)(_map_fields(v, fn) for v in x)
    return x


def _clone_fields(x):
    return _map_fields(x, torch.Tensor.clone)


def _state64(x):
    """The state (or factors) with every float tensor in float64 (masks and
    indices kept)."""
    return _map_fields(x, lambda v: v.double() if v.is_floating_point() else v)


def ba_parity(got, E, want, E_want, tol: dict = bk.PARITY_TOL, idepth_i=None) -> dict:
    """run_ba (run_ba_mixed) on the kernels against its plain form: the
    largest errors, and whether they are within `tol`. `idepth_i`: the
    mixed BA's indirect inverse depths, (kernels, plain), held like idepth."""
    T = max(float((got.T.t - want.T.t).abs().max()), float((got.T.R - want.T.R).abs().max()))
    pairs = [(got.idepth, want.idepth)] + ([] if idepth_i is None else [idepth_i])
    over = [float(((g - w).abs() / (tol["idepth_abs"] + tol["idepth_rel"] * w.abs())).max())
            for g, w in pairs]
    err = {"E_rel": float((E - E_want).abs() / E_want.abs().clamp_min(1e-30)), "T": T,
           "idepth_abs": float((got.idepth - want.idepth).abs().max()),
           "idepth_over_bound": over[0]}
    if idepth_i is not None:
        err["idepth_indirect_abs"] = float((idepth_i[0] - idepth_i[1]).abs().max())
        err["idepth_indirect_over_bound"] = over[1]
    within = {"E_rel": err["E_rel"] <= tol["E_rel"], "T": T <= tol["T"],
              "idepth": max(over) <= 1.0,
              "point_valid": bool(torch.equal(got.point_valid, want.point_valid))}
    return {"ok": all(within.values()), "within": within, "max_err": err}


def nullspaces_like_state(state) -> torch.Tensor:
    """ba._nullspaces in the state's floating type (it builds float32)."""
    F = state.num_frames
    R, t = state.T.R, state.T.t
    fv = state.frame_valid[:, None, None].to(R.dtype)
    N = torch.zeros((F, 8, 7), dtype=R.dtype, device=R.device)
    N[:, 0:3, 0:3] = R * fv
    N[:, 0:3, 3:6] = (skew(t) @ R) * fv
    N[:, 3:6, 3:6] = R * fv
    N[:, 0:3, 6] = t * fv[..., 0]
    return N.reshape(F * 8, 7)


def run_ba_f64(st, images, cam, cfg, ind=None) -> dict:
    """run_ba_plain (run_ba_mixed_plain with `ind`) in float64 on the window:
    the state, the images (and the factors) in float64, the scale gauge's
    nullspace built in the state's type. Its state, energy, each step's
    accept decision (and the indirect inverse depths)."""
    tr = []
    orig = ba._nullspaces
    ba._nullspaces = nullspaces_like_state
    try:
        if ind is None:
            out, E = ba.run_ba_plain(_state64(st), images.double(), cam, cfg, trace=tr)
            idepth_i = None
        else:
            out, out_i, E = ba.run_ba_mixed_plain(_state64(st), images.double(), cam, cfg,
                                                  _state64(ind), trace=tr)
            idepth_i = out_i.idepth
    finally:
        ba._nullspaces = orig
    return {"state": out, "E": E, "idepth_i": idepth_i,
            "accept": [bool(e[1] < e[0]) for e in tr]}


def f64_distances(forms: dict, f64: dict, tol: dict) -> dict:
    """Each float32 form's distance from the float64 run (ba_parity's
    measures, taken in float64): forms maps a name to (state, E, the
    indirect inverse depths or None)."""
    out = {}
    for name, (s, E, idepth_i) in forms.items():
        pair = None if idepth_i is None else (idepth_i.double(), f64["idepth_i"])
        out[name] = ba_parity(_state64(s), E.double(), f64["state"], f64["E"], tol,
                              pair)["max_err"]
    return out


def run_ba_verdict(got, E, want, E_want, dec: dict, f64: dict, tol: dict,
                   idepth_i: tuple | None = None) -> dict:
    """run_ba (run_ba_mixed) on the kernels, (got, E), against its plain form
    (want, E_want) and the float64 run `f64` (run_ba_f64) of the same
    window, with `dec` the two forms' accept decisions (_decisions) and
    `idepth_i` the mixed BA's indirect inverse depths (kernels, plain). `ok`
    when within `tol` of the plain form (ba_parity), or the first differing
    decision sits within bk.DECISION_TOL of its threshold, or, over `tol`
    with every decision equal, on float64 evidence (f64_evidence); a
    decision that differs away from its threshold fails whatever else
    holds."""
    rep = ba_parity(got, E, want, E_want, tol, idepth_i)
    gi, wi = (None, None) if idepth_i is None else idepth_i
    dist64 = f64_distances({"kernel": (got, E, gi), "plain_f32": (want, E_want, wi)}, f64, tol)
    ev = f64_evidence(rep, dec, dist64, f64)
    differ = dec.get("first_differing")
    ok = differ["within"] if differ is not None else rep["ok"] or ev["holds"]
    return {"ok": ok, "parity": rep, "from_f64": dist64, "f64_decisions": f64["accept"],
            "f64_evidence": ev}


def f64_evidence(rep: dict, dec: dict, dist64: dict, f64: dict) -> dict:
    """Whether a case over the plain form's bound passes on float64
    evidence: no accept decision differs between the kernels and the plain
    form, the float64 run takes the same decisions, the energy and the
    point mask are within their bounds, and the kernels' T and inverse
    depths are no further from the float64 run than the plain form's."""
    k, p = dist64["kernel"], dist64["plain_f32"]
    keys = [n for n in ("T", "idepth_over_bound", "idepth_indirect_over_bound") if n in k]
    closer = {n: k[n] <= p[n] for n in keys}
    same = f64["accept"] == dec["plain"] == dec["kernel"]
    holds = (rep["within"]["E_rel"] and rep["within"]["point_valid"] and same
             and all(closer.values()))
    return {"holds": holds, "f64_decisions_equal": same, "kernel_no_further": closer}


def _decisions(trace_k: torch.Tensor, trace_p: list) -> dict:
    """Each step's accept decision of the kernels and of the plain form, and
    the first that differs with the plain form's margin |E_new - E| / E."""
    k = trace_k.cpu().double()
    p = torch.stack(trace_p).cpu().double() if trace_p else torch.zeros((0, 2))
    acc_k, acc_p = (k[:, 1] < k[:, 0]).tolist(), (p[:, 1] < p[:, 0]).tolist()
    out = {"kernel": acc_k, "plain": acc_p, "E_plain": p.tolist()}
    j = next((i for i, (a, b) in enumerate(zip(acc_k, acc_p)) if a != b), None)
    if j is not None:
        margin = float(abs(p[j, 1] - p[j, 0]) / max(abs(float(p[j, 0])), 1e-30))
        out["first_differing"] = {"step": j, "margin": margin,
                                  "within": margin <= bk.DECISION_TOL["E_rel"]}
    return out


def _active_pairs(st, images, cam, cfg) -> tuple[torch.Tensor, torch.Tensor]:
    """The active (point, target) pairs of the state and the distinct
    texels their pattern pixels gather (ops/image.py's clamps)."""
    lin = ba.linearize(st, images, cam, cfg)
    host = st.host.long()
    rel = ba._pairwise_rel(st.T)
    Xp = cam.unproject(residuals.pattern_uv(st.uv), st.idepth[:, None])
    Y = torch.einsum("pfij,pkj->pfki", rel.R[host], Xp) + rel.t[host][:, :, None, :]
    uv, _ = cam.project(Y)
    H, W = images.shape[1], images.shape[2]
    x0 = torch.nan_to_num(torch.clamp(torch.floor(uv[..., 0]), 0, W - 2), nan=0.0).long()
    y0 = torch.nan_to_num(torch.clamp(torch.floor(uv[..., 1]), 0, H - 2), nan=0.0).long()
    f = torch.arange(st.num_frames, device=uv.device)[None, :, None].expand_as(x0)
    base = ((f * H + y0) * W + x0)[lin.active]
    texels = torch.unique(torch.cat([base, base + 1, base + W, base + W + 1]))
    return lin.active, texels


def sweep_bound(st, images, cam, cfg, mode: str = "system") -> tuple[float, str, dict]:
    """Least time of one system (or energy) sweep, in ms: the larger of its
    bytes over the HBM rate (the texels its active pairs gather, 12 bytes
    each; the point and frame data read once; the Schur-complemented system
    H - H_corr, b - b_corr and the per-point rows, or the energy, written
    once) and its arithmetic over
    the f32 rate (the FMAs above, as 2 operations each, for the active pairs
    and valid points of this state)."""
    active, texels = _active_pairs(st, images, cam, cfg)
    P, F = st.num_points, st.num_frames
    D = 8 * F
    pairs = int(active.sum())
    valid = int(st.point_valid.sum())
    if mode == "energy":
        nbytes = 12 * texels.numel() + P * (8 + 4 + 4 + 32 + 32 + 1 + F) + F * (48 + 8 + 1) + 4
        fma = pairs * 8 * BA_ENERGY_RESIDUAL_FMA
    else:
        nbytes = (12 * texels.numel() + P * (8 + 4 + 4 + 4 + 32 + 32 + 1 + F)
                  + F * (2 * 48 + 2 * 8 + 32 + 1) + D * D * 4 + 4
                  + D * D * 4 + D * 4 + P * (4 + 4 + 4 * D) + 4)
        fma = (pairs * (8 * BA_RESIDUAL_FMA + BA_PAIR_FEJ_FMA + BA_PAIR_SYSTEM_FMA)
               + valid * (D * (D + 1) // 2 + D))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * fma / F32_FLOP_PER_S * 1e3
    detail = {"bytes": nbytes, "flops": 2 * fma, "active_pairs": pairs, "residuals": 8 * pairs,
              "texels": int(texels.numel()), "valid_points": valid}
    return (t_ops, "operations", detail) if t_ops >= t_bytes else (t_bytes, "bytes", detail)


def solve_bound(st) -> tuple[float, str, dict]:
    """Least time of one solve, in ms: its inputs (the Schur-complemented
    system, the prior, the state, the per-point rows) read once and its
    outputs written once over the HBM rate, or its FMAs over the f32 rate:
    an LU of the D x D system with one right-hand side (D^3 / 3 + D^2), the
    back-substitution and the gauge projection (D^2 / 2 + 2D), and D a
    valid point row."""
    P, F = st.num_points, st.num_frames
    D = 8 * F
    valid = int(st.point_valid.sum())
    nbytes = 2 * D * D * 4 + 2 * D * 4 + F * (48 + 8 + 32 + 1) + 4 + P * (4 * D + 4 + 4 + 1 + 4) \
        + F * (48 + 8 + 32) + P * 4
    fma = D ** 3 // 3 + D * D + D * D // 2 + 2 * D + valid * D
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * fma / F32_FLOP_PER_S * 1e3
    detail = {"bytes": nbytes, "flops": 2 * fma, "valid_points": valid}
    return (t_ops, "operations", detail) if t_ops >= t_bytes else (t_bytes, "bytes", detail)


def run_ba_bound(st, images, cam, cfg, ind=None) -> tuple[float, str, dict]:
    """Least time of one run_ba (run_ba_mixed with the factors `ind`) in one
    launch, in ms: the larger of its bytes over the HBM rate (the state's
    point and frame data and the prior read once, the factors' read once,
    the texels that any of its sweeps gathers read once, 12 bytes each, and
    the result's frames, inverse depths and energy written once; the
    systems and the point rows stay on the chip) and its arithmetic over
    the f32 rate (the operations that sweep_bound and solve_bound count for
    each sweep and solve it makes, and the factors' active pairs and valid
    points in each sweep, each at the state it takes along the plain form's
    run: the energy sweep at the start; a step's system sweep and solve at
    the held state, its energy sweep at the candidate)."""
    P, F = st.num_points, st.num_frames
    D = 8 * F
    flops, texels, ind_pairs = 0, [], 0

    def sweep(s, i, mode):
        nonlocal flops, ind_pairs
        flops += sweep_bound(s, images, cam, cfg, mode)[2]["flops"]
        texels.append(_active_pairs(s, images, cam, cfg)[1])
        if i is not None:
            n = int(ba._linearize_indirect(s, i, cam, cfg)[5].sum())
            ind_pairs += n
            fma = n * BA_IND_RESIDUAL_FMA
            if mode == "system":
                valid = int(i.point_valid.sum())
                fma += n * (BA_IND_JACOBIAN_FMA + BA_IND_PAIR_SYSTEM_FMA) + valid * (
                    D * (D + 1) // 2 + D)
            flops += 2 * fma

    sweep(st, ind, "energy")
    lam = torch.full((), cfg.ba_lambda_init, dtype=torch.float32, device=images.device)
    E = ba.total_energy_plain(st, images, cam, cfg, ind)
    for _ in range(cfg.ba_iters):
        step = ba.ba_step_plain(st, images, cam, cfg, lam, ind)
        cand, cand_i = step[0], None if ind is None else step[1]
        sweep(st, ind, "system")
        flops += solve_bound(st)[2]["flops"]
        if ind is not None:
            flops += 2 * int(ind.point_valid.sum()) * D
        sweep(cand, cand_i, "energy")
        E_new = ba.total_energy_plain(cand, images, cam, cfg, cand_i)
        accept = bool(E_new < E)
        if accept:
            st, ind, E = cand, cand_i, E_new
        lam = torch.clamp(lam * 0.4, min=1e-7) if accept else torch.clamp(lam * 5.0, max=1e2)
    n_tex = int(torch.unique(torch.cat(texels)).numel())
    Q = 0 if ind is None else ind.num_points
    nbytes = (12 * n_tex + P * (8 + 4 + 4 + 4 + 32 + 32 + 1 + F) + F * (2 * 48 + 2 * 8 + 32 + 1)
              + D * D * 4 + D * 4 + 4 + F * (48 + 8 + 32) + P * 4 + 4
              + Q * (8 + 4 + 4 + 1 + F * (8 + 1 + 4)) + Q * 4)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    detail = {"sweeps": 1 + 2 * cfg.ba_iters, "solves": cfg.ba_iters, "bytes": nbytes,
              "flops": flops, "texels": n_tex,
              "texels_summed_over_sweeps": sum(x.numel() for x in texels),
              "factor_points": Q, "factor_pairs_summed_over_sweeps": ind_pairs}
    return (t_ops, "operations", detail) if t_ops >= t_bytes else (t_bytes, "bytes", detail)


def _ba_launches(before: dict) -> dict:
    now = path_launches()
    return {k: now[k] - before[k] for k in BA_KERNELS}


def _bits_equal(a, Ea, b, Eb) -> bool:
    return bool(torch.equal(Ea, Eb) and all(torch.equal(x, y) for x, y in (
        (a.T.R, b.T.R), (a.T.t, b.T.t), (a.ab, b.ab), (a.delta, b.delta), (a.idepth, b.idepth))))


def ba_case(name: str, st, images, cam, cfg, card: str, mesh, rejected: bool = False) -> dict:
    """One phase-14 case: run_ba on the kernels against run_ba_plain on the
    card (E, T, idepth within bk.PARITY_TOL, point_valid equal, the accept
    decisions compared), its launches (1 ba_run), the same run on `mesh`, a
    world of one (split into 2 + 3 x ba_iters sweep and FINISH launches and
    ba_iters solves, the route of a mesh), with the same bits, and
    update_residual_status on both forms at the plain result (res_active
    and point_valid equal). Both forms' distances from a float64 run of the
    window are printed; a case over bk.PARITY_TOL whose decisions all agree
    passes only on that evidence (f64_evidence). `rejected`: every step must
    be rejected and the state keep its bits."""
    before = path_launches()
    trace = torch.empty((cfg.ba_iters, 2), dtype=torch.float32, device=images.device)
    got, E = ba._run_ba_cuda(st, images, cam, cfg, None, trace=trace)
    torch.cuda.synchronize()
    launches = _ba_launches(before)
    before = path_launches()
    trace_m = torch.empty((cfg.ba_iters, 2), dtype=torch.float32, device=images.device)
    on_mesh, E_m = ba._run_ba_cuda(st, images, cam, cfg, mesh, trace=trace_m)
    torch.cuda.synchronize()
    launches_mesh = _ba_launches(before)
    same = _bits_equal(got, E, on_mesh, E_m) and bool(torch.equal(trace, trace_m))
    tr = []
    want, E_want = ba.run_ba_plain(st, images, cam, cfg, trace=tr)
    rep_mesh = ba_parity(on_mesh, E_m, want, E_want)
    dec = _decisions(trace, tr)
    verdict = run_ba_verdict(got, E, want, E_want, dec, run_ba_f64(st, images, cam, cfg),
                             bk.PARITY_TOL)
    s_k = ba.update_residual_status(want, images, cam, cfg)
    s_p = ba.update_residual_status_plain(want, images, cam, cfg)
    status = {"res_active": bool(torch.equal(s_k.res_active, s_p.res_active)),
              "point_valid": bool(torch.equal(s_k.point_valid, s_p.point_valid)),
              "residuals_dropped": int((want.res_active & ~s_p.res_active).sum())}
    row = {"case": name, "frames_valid": int(st.frame_valid.sum()),
           "points_valid": int(st.point_valid.sum()), "E": float(E), "E_plain": float(E_want),
           **{k: v for k, v in verdict.items() if k != "ok"}, "parity_mesh": rep_mesh,
           "decisions": dec, "status": status, "launches": launches, "launches_mesh": launches_mesh,
           "mesh_bits_equal": same, "card": card}
    print(json.dumps(row))
    require(launches == {"ba_sweep": 0, "ba_solve": 0, "ba_run": 1}, f"{name}: launches {launches}")
    require(launches_mesh == {"ba_sweep": 2 + 3 * cfg.ba_iters, "ba_solve": cfg.ba_iters,
                              "ba_run": 0}, f"{name}: a world of one's launches {launches_mesh}")
    require(same, f"{name}: a world of one's split launches differ from the one launch")
    if rejected:
        require(not any(dec["kernel"]) and _bits_equal(got, E, st, E)
                and _bits_equal(want, E_want, st, E_want),
                f"{name}: a step was accepted or a rejected step moved the state: {dec}")
    require(verdict["ok"], f"run_ba kernels != plain on {name}: {verdict} {dec}")
    require(status["res_active"] and status["point_valid"],
            f"update_residual_status kernel != plain on {name}: {status}")
    return row


def mixed_verdict(st, images, cam, cfg, ind, plain: tuple, f64: dict) -> tuple[dict, dict]:
    """run_ba_mixed on the kernels (one launch of the run kernel that
    bk.RUN_SOURCE builds) against `plain` (run_ba_mixed_plain's state,
    factors, E and (E, E_new) trace) and the float64 run `f64`
    (run_ba_f64): run_ba_verdict at bk.MIXED_PARITY_TOL, and the decisions."""
    want, want_ind, E_want, tr = plain
    trace = torch.empty((cfg.ba_iters, 2), dtype=torch.float32, device=images.device)
    got, got_i, E = ba._run_ba_cuda(st, images, cam, cfg, None, ind=ind, trace=trace)
    dec = _decisions(trace, tr)
    verdict = run_ba_verdict(got, E, want, E_want, dec, f64, bk.MIXED_PARITY_TOL,
                             (got_i, want_ind.idepth))
    verdict.update(E=float(E), run=(got, got_i, E, trace))
    return verdict, dec


def mixed_case(name: str, st, images, cam, cfg, ind, card: str, mesh) -> dict:
    """One phase-14 case of the mixed BA: run_ba_mixed on the kernels (one
    launch of the run kernel: the factors swept, their sums joining the
    solve as an additive system and a second Schur pair, their inverse
    depths back-substituted and selected, their energy in the finish)
    against run_ba_mixed_plain on the card within bk.MIXED_PARITY_TOL (E, T,
    idepth, the indirect idepths; point_valid equal), the accept decisions
    and the float64 evidence as in ba_case; its launches (1 ba_run; no
    other kernel enqueued, no copy or wait inside the call), and the same
    run on `mesh`, a world of one (2 + 3 x ba_iters sweep and FINISH
    launches and ba_iters solves, the factors whole in them), with the same
    bits."""
    before = path_launches()
    tr = []
    want, want_ind, E_want = ba.run_ba_mixed_plain(st, images, cam, cfg, ind, trace=tr)
    verdict, dec = mixed_verdict(st, images, cam, cfg, ind, (want, want_ind, E_want, tr),
                                 run_ba_f64(st, images, cam, cfg, ind))
    got, got_i, E, trace = verdict.pop("run")
    torch.cuda.synchronize()
    launches = _ba_launches(before)
    before = path_launches()
    trace_m = torch.empty((cfg.ba_iters, 2), dtype=torch.float32, device=images.device)
    on_mesh, mesh_i, E_m = ba._run_ba_cuda(st, images, cam, cfg, mesh, ind=ind, trace=trace_m)
    torch.cuda.synchronize()
    launches_mesh = _ba_launches(before)
    same = (_bits_equal(got, E, on_mesh, E_m) and bool(torch.equal(trace, trace_m))
            and bool(torch.equal(got_i, mesh_i)))
    inside = _syncs(lambda: ba.run_ba_mixed(st, images, cam, cfg, ind))
    row = {"case": name, "frames_valid": int(st.frame_valid.sum()),
           "points_valid": int(st.point_valid.sum()),
           "indirect_points_valid": int(ind.point_valid.sum()),
           "indirect_obs": int(ind.obs_valid.sum()), "E": float(E), "E_plain": float(E_want),
           **{k: v for k, v in verdict.items() if k not in ("ok", "E")}, "decisions": dec,
           "launches": launches, "inside_the_call": inside, "launches_mesh": launches_mesh,
           "mesh_bits_equal": same, "card": card}
    print(json.dumps(row))
    require(launches == {"ba_sweep": 0, "ba_solve": 0, "ba_run": 1}, f"{name}: launches {launches}")
    require(inside == {"syncs": 0, "memcpys": 0, "enqueues": 1},
            f"{name}: run_ba_mixed enqueued or waited for more than its one launch: {inside}")
    require(launches_mesh == {"ba_sweep": 2 + 3 * cfg.ba_iters, "ba_solve": cfg.ba_iters,
                              "ba_run": 0}, f"{name}: a world of one's launches {launches_mesh}")
    require(same, f"{name}: a world of one's split launches differ from the one launch")
    require(verdict["ok"], f"run_ba_mixed kernels != plain on {name}: {verdict} {dec}")
    return row


def write_ba_faults(out_dir: Path) -> dict:
    """Each planted fault's run kernel: a copy of csrc/ with the fault's
    substitutions in ba_common.cuh, in out_dir/NAME/. Returns {name: the
    copy's ba_run.cu}."""
    csrc = bk.RUN_SOURCE.parent
    header = (csrc / "ba_common.cuh").read_text()
    paths = {}
    for name, subs in BA_MIXED_FAULTS.items():
        text = header
        for old, new in subs:
            require(text.count(old) == 1, f"fault {name}: its source line is not in the kernel")
            text = text.replace(old, new)
        d = out_dir / name
        d.mkdir(parents=True, exist_ok=True)
        for src in csrc.glob("*.cu*"):
            (d / src.name).write_text(text if src.name == "ba_common.cuh" else src.read_text())
        paths[name] = d / bk.RUN_SOURCE.name
    return paths


@contextlib.contextmanager
def ba_run_source(path: Path):
    """bk.ba_run_cuda launching the run kernel built from `path` inside the
    block."""
    orig = bk.RUN_SOURCE
    bk.RUN_SOURCE = path
    try:
        yield
    finally:
        bk.RUN_SOURCE = orig


def mixed_faults(st, images, cam, cfg, ind) -> dict:
    """Each planted fault (write_ba_faults) built and run on one
    run_ba_mixed call through mixed_verdict: what it reads."""
    paths = write_ba_faults(kernel_build.BUILD_DIR / "ba_faults")
    kernel_build.build_many(list(paths.values()))
    tr = []
    plain = (*ba.run_ba_mixed_plain(st, images, cam, cfg, ind, trace=tr), tr)
    f64 = run_ba_f64(st, images, cam, cfg, ind)
    out = {}
    for name, path in paths.items():
        with ba_run_source(path):
            verdict, dec = mixed_verdict(st, images, cam, cfg, ind, plain, f64)
        verdict.pop("run")
        out[name] = {"ok": verdict["ok"], "max_err": verdict["parity"]["max_err"],
                     "within": verdict["parity"]["within"], "tol": bk.MIXED_PARITY_TOL,
                     "decisions_kernel": dec["kernel"], "decisions_plain": dec["plain"],
                     "first_differing": dec.get("first_differing"),
                     "f64_evidence": verdict["f64_evidence"]["holds"]}
    return out


def decision_witness(st, images, cam, cfg, ind=None) -> list[dict]:
    """The accept test's value (E_new - E) / E at each step of the plain
    form's run (run_ba_plain, or run_ba_mixed_plain with `ind`), evaluated
    at the same two states by the plain form in float32, by the kernels'
    energy sweep (float64 block partials) and by the plain form in float64:
    how far each float32 form's value sits from float64's says how near its
    threshold a decision may go either way (bk.DECISION_TOL)."""
    images64 = images.double()
    lam = torch.full((), cfg.ba_lambda_init, dtype=torch.float32, device=images.device)

    def energies(s, i):
        return (ba.total_energy_plain(s, images, cam, cfg, i).double(),
                ba.total_energy(s, images, cam, cfg, i).double(),
                ba.total_energy_plain(_state64(s), images64, cam, cfg,
                                      None if i is None else _state64(i)))

    E = energies(st, ind)
    out = []
    for _ in range(cfg.ba_iters):
        step = ba.ba_step_plain(st, images, cam, cfg, lam, ind)
        cand, cand_i = step[0], None if ind is None else step[1]
        E_new = energies(cand, cand_i)
        v = [float((n - e) / e.abs().clamp_min(1e-30)) for e, n in zip(E, E_new)]
        out.append({"plain_f32": v[0] - v[2], "kernel": v[1] - v[2], "value_f64": v[2]})
        accept = bool(E_new[0] < E[0])
        if accept:
            st, ind, E = cand, cand_i, E_new
        lam = torch.clamp(lam * 0.4, min=1e-7) if accept else torch.clamp(lam * 5.0, max=1e2)
    return out


def partials_measure(st, images, cam, cfg, sweep=bk.ba_sweep_cuda) -> dict:
    """The system sweep's sums against float64 from the same state: the
    plain form's linearize/_assemble/_schur_terms in float64 as the
    reference, the kernel `sweep` (float64 block partials) and the plain
    form in float32. For each: the largest error of H - H_corr
    over its largest entry, of b - b_corr over its largest entry, and of the
    curvature along the scale direction s^T (H - H_corr) s (s: each valid
    slot's translation, normalized), relative."""
    lam = torch.tensor(cfg.ba_lambda_init, dtype=torch.float32, device=images.device)
    _, ref = ba._sweep_plain(_state64(st), images.double(), cam, cfg, lam.double())
    A64 = ref["H"] - ref["H_corr"]
    g64 = ref["b"] - ref["b_corr"]
    s = ba._nullspaces(_state64(st))[:, 6].double()
    s = s / s.norm().clamp_min(1e-30)
    c64 = float(s @ A64 @ s)
    forms = {"kernel": sweep(st, images, cam, cfg, "system", lam=lam),
             "plain_f32": ba._sweep_plain(st, images, cam, cfg, lam)[1]}
    out = {"scale_curvature_f64": c64, "H_scale": float(A64.abs().max())}
    for name, sysd in forms.items():   # the kernel's H, b: H - H_corr, b - b_corr
        A = sysd["H"].double() - (sysd["H_corr"].double() if "H_corr" in sysd else 0.0)
        g = sysd["b"].double() - (sysd["b_corr"].double() if "b_corr" in sysd else 0.0)
        out[name] = {"H_sc_rel": float((A - A64).abs().max() / A64.abs().max()),
                     "b_sc_rel": float((g - g64).abs().max() / g64.abs().max().clamp_min(1e-30)),
                     "scale_rel": abs(float(s @ A @ s) - c64) / max(abs(c64), 1e-30)}
    return out


# the marginalization's four device sums (ba._marg_pieces' first four)
MARG_SUMS = ("H_pts", "b_pts", "H_corr", "b_corr")
# A sum's error from float64, relative to the float64 sum's largest entry (at
# least 1), that phase 14 allows a float32 form without comparing: above it,
# the kernel's sum must be no further from float64 than the plain float32
# form's on the same call (marg_case). b_pts is a sum of terms that cancel,
# and each residual's rounding in float32 reaches it: either form sits up
# to ~1e-2 from float64 on a real run (PERF.md), so the kernel is held to the
# plain form's own distance, not to a bound.
MARG_F64_TOL = 1e-3


def f64_rule(kernel: float, plain: float, bound: float) -> bool:
    """Both float32 forms within `bound` of float64, or the kernel's form no
    further from float64 than the plain float32 form's."""
    return (kernel <= bound and plain <= bound) or kernel <= plain


def _rel(x: torch.Tensor, ref: torch.Tensor) -> float:
    return float((x.double() - ref.double()).abs().max()
                 / ref.double().abs().max().clamp_min(1.0))


def marg_check(name: str, forms: dict, ref: tuple, slot: int, cfg) -> dict:
    """The f64 witness of one _marg_pieces call: `forms` maps "kernel" and
    "plain_f32" to their pieces, `ref` the float64 pieces of the same call.
    Each of the four sums' error from float64 relative to the float64 sum's
    largest entry (at least 1), and marg_host_schur's packed result of each
    form against float64's; `ok` when each passes f64_rule and the hosted
    mask is equal in the three forms. The kernel against the plain float32
    form, the measure that decided before, is reported beside them."""
    packed64 = ba.marg_host_schur(ref, slot, cfg)[0].astype(np.float64)
    err, packed = {}, {}
    for form, pieces in forms.items():
        err[form] = {n: _rel(pieces[k], ref[k]) for k, n in enumerate(MARG_SUMS)}
        pk = ba.marg_host_schur(pieces, slot, cfg)[0].astype(np.float64)
        packed[form] = float(np.abs(pk - packed64).max() / max(np.abs(packed64).max(), 1.0))
    hosted = all(bool(torch.equal(p[4], ref[4])) for p in forms.values())
    passes = {n: f64_rule(err["kernel"][n], err["plain_f32"][n], MARG_F64_TOL)
              for n in MARG_SUMS}
    passes["packed"] = f64_rule(packed["kernel"], packed["plain_f32"], MARG_F64_TOL)
    return {"case": f"{name}, slot {slot}", "ok": hosted and all(passes.values()),
            "from_f64": err, "packed_from_f64": packed, "hosted_equal": hosted,
            "passes": passes, "kernel_vs_plain": {
                n: _rel(forms["kernel"][k], forms["plain_f32"][k])
                for k, n in enumerate(MARG_SUMS)}}


def marg_case(name: str, args) -> dict:
    """One captured _marg_pieces call: the sweep's marg mode (the kernel's
    form) and _marg_pieces_plain in float32, each against
    _marg_pieces_plain in float64 on the same state and images (_state64),
    under marg_check."""
    st, images, cam, cfg, slot = args
    forms = {"kernel": ba._marg_pieces(st, images, cam, cfg, slot),
             "plain_f32": ba._marg_pieces_plain(st, images, cam, cfg, slot)}
    ref = ba._marg_pieces_plain(_state64(st), images.double(), cam, cfg, slot)
    row = marg_check(name, forms, ref, int(slot), cfg)
    print(json.dumps(row))
    require(row["ok"], f"_marg_pieces: the kernel's sums further from float64 than the "
            f"plain form's: {row}")
    return row


def ba_phase(cap: BACapture, mixed_cap: BACapture, card: str) -> tuple[list[dict], dict]:
    """Phase 14: the BA kernels against their plain forms on the card, on
    every run_ba of phase 3 (the initial BA included), every _marg_pieces call,
    an all-invalid window, ba_iters 0 and every run_ba_mixed of phase 5; the
    decisions compared, and their float64 witness; the host waits inside
    run_ba (none); times, bounds and the library's solve; the kernel's and
    the plain form's sums against float64."""
    runs, mixed = cap.calls["run_ba"], mixed_cap.calls["run_ba_mixed"]
    require(len(runs) >= 2, f"phase 3's run_ba calls not captured ({len(runs)})")
    require(cap.calls["_marg_pieces"], "no _marg_pieces call captured")
    require(mixed, "phase 5's run_ba_mixed calls not captured")
    mesh = make_mesh()   # a world of one: the mesh's split route beside the one launch
    try:
        rows = [ba_case(f"run_ba, phase-3 call {k} ({int(a[0].frame_valid.sum())} frames)",
                        *a, card, mesh) for k, a in enumerate(runs)]
        st, images, cam, cfg = runs[-1]
        rows.append(ba_case("run_ba, every frame slot invalid",
                            st.replace(frame_valid=torch.zeros_like(st.frame_valid)), images,
                            cam, cfg, card, mesh))
        rows.append(ba_case("run_ba, ba_iters 0", st, images, cam,
                            dataclasses.replace(cfg, ba_iters=0), card, mesh))
        # the candidates' inverse depths clamped to 1e-3 (points near
        # infinity) raise the energy: every step rejected, the select's keep
        # branch
        rows.append(ba_case("run_ba, every step rejected", st, images, cam,
                            dataclasses.replace(cfg, idepth_max=1e-3), card, mesh,
                            rejected=True))
        mixed_rows = [mixed_case(f"run_ba_mixed, phase-5 call {k} "
                                 f"({int(a[0].frame_valid.sum())} frames)", *a, card, mesh)
                      for k, a in enumerate(mixed)]
    finally:
        dist.destroy_process_group()
    faults = mixed_faults(*mixed[0])
    for name, f in faults.items():
        print(f"  BA planted fault {name} on run_ba_mixed, phase-5 call 0: {json.dumps(f)}")
        require(not f["ok"], f"the planted fault {name} passed the mixed BA's verdict")
    witness = ([w for a in runs for w in decision_witness(*a)]
               + [w for a in mixed for w in decision_witness(*a)])
    spread = {k: max(abs(w[k]) for w in witness) for k in ("plain_f32", "kernel")}
    print(json.dumps({"phase": "ba_decision_witness", "steps": len(witness),
                      "max_from_f64": spread, "decision_tol": bk.DECISION_TOL,
                      "nearest_f64_value": min(abs(w["value_f64"]) for w in witness)}))
    marg_rows = [marg_case(f"_marg_pieces, phase-3 call {k}", a)
                 for k, a in enumerate(cap.calls["_marg_pieces"])]
    marg = {"calls": len(marg_rows), "worst_from_f64": {
        form: {n: max(r["from_f64"][form][n] for r in marg_rows) for n in MARG_SUMS}
        | {"packed": max(r["packed_from_f64"][form] for r in marg_rows)}
        for form in ("kernel", "plain_f32")},
        "worst_kernel_vs_plain": {n: max(r["kernel_vs_plain"][n] for r in marg_rows)
                                  for n in MARG_SUMS}}
    f64_rows = rows + mixed_rows
    from_f64 = {form: {k: max(r["from_f64"][form][k] for r in f64_rows)
                       for k in ("T", "idepth_abs", "idepth_over_bound", "E_rel")}
                for form in ("kernel", "plain_f32")}
    print(json.dumps({"phase": "ba_f64_witness", "run_ba_cases": len(rows),
                      "run_ba_mixed_cases": len(mixed_rows), "worst_from_f64": from_f64,
                      "cases_on_f64_evidence": [r["case"] for r in f64_rows
                                                if not r["parity"]["ok"]
                                                and "first_differing" not in r["decisions"]],
                      "marg": marg}))
    measure = [partials_measure(*a) for a in runs]
    worst = {name: {k: max(m[name][k] for m in measure) for k in measure[0][name]}
             for name in ("kernel", "plain_f32")}
    print(json.dumps({"phase": "ba_partials", "worst": worst, "cases": measure}))

    # times, bounds and host waits on the last captured window (the fullest)
    lam = torch.tensor(cfg.ba_lambda_init, dtype=torch.float32, device=images.device)
    system = bk.ba_sweep_cuda(st, images, cam, cfg, "system", lam=lam)
    plain_sys = ba._sweep_plain(st, images, cam, cfg, lam)[1]
    D = 8 * st.num_frames
    A = (plain_sys["H"] + st.H_m + torch.eye(D, device=images.device)
         - plain_sys["H_corr"]).contiguous()
    g = (plain_sys["b"] - plain_sys["b_corr"]).contiguous()
    s_bound, s_by, s_detail = sweep_bound(st, images, cam, cfg)
    e_bound, e_by, e_detail = sweep_bound(st, images, cam, cfg, "energy")
    v_bound, v_by, v_detail = solve_bound(st)
    r_bound, r_by, r_detail = run_ba_bound(st, images, cam, cfg)
    mst, mimages, mcam, mcfg, mind = mixed[-1]   # the last phase-5 call
    m_bound, m_by, m_detail = run_ba_bound(mst, mimages, mcam, mcfg, mind)

    def run():
        return ba.run_ba(st, images, cam, cfg)

    def run_mixed():
        return ba.run_ba_mixed(mst, mimages, mcam, mcfg, mind)

    def sweep():
        return bk.ba_sweep_cuda(st, images, cam, cfg, "system", lam=lam)

    def energy():
        return bk.ba_sweep_cuda(st, images, cam, cfg, "energy")

    def solve():
        return bk.ba_solve_cuda(system, st, cfg, lam, st)

    mixed_host, mixed_device = launches_per_call(run_mixed)
    require(mixed_host == 1, f"run_ba_mixed: {mixed_host} profiled launches a call")
    timing = {
        "run_ba": {"kernel_ms": cuda_ms(run), "kernel_warm_ms": cuda_ms(run, cold=False),
                   "plain_ms": cuda_ms(lambda: ba.run_ba_plain(st, images, cam, cfg), reps=5,
                                       warmup=1),
                   "host_waits": _syncs(run), "library_ms": None,
                   "bound_ms": r_bound, "bound_by": r_by, "bound_detail": r_detail},
        "run_ba_mixed": {"kernel_ms": cuda_ms(run_mixed),
                         "kernel_warm_ms": cuda_ms(run_mixed, cold=False),
                         "plain_ms": cuda_ms(lambda: ba.run_ba_mixed_plain(
                             mst, mimages, mcam, mcfg, mind), reps=5, warmup=1),
                         "host_waits": _syncs(run_mixed), "library_ms": None,
                         "bound_ms": m_bound, "bound_by": m_by, "bound_detail": m_detail,
                         "launches_per_call": mixed_host,
                         "device_ops_per_call": mixed_device},
        "ba_sweep": {"kernel_ms": cuda_ms(sweep), "kernel_warm_ms": cuda_ms(sweep, cold=False),
                     "energy_ms": cuda_ms(energy), "energy_warm_ms": cuda_ms(energy, cold=False),
                     "plain_ms": cuda_ms(lambda: ba._sweep_plain(st, images, cam, cfg, lam),
                                         reps=5, warmup=1),
                     "bound_ms": s_bound, "bound_by": s_by, "bound_detail": s_detail,
                     "energy_bound_ms": e_bound, "energy_bound_by": e_by,
                     "energy_bound_detail": e_detail, "library_ms": None},
        "ba_solve": {"kernel_ms": cuda_ms(solve), "kernel_warm_ms": cuda_ms(solve, cold=False),
                     "plain_ms": cuda_ms(lambda: ba._solve_plain(plain_sys, st, cfg, lam, st),
                                         reps=5, warmup=1),
                     "library_ms": cuda_ms(lambda: torch.linalg.solve_ex(A, g)),
                     "bound_ms": v_bound, "bound_by": v_by, "bound_detail": v_detail}}
    for k in ("run_ba", "run_ba_mixed", "ba_sweep", "ba_solve"):
        timing[k]["bound_share"] = timing[k]["bound_ms"] / timing[k]["kernel_ms"]
    timing["ba_sweep"]["energy_bound_share"] = e_bound / timing["ba_sweep"]["energy_ms"]
    def err(reps):   # the largest T and idepth error of run_ba's kernels against plain
        return max(max(r["max_err"]["T"], r["max_err"]["idepth_abs"]) for r in reps)

    # ba_run: its own launches (the one-launch runs, run_ba's and
    # run_ba_mixed's); ba_sweep and ba_solve: the runs that launch them (a
    # world of one's, whose mixed runs have the one launch's bits)
    kernel_err = {"ba_run": err([r["parity"] for r in rows + mixed_rows])}
    kernel_err["ba_sweep"] = kernel_err["ba_solve"] = err(r["parity_mesh"] for r in rows)
    public = {"timing": timing, "marg": marg, "run_ba_from_f64": from_f64,
              "partials_worst": worst, "run_max_groups": bk.run_max_groups(images.device),
              "max_abs_err": kernel_err,
              "partials_recorded_worst_scale_rel": SCALE_REL_RECORDED,
              "launches_per_run_ba": rows[0]["launches"],
              "launches_per_run_ba_mesh": rows[0]["launches_mesh"],
              "launches_per_run_ba_mixed": mixed_rows[0]["launches"],
              "launches_per_run_ba_mixed_mesh": mixed_rows[0]["launches_mesh"],
              "mixed_faults": faults,
              "decisions_differing": sum("first_differing" in r["decisions"]
                                         for r in rows + mixed_rows),
              "decision_witness": spread, "cases": len(rows), "mixed_cases": len(mixed_rows)}
    print(json.dumps({"phase": "ba_public", **public}))
    waits = timing["run_ba"]["host_waits"]
    require(waits["syncs"] == 0 and waits["memcpys"] == 0, f"run_ba waits for the device: {waits}")
    require(worst["kernel"]["scale_rel"] <= SCALE_REL_RECORDED["plain_f32"],
            f"the scale curvature of H - H_corr is off by {worst['kernel']['scale_rel']}")
    waits = timing["run_ba_mixed"]["host_waits"]
    require(waits == {"syncs": 0, "memcpys": 0, "enqueues": 1},
            f"run_ba_mixed waits for the device or enqueues more than its launch: {waits}")
    for k in ("run_ba", "run_ba_mixed", "ba_sweep", "ba_solve"):
        require(timing[k]["bound_share"] <= 1.0, f"{k}: under its bound: the bound is wrong")
    require(timing["ba_sweep"]["energy_bound_share"] <= 1.0, "energy sweep under its bound")
    return rows + mixed_rows, public


# -- phase 15 ----------------------------------------------------------------------

# arithmetic the tracer's function needs, counted from csrc/trace_epipolar.cu
# (a rounded op, a floor and a square root one each; compares, clamps and
# selects not counted): a sample (a pattern pixel of a hypothesis: its
# pixel, 2; unprojection, 6; transform, 15 + 3; projection, 7; the bilinear
# sample of channel 0, 15; the residual's square and sum, 3); a hypothesis
# (its grid value, 2; exp; the depth's reciprocal); a swept point (two
# logs, the grid's width, the argmin's and the windows' 16 compares not
# counted, the refine, 12, the span, 6, the new interval, 6); a traced row
# (its relative pose, 3 x 3 x 5 + 3 x 5 + 3 x 5)
TRACE_SAMPLE_FLOPS, TRACE_HYP_FLOPS, TRACE_POINT_FLOPS, TRACE_ROW_FLOPS = 51, 4, 27, 75
# an arena entry's bytes: uv, colour, rho_lo, rho_hi, n_ok, n_fail, valid
ARENA_ENTRY_BYTES = 2 * 4 + 8 * 4 + 4 + 4 + 4 + 4 + 1


class TraceCapture:
    """Keeps (cloned) the inputs of every trace_immatures_rows call that a
    run makes (runtime/odometry.py's _frame_step looks it up at call time,
    for the direct path and the hybrid's direct spine), by phase."""

    def __init__(self):
        self.calls: dict[str, list] = {}
        self.phase: str | None = None
        self._orig = odometry.trace_immatures_rows

    def _call(self, *args):
        if self.phase is not None:
            self.calls.setdefault(self.phase, []).append(_clone_trace_args(args))
        return self._orig(*args)

    def __enter__(self):
        odometry.trace_immatures_rows = self._call
        return self

    def __exit__(self, *exc):
        odometry.trace_immatures_rows = self._orig


def _clone_trace_args(args):
    arena, rows, T_hosts, host_valid, obs_grad, T_obs, cam, cfg = args
    return (arena.map(torch.Tensor.clone), rows.clone(),
            SE3(R=T_hosts.R.clone(), t=T_hosts.t.clone()), host_valid.clone(), obs_grad.clone(),
            SE3(R=T_obs.R.clone(), t=T_obs.t.clone()), cam, cfg)


def _trace_probes(args) -> torch.Tensor:
    arena, rows = args[0], args[1]
    return torch.full((rows.shape[0], arena.valid.shape[1], len(te.PROBE_FIELDS)),
                      float("nan"), device=rows.device)


def trace_parity(args) -> tuple[dict, object, object]:
    """The kernel (through the dispatcher, probes on) against
    trace_immatures_rows_plain on the card: te.parity, its one launch."""
    pk, pp = _trace_probes(args), _trace_probes(args)
    before = te.trace_rows_cuda.launches
    got = tracer.trace_immatures_rows(*args, probes=pk)
    torch.cuda.synchronize()
    calls = te.trace_rows_cuda.launches - before
    want = tracer.trace_immatures_rows_plain(*args, probes=pp)
    rep = te.parity(got, want, (pk, pp), args[1], args[7])
    rep["launches"] = calls
    return rep, got, want


def _swept_points(args) -> int:
    """Points the tracer sweeps: the valid points of traced live slots."""
    arena, rows, _, host_valid = args[:4]
    return sum(int((arena.valid[f] & host_valid[f]).sum()) for f in set(rows.tolist()) if f >= 0)


def trace_bound(args) -> tuple[float, str, dict]:
    """Least time of one tracer call, in ms: the larger of its bytes over the
    HBM rate and its arithmetic over the f32 rate. Bytes: the arena read
    once and the new arena written once (every entry, the copied rows too),
    the rows, the host slots' poses and flags, the observer's pose, and each
    texel of channel 0 that a swept point's samples read, counted once.
    Arithmetic: the swept points' samples, hypotheses and refines (a point
    of a traced row whose slot is live and which is valid), and the traced
    rows' relative poses."""
    arena, rows, T_hosts, host_valid, obs_grad, T_obs, cam, cfg = args
    F, K = arena.valid.shape
    S = cfg.trace_steps
    traced = sorted({f for f in rows.tolist() if f >= 0})
    swept = [(f, arena.valid[f] & host_valid[f]) for f in traced]
    ids = []
    for f, m in swept:
        if not bool(m.any()):
            continue
        T_oh = T_obs.compose(SE3(R=T_hosts.R[f], t=T_hosts.t[f]).inverse())
        lo = torch.log(torch.clamp(arena.rho_lo[f][m], min=1e-6))
        hi = torch.log(torch.clamp(arena.rho_hi[f][m], min=2e-6))
        frac = torch.linspace(0.0, 1.0, S, device=lo.device)
        rho = torch.exp(lo[:, None] + (hi - lo)[:, None] * frac)             # (P, S)
        Xh = cam.unproject(residuals.pattern_uv(arena.uv[f][m])[:, None], rho[..., None])
        uv, _ = cam.project(T_oh.apply(Xh))                                   # (P, S, 8, 2)
        W, H = cam.width, cam.height
        x0 = torch.nan_to_num(torch.clamp(torch.floor(uv[..., 0]), 0, W - 2), nan=0.0).long()
        y0 = torch.nan_to_num(torch.clamp(torch.floor(uv[..., 1]), 0, H - 2), nan=0.0).long()
        base = (y0 * W + x0).reshape(-1)
        ids += [base, base + 1, base + W, base + W + 1]
    texels = int(torch.unique(torch.cat(ids)).numel()) if ids else 0
    points = int(sum(int(m.sum()) for _, m in swept))
    nbytes = (2 * F * K * ARENA_ENTRY_BYTES + rows.numel() * 4 + F * (12 * 4 + 1) + 12 * 4
              + 4 * texels)
    flops = float(points * (S * (8 * TRACE_SAMPLE_FLOPS + TRACE_HYP_FLOPS) + TRACE_POINT_FLOPS)
                  + len(traced) * TRACE_ROW_FLOPS)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    detail = {"bytes": nbytes, "flops": flops, "texels": texels, "swept_points": points,
              "traced_rows": len(traced)}
    return (t_ops, "operations", detail) if t_ops >= t_bytes else (t_bytes, "bytes", detail)


def trace_phase(cap: TraceCapture, card: str) -> tuple[dict, dict]:
    """Phase 15: the tracer's kernel against its plain form on the card
    (te.parity) on every trace_immatures_rows call of phases 3 and 5, then
    all-padding rows, a dead host slot and a NaN observer pose on the
    phase-3 call that sweeps the most points; one launch a call (counted
    and profiled), no host wait inside; cold and warm ms, the plain form's,
    the bound and its share on that call (the main path's shapes)."""
    calls = {ph: cap.calls.get(ph, []) for ph in ("direct", "hybrid")}
    require(all(calls.values()), f"tracer calls not captured: "
            f"{ {k: len(v) for k, v in calls.items()} }")
    reports = []
    for ph, captured in calls.items():
        for k, args in enumerate(captured):
            rep, _, _ = trace_parity(args)
            rep["case"] = f"phase-{3 if ph == 'direct' else 5} call {k}"
            reports.append(rep)
    args = max(calls["direct"], key=_swept_points)      # the call with the most work
    arena, rows, T_hosts, host_valid, obs_grad, T_obs, cam, cfg = args
    dead = host_valid.clone()
    dead[rows[rows >= 0][0]] = False
    t_nan = T_obs.t.clone()
    t_nan[0] = float("nan")
    edge_cases = {"all rows padding": (arena, torch.full_like(rows, -1), *args[2:]),
                  "a dead host slot": (*args[:3], dead, *args[4:]),
                  "a NaN observer pose": (*args[:5], SE3(R=T_obs.R, t=t_nan), cam, cfg)}
    for name, case in edge_cases.items():
        rep, got, want = trace_parity(case)
        rep["case"] = name
        reports.append(rep)
        if name == "a NaN observer pose":
            rep["intervals_kept"] = bool(torch.equal(got.rho_lo, arena.rho_lo)
                                         and torch.equal(got.rho_hi, arena.rho_hi))
            require(rep["intervals_kept"], "a NaN observer pose moved an interval")
    for rep in reports:
        for d in rep["edge_points"]:
            print(f"  tracer {rep['case']}: row {d['row']} point {d['point']} differs at a "
                  f"decision's edge: {d}")
        require(rep["ok"] and rep["launches"] == 1, f"trace_epipolar != plain: {rep}")

    def kernel():
        return tracer.trace_immatures_rows(*args)

    def plain():
        return tracer.trace_immatures_rows_plain(*args)

    host, device_ops = launches_per_call(kernel)
    waits = _syncs(kernel)
    bound, by, detail = trace_bound(args)
    ms, warm = cuda_ms(kernel), cuda_ms(kernel, cold=False)
    floor = launch_floor()
    timing = {"kernel_ms": ms, "kernel_warm_ms": warm, **floor,
              "above_floor_share": (ms - floor["floor_ms"]) / ms,
              "above_floor_warm_share": (warm - floor["floor_warm_ms"]) / warm,
              "plain_ms": cuda_ms(plain), "launches_per_call": host,
              "device_ops_per_call": device_ops, "host_waits": waits, "bound_ms": bound,
              "bound_by": by, "bound_detail": detail, "bound_share": bound / ms,
              "library_ms": None, "card": card}
    parity_rows = [r for r in reports if r["case"].startswith("phase")]
    public = {"calls": {ph: len(v) for ph, v in calls.items()},
              "points_traced": sum(r["traced_points"] for r in parity_rows),
              "points_swept": sum(r["swept_points"] for r in parity_rows),
              "edge_points": sum(r["differing"] for r in reports),
              "max_rho_steps_agreeing": max(r["max_rho_steps_agreeing"] for r in reports),
              "max_abs_err": max(r["max_abs_err"] for r in reports),
              "edge_cases": {r["case"]: {k: r[k] for k in ("ok", "differing", "swept_points")}
                             for r in reports if not r["case"].startswith("phase")},
              "decision_tol": te.DECISION_TOL, "rho_tol": te.RHO_TOL, "timing": timing}
    print(json.dumps({"phase": "trace_public", **public}))
    require(host == 1, f"trace_immatures_rows made {host} launches a call")
    require(waits["syncs"] == 0 and waits["memcpys"] == 0,
            f"trace_immatures_rows waits for the device: {waits}")
    require(timing["bound_share"] <= 1.0, "trace_epipolar: under its bound: the bound is wrong")
    return public, timing



# -- phase 16 -----------------------------------------------------------------

# the runs whose run_local_ba calls phase 16 holds (phases 5, 7, 10, 12)
LOCAL_BA_RUNS = ("hybrid", "cli_modslam", "hybrid_pipelined", "hybrid_staged", "sharded_hybrid")
# f32 operations of the plain form's LM step for one observation: the
# residual (31: R X + t, the projection, r, chi2), the Huber weight (4), the
# Jacobians (J_proj 8, J_pose 72, J_pt 36), the weighting (18), the products
# H_cc (144), b_c (24), H_pp (36), b_p (12) and W (72), and the candidate's
# energy (36)
LBA_OBS_STEP_FLOPS = 31 + 4 + 8 + 72 + 36 + 18 + 144 + 24 + 36 + 12 + 72 + 36
# a point a step: damping and the 3x3 inverse (~50), H_pp^-1 u and the update
# (21); a (point, frame) pair: W H_pp^-1 (108), b_red (36), W^T dx (36); a
# (point, frame, frame) triple: its 6x6 block of W H_pp^-1 W^T (216)
LBA_POINT_FLOPS, LBA_PAIR_FLOPS, LBA_TRIPLE_FLOPS = 71, 180, 216
LBA_OBS_ENERGY_FLOPS = 36   # a stage's first energy, and each prune, an observation


class LocalBACapture:
    """Keeps (cloned) the problem of every run_local_ba call that an armed
    run makes (runtime/hybrid.py looks iba.run_local_ba up at call time), by
    run, and counts every call of run_local_ba_plain and ba_step while it is
    entered: on the card no path may reach them."""

    def __init__(self):
        self.calls: dict[str, list] = {}
        self.run: str | None = None
        self.plain_calls = Counter()
        self._orig = {n: getattr(iba, n) for n in ("run_local_ba", "run_local_ba_plain",
                                                   "ba_step")}

    def _call(self, prob, cam, *args, **kw):
        if self.run is not None:
            self.calls.setdefault(self.run, []).append((clone_problem(prob), cam, args, kw))
        return self._orig["run_local_ba"](prob, cam, *args, **kw)

    def _counted(self, name):
        fn = self._orig[name]

        def call(*args, **kw):
            self.plain_calls[name] += 1
            return fn(*args, **kw)
        return call

    def __enter__(self):
        iba.run_local_ba = self._call
        iba.run_local_ba_plain = self._counted("run_local_ba_plain")
        iba.ba_step = self._counted("ba_step")
        return self

    def __exit__(self, *exc):
        for name, fn in self._orig.items():
            setattr(iba, name, fn)


def clone_problem(prob):
    return prob.replace(T=SE3(R=prob.T.R.clone(), t=prob.T.t.clone()),
                        **{f.name: getattr(prob, f.name).clone()
                           for f in dataclasses.fields(prob) if f.name != "T"})


def _stage_iters(args, kw) -> tuple[int, int]:
    it = dict(zip(("stage1_iters", "stage2_iters"), args))
    it.update(kw)
    return it.get("stage1_iters", 5), it.get("stage2_iters", 10)


LBA_FIELDS = ("frame_valid", "frame_fixed", "Xw", "point_valid", "obs_frame", "obs_point",
              "obs_uv", "obs_valid", "obs_sigma2")


def save_local_ba_calls(path: Path, calls: list, extra: dict | None = None) -> None:
    """Writes run_local_ba calls, [(run, problem, camera, (stage1, stage2))],
    to an .npz that load_local_ba_calls reads (with `extra`'s arrays)."""
    out = {"n": np.array(len(calls))}
    for k, (run, prob, cam, iters) in enumerate(calls):
        out.update({f"c{k}_run": np.array(run), f"c{k}_R": prob.T.R, f"c{k}_t": prob.T.t,
                    f"c{k}_iters": np.array(iters),
                    f"c{k}_cam": np.array([cam.fx, cam.fy, cam.cx, cam.cy, cam.width,
                                           cam.height], np.float64),
                    **{f"c{k}_{f}": getattr(prob, f) for f in LBA_FIELDS}})
    out.update(extra or {})
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, **{k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                                 else v for k, v in out.items()})


def load_local_ba_calls(path: Path, dev) -> list:
    """save_local_ba_calls' calls, their problems on `dev`."""
    from libcml_tpu_torch.core.camera import PinholeCamera
    d = np.load(path)
    calls = []
    for k in range(int(d["n"])):
        def g(f):
            return d[f"c{k}_{f}"]
        fx, fy, cx, cy, w, h = g("cam").tolist()
        prob = iba.IndirectBAProblem(
            T=SE3(R=torch.tensor(g("R"), device=dev), t=torch.tensor(g("t"), device=dev)),
            **{f: torch.tensor(g(f), device=dev) for f in LBA_FIELDS})
        calls.append((str(g("run")), prob, PinholeCamera.make(fx, fy, cx, cy, int(w), int(h)),
                      tuple(int(v) for v in g("iters"))))
    return calls


def local_ba_work(prob) -> int:
    """The size by which phase 16 picks its heaviest call: observations x
    frame slots."""
    return prob.obs_frame.shape[0] * prob.T.t.shape[0]


def local_ba_bound(prob, iters: tuple[int, int]) -> tuple[float, str, dict]:
    """Least time of one run_local_ba, in ms: the larger of its bytes over the
    HBM rate and its f32 operations over the f32 rate. Bytes: the problem
    read once (poses and flags, points and flags, the observations' frames,
    points, pixels, validity and variances) and the result written once
    (poses, points, validity). Operations: the plain form's, for this
    problem's observations, points, (point, frame) pairs and (point, frame,
    frame) triples, over the steps run, with the (6M)^2 LU a step and each
    stage's first energy and prune."""
    M, N, K = prob.T.t.shape[0], prob.Xw.shape[0], prob.obs_frame.shape[0]
    f = prob.obs_frame.long().cpu().numpy()
    p = prob.obs_point.long().cpu().numpy()
    pairs = np.unique(p * M + f)
    per_point = np.bincount(pairs // M, minlength=N)
    steps = sum(iters)
    D = 6 * M
    step = (K * LBA_OBS_STEP_FLOPS + N * LBA_POINT_FLOPS + pairs.size * LBA_PAIR_FLOPS
            + int((per_point ** 2).sum()) * LBA_TRIPLE_FLOPS + 2 * D ** 3 // 3 + 2 * D * D
            + M * 100)
    flops = float(steps * step + 2 * 2 * K * LBA_OBS_ENERGY_FLOPS)
    nbytes = (M * (48 + 2) + N * (12 + 1) + K * (4 + 4 + 8 + 1 + 4)) + (M * 48 + N * 12 + K)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    detail = {"bytes": nbytes, "flops": flops, "M": M, "N": N, "K": K,
              "point_frame_pairs": int(pairs.size), "steps": steps}
    return (t_ops, "operations", detail) if t_ops >= t_bytes else (t_bytes, "bytes", detail)


def local_ba_check(prob, cam, iters: tuple[int, int]) -> dict:
    """The kernel through run_local_ba's dispatch (its launches counted),
    then lba.compare (a traced launch, uncounted, against run_local_ba_plain
    and a float64 run of it), and the two launches' results bit for bit."""
    before = lba.local_ba_cuda.launches
    got = iba.run_local_ba(prob, cam, *iters)
    torch.cuda.synchronize()
    launches = lba.local_ba_cuda.launches - before
    rep = lba.compare(prob, cam, iters)
    again = rep.pop("got")
    rep.pop("want"), rep.pop("trace"), rep.pop("mid")
    same = all(torch.equal(x.view(torch.int32) if x.dtype == torch.float32 else x,
                           y.view(torch.int32) if y.dtype == torch.float32 else y)
               for x, y in ((got.T.R, again.T.R), (got.T.t, again.T.t), (got.Xw, again.Xw),
                            (got.obs_valid, again.obs_valid)))
    rep.update(launches=launches, repeat_bits=same, M=prob.T.t.shape[0], N=prob.Xw.shape[0],
               K=prob.obs_frame.shape[0])
    return rep


def local_ba_phase(cap: LocalBACapture, card: str) -> tuple[dict, dict]:
    """Phase 16: the local BA's kernel against its plain form on the card
    (lba.parity, with a float64 run of the plain form) on every run_local_ba
    call of phases 5, 7, 10 and 12; one launch a call (counted and
    profiled), no sync and no memcpy inside, two runs bit for bit; the
    steps whose accept decision differs and the observations pruned at the
    chi2 edge, printed; on the heaviest call cold and warm ms beside the
    launch floor, the plain form's, the bound and its share."""
    require(sum(cap.plain_calls.values()) == 0,
            f"a path on the card reached the plain local BA: {dict(cap.plain_calls)}")
    calls = [(run, k, c) for run in LOCAL_BA_RUNS for k, c in enumerate(cap.calls.get(run, []))]
    require(cap.calls.get("hybrid"), f"no run_local_ba call captured in phase 5: "
            f"{ {k: len(v) for k, v in cap.calls.items()} }")
    reports = []
    for run, k, (prob, cam, args, kw) in calls:
        iters = _stage_iters(args, kw)
        rep = local_ba_check(prob, cam, iters)
        rep["case"] = f"{run} call {k}"
        rep["host_waits"] = _syncs(lambda: iba.run_local_ba(prob, cam, *iters))
        reports.append(rep)
        print(f"  local BA {rep['case']} (M {rep['M']}, N {rep['N']}, K {rep['K']}): "
              f"{rep['launches']} launch, {rep['host_waits']['syncs']} syncs, "
              f"{rep['host_waits']['memcpys']} memcpys; ok {rep['ok']}, beyond the bounds "
              f"{rep['over']}, from float64 kernel / plain: " + ", ".join(
                  f"{m} {rep['kernel_vs_f64'][m]:.3g} / {rep['plain_vs_f64'][m]:.3g}"
                  for m in lba.MEASURES))
        for key, why in (("edge_obs", "at the chi2 edge"), ("f64_obs", "as the float64 run"),
                         ("unexplained_obs", "UNEXPLAINED")):
            for d in rep[key]:
                print(f"  local BA {rep['case']}: observation pruned otherwise than the plain "
                      f"form ({why}): {d}")
        for d in rep["decisions"]:
            print(f"  local BA {rep['case']}: step {d['step']} accepted otherwise: {d}")
        require(rep["ok"] and rep["launches"] == 1 and rep["repeat_bits"]
                and rep["host_waits"]["syncs"] == 0 and rep["host_waits"]["memcpys"] == 0,
                f"local_ba != plain on {rep['case']}: "
                f"{ {k: v for k, v in rep.items() if k != 'decisions'} }")
    prob, cam, args, kw = max((c for _, _, c in calls), key=lambda c: local_ba_work(c[0]))
    iters = _stage_iters(args, kw)

    def kernel():
        return iba.run_local_ba(prob, cam, *iters)

    def plain():
        return iba.run_local_ba_plain(prob, cam, *iters)

    def no_steps():
        return iba.run_local_ba(prob, cam, 0, 0)

    host, device_ops = launches_per_call(kernel)
    waits = _syncs(kernel)
    bound, by, detail = local_ba_bound(prob, iters)
    ms, warm = cuda_ms(kernel), cuda_ms(kernel, cold=False)
    set_up = cuda_ms(no_steps)    # the grouping, the copies and the two prunes
    floor = launch_floor()
    timing = {"kernel_ms": ms, "kernel_warm_ms": warm, **floor,
              "no_steps_ms": set_up, "ms_per_step": (ms - set_up) / max(sum(iters), 1),
              "above_floor_share": (ms - floor["floor_ms"]) / ms,
              "above_floor_warm_share": (warm - floor["floor_warm_ms"]) / warm,
              "plain_ms": cuda_ms(plain, reps=5, warmup=1), "launches_per_call": host,
              "device_ops_per_call": device_ops, "host_waits": waits, "bound_ms": bound,
              "bound_by": by, "bound_detail": detail, "bound_share": bound / ms,
              "library_ms": None, "card": card}
    public = {"calls": {run: len(cap.calls.get(run, [])) for run in LOCAL_BA_RUNS},
              "shapes": sorted({(r["M"], r["N"], r["K"]) for r in reports}),
              "edge_obs": sum(len(r["edge_obs"]) for r in reports),
              "obs_as_f64": sum(len(r["f64_obs"]) for r in reports),
              "decisions_differing": sum(len(r["decisions"]) for r in reports),
              "beyond_bounds_within_f64_tol": sum(not r["within"] for r in reports),
              "max_abs_err": max(max(r["vs_plain"]["T"], r["vs_plain"]["X_abs"])
                                 for r in reports),
              "max_vs_plain": {m: max(r["vs_plain"][m] for r in reports)
                               for m in ("T", "X_scaled", "px")},
              "max_kernel_vs_f64": {m: max(r["kernel_vs_f64"][m] for r in reports)
                                    for m in ("T", "X_scaled", "px")},
              "max_plain_vs_f64": {m: max(r["plain_vs_f64"][m] for r in reports)
                                   for m in ("T", "X_scaled", "px")},
              "steps_accepted": {f: sum(r["steps_accepted"][f] for r in reports)
                                 for f in ("kernel", "plain")},
              "parity_tol": lba.PARITY_TOL, "f64_tol": lba.F64_TOL,
              "chi2_edge_rel": lba.CHI2_EDGE_REL,
              "max_points": lba.max_points(prob.Xw.device), "timing": timing}
    print(json.dumps({"phase": "local_ba_public", **public}))
    require(host == 1, f"run_local_ba made {host} launches a call")
    require(waits["syncs"] == 0 and waits["memcpys"] == 0,
            f"run_local_ba waits for the device: {waits}")
    require(timing["bound_share"] <= 1.0, "local_ba: under its bound: the bound is wrong")
    return public, timing


# -- phase 17 -----------------------------------------------------------------

# the runs whose extract_orb calls phase 17 holds (phases 4, 5, 6 and 7)
ORB_RUNS = ("hybrid_tracking", "hybrid", "relocalization", "cli_modslam")
ORB_FIELDS = ("uv", "level", "angle", "score", "desc", "valid")
# the plain form's f32 operations, for the bound: a pixel's FAST score
# (c + t, c - t; a lane's two compares, its two terms, a difference less t
# each, and two sums; the larger sum) and its NMS (8 maxima, 2 compares); a slot's
# moment terms (a product and a sum for each of m10 and m01) over the
# radius-15 disk's 709 offsets; a BRIEF point (the rotation's 4 products and
# 2 sums, the pixel's 2 sums, the bilinear sample's 2 floors, 4 clamps, 2
# differences, 2 complements, 6 products and 3 sums) and a pair's compare
ORB_PIXEL_OPS = 2 + 16 * 8 + 1 + 10
ORB_IC_TERMS, ORB_IC_TERM_OPS = 709, 4
ORB_POINT_OPS = 4 + 2 + 2 + 2 + 4 + 2 + 2 + 6 + 3
# a slot's outputs: uv, level, angle, score, 8 words, valid
ORB_SLOT_BYTES = 2 * 4 + 4 + 4 + 4 + 8 * 4 + 1
# planted faults (a source substitution each) that phase 17 builds beside the
# kernel and runs on one call: parity must refuse each (the third changes
# only the order of the moments' last five additions; the last breaks the
# selection's ties among equal nonzero keys the other way, so it runs on the
# call's pyramid rounded to whole grey levels, where every score is an
# integer and many tie, at a budget whose cut splits such a group)
ORB_FAULTS = {
    "cell_ties_to_the_highest_index": (
        "__reduce_min_sync(FULL, mine == best ? (unsigned)(lane + 32 * mk) : ~0u)",
        "__reduce_max_sync(FULL, mine == best ? (unsigned)(lane + 32 * mk) : 0u)"),
    "pattern_rotated_by_1.0001x_the_angle": (
        "const float ca = cosf(ang), sa = sinf(ang)",
        "const float ca = cosf(ang * 1.0001f), sa = sinf(ang * 1.0001f)"),
    "moments_butterfly_reversed": ("for (int o = 16; o; o >>= 1) {\n    m10 =",
                                   "for (int o = 1; o < 32; o <<= 1) {\n    m10 ="),
    "level_ties_to_the_highest_index": ("((o.x == me.x) & (o.y < me.y))",
                                        "((o.x == me.x) & (o.y > me.y))"),
}
# the faults run on the rounded pyramid (the others on the call's own)
ORB_ROUNDED_FAULTS = ("level_ties_to_the_highest_index",)


class OrbCapture:
    """Watches every extract_orb call that the runs make through
    runtime/hybrid.py (which looks `extract_orb` up at call time): the
    orb_extract_cuda calls each made (one each), every extract_orb_plain call
    on card tensors (none may happen), and, for an armed run, the pyramid,
    budget, threshold and features (cloned), by run."""

    def __init__(self):
        self.calls: dict[str, list] = {}
        self.run: str | None = None
        self.kernel_calls = Counter()
        self.plain_on_card = 0
        self._orig = hybrid.extract_orb
        self._plain = orb.extract_orb_plain

    def _call(self, pyramid, budget_per_level=512, threshold=12.0, cell=16, per_cell=4):
        before = oe.orb_extract_cuda.launches
        out = self._orig(pyramid, budget_per_level, threshold, cell, per_cell)
        self.kernel_calls[oe.orb_extract_cuda.launches - before] += 1
        if self.run is not None:
            self.calls.setdefault(self.run, []).append(
                (tuple(x.clone() for x in pyramid), budget_per_level, threshold,
                 {f: getattr(out, f).clone() for f in ORB_FIELDS}))
        return out

    def _plain_call(self, pyramid, *args, **kw):
        self.plain_on_card += int(pyramid[0].is_cuda)
        return self._plain(pyramid, *args, **kw)

    def __enter__(self):
        hybrid.extract_orb = self._call
        orb.extract_orb_plain = self._plain_call
        return self

    def __exit__(self, *exc):
        hybrid.extract_orb = self._orig
        orb.extract_orb_plain = self._plain


def orb_bound(pyr, budget: int) -> tuple[float, str, dict]:
    """Least time of one extract_orb, in ms: the larger of its bytes over the
    HBM rate (every level read once, every slot's outputs written once) and
    the plain form's f32 operations over the f32 rate (every pixel's FAST
    score and NMS, every slot's moments and BRIEF samples)."""
    pixels = oe.n_pixels(pyr)
    slots = len(pyr) * budget
    nbytes = 4 * pixels + slots * ORB_SLOT_BYTES
    ops = float(pixels * ORB_PIXEL_OPS
                + slots * (ORB_IC_TERMS * ORB_IC_TERM_OPS + 256 * (2 * ORB_POINT_OPS + 1)))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_FLOP_PER_S * 1e3
    detail = {"bytes": nbytes, "flops": ops, "pixels": pixels, "slots": slots}
    return (t_ops, "operations", detail) if t_ops >= t_bytes else (t_bytes, "bytes", detail)


def orb_check(pyr, budget: int, threshold: float, saved: dict) -> dict:
    """The kernels with a probe against extract_orb_plain on the card
    (oe.parity), and their features against the run's own call bit for bit."""
    probe = oe.new_probe(pyr)
    got = oe.orb_extract_cuda(pyr, budget, threshold, probe=probe)
    want = orb.extract_orb_plain(pyr, budget, threshold)
    rep = oe.parity(got, pyr, budget, threshold, probe, want)
    rep["repeat_bits"] = all(torch.equal(getattr(got, f), saved[f]) for f in ORB_FIELDS)
    return rep


def write_orb_faults(out_dir: Path) -> dict:
    """Each planted fault's source: a copy of csrc/orb_extract.cu with one
    substitution, in out_dir/NAME/ beside copies of the headers it
    includes. Returns {name: path}."""
    text = oe.SOURCE.read_text()
    paths = {}
    for name, (old, new) in ORB_FAULTS.items():
        require(text.count(old) == 1, f"fault {name}: its source line is not in the kernel")
        path = out_dir / name / oe.SOURCE.name
        path.parent.mkdir(parents=True, exist_ok=True)
        for header in oe.SOURCE.parent.glob("*.cuh"):
            shutil.copy(header, path.parent / header.name)
        path.write_text(text.replace(old, new))
        paths[name] = path
    return paths


def orb_faults(pyr, budget: int, threshold: float, tie_budget: int) -> dict:
    """Each planted fault (write_orb_faults) built and run on one call
    through oe.parity (ORB_ROUNDED_FAULTS on its pyramid rounded to whole
    grey levels, at `tie_budget`): what it reads."""
    paths = write_orb_faults(kernel_build.BUILD_DIR / "orb_faults")
    kernel_build.build_many(list(paths.values()))
    out, rounded = {}, tuple(torch.round(x) for x in pyr)
    for name, path in paths.items():
        p, b = (rounded, tie_budget) if name in ORB_ROUNDED_FAULTS else (pyr, budget)
        with _module_source(oe, path):
            probe = oe.new_probe(p)
            got = oe.orb_extract_cuda(p, b, threshold, probe=probe)
        rep = oe.parity(got, p, b, threshold, probe)
        out[name] = {k: rep[k] for k in ("ok", "selection_equal", "max_abs_err",
                                          "angles_off_model", "max_angle_vs_model",
                                          "bits_differing", "bits_beyond_edge",
                                          "max_gap_differing_bit")}
    return out


def orb_stage_ms(pyr, budget: int, threshold: float) -> dict:
    """Cold and warm ms of each of the call's three passes alone (the entry
    point's stage mask), each on what a whole call left in the scratch."""
    lib = kernel_build.load(oe.SOURCE, "orb_extract_launch", oe.ARGTYPES)
    outs, args, scratch = oe.launch_args(pyr, budget, threshold, None)

    def launch(mask: int):
        def run():
            err = lib.orb_extract_launch(mask, *args, torch.cuda.current_stream().cuda_stream)
            if err:
                raise kernel_build.KernelLaunchError(f"orb_extract stages {mask}: CUDA error {err}")
        return run

    launch(oe.ALL_STAGES)()
    ms = {}
    for k, name in enumerate(oe.STAGES):
        ms[name] = cuda_ms(launch(1 << k))
        ms[name + "_warm"] = cuda_ms(launch(1 << k), cold=False)
    torch.cuda.synchronize()
    del outs, scratch
    return ms


def _ba_stages():
    """tools/ba_stages.py (Build, instrument, stage_report), loaded once; it
    imports this module as chip_smoke, which is this run's own module."""
    mod = sys.modules.get("ba_stages")
    if mod is None:
        sys.modules.setdefault("chip_smoke", sys.modules[__name__])
        path = Path(__file__).resolve().parent / "tools" / "ba_stages.py"
        spec = importlib.util.spec_from_file_location("ba_stages", path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules["ba_stages"] = mod
        spec.loader.exec_module(mod)
    return mod


@contextlib.contextmanager
def _module_source(mod, path: Path):
    """`mod`'s wrappers (an ops module) launching the library built from
    `path`."""
    before = mod.SOURCE
    mod.SOURCE = path
    try:
        yield
    finally:
        mod.SOURCE = before


def orb_stamps(pyr, budget: int, threshold: float, reps: int = 20) -> dict | None:
    """The kernel's stage stamps on one call (tools/ba_stages.py orb_stamps:
    its `// stage:` marks made %globaltimer stamps in a copy of csrc/)."""
    bs = _ba_stages()
    return bs.orb_stamps(bs.OrbBuild("tree"), pyr, budget, threshold, reps)


def nonzero_tie_budget(pyr, budget: int, threshold: float) -> int | None:
    """The largest budget up to `budget` at which some level's cut splits a
    group of equal nonzero scores (its key, the score of rank budget - 1, is
    nonzero and shared by a candidate below the cut), or None."""
    best = None
    for sc in oe.level_candidate_scores(pyr, threshold):
        s = torch.sort(sc, descending=True).values[:budget + 1]
        split = torch.nonzero((s[:-1] == s[1:]) & (s[:-1] > 0)).flatten()
        if len(split):
            best = max(best or 0, int(split[-1]) + 1)
    return best


def orb_digest(outputs) -> str:
    """One sha256 over the six output tensors of every call, in order."""
    h = hashlib.sha256()
    for out in outputs:
        for f in ORB_FIELDS:
            h.update(out[f].contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def orb_timing(pyr, budget: int, threshold: float, card: str) -> dict:
    """One call's launches (profiled), host waits, cold and warm ms beside the
    launch floor, each launch's alone, the plain form's ms, the bound and its
    share."""
    def kernel():
        return orb.extract_orb(pyr, budget_per_level=budget, threshold=threshold)

    def plain():
        return orb.extract_orb_plain(pyr, budget, threshold)

    host, device_ops = launches_per_call(kernel)
    waits = _syncs(kernel)
    bound, by, detail = orb_bound(pyr, budget)
    ms, warm = cuda_ms(kernel), cuda_ms(kernel, cold=False)
    floor = launch_floor()
    return {"budget": budget, "levels": [list(x.shape) for x in pyr], "kernel_ms": ms,
            "kernel_warm_ms": warm, **floor,
            "above_floor_share": (ms - floor["floor_ms"]) / ms,
            "above_floor_warm_share": (warm - floor["floor_warm_ms"]) / warm,
            "stage_ms": orb_stage_ms(pyr, budget, threshold),
            "plain_ms": cuda_ms(plain, reps=10, warmup=1), "launches_per_call": host,
            "device_ops_per_call": device_ops, "host_waits": waits, "bound_ms": bound,
            "bound_by": by, "bound_detail": detail, "bound_share": bound / ms,
            "library_ms": None, "card": card}


def orb_phase(cap: OrbCapture, card: str) -> tuple[dict, dict]:
    """Phase 17: the ORB kernels against extract_orb_plain on the card
    (oe.parity, with the kernels' FAST maps) on every extract_orb call of
    phases 4, 5, 6 and 7; each run's call bit for bit again; every call of
    phases 4-12 one kernel call and none reaching the plain form; the slots
    at a tie (NMS flips, angles beyond ANGLE_TOL of ic_angle, bits at the
    edge) printed; four planted faults refused and the kernel held on the
    tie fault's rounded pyramid (at the call's budget and at one whose cut
    splits a group of equal nonzero scores); at budgets 512 (phase 5) and
    800 (phase 7) the launches (one host enqueue) and host waits (none) of a
    call, cold and warm ms beside the launch floor, the plain form's, the
    bound and its share, and the stage stamps; the digest of every captured
    call's outputs."""
    require(cap.plain_on_card == 0,
            f"a path on the card reached extract_orb_plain {cap.plain_on_card} times")
    require(set(cap.kernel_calls) == {1},
            f"extract_orb calls by kernel calls made: {dict(cap.kernel_calls)}")
    require(all(cap.calls.get(run) for run in ORB_RUNS),
            f"extract_orb calls not captured: { {r: len(cap.calls.get(r, [])) for r in ORB_RUNS} }")
    reports = []
    for run in ORB_RUNS:
        for k, (pyr, budget, threshold, saved) in enumerate(cap.calls[run]):
            rep = orb_check(pyr, budget, threshold, saved)
            rep["case"] = f"{run} call {k} (budget {budget})"
            reports.append(rep)
            for d in rep["nms_flips"]:
                print(f"  ORB {rep['case']}: NMS decided otherwise at a tie: {d}")
            if rep["differing_slots"] or rep["angles_beyond_tol"] or rep["bits_differing"]:
                print(f"  ORB {rep['case']}: {rep['differing_slots']} slots differ from the plain "
                      f"form's, {rep['angles_beyond_tol']} angles beyond ANGLE_TOL of ic_angle "
                      f"(largest {rep['max_abs_err']:.3g} rad, kappa from "
                      f"{rep['min_kappa_beyond_tol'] or 0:.3g}), {rep['bits_differing']} bits at "
                      f"the edge (largest |v_p - v_q| {rep['max_gap_differing_bit']:.3g})")
            require(rep["ok"] and rep["repeat_bits"],
                    f"orb_extract != plain on {rep['case']}: "
                    f"{ {k: v for k, v in rep.items() if k != 'nms_flips'} }")
    pyr, budget, threshold, _ = cap.calls["hybrid"][1]
    # the pyramid rounded to whole grey levels, where scores are integers and
    # many tie: at the call's budget (whose cut falls among the zero scores)
    # and at the largest budget under it whose cut splits a group of equal
    # nonzero scores, the kernel held to the plain form; the selection's tie
    # fault runs at the latter
    rounded = tuple(torch.round(x) for x in pyr)
    tie_budget = nonzero_tie_budget(rounded, budget, threshold)
    require(tie_budget is not None,
            f"no budget up to {budget} cuts a group of equal nonzero scores of the rounded pyramid")
    rounded_rep = {}
    for b in (budget, tie_budget):
        probe = oe.new_probe(rounded)
        got = oe.orb_extract_cuda(rounded, b, threshold, probe=probe)
        rep = oe.parity(got, rounded, b, threshold, probe,
                        orb.extract_orb_plain(rounded, b, threshold))
        rounded_rep[str(b)] = {"ok": rep["ok"], "selection_equal": rep["selection_equal"],
                               "differing_slots": rep["differing_slots"],
                               "ties_at_budget": oe.ties_at_budget(rounded, b, threshold)}
        print(f"  ORB the rounded pyramid at budget {b}: {rounded_rep[str(b)]}")
        require(rep["ok"], f"orb_extract != plain on the rounded pyramid at budget {b}: "
                           f"{ {k: v for k, v in rep.items() if k != 'nms_flips'} }")
    require(any(t["taken"] and t["left"] and t["key"]
                for t in rounded_rep[str(tie_budget)]["ties_at_budget"]),
            f"budget {tie_budget} cuts no group of equal nonzero scores: {rounded_rep}")
    faults = orb_faults(pyr, budget, threshold, tie_budget)
    for name, f in faults.items():
        print(f"  ORB planted fault {name}: {f}")
        require(not f["ok"], f"the planted fault {name} passed parity")
    digest = orb_digest(c[3] for run in ORB_RUNS for c in cap.calls[run])
    print(json.dumps({"phase": "orb_digest", "calls": sum(len(cap.calls[r]) for r in ORB_RUNS),
                      "digest": digest}))
    timing = {}
    for run in ("hybrid", "cli_modslam"):
        pyr, budget, threshold = cap.calls[run][1][:3]
        t = timing[str(budget)] = orb_timing(pyr, budget, threshold, card)
        t["stamps"] = orb_stamps(pyr, budget, threshold)
        print(json.dumps({"phase": "orb_stamps", "budget": budget, "stamps": t["stamps"]}))
    public = {"calls": {run: len(cap.calls[run]) for run in ORB_RUNS},
              "kernel_calls_per_extract_orb": dict(cap.kernel_calls),
              "slots": sum(len(c[3]["valid"]) for run in ORB_RUNS for c in cap.calls[run]),
              "nms_flips": sum(len(r["nms_flips"]) for r in reports),
              "differing_slots": sum(r["differing_slots"] for r in reports),
              "angles_off_model": sum(r["angles_off_model"] for r in reports),
              "max_angle_vs_model": max(r["max_angle_vs_model"] for r in reports),
              "angles_beyond_tol": sum(r["angles_beyond_tol"] for r in reports),
              "min_kappa_beyond_tol": min((r["min_kappa_beyond_tol"] for r in reports
                                           if r["min_kappa_beyond_tol"] is not None),
                                          default=None),
              "max_angle_per_kappa": max(r["max_angle_per_kappa"] for r in reports),
              "bits_at_edge": sum(r["bits_differing"] for r in reports),
              "max_gap_differing_bit": max(r["max_gap_differing_bit"] for r in reports),
              "bits_differing_vs_plain": sum(r["bits_differing_vs_plain"] for r in reports),
              "max_gap_vs_plain": max(r["max_gap_vs_plain"] for r in reports),
              "max_angle_vs_plain": max(r["max_angle_vs_plain"] for r in reports),
              "max_score_rel": max(r["max_score_rel"] for r in reports),
              "max_abs_err": max(r["max_abs_err"] for r in reports),
              "score_rtol": oe.SCORE_RTOL, "decision_tol": oe.DECISION_TOL,
              "angle_ulp": oe.ANGLE_ULP, "angle_tol": oe.ANGLE_TOL, "desc_edge": oe.DESC_EDGE,
              "faults": faults, "rounded": rounded_rep, "tie_budget": tie_budget,
              "digest": digest, "timing": timing}
    print(json.dumps({"phase": "orb_public", **public}))
    for t in timing.values():
        # host enqueues: the profiler sees no device operation for a
        # cooperative launch, so its count cannot show this one
        require(t["launches_per_call"] == 1,
                f"extract_orb made {t['launches_per_call']} launches a call")
        require(t["host_waits"]["syncs"] == 0 and t["host_waits"]["memcpys"] == 0,
                f"extract_orb waits for the device: {t['host_waits']}")
        require(t["bound_share"] <= 1.0, "orb_extract: under its bound: the bound is wrong")
    return public, timing


# -- phase 18 ----------------------------------------------------------------------

# arithmetic the plain forms do, counted from them (an FMA as 2, a division,
# a square root or a tan as 1, compares not counted): match_projection's
# point (transform 15 + 3, projection 7, radius 3) and pair (2 differences,
# 2 squares, a sum); match_epipolar's line (6) and pair (the dot product 5,
# its square, a division); the triangulation's row: the bins 3, F' 30, two
# SVDs counted as 2 x 100, F'' 54, the pencil cost 17 + its tan at 129 grid
# points, 80 golden-section points and t_best, the golden bookkeeping 6 a
# step, the asymptote, lines and transfers 60, the DLT 120
PROJ_POINT_OPS = 15 + 3 + 7 + 3
# the kernel's projected pixels (float64 rounded once) against float64's on
# the visible points: one float32 rounding of up to ~1e3 px is 6e-5
UV_TOL = 1e-4
PROJ_PAIR_OPS = 5
EPI_LINE_OPS = 6
EPI_PAIR_OPS = 7
TRI_COST_OPS = 18
TRI_ROW_OPS = 3 + 30 + 200 + 54 + TRI_COST_OPS * (129 + 80 + 1) + 6 * 40 + 60 + 120
TRI_ROW_OPS_NO_CORRECTION = 3 + 120
# faults planted in copies of the sources, each a substitution: the grid's
# shuffled argmin taking the last index on ties, the t -> inf asymptote left
# out, and
# the projection test's level window widened to 2; each must fail its
# verdict (triangulate.tri_parity on triangulate.FAULT_PENCILS, or
# hamming_match.pair_parity on phase 4's first projection match)
TRI_FAULTS = {
    "grid_ties_to_the_last_index": (tr.SOURCE, "return c < bc || (c == bc && i < bi);",
                                    "return c < bc || (c == bc && i > bi);"),
    "asymptote_left_out": (tr.SOURCE, "const bool use_inf = cost_inf < cost_best;",
                           "const bool use_inf = false;"),
    "level_window_of_2": (hm.SOURCE, "abs(rt.lev - s.lev[c]) <= 1", "abs(rt.lev - s.lev[c]) <= 2"),
}


# the outputs that pair_digest hashes: a pair-test match's (those it has),
# a triangulation's
PAIR_FIELDS = ("d1", "d2", "idx", "col_row", "best", "ok", "num", "uv_p", "geom", "t_norm")
TRI_FIELDS = ("X0", "ok", "probe")


def pair_digest(outputs, h=None) -> str:
    """One sha256 over the output tensors of every call, in order: a
    PairMatch's PAIR_FIELDS, a triangulation's (a dict) TRI_FIELDS; `h`, a
    running hashlib object, to add them to."""
    h = hashlib.sha256() if h is None else h
    for out in outputs:
        get = out.get if isinstance(out, dict) else lambda f, o=out: getattr(o, f, None)
        for f in TRI_FIELDS if isinstance(out, dict) else PAIR_FIELDS:
            if get(f) is not None:
                h.update(get(f).contiguous().cpu().numpy().tobytes())
    return h.hexdigest()

class PairCapture:
    """Keeps (cloned) the arguments of every match_projection and
    _epipolar_triangulate call that runtime/hybrid.py makes (it looks both
    names up at call time), by run, and counts the calls of the plain forms
    (match_projection_plain, match_epipolar_plain,
    _epipolar_triangulate_plain) on card tensors, which must be none."""

    def __init__(self):
        self.calls: dict[str, list] = {"projection": [], "epipolar": []}
        self.run: str | None = None
        self.plain_on_card = Counter()
        self._orig = {"match_projection": hybrid.match_projection,
                      "_epipolar_triangulate": hybrid._epipolar_triangulate}
        self._plain = {(matching, "match_projection_plain"): matching.match_projection_plain,
                       (matching, "match_epipolar_plain"): matching.match_epipolar_plain,
                       (hybrid, "_epipolar_triangulate_plain"):
                           hybrid._epipolar_triangulate_plain}

    def _keep(self, kind, fn):
        def call(*args, **kw):
            self.calls[kind].append((self.run, tuple(_clone_arg(a) for a in args),
                                     {k: _clone_arg(v) for k, v in kw.items()}))
            return fn(*args, **kw)
        return call

    def _count(self, name, fn):
        def call(*args, **kw):
            self.plain_on_card[name] += int(args[0].is_cuda)
            return fn(*args, **kw)
        return call

    def __enter__(self):
        hybrid.match_projection = self._keep("projection", self._orig["match_projection"])
        hybrid._epipolar_triangulate = self._keep("epipolar",
                                                  self._orig["_epipolar_triangulate"])
        for (mod, name), fn in self._plain.items():
            setattr(mod, name, self._count(name, fn))
        return self

    def __exit__(self, *exc):
        for name, fn in self._orig.items():
            setattr(hybrid, name, fn)
        for (mod, name), fn in self._plain.items():
            setattr(mod, name, fn)


def projection_check(args, kw) -> tuple[dict, tuple]:
    """One captured match_projection call: the kernel (one launch) against
    the mask mode fed projection_pair_mask's mask, and _finish
    (hm.pair_parity), its projected pixels against the plain form's."""
    Xw, desc_p, valid_p, level_p, T, cam, desc_f, uv_f, level_f, valid_f = args[:10]
    radius = _radius(kw, args)
    kargs = (Xw, desc_p, valid_p, level_p, T.R, T.t, cam, desc_f, uv_f, level_f, valid_f, radius)
    got = hm.match_projection_cuda(*kargs)
    vis, pair, uv_plain = matching.projection_pair_mask(Xw, valid_p, level_p, T, cam, uv_f,
                                                        level_f, radius)
    want = hm.hamming_resolve_cuda(desc_p, vis, desc_f, valid_f, pair)
    best, _, ok = matching._finish(*want, matching.TH_HIGH, 0.9)
    edges = hm.projection_edges(Xw, valid_p, level_p, T.R, T.t, cam, uv_f, level_f, valid_f,
                                radius)
    rep = hm.pair_parity(got, (*want, best, ok), edges)
    # the pixels of the points visible in float64 (the rows whose pixels the
    # pair test reads): the kernel's against float64's, held; the plain
    # float32 form's against the kernel's, read (its transform's rounding
    # reaches ~2e-3 px at the corridor's focal length, and off the frame a
    # point whose depth cancels to near 0 projects to 1e5 px and more)
    zero = torch.zeros(Xw.shape[0], dtype=torch.float64, device=Xw.device)
    err64 = (got.uv_p.double() - edges["uv"]).abs().amax(1)
    err = (got.uv_p - uv_plain).abs().amax(1).double()
    rep["uv_vs_f64"] = float(torch.where(edges["vis"], err64, zero).max())
    rep["uv_max_err"] = float(torch.where(edges["vis"], err, zero).max())
    rep["uv_max_err_off_frame"] = float(err.max())
    rep["ok"] = rep["ok"] and rep["uv_vs_f64"] <= UV_TOL
    rep["max_abs_err"] = max(rep["max_abs_err"], rep["uv_max_err"])
    live = int((vis[:, None] & valid_f[None, :] & pair).sum())
    return rep, (kargs, live, int(vis.sum()), int(valid_f.sum()), got)


def epipolar_check(args, kw) -> tuple[dict, dict]:
    """One captured _epipolar_triangulate call: the two launches against the
    plain form: the match against the mask mode fed the plain form's mask
    (hm.pair_parity, the edges from the kernel's own float64 F); the
    triangulation kernel on the plain form's match against
    triangulate.plain_triangulate, the model and the plain form in float64
    (tr.tri_parity); and, where the two matches agree, the whole call's ok
    equal to the triangulation kernel's on that match."""
    desc0, uv0, valid0, angle0, desc1, uv1, valid1, angle1, T_new, T0, cam = args[:11]
    optimal = kw.get("optimal", args[11] if len(args) > 11 else True)
    m, X0, ok, t_norm = tr.epipolar_triangulate_cuda(*args[:11], optimal)
    mp, Xp, okp, tnp = hybrid._epipolar_triangulate_plain(*args[:11], optimal)
    T_10 = T_new.compose(T0.inverse())
    F = fundamental(T_10, cam)
    pair = matching.epipolar_pair_mask(uv0, uv1, F)
    want = hm.hamming_resolve_cuda(desc0, valid0, desc1, valid1, pair)
    best, _, okw = matching._finish(*want, matching.TH_LOW, 0.8)
    Fk = m.geom[:9].reshape(3, 3)
    edges = hm.epipolar_edges(uv0, valid0, uv1, valid1, Fk)
    mrep = hm.pair_parity(m, (*want, best, okw), edges)
    probe = torch.full((uv0.shape[0], 4), float("nan"), device=uv0.device)
    Xk, okk = tr.triangulate_cuda(uv0, uv1, angle0, angle1, mp.idx, mp.valid, m.geom, cam,
                                  optimal, probe)
    plain = tr.plain_triangulate(uv0, uv1, angle0, angle1, mp.idx, mp.valid, F, T_10, cam,
                                 optimal)
    geom = m.geom.cpu().numpy()
    model = tr.model_triangulate(*(x.cpu().numpy() for x in (uv0, uv1, angle0, angle1, mp.idx,
                                                              mp.valid)), geom, cam, optimal)
    f64 = tr.plain_triangulate(uv0.double(), uv1.double(), angle0, angle1, mp.idx, mp.valid,
                               Fk, SE3(R=m.geom[9:18].reshape(3, 3), t=m.geom[18:21]), cam,
                               optimal)
    trep = tr.tri_parity({"X0": Xk, "ok": okk, "corrected": probe}, plain, model, f64, cam)
    same_match = bool(torch.equal(m.best, mp.idx) and torch.equal(m.ok, mp.valid))
    whole = {"same_match": same_match,
             "ok_equal_to_kernel_on_plain_match": same_match and bool(torch.equal(ok, okk)),
             "ok": int(ok.sum()), "ok_plain": int(okp.sum()),
             "ok_differing_from_plain": int((ok != okp).sum()),
             "t_norm_err": abs(float(t_norm) - float(tnp))}
    verdict = (mrep["ok"] and trep["ok"] and (not same_match
                                             or whole["ok_equal_to_kernel_on_plain_match"])
               and whole["t_norm_err"] <= 1e-6 * max(float(tnp), 1.0))
    return {"ok": bool(verdict), "match": mrep, "triangulation": trep, "whole": whole,
            "optimal": bool(optimal)}, {"m": m, "plain_match": mp, "X0": Xk, "ok": okk,
                                        "probe": probe, "call": {"X0": X0, "ok": ok}}


def write_tri_faults(out_dir: Path) -> dict:
    """Each TRI_FAULTS source: a copy of its kernel with one substitution in
    out_dir/NAME/. Returns {name: path}."""
    paths = {}
    for name, (src, old, new) in TRI_FAULTS.items():
        text = src.read_text()
        require(text.count(old) == 1, f"fault {name}: its source line is not in the kernel")
        path = out_dir / name / src.name
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(text.replace(old, new))
        paths[name] = path
    return paths


def pencil_check(name: str, dev, cam) -> dict:
    """triangulate_cuda on one FAULT_PENCILS case against the plain form, the
    model and the plain form in float64 (tr.tri_parity)."""
    case = tr.fault_case(name)
    c = {k: torch.as_tensor(v).to(dev) for k, v in case.items()}
    probe = torch.full((1, 4), float("nan"), device=dev)
    X0, ok = tr.triangulate_cuda(c["uv0"], c["uv1"], c["angle0"], c["angle1"], c["idx"],
                                 c["valid"], c["geom"], cam, True, probe)
    g = c["geom"]
    F, T = g[:9].reshape(3, 3), SE3(R=g[9:18].reshape(3, 3), t=g[18:21])
    plain = tr.plain_triangulate(c["uv0"], c["uv1"], c["angle0"], c["angle1"], c["idx"],
                                 c["valid"], F.float(), SE3(R=T.R.float(), t=T.t.float()),
                                 cam)
    f64 = tr.plain_triangulate(c["uv0"].double(), c["uv1"].double(), c["angle0"], c["angle1"],
                               c["idx"], c["valid"], F, T, cam)
    model = tr.model_triangulate(*(case[k] for k in ("uv0", "uv1", "angle0", "angle1", "idx",
                                                      "valid", "geom")), cam)
    rep = tr.tri_parity({"X0": X0, "ok": ok, "corrected": probe}, plain, model, f64, cam)
    rep["corrected"] = [float(x) for x in probe[0].cpu()]
    return rep


def tri_faults(proj_call, dev) -> dict:
    """Each planted fault built and run where it shows: the triangulation's
    on both FAULT_PENCILS, the level window on phase 4's first projection
    match; a fault is refused when its verdict fails (the honest kernel's
    verdicts on the same inputs are printed beside)."""
    paths = write_tri_faults(kernel_build.BUILD_DIR / "tri_faults")
    kernel_build.build_many(list(paths.values()))
    cam = proj_call[0][5]
    out = {"honest": {p: pencil_check(p, dev, cam)["ok"] for p in tr.FAULT_PENCILS}}
    out["honest"]["level_window"] = projection_check(*proj_call)[0]["ok"]
    for name, path in paths.items():
        if TRI_FAULTS[name][0] == tr.SOURCE:
            with _module_source(tr, path):
                reps = {p: pencil_check(p, dev, cam) for p in tr.FAULT_PENCILS}
            out[name] = {"refused": not all(r["ok"] for r in reps.values()),
                         **{p: {"ok": r["ok"], "vs_model": r["vs_model"],
                                "corrected": r["corrected"]} for p, r in reps.items()}}
        else:
            with _module_source(hm, path):
                rep = projection_check(*proj_call)[0]
            out[name] = {"refused": not rep["ok"],
                         **{k: rep[k] for k in ("rows_beyond_edge", "cols_beyond_edge",
                                                "ok_beyond_edge", "num", "num_plain")}}
    return out


def pair_bound(kind: str, n_rows: int, n_cols: int, N: int, M: int, n_live: int,
               popc_rate: float) -> tuple[float, str, dict]:
    """Least time of one predicate-mode match, in ms: the larger of its
    bytes over the HBM rate (every input read once: the descriptors, pixels,
    points, levels and masks; every output written once) and its operations
    (the pair tests of the live rows against the valid columns in f32, or
    the popcounts of the live entries, whichever takes longer)."""
    nbytes = (N * (32 + 1) + M * (32 + 1 + 8) + N * 12 + M * 4 + N * 8 + N + 8
              + (N * (12 + 4 + 8) + M * 4 if kind == "projection" else N * 8))
    row_ops = PROJ_POINT_OPS if kind == "projection" else EPI_LINE_OPS
    pair_ops = PROJ_PAIR_OPS if kind == "projection" else EPI_PAIR_OPS
    flops = float(N * row_ops + n_rows * n_cols * pair_ops)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(flops / F32_FLOP_PER_S, 8.0 * n_live / popc_rate) * 1e3
    detail = {"bytes": nbytes, "flops": flops, "live_entries": n_live}
    return (t_ops, "operations", detail) if t_ops >= t_bytes else (t_bytes, "bytes", detail)


def tri_bound(N: int, optimal: bool) -> tuple[float, str, dict]:
    """Least time of one triangulation launch, in ms: its bytes (uv0,
    angle0, idx, valid, the gathered uv1 and angle1, the geometry read
    once; X0 and ok written once) or the plain form's f32 operations."""
    nbytes = N * (8 + 4 + 8 + 1 + 8 + 4) + 22 * 8 + N * (12 + 1)
    flops = float(N * (TRI_ROW_OPS if optimal else TRI_ROW_OPS_NO_CORRECTION))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    detail = {"bytes": nbytes, "flops": flops}
    return (t_ops, "operations", detail) if t_ops >= t_bytes else (t_bytes, "bytes", detail)


def _timed(fn, plain, bound: tuple, floor: dict) -> dict:
    kernel_ms = cuda_ms(fn)
    launches, device_ops = launches_per_call(fn)
    row = {"kernel_ms": kernel_ms, "kernel_warm_ms": cuda_ms(fn, cold=False),
           "plain_ms": cuda_ms(plain, reps=10), "bound_ms": bound[0], "bound_by": bound[1],
           "bound_share": bound[0] / kernel_ms, "bound_detail": bound[2],
           "launches_per_call": launches, "device_ops_per_call": device_ops, **floor}
    require(row["bound_share"] <= 1.0, f"{kernel_ms} ms is under its bound {bound[0]} ms")
    return row


EPI_ARGS = ("desc0", "uv0", "valid0", "angle0", "desc1", "uv1", "valid1", "angle1")


def save_tri_calls(path: Path, calls: list) -> None:
    """Writes captured _epipolar_triangulate calls, [(run, args, kwargs,
    kernel outputs)], to an .npz: each call's eight feature arrays, both
    poses, the camera, `optimal`, and the triangulation kernel's outputs on
    the plain form's match (X0, ok, the corrected pixels) with the
    match's geometry and the plain match (idx, valid)."""
    out = {"n": np.array(len(calls))}
    for k, (run, args, kw, res) in enumerate(calls):
        cam = args[10]
        out.update({f"c{k}_{name}": a for name, a in zip(EPI_ARGS, args[:8])})
        out.update({f"c{k}_run": np.array(run), f"c{k}_R_new": args[8].R, f"c{k}_t_new": args[8].t,
                    f"c{k}_R0": args[9].R, f"c{k}_t0": args[9].t,
                    f"c{k}_cam": np.array([cam.fx, cam.fy, cam.cx, cam.cy, cam.width,
                                           cam.height], np.float64),
                    f"c{k}_optimal": np.array(bool(kw.get("optimal", True))),
                    f"c{k}_geom": res["m"].geom, f"c{k}_idx": res["plain_match"].idx,
                    f"c{k}_valid": res["plain_match"].valid, f"c{k}_X0": res["X0"],
                    f"c{k}_ok": res["ok"], f"c{k}_probe": res["probe"]})
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, **{k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                                 else v for k, v in out.items()})


def tri_phase(cap: PairCapture, sites_by_phase: dict, card: str, popc_rate: float,
              save: Path | None = None) -> tuple:
    """Phase 18: every captured match_projection call of phases 4-12 and
    every _epipolar_triangulate call held to the plain forms
    (projection_check, epipolar_check), the launches per call site of every
    kernel in phases 5, 7 and 10, the three planted faults, one
    _epipolar_triangulate call's host waits, cold and warm ms of the three
    entry points beside their bounds and plain forms, their `// stage:`
    stamps (a line each), and one sha256 of every captured call's
    outputs."""
    dev = torch.device("cuda")
    require(not cap.plain_on_card, f"a plain form ran on card tensors: {cap.plain_on_card}")
    proj = cap.calls["projection"]
    epi = cap.calls["epipolar"]
    require(proj and epi, f"{len(proj)} match_projection and {len(epi)} "
                          "_epipolar_triangulate calls captured")
    by_run: dict[str, Counter] = {}
    edge = Counter()
    worst = {"uv": 0.0, "uv_vs_f64": 0.0, "uv_off_frame": 0.0, "hamming_projection": 0.0,
             "hamming_epipolar": 0.0}
    failed = []
    digest = hashlib.sha256()
    for k, (run, args, kw) in enumerate(proj):
        rep, (*_, got) = projection_check(args, kw)
        pair_digest([got], digest)
        c = by_run.setdefault(f"projection/{run}", Counter())
        c["calls"] += 1
        for key in ("edge_pairs", "edge_rows", "rows_differing", "cols_differing",
                    "ok_differing"):
            c[key] += rep[key]
        worst["uv"] = max(worst["uv"], rep["uv_max_err"])
        worst["uv_off_frame"] = max(worst["uv_off_frame"], rep["uv_max_err_off_frame"])
        worst["uv_vs_f64"] = max(worst["uv_vs_f64"], rep["uv_vs_f64"])
        worst["hamming_projection"] = max(worst["hamming_projection"], rep["max_abs_err"])
        if not rep["ok"]:
            failed.append({"kind": "projection", "run": run, "call": k, **rep})
    tri_readings, kept = [], []
    for k, (run, args, kw) in enumerate(epi):
        rep, res = epipolar_check(args, kw)
        pair_digest([res["m"], res["call"], {f: res[f] for f in TRI_FIELDS}], digest)
        if save is not None:
            kept.append((run, args, kw, res))
        c = by_run.setdefault(f"epipolar/{run}", Counter())
        c["calls"] += 1
        for key in ("edge_pairs", "edge_rows", "rows_differing", "ok_differing"):
            c[key] += rep["match"][key]
        t = rep["triangulation"]
        c["basin_edges"] += t["basin_edges"]
        c["depth_edges"] += t["depth_edges"]
        c["plain_further_beyond_tol"] += t["plain_further_beyond_tol"]
        c["calls_match_differing"] += int(not rep["whole"]["same_match"])
        worst["hamming_epipolar"] = max(worst["hamming_epipolar"], rep["match"]["max_abs_err"])
        tri_readings.append(t)
        if not rep["ok"]:
            failed.append({"kind": "epipolar", "run": run, "call": k, **rep})
    if save is not None:
        save_tri_calls(save, kept)
    edge_totals = {run: dict(c) for run, c in by_run.items()}
    print(json.dumps({"phase": "tri_edges", "by_run": edge_totals}))
    # every captured call's outputs (the projection matches, then each
    # epipolar call's match, whole call and triangulation on the plain
    # match), so that another tree's kernels can be held to these bits
    print(json.dumps({"phase": "tri_digest", "projection_calls": len(proj),
                      "epipolar_calls": len(epi), "digest": digest.hexdigest()}))
    shown = Counter()
    for f in failed:
        shown[f["kind"]] += 1
        if shown[f["kind"]] <= 3:
            print(json.dumps({"phase": "tri_failed", **f}, default=str))
    print(json.dumps({"phase": "tri_failed_by_kind",
                      **Counter(f"{f['kind']}/{f['run']}" for f in failed)}))
    require(not failed, f"phase 18: {len(failed)} captured calls outside their verdicts")
    per_site = {ph: {site: dict(c) for site, c in kern.items()}
                for ph, (kern, _) in sites_by_phase.items()}
    print(json.dumps({"phase": "tri_launches_per_site", "sites": per_site}))
    for ph, sites in per_site.items():
        for site, c in sites.items():
            calls = sites_by_phase[ph][1][site]
            if site == "_epipolar_triangulate":
                require(c.get("hamming_epipolar", 0) == calls and c.get("triangulate", 0) == calls
                        and sum(c.values()) == 2 * calls,
                        f"{ph}: _epipolar_triangulate made {c} launches in {calls} calls")
            if site in ("_project_match_pnp", "_local_map_pass2", "_map_projection_match"):
                require(c.get("hamming_projection", 0) == calls and not c.get("hamming_resolve"),
                        f"{ph}: {site} made {c} Hamming launches in {calls} calls")

    t0 = time.perf_counter()
    faults = tri_faults(proj[0][1:], dev)
    print(json.dumps({"phase": "tri_faults", "seconds": time.perf_counter() - t0, **faults}))
    require(all(faults["honest"].values()), f"the honest kernels on the fault inputs: {faults}")
    for name in TRI_FAULTS:
        require(faults[name]["refused"], f"planted fault {name} passed its verdict")

    # timing: phase 4's first projection match, phase 5's first keyframe pair
    floor = launch_floor()
    _, (kargs, live, rows, cols, _) = projection_check(*proj[0][1:])
    N, M = kargs[0].shape[0], kargs[7].shape[0]
    args, kw = proj[0][1], proj[0][2]
    projection = _timed(lambda: hm.match_projection_cuda(*kargs),
                        lambda: matching.match_projection_plain(*args[:10], _radius(kw, args)),
                        pair_bound("projection", rows, cols, N, M, live, popc_rate), floor)
    run5 = [c for c in epi if c[0] == "hybrid"] or epi
    _, args, kw = run5[0]
    optimal = kw.get("optimal", True)
    rep, out = epipolar_check(args, kw)
    desc0, uv0, valid0, angle0, desc1, uv1, valid1, angle1, T_new, T0, cam = args[:11]
    poses = (T_new.R, T_new.t, T0.R, T0.t)
    T_10 = T_new.compose(T0.inverse())
    F = fundamental(T_10, cam)
    pair = matching.epipolar_pair_mask(uv0, uv1, F)
    live_e = int((valid0[:, None] & valid1[None, :] & pair).sum())
    epipolar = _timed(
        lambda: hm.match_epipolar_cuda(desc0, uv0, valid0, desc1, uv1, valid1, poses=poses,
                                       cam=cam),
        lambda: matching.match_epipolar_plain(desc0, uv0, valid0, desc1, uv1, valid1, F),
        pair_bound("epipolar", int(valid0.sum()), int(valid1.sum()), uv0.shape[0],
                   uv1.shape[0], live_e, popc_rate), floor)
    m = out["m"]
    triangulate = _timed(
        lambda: tr.triangulate_cuda(uv0, uv1, angle0, angle1, m.best, m.ok, m.geom, cam,
                                    optimal),
        lambda: tr.plain_triangulate(uv0, uv1, angle0, angle1, m.best, m.ok, F, T_10, cam,
                                     optimal),
        tri_bound(uv0.shape[0], optimal), floor)
    whole = {"kernel_ms": cuda_ms(lambda: hybrid._epipolar_triangulate(*args[:11], optimal)),
             "plain_ms": cuda_ms(lambda: hybrid._epipolar_triangulate_plain(*args[:11], optimal),
                                 reps=10),
             **_syncs(lambda: hybrid._epipolar_triangulate(*args[:11], optimal))}
    require(whole["syncs"] == 0 and whole["memcpys"] == 0 and whole["enqueues"] == 2,
            f"_epipolar_triangulate on the card: {whole}")
    for name, row in (("projection", projection), ("epipolar", epipolar),
                      ("triangulate", triangulate)):
        require(row["launches_per_call"] == 1, f"{name}: {row['launches_per_call']} launches")
    # the `// stage:` stamps of the three timed calls (tools/ba_stages.py
    # pair_stamps: the marks made %globaltimer stamps in a copy of csrc/)
    bs = _ba_stages()
    stamps = bs.pair_stamps(bs.PairBuild("tree"), {
        "hamming_projection": (lambda b: b.hm.match_projection_cuda(*kargs), hm.SOURCE.name),
        "hamming_epipolar": (lambda b: b.hm.match_epipolar_cuda(desc0, uv0, valid0, desc1, uv1,
                                                                valid1, poses=poses, cam=cam),
                             hm.SOURCE.name),
        "triangulate": (lambda b: b.tr.triangulate_cuda(uv0, uv1, angle0, angle1, m.best, m.ok,
                                                         m.geom, cam, optimal), tr.SOURCE.name)},
        20)
    for name in ("hamming_projection", "hamming_epipolar", "triangulate"):
        print(json.dumps({"phase": "tri_stamps", "kernel": name, "stamps": stamps[name]}))
    timing = {"hamming_projection": {**projection, "N": N, "M": M},
              "hamming_epipolar": {**epipolar, "N": uv0.shape[0], "M": uv1.shape[0]},
              "triangulate": {**triangulate, "N": uv0.shape[0], "optimal": bool(optimal)},
              "epipolar_triangulate": whole, "card": card}
    print(json.dumps({"phase": "tri_timing", **timing}))
    public = {"projection_calls": len(proj), "epipolar_calls": len(epi),
              "edges_by_run": edge_totals, "max_uv_err": worst["uv"],
              "max_uv_err_off_frame": worst["uv_off_frame"],
              "max_uv_vs_f64": worst["uv_vs_f64"],
              "max_abs_err": {"hamming_projection": worst["hamming_projection"],
                              "hamming_epipolar": worst["hamming_epipolar"],
                              "triangulate": max(t["max_abs_err"] for t in tri_readings)},
              "triangulation_worst": {
                  "vs_f64_px": max(t["vs_f64"]["max_pixel"] for t in tri_readings),
                  "vs_plain_px": max(t["vs_plain"]["max_pixel"] for t in tri_readings),
                  "plain_vs_f64_px": max(t["plain_vs_f64_max_pixel"] for t in tri_readings)},
              "faults": {k: v["refused"] for k, v in faults.items() if k != "honest"},
              "launches_per_site": per_site, "digest": digest.hexdigest()}
    return public, timing


# -- phase 19 -----------------------------------------------------------------

# every call site of the direct keyframe programs and their pieces: the
# keyframe event's two programs (_make_keyframe), the startup's pieces
# (_promote_initialization, the hybrid's _promote_two_view, set_first's
# selection, _rebuild_tracker_ref); each module's own global is wrapped
KF_SITES = ((odometry, "_activate_and_clear"), (odometry, "_refresh_after_kf"),
            (win_mod, "add_points"), (odometry, "_tracker_ref_in_frame"),
            (odometry, "_working_rho_range"), (hybrid, "_working_rho_range"),
            (odometry, "select_points"), (hybrid, "select_points"),
            (initializer, "select_points"), (odometry, "seed_immatures"),
            (hybrid, "seed_immatures"))
KF_RUNS = ("direct", "hybrid", "direct_pipelined")
# planted faults (a source substitution each, and the input it is run on)
# that phase 19 builds beside the kernels and runs: position i of a row
# lands one free slot further within each scan thread's run (the last
# repeats), on the activation that writes the most points; the top k's ties
# go to the highest cell index, on a keyframe flat below its top third
# (the cut falls among cells that score 0); the region quantile's low rank
# one too high, on a keyframe whose regions hold equal halves of zero and of
# one magnitude (the two middle keys differ: `striped`)
KF_FAULTS = {
    "dest_one_free_slot_further": (kfp.ACTIVATE_SOURCE, "        const int b = __ffs(f) - 1;\n",
                                   "        const int b = __ffs(f & (f - 1u) ? f & (f - 1u) : f)"
                                   " - 1;\n", "activation"),
    "topk_ties_to_the_highest_index": (kfp.REFRESH_SOURCE,
                                       "cnt += (o > me) | ((o == me) & (j < c));",
                                       "cnt += (o > me) | ((o == me) & (j > c));", "half_flat"),
    "quantile_rank_one_too_high": (kfp.REFRESH_SOURCE, "  }, a.q_lo, a.q_hi, sm, red);",
                                   "  }, a.q_lo + 1, a.q_hi, sm, red);", "striped"),
}
# the plain forms' float32 operations, for the bounds: a bilinear sample's
# floors, clamps, fractions and complements (8) and 6 products and 3 sums a
# channel; the gradient weight (2 products, 3 sums, a reciprocal, a product,
# a root); a point transform (unproject 6, two 3x3 products and sums 30,
# project 8, the tests 8, the cell 4); a selection pixel (2 products, a sum,
# a root, the threshold and border tests 5); a cell's rank (2 compares a
# cell)
KF_SAMPLE_OPS = 8 + 9 * 3
KF_WEIGHT_OPS = 8
KF_POINT_OPS = 6 + 30 + 8 + 8 + 4
KF_PIXEL_OPS = 4 + 5
# a BA arena row's bytes (uv, host, idepth, idepth_fej, colour, weight,
# point_valid; res_active is F more) and an immature entry's (uv, colour,
# rho_lo, rho_hi, n_ok, n_fail, valid)
KF_BA_ROW_BYTES = 8 + 4 + 4 + 4 + 32 + 32 + 1
KF_ARENA_ENTRY_BYTES = 8 + 32 + 4 + 4 + 4 + 4 + 1


class KfCapture:
    """Keeps (cloned) the arguments of every call of the keyframe programs
    and their pieces (KF_SITES) that a run makes, by run."""

    def __init__(self):
        self.calls: dict[str, list] = {}
        self.run: str | None = None
        self._orig: dict = {}

    def _wrap(self, name, fn):
        def call(*args, **kw):
            if self.run is not None:
                self.calls.setdefault(self.run, []).append((name, _clone_fields(args),
                                                            _clone_fields(kw)))
            return fn(*args, **kw)
        return call

    def __enter__(self):
        for mod, name in KF_SITES:
            self._orig[(mod, name)] = getattr(mod, name)
            setattr(mod, name, self._wrap(name, getattr(mod, name)))
        return self

    def __exit__(self, *exc):
        for (mod, name), fn in self._orig.items():
            setattr(mod, name, fn)


def _kf_launches() -> tuple[int, int]:
    return kfp.kf_activate_cuda.launches, kfp.kf_refresh_cuda.launches


def kf_check(name: str, args: tuple, kw: dict) -> dict:
    """One captured call: the kernel (through its dispatcher) against the
    plain form on the same inputs, with the launches it made."""
    before = _kf_launches()
    if name == "_activate_and_clear":
        got = odometry._activate_and_clear(*args, **kw)
        n = _kf_launches()
        want = odometry._activate_and_clear_plain(*args, **kw)
        rep = kfp.activate_parity(got, want)
        rep["written"] = int(got[0].ba.point_valid.sum() - args[0].ba.point_valid.sum())
    elif name == "add_points":
        got = win_mod.add_points(*args, **kw)
        n = _kf_launches()
        slot = args[1]
        want = win_mod.add_points_plain(args[0], int(slot), *args[2:], **kw)
        rep = kfp.activate_parity((got, None), (want, None))
    elif name == "_refresh_after_kf":
        window, slot, pyr, imm, cam, cfg = args
        got = odometry._refresh_after_kf(*args)
        n = _kf_launches()
        want = odometry._refresh_after_kf_plain(*args)
        rep = kfp.refresh_parity(got, want, window.ba, int(slot), cam, pyr, cfg)
    elif name == "_tracker_ref_in_frame":
        window, slot, pyr, cam, cfg = args
        got = odometry._tracker_ref_in_frame(*args)
        n = _kf_launches()
        want = odometry._tracker_ref_in_frame_plain(*args)
        rep = kfp.ref_parity(got, want, window.ba, int(slot), cam, pyr, cfg)
        rep["max_abs_err"] = rep["max_uv_err"]
    else:
        fn, plain = {"_working_rho_range": (odometry._working_rho_range,
                                            odometry._working_rho_range_plain),
                     "select_points": (selector.select_points, selector.select_points_plain),
                     "seed_immatures": (tracer.seed_immatures, tracer.seed_immatures_plain)}[name]
        got = fn(*args, **kw)
        n = _kf_launches()
        want = plain(*args, **kw)
        if name == "seed_immatures":
            got, want = [getattr(got, f) for f in kfp._ARENA_FIELDS], \
                [getattr(want, f) for f in kfp._ARENA_FIELDS]
        differing = [i for i, (a, b) in enumerate(zip(got, want)) if not kfp._bits_equal(a, b)]
        rep = {"ok": not differing, "differing": differing, "max_abs_err": max(
            kfp._max_err(a, b) for a, b in zip(got, want))}
    rep["launches"] = (n[0] - before[0], n[1] - before[1])
    return rep


def activate_bound(window, imm, cfg) -> tuple[float, str, dict]:
    """Least time of one _activate_and_clear, in ms: the larger of its bytes
    over the HBM rate and its operations over the f32 rate. Bytes: the BA
    arena's point rows read once and written once, the immature arena's
    entries read once and their validity written, the frames' flags, and
    each texel (3 channels) the ready candidates' pattern samples read,
    counted once. Operations: each candidate's readiness (6), each ready
    one's 8 samples and weights."""
    ba = window.ba
    P, F = ba.uv.shape[0], ba.ab.shape[0]
    R, K = imm.valid.shape
    ready, _ = tracer.mature_mask(imm, cfg)
    n_ready = int(ready.sum())
    H, W = window.images.shape[1:3]
    ids = []
    for r in range(R):
        m = ready[r]
        if not bool(m.any()):
            continue
        uv = residuals.pattern_uv(imm.uv[r][m])
        x0 = torch.clamp(torch.floor(uv[..., 0]), 0, W - 2).long()
        y0 = torch.clamp(torch.floor(uv[..., 1]), 0, H - 2).long()
        base = (r * H * W + y0 * W + x0).reshape(-1)
        ids += [base, base + 1, base + W, base + W + 1]
    texels = int(torch.unique(torch.cat(ids)).numel()) if ids else 0
    nbytes = (2 * P * (KF_BA_ROW_BYTES + F) + R * K * (8 + 4 + 4 + 4 + 1 + 1) + F
              + 12 * texels)
    ops = R * K * 6 + n_ready * 8 * (KF_SAMPLE_OPS + KF_WEIGHT_OPS)
    t_b, t_o = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_FLOP_PER_S * 1e3
    detail = {"bytes": nbytes, "ops": ops, "ready": n_ready, "texels": texels}
    return (t_o, "operations", detail) if t_o > t_b else (t_b, "bytes", detail)


def refresh_bound(window, slot, pyr, imm, cam, cfg) -> tuple[float, str, dict]:
    """Least time of one _refresh_after_kf, in ms, as activate_bound counts
    it. Bytes: the keyframe's two gradient channels at every pixel of level
    0 (the selection), the window's points and poses, the texels the
    reference's samples read at every level and the seeds' pattern samples
    read (counted once), the immature arena read once and written once, and
    the reference, the range and the selection written once. Operations:
    the points' transforms, the reference's samples and weights, the
    selection's pixels, and the cells' ranks (two compares a pair)."""
    ba = window.ba
    P, F = ba.uv.shape[0], ba.ab.shape[0]
    Fi, K = imm.valid.shape
    L = len(pyr)
    H, W = pyr[0].shape[:2]
    ref, new = odometry._refresh_after_kf_plain(window, slot, pyr, imm, cam, cfg)
    texels = 0
    for l in range(L):
        h, w = pyr[l].shape[:2]
        x0 = torch.nan_to_num(torch.clamp(torch.floor(ref.uv[l][:, 0]), 0, w - 2)).long()
        y0 = torch.nan_to_num(torch.clamp(torch.floor(ref.uv[l][:, 1]), 0, h - 2)).long()
        b = y0 * w + x0
        texels += int(torch.unique(torch.cat([b, b + 1, b + w, b + w + 1])).numel())
    uv = residuals.pattern_uv(new.uv[int(slot)])
    x0 = torch.clamp(torch.floor(uv[..., 0]), 0, W - 2).long()
    y0 = torch.clamp(torch.floor(uv[..., 1]), 0, H - 2).long()
    b = (y0 * W + x0).reshape(-1)
    seed_texels = int(torch.unique(torch.cat([b, b + 1, b + W, b + W + 1])).numel())
    g = kfp.select_geometry(H, W, cfg.points_per_kf)
    cells = g["Hc"] * g["Wc"]
    nbytes = (H * W * 8 + P * (8 + 4 + 4 + 1) + F * 48 + 12 * texels + 4 * seed_texels
              + 2 * Fi * K * KF_ARENA_ENTRY_BYTES + L * P * (8 + 4 + 4 + 1) + P * 4 + 8
              + cfg.points_per_kf * (8 + 1 + 4))
    ops = (P * KF_POINT_OPS + L * P * (KF_SAMPLE_OPS + KF_WEIGHT_OPS) + H * W * KF_PIXEL_OPS
           + 2 * cells * cells + K * 8 * (8 + 9))
    t_b, t_o = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_FLOP_PER_S * 1e3
    detail = {"bytes": nbytes, "ops": ops, "texels": texels, "seed_texels": seed_texels,
              "cells": cells}
    return (t_o, "operations", detail) if t_o > t_b else (t_b, "bytes", detail)


@contextlib.contextmanager
def kf_sources(activate: Path | None = None, refresh: Path | None = None):
    """kf_programs' wrappers launching the libraries built from the given
    sources inside the block."""
    before = kfp.ACTIVATE_SOURCE, kfp.REFRESH_SOURCE
    kfp.ACTIVATE_SOURCE = activate or before[0]
    kfp.REFRESH_SOURCE = refresh or before[1]
    try:
        yield
    finally:
        kfp.ACTIVATE_SOURCE, kfp.REFRESH_SOURCE = before


def write_kf_faults(out_dir: Path) -> dict:
    """Each planted fault's source: a copy of its kernel with one
    substitution, in out_dir/NAME/ beside copies of the headers. Returns
    {name: path}."""
    paths = {}
    for name, (source, old, new, _) in KF_FAULTS.items():
        text = source.read_text()
        require(text.count(old) == 1, f"fault {name}: its source line is not in the kernel")
        path = out_dir / name / source.name
        path.parent.mkdir(parents=True, exist_ok=True)
        for header in source.parent.glob("*.cuh"):
            shutil.copy(header, path.parent / header.name)
        path.write_text(text.replace(old, new))
        paths[name] = path
    return paths


def half_flat(pyr) -> tuple:
    """The keyframe's pyramid flat (grey 100, no gradient) below the top
    third of every level."""
    out = []
    for G in pyr:
        G = G.clone()
        G[G.shape[0] // 3:] = torch.tensor([100.0, 0.0, 0.0], device=G.device)
        out.append(G)
    return tuple(out)


def striped(pyr, c: float = 50.0) -> tuple:
    """The keyframe's pyramid with level 0's gradient (gx, gy) set to (0, 0)
    on even columns and (c, 0) on odd ones: every 32x32 region holds 512
    zero magnitudes and 512 of c, so its median c / 2 lies between its two
    middle keys, and every pixel of magnitude c > 14 passes the smoothed
    threshold (c / 2 + 7)^2 (a quantile of c would pass none)."""
    G = pyr[0].clone()
    odd = torch.arange(G.shape[1], device=G.device) % 2 == 1
    G[..., 1] = torch.where(odd, torch.tensor(c, device=G.device), torch.zeros((), device=G.device))
    G[..., 2] = 0.0
    return (G, *pyr[1:])


def kf_faults(act_call: tuple, ref_call: tuple) -> dict:
    """Each planted fault built and run through the verdict on its input
    (KF_FAULTS: the activation that writes the most points, or the first
    refresh with its keyframe half flat or striped), beside the honest
    kernel on every input."""
    paths = write_kf_faults(kernel_build.BUILD_DIR / "kf_faults")
    kernel_build.build_many(list(paths.values()))
    window, slot, pyr, imm, cam, cfg = ref_call
    refs = {kind: (window, slot, make(pyr), imm, cam, cfg)
            for kind, make in (("half_flat", half_flat), ("striped", striped))}
    out = {}
    for name, path in (("honest", None), *paths.items()):
        kind = KF_FAULTS[name][3] if path else None
        rep = {}
        if kind in (None, "activation"):
            with kf_sources(activate=path):
                a = kf_check("_activate_and_clear", act_call, {})
            rep.update(activate_ok=a["ok"], activate_differing=a["differing"])
        for k, call in refs.items():
            if kind in (None, k):
                with kf_sources(refresh=path):
                    r = kf_check("_refresh_after_kf", call, {})
                rep[f"refresh_{k}_ok"] = r["ok"]
                rep[f"refresh_{k}_arena_differing"] = r["arena_differing"]
        rep["ok"] = all(v for key, v in rep.items() if key.endswith("_ok"))
        out[name] = rep
    return out


def kf_timing(name: str, args: tuple, bound: tuple, card: str) -> dict:
    """Cold and warm ms of one program call through its dispatcher beside
    the launch floor, its enqueues and device operations, its host waits,
    the plain form's ms, the bound and its share."""
    fn = getattr(odometry, name)
    plain = getattr(odometry, name + "_plain")
    host, device_ops = launches_per_call(lambda: fn(*args))
    waits = _syncs(lambda: fn(*args))
    ms, warm = cuda_ms(lambda: fn(*args)), cuda_ms(lambda: fn(*args), cold=False)
    floor = launch_floor()
    t, by, detail = bound
    return {"kernel_ms": ms, "kernel_warm_ms": warm, **floor,
            "above_floor_ms": ms - floor["floor_ms"],
            "above_floor_warm_ms": warm - floor["floor_warm_ms"],
            "plain_ms": cuda_ms(lambda: plain(*args), reps=10), "launches_per_call": host,
            "device_ops_per_call": device_ops, "host_waits": waits, "bound_ms": t,
            "bound_by": by, "bound_detail": detail, "bound_share": t / ms, "library_ms": None,
            "card": card}


def kf_phase(cap: KfCapture, card: str) -> tuple[dict, dict]:
    """Phase 19: the keyframe programs' kernels against their plain forms on
    the card, on every call of the programs and their pieces that phases 3,
    5 and 9 made (kf_check: activate_parity, refresh_parity, ref_parity;
    the range, the selection and the seed bit for bit); one launch a call
    of the activation kernel or of the refresh kernel (1 for a piece, 1 for
    _refresh_after_kf, at most 3 allowed), no plain form on the card in the
    runs; the three planted faults refused; cold and warm ms of both programs
    on phase 3's first keyframe event, their host waits (none), plain ms,
    bounds and shares."""
    counts = {run: Counter(name for name, _, _ in cap.calls.get(run, [])) for run in KF_RUNS}
    print(json.dumps({"phase": "kf_calls", **{k: dict(v) for k, v in counts.items()}}))
    for run in KF_RUNS:
        require(counts[run]["_activate_and_clear"] > 0 and counts[run]["_refresh_after_kf"] > 0,
                f"{run}: no keyframe program captured: {dict(counts[run])}")
        require(counts[run]["_tracker_ref_in_frame"] > 0 and counts[run]["select_points"] > 0,
                f"{run}: no startup piece captured: {dict(counts[run])}")
    reports, worst, edges = [], 0.0, 0
    by_name: dict = {}
    for run in KF_RUNS:
        for k, (name, args, kw) in enumerate(cap.calls[run]):
            rep = kf_check(name, args, kw)
            rep.update(run=run, call=k, name=name)
            limit = 3 if name == "_refresh_after_kf" else 1
            n = sum(rep["launches"])
            require(rep["ok"] and 1 <= n <= limit,
                    f"phase 19: {run} call {k} ({name}) against its plain form: {rep}")
            worst = max(worst, rep.get("max_abs_err", 0.0))
            edges += rep.get("edge_points", 0)
            if rep.get("edge_points"):
                print(f"  kf {run} call {k} {name}: {rep['edge_points']} reference points "
                      f"at a decision's edge")
            by_name.setdefault(name, []).append(rep)
            reports.append(rep)
    act_calls = [args for run in KF_RUNS for name, args, _ in cap.calls[run]
                 if name == "_activate_and_clear"]
    ref_calls = [args for run in KF_RUNS for name, args, _ in cap.calls[run]
                 if name == "_refresh_after_kf"]
    written = [r["written"] for r in by_name["_activate_and_clear"]]
    act = act_calls[int(np.argmax(written))]
    faults = kf_faults(act, ref_calls[0])
    print(json.dumps({"phase": "kf_faults", **faults}))
    require(faults["honest"]["ok"], f"the kernels fail their own fault inputs: {faults['honest']}")
    for name in KF_FAULTS:
        require(not faults[name]["ok"], f"the planted fault {name} passed its verdict")
    # the main path's shapes: phase 3's first keyframe event (the activation
    # that writes the most points of phase 3)
    first = [args for name, args, _ in cap.calls["direct"] if name == "_activate_and_clear"]
    act3 = first[int(np.argmax([r["written"] for r in by_name["_activate_and_clear"]
                                if r["run"] == "direct"]))]
    ref3 = next(args for name, args, _ in cap.calls["direct"] if name == "_refresh_after_kf")
    timing = {"_activate_and_clear": kf_timing("_activate_and_clear", act3,
                                               activate_bound(*act3), card),
              "_refresh_after_kf": kf_timing("_refresh_after_kf", ref3,
                                             refresh_bound(*ref3), card)}
    # each of the refresh's stages alone (one launch of its stage mask, the
    # pieces' entry points) on the same call
    window, slot, pyr, imm, cam, cfg = ref3
    uv, valid, _ = selector.select_points(pyr[0], cfg.points_per_kf)
    lo, hi = odometry._working_rho_range(window.ba, cfg)
    stages = {"A_reference": lambda: odometry._tracker_ref_in_frame(window, slot, pyr, cam, cfg),
              "B_range": lambda: odometry._working_rho_range(window.ba, cfg),
              "C_select": lambda: selector.select_points(pyr[0], cfg.points_per_kf),
              "D_seed": lambda: tracer.seed_immatures(imm, slot, pyr[0], uv, valid, lo, hi)}
    timing["_refresh_after_kf"]["stage_ms"] = {k: cuda_ms(f) for k, f in stages.items()}
    for name, t in timing.items():
        limit = 3 if name == "_refresh_after_kf" else 1
        require(1 <= t["launches_per_call"] <= limit,
                f"{name} made {t['launches_per_call']} launches a call")
        require(t["host_waits"]["syncs"] == 0 and t["host_waits"]["memcpys"] == 0,
                f"{name} waits for the device: {t['host_waits']}")
        require(t["bound_share"] <= 1.0, f"{name}: under its bound: the bound is wrong")
    print(json.dumps({"phase": "kf_timing", **timing}))
    public = {"calls": {k: dict(v) for k, v in counts.items()},
              "checked": len(reports), "edge_points": edges, "max_abs_err": worst,
              "written_per_activation": written,
              "faults": {k: not v["ok"] for k, v in faults.items() if k != "honest"},
              "uv_tol": kfp.UV_TOL, "edge_rel": kfp.EDGE_REL}
    print(json.dumps({"phase": "kf_public", **public}))
    return public, timing


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description="Smoke run of libcml_tpu_torch on one CUDA card.")
    ap.add_argument("--save-tri", type=Path, default=None, metavar="FILE",
                    help="also write phase 18's captured _epipolar_triangulate calls and the "
                         "triangulation kernel's outputs to FILE (.npz)")
    ap.add_argument("--save-local-ba", type=Path, default=None, metavar="FILE",
                    help="also write phase 16's captured run_local_ba calls to FILE (.npz; "
                         "tools/local_ba_witness.py --calls reads it)")
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = nvidia_smi("name,power.limit")
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card} | torch: {kind} | torch {torch.__version__} cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    for path, secs, log in kernel_build.build_many((*kernel_build.SOURCES, floor_source()),
                                                   verbose=True):
        print(f"built {path.name} in {secs:.1f} s")
        print(log.strip())
    print(f"kernels built in {time.perf_counter() - t0:.1f} s (one nvcc each, in parallel)")

    t0 = time.perf_counter()
    cam, traj, frames = wl.render_frames(dev, N_DIRECT)
    torch.cuda.synchronize()
    print(f"rendered {len(frames)} frames in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    map_, _ = wl.build_map(cam, traj, frames, dev)
    phase4_args = wl.projection_match_inputs(map_, cam, traj, wl.extract(frames[1]), 1, dev)
    popc_rate = popc_per_s()
    rows, max_err = kernel_vs_plain(dev, card, popc_rate, phase4_args)
    print(f"phase 2 (kernel vs plain) {time.perf_counter() - t0:.1f} s")

    # phases 3-12 run with the local BA's calls watched (captured for phase
    # 16 in phases 5, 7, 10 and 12)
    lba_cap = LocalBACapture().__enter__()
    # and every extract_orb call watched (captured for phase 17 in phases 4-7)
    orb_cap = OrbCapture().__enter__()
    # and the keyframe programs' calls (captured for phase 19 in phases 3, 5, 9)
    kf_cap = KfCapture().__enter__()
    with LMCapture() as cap, TraceCapture() as trace_cap:
        cap.arm("track_lm", TRACK_FROM)
        t0 = time.perf_counter()
        trace_cap.phase = kf_cap.run = "direct"
        with BACapture(every=("run_ba", "_marg_pieces")) as ba_cap:
            direct, direct_snap = direct_phase(dev, cam, traj, frames)
        trace_cap.phase = kf_cap.run = None
        print(f"phase 3 (direct) {time.perf_counter() - t0:.1f} s")

        # every match_projection and _epipolar_triangulate call of phases 4-12
        # kept for phase 18
        pair_cap = PairCapture().__enter__()
        site_tables = {}
        t0 = time.perf_counter()
        orb_cap.run = pair_cap.run = "hybrid_tracking"
        hyb = hybrid_phase(dev, cam, traj, frames)
        orb_cap.run = None
        print(f"phase 4 (hybrid tracking) {time.perf_counter() - t0:.1f} s")

        cap.arm("pnp_lm", PNP_FROM)
        with CallSites() as sites:
            cap.sites = sites
            t0 = time.perf_counter()
            trace_cap.phase = "hybrid"
            lba_cap.run = orb_cap.run = pair_cap.run = kf_cap.run = "hybrid"
            with BACapture(every=("run_ba_mixed",)) as mixed_cap:
                full, hybrid_snap = full_hybrid_phase(dev, cam, traj, frames, sites)
            site_tables["hybrid"] = _site_table(sites)
            lba_cap.run = orb_cap.run = kf_cap.run = None
            trace_cap.phase = None
            print(f"phase 5 (hybrid) {time.perf_counter() - t0:.1f} s")
            t0 = time.perf_counter()
            orb_cap.run = pair_cap.run = "relocalization"
            reloc = relocalization_phase(dev, cam, traj, frames, sites)
            site_tables["relocalization"] = _site_table(sites)
            orb_cap.run = None
            print(f"phase 6 (relocalization) {time.perf_counter() - t0:.1f} s")
    real = {"_epipolar_triangulate": "1536x1536 first keyframe's epipolar band (phase 5)",
            "match_descriptors": "1536x1536 relocalization match_descriptors (phase 6)"}
    for site, name in real.items():
        require(site in sites.captured, f"no resolution captured at {site}")
        row = kernel_case(name, mask_case(site, sites.captured[site]), card, popc_rate)
        rows.append(row)
        max_err = max(max_err, row["max_abs_err"])

    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        with CallSites() as sites:
            t0 = time.perf_counter()
            lba_cap.run = orb_cap.run = pair_cap.run = "cli_modslam"
            entry, seq = entry_points_phase(dev, work, sites)
            site_tables["cli_modslam"] = _site_table(sites)
            lba_cap.run = orb_cap.run = None
            print(f"phase 7 (entry points) {time.perf_counter() - t0:.1f} s")
        row = kernel_case(CLI_CASE, mask_case("_project_match_pnp",
                                              sites.captured["_project_match_pnp"]),
                          card, popc_rate)
        rows.append(row)
        max_err = max(max_err, row["max_abs_err"])
        t0 = time.perf_counter()
        pair_cap.run = "repeat_resume"
        repeat = repeatability_phase(seq, work)
        print(f"phase 8 (repeatability and resume) {time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(work, ignore_errors=True)

    t0 = time.perf_counter()
    kf_cap.run = "direct_pipelined"
    pipe_direct = pipelined_direct_phase(cam, traj, frames, direct)
    kf_cap.__exit__()
    print(f"phase 9 (pipelined direct) {time.perf_counter() - t0:.1f} s")
    staged = {}
    with CallSites() as sites:
        for mode in ("pipelined", "staged"):
            t0 = time.perf_counter()
            lba_cap.run = pair_cap.run = f"hybrid_{mode}"
            staged[mode] = staged_hybrid_phase(cam, traj, frames, sites, mode)
            site_tables[f"hybrid_{mode}"] = _site_table(sites)
            lba_cap.run = None
            print(f"phase 10 (hybrid {mode}) {time.perf_counter() - t0:.1f} s")
            if mode == "pipelined":
                require("_map_projection_match" in sites.captured,
                        "no staged-tick match_projection captured")
                row = kernel_case(STAGED_CASE, mask_case("_map_projection_match",
                                                         sites.captured["_map_projection_match"]),
                                  card,
                                  popc_rate)
                rows.append(row)
                max_err = max(max_err, row["max_abs_err"])
    t0 = time.perf_counter()
    pair_cap.run = "calib"
    calib = calib_phase(cam, traj, frames)
    print(f"phase 11 (calib SLAM, depth prior) {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    lba_cap.run = pair_cap.run = "sharded_hybrid"
    sharded = sharded_phase(cam, traj, frames, direct_snap, hybrid_snap)
    lba_cap.__exit__()
    pair_cap.__exit__()
    ratio, row = match_ratio_phase(frames, card, popc_rate)
    orb_cap.__exit__()
    rows.append(row)
    max_err = max(max_err, row["max_abs_err"])
    print(f"phase 12 (sharded BA, match_ratio) {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    t_rows, p_rows, lm_public = lm_phase(cap, card)
    print(f"phase 13 (LM kernels) {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    _, ba_public = ba_phase(ba_cap, mixed_cap, card)
    print(f"phase 14 (BA kernels) {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    trace_public, trace_timing = trace_phase(trace_cap, card)
    print(f"phase 15 (tracer kernel) {time.perf_counter() - t0:.1f} s")

    if opts.save_local_ba:
        save_local_ba_calls(opts.save_local_ba, [
            (run, prob, cam_, _stage_iters(args, kw)) for run in LOCAL_BA_RUNS
            for prob, cam_, args, kw in lba_cap.calls.get(run, [])])
    t0 = time.perf_counter()
    lba_public, lba_timing = local_ba_phase(lba_cap, card)
    print(f"phase 16 (local BA kernel) {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    orb_public, orb_timings = orb_phase(orb_cap, card)
    print(f"phase 17 (ORB kernels) {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    tri_public, tri_timing = tri_phase(pair_cap, site_tables, card, popc_rate, opts.save_tri)
    print(f"phase 18 (pair tests in the Hamming kernel, triangulation) "
          f"{time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    kf_public, kf_times = kf_phase(kf_cap, card)
    print(f"phase 19 (direct keyframe programs) {time.perf_counter() - t0:.1f} s")

    main_row = next(r for r in rows if r["case"] == PHASE4_CASE)
    cli_row = next(r for r in rows if r["case"] == CLI_CASE)
    staged_row = next(r for r in rows if r["case"] == STAGED_CASE)
    ratio_row = next(r for r in rows if r["case"] == RATIO_CASE)
    # each Hamming entry point's launches by path (the mask modes: the
    # bootstrap's match_window, relocalization's match_descriptors,
    # match_ratio; the pair tests: the projection and epipolar matches)
    paths = {"hybrid": full["lm_launches"], "cli_modslam": entry["lm_launches"],
             "repeat_resume_hybrid": repeat["hybrid"]["lm_launches"],
             "hybrid_pipelined": staged["pipelined"]["lm_launches"],
             "hybrid_staged": staged["staged"]["lm_launches"],
             "calib_slam": calib["lm_launches"],
             "sharded_hybrid": sharded["hybrid"]["lm_launches"],
             "hybrid_tracking": hyb["lm_launches"], "relocalization": reloc["lm_launches"]}
    by_path = {k: v["hamming_resolve"] for k, v in paths.items() if v["hamming_resolve"]}
    by_path["match_ratio"] = ratio["launches"]
    kernels = [{
        "name": "hamming_resolve",
        "route": "cuda",
        "source": "libcml_tpu_torch/csrc/hamming_match.cu",
        "replaces": "libcml_tpu/ops/pallas_match.py:107",
        "launches": sum(by_path.values()),
        "launches_by_path": by_path,
        "launches_per_hybrid_frame": full["lm_launches"]["hamming_resolve"] / full["frames"],
        "max_abs_err": max_err,
        "ms": main_row["kernel_ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": None,
        "case_4096x2400": {k: cli_row[k] for k in ("kernel_ms", "kernel_warm_ms", "plain_ms",
                                                   "bound_ms", "bound_by", "bound_share",
                                                   "live_entries")},
        "case_staged_tick": {k: staged_row[k] for k in ("kernel_ms", "kernel_warm_ms",
                                                        "plain_ms", "bound_ms", "bound_by",
                                                        "bound_share", "live_entries",
                                                        "max_abs_err")},
        "case_match_ratio": {k: ratio_row[k] for k in ("kernel_ms", "kernel_warm_ms", "plain_ms",
                                                       "bound_ms", "bound_by", "bound_share",
                                                       "live_entries", "max_abs_err")},
        "launches_per_site": {m: staged[m]["launches_per_site"] for m in staged},
    }]
    runs = {"direct": direct["kernel_launches"], "hybrid": full["lm_launches"],
            "relocalization": reloc["lm_launches"], "cli_modslam": entry["lm_launches"],
            "repeat_resume_hybrid": repeat["hybrid"]["lm_launches"],
            "repeat_resume_direct": repeat["direct"]["lm_launches"],
            "direct_pipelined": pipe_direct["lm_launches"],
            "hybrid_pipelined": staged["pipelined"]["lm_launches"],
            "hybrid_staged": staged["staged"]["lm_launches"],
            "calib_slam": calib["lm_launches"],
            "sharded_direct": sharded["direct"]["lm_launches"],
            "sharded_hybrid": sharded["hybrid"]["lm_launches"]}
    keys = ("kernel_ms", "kernel_warm_ms", "us_per_step", "plain_ms", "bound_ms", "bound_by",
            "bound_share", "launches_per_call", "max_abs_err")
    for name, source, replaces, rows in (
            ("track_lm", "libcml_tpu_torch/csrc/track_lm.cu",
             "libcml_tpu/models/direct/tracker.py:118", t_rows),
            ("pnp_lm", "libcml_tpu_torch/csrc/pnp_lm.cu",
             "libcml_tpu/models/indirect/pnp.py:64", p_rows)):
        by_path = {k: v[name] for k, v in runs.items() if v[name]}
        if name == "pnp_lm":
            by_path["hybrid_tracking"] = hyb["lm_launches"]["pnp_lm"]
        main_row = rows[0]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": main_row["kernel_ms"], "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
            "library_ms": None, "us_per_step": main_row["us_per_step"],
            "cluster": lm_public["cluster"][name],
            "cases": {r["case"]: {k: r[k] for k in keys} for r in rows}})
    timing = ba_public["timing"]
    for name, replaces, t in (
            ("ba_sweep", "libcml_tpu/models/direct/ba.py:317", timing["ba_sweep"]),
            ("ba_solve", "libcml_tpu/models/direct/ba.py:532", timing["ba_solve"]),
            ("ba_run", "libcml_tpu/models/direct/ba.py:619", timing["run_ba"])):
        by_path = {k: v[name] for k, v in runs.items() if v[name]}
        row = {
            "name": name, "route": "cuda", "source": f"libcml_tpu_torch/csrc/{name}.cu",
            "replaces": replaces, "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": ba_public["max_abs_err"][name], "ms": t["kernel_ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "kernel_warm_ms": t["kernel_warm_ms"], "bound_share": t["bound_share"]}
        if name == "ba_sweep":
            row.update({k: t[k] for k in ("energy_ms", "energy_warm_ms", "energy_bound_ms",
                                          "energy_bound_share")})
        row["launches_per_run_ba_mixed"] = ba_public["launches_per_run_ba_mixed"][name]
        row["launches_per_run_ba_mixed_mesh"] = ba_public["launches_per_run_ba_mixed_mesh"][name]
        if name != "ba_run":
            row["launches_per_run_ba_mesh"] = ba_public["launches_per_run_ba_mesh"][name]
        else:
            row["case_run_ba_mixed"] = {k: timing["run_ba_mixed"][k] for k in (
                "kernel_ms", "kernel_warm_ms", "plain_ms", "bound_ms", "bound_by",
                "bound_share", "library_ms", "launches_per_call", "device_ops_per_call")}
        kernels.append(row)
    by_path = {k: v["trace_epipolar"] for k, v in runs.items() if v["trace_epipolar"]}
    t = trace_timing
    kernels.append({
        "name": "trace_epipolar", "route": "cuda",
        "source": "libcml_tpu_torch/csrc/trace_epipolar.cu",
        "replaces": "libcml_tpu/models/direct/tracer.py:185",
        "launches": sum(by_path.values()), "launches_by_path": by_path,
        "max_abs_err": trace_public["max_abs_err"],
        "ms": t["kernel_ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": None, "kernel_warm_ms": t["kernel_warm_ms"],
        "bound_share": t["bound_share"], "floor_ms": t["floor_ms"],
        "floor_warm_ms": t["floor_warm_ms"], "edge_points": trace_public["edge_points"]})
    by_path = {k: v["local_ba"] for k, v in runs.items() if v["local_ba"]}
    for run in LOCAL_BA_RUNS:   # each captured call was one launch of its run
        require(len(lba_cap.calls.get(run, [])) == by_path.get(run, 0),
                f"{run}: {len(lba_cap.calls.get(run, []))} run_local_ba calls, "
                f"{by_path.get(run, 0)} local_ba launches")
    t = lba_timing
    kernels.append({
        "name": "local_ba", "route": "cuda", "source": "libcml_tpu_torch/csrc/local_ba.cu",
        "replaces": "libcml_tpu/models/indirect/indirect_ba.py:188",
        "launches": sum(by_path.values()), "launches_by_path": by_path,
        "max_abs_err": lba_public["max_abs_err"],
        "ms": t["kernel_ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": None, "kernel_warm_ms": t["kernel_warm_ms"],
        "bound_share": t["bound_share"], "floor_ms": t["floor_ms"],
        "floor_warm_ms": t["floor_warm_ms"], "edge_obs": lba_public["edge_obs"],
        "decisions_differing": lba_public["decisions_differing"],
        # max_abs_err is the kernel against the plain form; with one fixed
        # frame the plain form drifts from float64 far more than the kernel
        "max_kernel_vs_f64": lba_public["max_kernel_vs_f64"],
        "max_plain_vs_f64": lba_public["max_plain_vs_f64"]})
    by_path = {k: v["orb_extract"] for k, v in runs.items() if v["orb_extract"]}
    by_path["hybrid_tracking"] = hyb["orb_launches"]
    t = orb_timings["512"]
    kernels.append({
        "name": "orb_extract", "route": "cuda", "source": "libcml_tpu_torch/csrc/orb_extract.cu",
        "replaces": "libcml_tpu/models/indirect/orb.py:137",
        "launches": sum(by_path.values()), "launches_by_path": by_path,
        "max_abs_err": orb_public["max_abs_err"],
        "ms": t["kernel_ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": None, "kernel_warm_ms": t["kernel_warm_ms"],
        "bound_share": t["bound_share"], "floor_ms": t["floor_ms"],
        "floor_warm_ms": t["floor_warm_ms"], "launches_per_call": t["launches_per_call"],
        "stage_ms": t["stage_ms"], "digest": orb_public["digest"],
        "case_budget_800": {k: orb_timings["800"][k] for k in (
            "kernel_ms", "kernel_warm_ms", "stage_ms", "plain_ms", "bound_ms", "bound_by",
            "bound_share")},
        "nms_flips": orb_public["nms_flips"], "bits_at_edge": orb_public["bits_at_edge"]})
    for name, replaces, program in (
            ("hamming_projection", "libcml_tpu/ops/pallas_match.py:107",
             "libcml_tpu/models/indirect/matching.py:185 match_projection"),
            ("hamming_epipolar", "libcml_tpu/ops/pallas_match.py:107",
             "libcml_tpu/models/indirect/matching.py:223 match_epipolar"),
            ("triangulate", "libcml_tpu/runtime/hybrid.py:195",
             "libcml_tpu/runtime/hybrid.py:195 _epipolar_triangulate after its match")):
        by_path = {k: v[name] for k, v in paths.items() if v[name]}
        t = tri_timing[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "libcml_tpu_torch/csrc/"
                      + ("triangulate.cu" if name == "triangulate" else "hamming_match.cu"),
            "replaces": replaces, "program": program,
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "launches_per_hybrid_frame": full["lm_launches"][name] / full["frames"],
            "max_abs_err": tri_public["max_abs_err"][name],
            "ms": t["kernel_ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None, "kernel_warm_ms": t["kernel_warm_ms"],
            "bound_share": t["bound_share"], "floor_ms": t["floor_ms"],
            "floor_warm_ms": t["floor_warm_ms"], "launches_per_call": t["launches_per_call"],
            "N": t["N"]})
    kernels[-1]["epipolar_triangulate"] = tri_timing["epipolar_triangulate"]
    for name, program, source, replaces in (
            ("kf_activate", "_activate_and_clear", "kf_activate.cu",
             "libcml_tpu/runtime/odometry.py:444"),
            ("kf_refresh", "_refresh_after_kf", "kf_refresh.cu",
             "libcml_tpu/runtime/odometry.py:461")):
        by_path = {k: v[name] for k, v in runs.items() if v[name]}
        t = kf_times[program]
        kernels.append({
            "name": name, "route": "cuda", "source": "libcml_tpu_torch/csrc/" + source,
            "replaces": replaces, "program": f"{replaces} {program}",
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "launches_per_direct_frame": direct["kernel_launches"][name] / direct["frames"],
            "max_abs_err": kf_public["max_abs_err"],
            "ms": t["kernel_ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None, "kernel_warm_ms": t["kernel_warm_ms"],
            "bound_share": t["bound_share"], "floor_ms": t["floor_ms"],
            "floor_warm_ms": t["floor_warm_ms"], "launches_per_call": t["launches_per_call"],
            "edge_points": kf_public["edge_points"]})
    print(json.dumps({"direct": direct, "hybrid_tracking": hyb, "hybrid": full,
                      "relocalization": reloc, "entry_points": entry,
                      "repeatability": repeat, "pipelined_direct": pipe_direct,
                      "hybrid_pipelined": staged["pipelined"],
                      "hybrid_staged": staged["staged"], "calib": calib,
                      "sharded": sharded, "match_ratio": ratio, "lm_public": lm_public,
                      "ba_public": ba_public, "trace_public": trace_public,
                      "local_ba_public": lba_public, "orb_public": orb_public,
                      "tri_public": tri_public, "kf_public": kf_public}))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
