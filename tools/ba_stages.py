"""Stage times of the window BA's kernels, and this tree's BA kernels against
another tree's, on one card.

    python3 tools/ba_stages.py [--parent DIR] [--frames 60] [--reps 20] [--out FILE]

Captures every `run_ba` call of DirectOdometry on the smoke's frames
(libcml_tpu_torch/workload.py: 640x480, bench.py's configuration) and keeps
the last window (the fullest: 7 keyframes). Then, for each build, this
tree's kernels (`tree`) and those of another tree (`--parent`: a parent
commit unpacked with `git archive` into a git-ignored directory; its
ops/ba_sweep.py and models/direct/ba.py are loaded from there under other
module names, so each build runs its own wrappers on its own csrc/):

- parity: the build's `run_ba` against `run_ba_plain` on the window
  (chip_smoke.ba_parity) and the system sweep's H - H_corr against float64
  from the same state (chip_smoke.partials_measure);
- stages: a throwaway copy of the build's BA sources, written under
  libcml_tpu_torch/_build/ba_stages/, in which thread 0 of every block
  records clock64() and %globaltimer at each stage boundary; for every
  stage, over `--reps` launches, the median of the time at which the last
  block passed it, from the first block's start (globaltimer, us), and the
  median of block 0's cycles since its previous stamp. The shipped sources
  carry no switch for this: they mark their stage boundaries with
  `// stage: NAME` comments, and each becomes a stamp. A tree whose sources
  carry no marks is timed but not staged;
- times: cold and warm device ms (chip_smoke.cuda_ms, median of 30) of a
  `run_ba`, a system sweep, an energy sweep and a solve, the builds in
  turns (each in order, then in reverse).

One JSON line a build and stage set, then the times; all of it also in
--out.

    python3 tools/ba_stages.py --orb [--parent DIR] [--reps 20] [--out FILE]

--orb takes the ORB call instead (ops/orb_extract.py orb_extract_cuda, which
the hybrid's extract_orb launches on the card) at budgets 512, 800 and 2000
(presets/orb2000.yaml), 3 levels, threshold 12, on two 640x480 pyramids:
the smoke's second frame (`frame`: few corners, so each level's cut falls
among the zero scores) and uniform noise in [0, 255) from a seed (`noise`:
a corner in nearly every cell, so the selection ranks thousands of nonzero
scores). For each input, budget and build: the sha256 of its six outputs
(equal across builds where the kernels agree bit for bit) and its stage
stamps (its `// stage: NAME` marks in csrc/orb_extract.cu, as
chip_smoke.py phase 17 prints them for this tree); then the builds' cold
and warm device ms in turns (each in order, then in reverse). Needs one
CUDA card; no JAX.

    python3 tools/ba_stages.py --pairs [--parent DIR] [--frames 60] [--reps 20] [--out FILE]

--pairs takes the pair-test modes of the Hamming kernel and the
triangulation kernel instead (ops/hamming_match.py match_projection_cuda and
match_epipolar_cuda, ops/triangulate.py triangulate_cuda) on real calls:
every match_projection and _epipolar_triangulate call of the smoke's
hybrid-tracking frames and of the full hybrid over its first `--frames`
frames (chip_smoke.PairCapture, as phases 4 and 5 make them). For each
build: the sha256 of every call's outputs by kernel (chip_smoke.pair_digest:
equal across builds where the kernels agree bit for bit) and the first call
that differs; its triangulations under triangulate.tri_parity against the
golden-section model, float64 and the plain form (tri_readings); the stage
stamps (`// stage: NAME` marks in csrc/hamming_match.cu and
csrc/triangulate.cu; a tree whose sources have none, such as commit
58485b9's, gets them at fixed lines, UNMARKED_PAIR_MARKS) of the projection
match at phase 4's first call, the epipolar match at phase 5's first
keyframe and the triangulation after it; then cold and warm device ms of
those three in turns.

    python3 tools/ba_stages.py --kf [--parent DIR] [--frames 60] [--reps 20] [--out FILE]

--kf takes the direct path's keyframe kernels instead (ops/kf_programs.py:
csrc/kf_activate.cu and csrc/kf_refresh.cu) on real calls: every call of the
keyframe programs and their pieces that DirectOdometry makes on the smoke's
first `--frames` frames (chip_smoke.KfCapture, as phase 3 makes them: 640x480,
P 2,048, F 7, K 512, 300 regions, 1,036 cells of side 17). For each build:
one sha256 of every captured call's outputs by program (equal across builds
where the kernels agree bit for bit) and the first call that differs; the
stage stamps (`// stage:` marks; those a source lacks, such as commit
cb7cc16's `candidates` and `ticket`, are put in at fixed lines, KF_MARKS) of the
activation that writes the most points, the first refresh and each of the
refresh's pieces alone on that refresh's inputs (its stage mask: A the
window's reference, A of given points, B the range, C the selection, D the
seed); then the cold and warm device ms of all of them in turns beside the
launch floor.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import hashlib
import importlib.util
import inspect
import json
import re
import shutil
import statistics
import sys
from collections import Counter
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from libcml_tpu_torch import workload as wl  # noqa: E402
from libcml_tpu_torch.models.direct import ba as tree_ba  # noqa: E402
from libcml_tpu_torch.ops import ba_sweep as tree_bk  # noqa: E402
from libcml_tpu_torch.ops import kernel_build as kb  # noqa: E402
from libcml_tpu_torch.models.indirect.triangulation import fundamental  # noqa: E402
from libcml_tpu_torch.ops import hamming_match as tree_hm  # noqa: E402
from libcml_tpu_torch.ops import kf_programs as tree_kfp  # noqa: E402
from libcml_tpu_torch.ops import orb_extract as tree_oe  # noqa: E402
from libcml_tpu_torch.ops import triangulate as tree_tr  # noqa: E402
from libcml_tpu_torch.ops.image import build_pyramid  # noqa: E402
from libcml_tpu_torch.runtime import odometry  # noqa: E402
from libcml_tpu_torch.runtime.odometry import DirectOdometry  # noqa: E402
from libcml_tpu_torch.models.direct import selector, tracer  # noqa: E402
from libcml_tpu_torch.models.direct import window as win_mod  # noqa: E402
from libcml_tpu_torch.core.lie import SE3  # noqa: E402

# MAXB: blocks whose stamps the tables hold (the ORB kernel's cell pass has
# 1,570 blocks at 640x480)
MAXB, NSTAGE = 2048, 64
STAMP_HEAD = f"""// stage stamps (tools/ba_stages.py; a throwaway copy, never shipped)
#include <cuda_runtime.h>
__device__ unsigned long long ba_stage_cycles[{MAXB}][{NSTAGE}];
__device__ unsigned long long ba_stage_ns[{MAXB}][{NSTAGE}];
__device__ __forceinline__ void ba_stage(int k) {{
  if (threadIdx.x == 0 && blockIdx.x < {MAXB} && k < {NSTAGE}) {{
    unsigned long long g;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g));
    ba_stage_cycles[blockIdx.x][k] = (unsigned long long)clock64();
    ba_stage_ns[blockIdx.x][k] = g;
  }}
}}
"""
STAMP_TAIL = """
extern "C" int ba_stage_read(void* cycles, void* ns) {
  cudaError_t e = cudaDeviceSynchronize();
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(cycles, ba_stage_cycles, sizeof(ba_stage_cycles));
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(ns, ba_stage_ns, sizeof(ba_stage_ns));
  return (int)e;
}
extern "C" int ba_stage_clear() {
  void* p = nullptr;
  cudaError_t e = cudaGetSymbolAddress(&p, ba_stage_cycles);
  if (e == cudaSuccess) e = cudaMemset(p, 0, sizeof(ba_stage_cycles));
  if (e == cudaSuccess) e = cudaGetSymbolAddress(&p, ba_stage_ns);
  if (e == cudaSuccess) e = cudaMemset(p, 0, sizeof(ba_stage_ns));
  if (e == cudaSuccess) e = cudaDeviceSynchronize();
  return (int)e;
}
"""
MARK = re.compile(r"^(\s*)// stage: (\S+)\s*$", re.M)


def _load_module(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod   # dataclasses look their module up there
    spec.loader.exec_module(mod)
    return mod


class Build:
    """The BA kernels of one tree: its wrapper module `bk` and its
    models/direct/ba.py `ba` (for another tree, loaded from its files with
    `bk` pointed at its own wrappers); inside `sources(dir)`, the wrappers
    launch the libraries built from the sources in `dir`."""

    FIELDS = ("SWEEP_SOURCE", "SOLVE_SOURCE", "RUN_SOURCE")

    def __init__(self, name: str, tree: Path | None = None):
        self.name = name
        if tree is None:
            self.bk, self.ba, self.csrc = tree_bk, tree_ba, kb.CSRC
        else:
            pkg = tree / "libcml_tpu_torch"
            self.csrc = pkg / "csrc"
            self.bk = _load_module(f"_ba_sweep_{name}", pkg / "ops" / "ba_sweep.py")
            for f in self.FIELDS:
                if hasattr(self.bk, f):
                    setattr(self.bk, f, self.csrc / getattr(self.bk, f).name)
            self.ba = _load_module(f"_ba_{name}", pkg / "models" / "direct" / "ba.py")
            self.ba.bk = self.bk

    @contextlib.contextmanager
    def sources(self, csrc: Path):
        before = {f: getattr(self.bk, f) for f in self.FIELDS if hasattr(self.bk, f)}
        for f, p in before.items():
            setattr(self.bk, f, csrc / p.name)
        try:
            yield
        finally:
            for f, p in before.items():
                setattr(self.bk, f, p)


class OrbBuild:
    """The ORB kernel of one tree: its wrapper module `oe` (for another
    tree, its ops/orb_extract.py loaded from its files and pointed at its own
    csrc/); inside `sources(dir)`, the wrapper launches the library built
    from the source in `dir`."""

    def __init__(self, name: str, tree: Path | None = None):
        self.name = name
        if tree is None:
            self.oe, self.csrc = tree_oe, kb.CSRC
        else:
            pkg = tree / "libcml_tpu_torch"
            self.csrc = pkg / "csrc"
            self.oe = _load_module(f"_orb_extract_{name}", pkg / "ops" / "orb_extract.py")
            self.oe.SOURCE = self.csrc / self.oe.SOURCE.name

    @contextlib.contextmanager
    def sources(self, csrc: Path):
        before = self.oe.SOURCE
        self.oe.SOURCE = csrc / before.name
        try:
            yield
        finally:
            self.oe.SOURCE = before


def instrument(build: Build | OrbBuild, out_dir: Path, prefix: str | tuple = "ba_", head: str = STAMP_HEAD,
               tail: str = STAMP_TAIL, edit=None) -> tuple[Path, list[str]]:
    """A copy of the build's csrc/ in `out_dir` with stage stamps in its
    sources whose names start with `prefix` (the BA sources by default; a
    tuple of prefixes too): each `// stage: NAME` mark becomes
    `ba_stage(k)`, one k a name, and each .cu source takes `head` (which
    defines ba_stage) before its text and `tail` after it. `edit(name,
    text)`, when given, first rewrites each such source (to add marks).
    Returns (the copy, the stage names by stamp index)."""
    if out_dir.exists():
        shutil.rmtree(out_dir)
    shutil.copytree(build.csrc, out_dir)
    files = sorted(p.name for p in out_dir.iterdir()
                   if p.name.startswith(prefix) and p.suffix in (".cu", ".cuh"))
    index: dict[str, int] = {}

    def sub(m):
        k = index.setdefault(m.group(2), len(index))
        return f"{m.group(1)}ba_stage({k});"

    for f in files:
        path = out_dir / f
        text = path.read_text()
        text = MARK.sub(sub, edit(f, text) if edit else text)
        if f.endswith(".cu"):
            text = head + text + tail
        path.write_text(text)
    return out_dir, sorted(index, key=index.get)


def read_stamps(lib) -> tuple[np.ndarray, np.ndarray]:
    cyc = np.zeros((MAXB, NSTAGE), np.uint64)
    ns = np.zeros((MAXB, NSTAGE), np.uint64)
    err = lib.ba_stage_read(cyc.ctypes.data, ns.ctypes.data)
    if err != 0:
        raise RuntimeError(f"ba_stage_read: CUDA error {err}")
    return cyc.astype(np.int64), ns.astype(np.int64)


def stage_report(build: Build, copy: Path, stages: list[str], calls: dict, reps: int) -> dict:
    """For each named call, each stage in the order the blocks pass them:
    the median over `reps` launches of the time (us, globaltimer) at which
    the last block passed it since the first block's first stamp (and the
    same of the first block to pass it), the
    median over blocks and launches of a block's time (us) and cycles
    (clock64) from its previous stamp, and the blocks that passed it."""
    out = {}
    with build.sources(copy):
        for name, (fn, source) in calls.items():
            lib = kb.load(copy / source, "ba_stage_clear", [])
            lib.ba_stage_read.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
            lib.ba_stage_read.restype = ctypes.c_int
            fn()
            torch.cuda.synchronize()
            timeline, firsts, own_ns, own_cyc, blocks = [], [], {}, {}, {}
            for _ in range(reps):
                if lib.ba_stage_clear() != 0:
                    raise RuntimeError("ba_stage_clear failed")
                fn()
                torch.cuda.synchronize()
                cyc, ns = read_stamps(lib)
                hit = ns > 0
                t0 = ns[hit].min()
                timeline.append({stages[k]: float((ns[:, k][hit[:, k]].max() - t0) / 1e3)
                                 for k in range(len(stages)) if hit[:, k].any()})
                firsts.append({stages[k]: float((ns[:, k][hit[:, k]].min() - t0) / 1e3)
                               for k in range(len(stages)) if hit[:, k].any()})
                for b in np.flatnonzero(hit.any(axis=1)):
                    ks = sorted(np.flatnonzero(hit[b]), key=lambda k: ns[b, k])
                    for prev, k in zip(ks[:-1], ks[1:]):
                        own_ns.setdefault(stages[k], []).append((ns[b, k] - ns[b, prev]) / 1e3)
                        own_cyc.setdefault(stages[k], []).append(int(cyc[b, k] - cyc[b, prev]))
                for k in range(len(stages)):
                    if hit[:, k].any():
                        blocks[stages[k]] = int(hit[:, k].sum())
            done = {n: statistics.median(r[n] for r in timeline if n in r) for n in blocks}
            order = sorted(done, key=done.get)
            total = done[order[-1]]
            rows, last = {}, 0.0
            for n in order:
                rows[n] = {"first_at_us": statistics.median(r[n] for r in firsts if n in r),
                           "done_at_us": done[n], "step_us": done[n] - last,
                           "share": (done[n] - last) / total if total > 0 else None,
                           "block_us": statistics.median(own_ns[n]) if n in own_ns else None,
                           "block_cycles": statistics.median(own_cyc[n]) if n in own_cyc
                           else None, "blocks": blocks[n]}
                last = done[n]
            out[name] = {"total_us": total, "stages": rows}
    return out


def orb_stamps(build: OrbBuild, pyr, budget: int, threshold: float, reps: int) -> dict | None:
    """The build's ORB stage stamps on one call (stage_report over `reps`
    calls of a copy of its csrc/ with its `// stage:` marks made stamps),
    with, before a launch's first mark (a name ending in `_start`), the gap
    from the last block's last stamp before it; None where the source has
    no marks."""
    copy, stages = instrument(build, kb.BUILD_DIR / "orb_stages" / build.name, prefix="orb_")
    if not stages:
        return None
    kb.build_many([copy / build.oe.SOURCE.name])
    call = (lambda: build.oe.orb_extract_cuda(pyr, budget, threshold), build.oe.SOURCE.name)
    rep = stage_report(build, copy, stages, {"call": call}, reps)["call"]
    prev = None
    for stage, row in rep["stages"].items():
        if stage.endswith("_start") and prev is not None:
            row["gap_us"] = row["first_at_us"] - rep["stages"][prev]["done_at_us"]
        prev = stage
    return {**rep, "blocks_held": MAXB}


def orb_main(a, dev, card: str) -> dict:
    """--orb: the ORB call of each build on each input at each budget."""
    builds = [OrbBuild("tree")] + ([OrbBuild("parent", a.parent.resolve())] if a.parent else [])
    kb.build_many([b.oe.SOURCE for b in builds], verbose=True)
    _, _, frames = wl.render_frames(dev, 2)
    noise = np.random.default_rng(0).uniform(0.0, 255.0, (wl.H, wl.W)).astype(np.float32)
    inputs = {"frame": build_pyramid(frames[1][0], wl.ORB_LEVELS),
              "noise": build_pyramid(torch.from_numpy(noise).to(dev), wl.ORB_LEVELS)}
    threshold, budgets = 12.0, (512, 800, 2000)
    out = {"card": card, "builds": {}}
    for b in builds:
        for name, pyr in inputs.items():
            for budget in budgets:
                got = b.oe.orb_extract_cuda(pyr, budget, threshold)
                h = hashlib.sha256()
                for f in ("uv", "level", "angle", "score", "desc", "valid"):
                    h.update(getattr(got, f).contiguous().cpu().numpy().tobytes())
                row = {"digest": h.hexdigest(), "valid": int(got.valid.sum()),
                       "stamps": orb_stamps(b, pyr, budget, threshold, a.reps)}
                out["builds"].setdefault(b.name, {}).setdefault(name, {})[budget] = row
                print(json.dumps({"build": b.name, "input": name, "budget": budget, **row,
                                  "card": card}), flush=True)
    times = {name: {budget: {b.name: {"cold": [], "warm": []} for b in builds}
                    for budget in budgets} for name in inputs}
    for b in builds + builds[::-1]:
        for name, pyr in inputs.items():
            for budget in budgets:
                def call(b=b, pyr=pyr, budget=budget):
                    b.oe.orb_extract_cuda(pyr, budget, threshold)
                times[name][budget][b.name]["cold"].append(cs.cuda_ms(call))
                times[name][budget][b.name]["warm"].append(cs.cuda_ms(call, cold=False))
    out["ms"] = times
    print(json.dumps({"ms": times, "card": card}), flush=True)
    return out


class PairBuild:
    """The pair-test Hamming kernel and the triangulation kernel of one tree:
    its wrapper modules `hm` and `tr` (for another tree, its
    ops/hamming_match.py and ops/triangulate.py loaded from its files, `tr`
    pointed at that `hm`, both at its own csrc/); inside `sources(dir)`, the
    wrappers launch the libraries built from the sources in `dir`."""

    def __init__(self, name: str, tree: Path | None = None):
        self.name = name
        if tree is None:
            self.hm, self.tr, self.csrc = tree_hm, tree_tr, kb.CSRC
        else:
            pkg = tree / "libcml_tpu_torch"
            self.csrc = pkg / "csrc"
            self.hm = _load_module(f"_hamming_match_{name}", pkg / "ops" / "hamming_match.py")
            self.tr = _load_module(f"_triangulate_{name}", pkg / "ops" / "triangulate.py")
            self.tr.hm = self.hm
            for mod in (self.hm, self.tr):
                mod.SOURCE = self.csrc / mod.SOURCE.name

    @contextlib.contextmanager
    def sources(self, csrc: Path):
        before = self.hm.SOURCE, self.tr.SOURCE
        self.hm.SOURCE, self.tr.SOURCE = (csrc / p.name for p in before)
        try:
            yield
        finally:
            self.hm.SOURCE, self.tr.SOURCE = before


# The pair-test and triangulation sources before their redesign (commit
# 58485b9) carry no `// stage:` marks: each (anchor, name, indent,
# occurrence) puts one after the `occurrence`-th line run that reads
# `anchor`, where the redesign's stages begin and end in that code
UNMARKED_PAIR_MARKS = {
    "hamming_match.cu": (
        ("void pred_unit(const Args& a, PredSmem& s, int group, int chunk, int c0, int c1) {",
         "pair_start", 2, 1),
        ("  if (MODE == MODE_EPI && threadIdx.x == 0) epi_geometry(a, s.F);\n  __syncthreads();",
         "pair_zero_geometry", 2, 1),
        ("      live = proj_row(a, row, chunk == 0 && lane == 0, rt);\n  }\n"
         "  if (!__syncthreads_or(live)) {               // every row masked: stage nothing\n"
         "    if (in && lane == 0) emit_row(a, chunk, row, empty());\n    return;\n  }",
         "pair_row_test", 2, 1),
        ("    if constexpr (MODE == MODE_PROJ) s.lev[c] = __ldg(a.level_t + c0 + c);\n  }\n"
         "  __syncthreads();", "pair_staging", 2, 1),
        ("      if (p) queue[queued + __popc(bits & ((1u << lane) - 1u))] = (uint16_t)c;\n"
         "      queued += n;\n    }", "pair_ballots", 4, 1),
        ("    if (queued) drain();\n    b = warp_merge(b);\n    if (lane == 0) emit_row(a, chunk,"
         " row, b);", "pair_drains", 4, 2),
        ("    if (key < COL_INIT) atomicMin(&a.col_best[c0 + c], key);\n  }", "pair_col_atomics",
         2, 2),
        ("    *a.num = total;\n    a.tickets[a.groups + a.chunks] = 0;\n  }", "finish", 2, 1),
        ("  const unsigned int l = last;", "tickets", 2, 1),
        ("    if (threadIdx.x == 0) a.tickets[group] = 0;", "row_merge", 4, 1),
        ("    if (threadIdx.x == 0) a.tickets[a.groups + chunk] = 0;", "col_unpack", 4, 1)),
    "triangulate.cu": (
        ("__global__ void __launch_bounds__(TPB) triangulate_kernel(const TriArgs a) {",
         "tri_start", 2, 1),
        ("    for (int k = 0; k < KEEP; ++k) keep[k] = hist[top[k]] >= floor10 ? top[k] : -1;\n"
         "  }\n  __syncthreads();", "tri_histogram", 2, 1),
        ("  const Pencil p{Fpp[4], Fpp[5], Fpp[7], Fpp[8], e0[2], e1[2]};", "tri_epipoles", 2, 1),
        ("      best = i;\n    }\n  }", "tri_grid", 2, 1),
        ("    else\n      lo = m1;\n  }", "tri_golden", 2, 1),
        ("  a.ok[i] = a.valid[i] && in_top && tri_ok && depth_ok;", "tri_dlt", 2, 1)),
}


def add_unmarked_pair_marks(name: str, text: str) -> str:
    """UNMARKED_PAIR_MARKS put into a source that has no `// stage:` mark."""
    if MARK.search(text) or name not in UNMARKED_PAIR_MARKS:
        return text
    for anchor, mark, indent, occurrence in UNMARKED_PAIR_MARKS[name]:
        i = -1
        for _ in range(occurrence):
            i = text.index(anchor, i + 1)
        j = text.index("\n", i + len(anchor) - 1) + 1
        text = text[:j] + " " * indent + f"// stage: {mark}\n" + text[j:]
    return text


def pair_stamps(build: PairBuild, calls: dict, reps: int) -> dict | None:
    """The build's stage stamps on each named call (stage_report over `reps`
    calls of a copy of its csrc/ with its `// stage:` marks made stamps),
    None where its sources have no marks. `calls`: name -> (fn(build),
    source name)."""
    copy, stages = instrument(build, kb.BUILD_DIR / "pair_stages" / build.name,
                              prefix=("hamming_", "triangulate"), edit=add_unmarked_pair_marks)
    if not stages:
        return None
    kb.build_many([copy / build.hm.SOURCE.name, copy / build.tr.SOURCE.name])
    named = {n: (lambda fn=fn: fn(build), src) for n, (fn, src) in calls.items()}
    return {**stage_report(build, copy, stages, named, reps), "blocks_held": MAXB}


def capture_pairs(dev, frames: int):
    """Every match_projection and _epipolar_triangulate call (cloned
    arguments, chip_smoke.PairCapture) of the smoke's hybrid-tracking frames
    (phase 4) and of the full hybrid over its first `frames` frames (phase
    5), with phase 4's projection inputs."""
    cam, traj, imgs = wl.render_frames(dev, max(frames, max(cs.HYBRID_FRAMES) + 1))
    with cs.PairCapture() as cap:
        cap.run = "hybrid_tracking"
        cs.hybrid_phase(dev, cam, traj, imgs)
        cap.run = "hybrid"
        odo = wl.hybrid_odometry(cam, dev=dev)
        for i, (img, _) in enumerate(imgs[:frames]):
            odo.process(img.cpu().numpy(), float(i))
        torch.cuda.synchronize()
    return cap.calls


def projection_args(args, kw) -> tuple:
    """match_projection_cuda's arguments of a captured match_projection call."""
    Xw, desc_p, valid_p, level_p, T, cam, desc_f, uv_f, level_f, valid_f = args[:10]
    c = lambda x: x.contiguous()   # noqa: E731
    return (c(Xw), c(desc_p), c(valid_p), c(level_p), c(T.R), c(T.t), cam, c(desc_f), c(uv_f),
            c(level_f), c(valid_f), cs._radius(kw, args))


def epipolar_args(args, kw) -> tuple:
    """(match_epipolar_cuda's positional arguments, its keywords,
    triangulate_cuda's feature arguments, cam, optimal) of a captured
    _epipolar_triangulate call."""
    desc0, uv0, valid0, angle0, desc1, uv1, valid1, angle1, T_new, T0, cam = \
        (x.contiguous() if torch.is_tensor(x) else x for x in args[:11])
    optimal = kw.get("optimal", args[11] if len(args) > 11 else True)
    poses = tuple(x.contiguous() for x in (T_new.R, T_new.t, T0.R, T0.t))
    return ((desc0, uv0, valid0, desc1, uv1, valid1), {"poses": poses, "cam": cam},
            (uv0, uv1, angle0, angle1), cam, optimal)


def run_pairs(build: PairBuild, calls: dict) -> dict:
    """The build's outputs on every captured call, by kernel: projection
    matches, epipolar matches (T_10 and F made in the launch) and the
    triangulation on each of those matches (with its probe)."""
    out = {"hamming_projection": [], "hamming_epipolar": [], "triangulate": []}
    for _, args, kw in calls["projection"]:
        out["hamming_projection"].append(build.hm.match_projection_cuda(*projection_args(args,
                                                                                         kw)))
    for _, args, kw in calls["epipolar"]:
        margs, mkw, feats, cam, optimal = epipolar_args(args, kw)
        m = build.hm.match_epipolar_cuda(*margs, **mkw)
        probe = torch.full((feats[0].shape[0], 4), float("nan"), device=feats[0].device)
        X0, ok = build.tr.triangulate_cuda(*feats, m.best, m.ok, m.geom, cam, optimal, probe)
        out["hamming_epipolar"].append(m)
        out["triangulate"].append({"X0": X0, "ok": ok, "probe": probe})
    torch.cuda.synchronize()
    return out


def tri_readings(calls: dict, res: dict) -> dict:
    """The build's triangulations (on its own matches) under this tree's
    verdict tr.tri_parity against the plain float32 form, the golden-section
    numpy model and the plain form in float64, as chip_smoke.epipolar_check
    holds them: calls that pass, the largest corrected-pixel distance from
    the model and keyframe-0 pixel distance from float64, basin and depth
    edges."""
    out = Counter()
    worst = {"vs_model_px": 0.0, "vs_f64_px": 0.0, "vs_f64_corrected_px": 0.0}
    for (_, args, kw), m, t in zip(calls["epipolar"], res["hamming_epipolar"],
                                   res["triangulate"]):
        _, _, (uv0, uv1, angle0, angle1), cam, optimal = epipolar_args(args, kw)
        T_10 = args[8].compose(args[9].inverse())
        plain = tree_tr.plain_triangulate(uv0, uv1, angle0, angle1, m.best, m.ok,
                                          fundamental(T_10, cam), T_10, cam, optimal)
        f64 = tree_tr.plain_triangulate(uv0.double(), uv1.double(), angle0, angle1, m.best, m.ok,
                                        m.geom[:9].reshape(3, 3),
                                        SE3(R=m.geom[9:18].reshape(3, 3), t=m.geom[18:21]),
                                        cam, optimal)
        model = tree_tr.model_triangulate(*(x.cpu().numpy() for x in (uv0, uv1, angle0, angle1,
                                                                      m.best, m.ok)),
                                          m.geom.cpu().numpy(), cam, optimal)
        rep = tree_tr.tri_parity({"X0": t["X0"], "ok": t["ok"], "corrected": t["probe"]}, plain,
                                 model, f64, cam)
        out["calls"] += 1
        out["ok"] += int(rep["ok"])
        out["rows"] += rep["rows"]
        out["basin_edges"] += rep["basin_edges"]
        out["depth_edges"] += rep["depth_edges"]
        worst["vs_model_px"] = max(worst["vs_model_px"], rep["vs_model"]["max_corrected_px"])
        worst["vs_f64_px"] = max(worst["vs_f64_px"], rep["vs_f64"]["max_pixel"])
        worst["vs_f64_corrected_px"] = max(worst["vs_f64_corrected_px"],
                                           rep["vs_f64"]["max_corrected_px"])
    return {**out, **worst}


def pairs_main(a, dev, card: str) -> dict:
    """--pairs: both kernels of each build on every captured call."""
    builds = [PairBuild("tree")] + ([PairBuild("parent", a.parent.resolve())] if a.parent else [])
    built = kb.build_many([p for b in builds for p in (b.hm.SOURCE, b.tr.SOURCE)], verbose=True)
    out = {"card": card, "ptxas": {f"{p.parent.parent.parent.name}/{p.name}":
                                   [ln.strip() for ln in log.splitlines()
                                    if "registers" in ln or "spill" in ln or "smem" in ln]
                                   for p, _, log in built}, "builds": {}}
    print(json.dumps(out), flush=True)
    calls = capture_pairs(dev, a.frames)
    proj, epi = calls["projection"], calls["epipolar"]
    out["calls"] = {"projection": len(proj), "epipolar": len(epi)}
    print(json.dumps({"calls": out["calls"]}), flush=True)
    results = {b.name: run_pairs(b, calls) for b in builds}
    first = builds[0].name
    for b in builds:
        res = results[b.name]
        row = {"build": b.name, "digest": {k: cs.pair_digest(v) for k, v in res.items()},
               "tri_parity": tri_readings(calls, res), "card": card}
        if b.name != first:
            row["first_differing_call"] = {
                k: next((i for i, (x, y) in enumerate(zip(v, results[first][k]))
                         if cs.pair_digest([x]) != cs.pair_digest([y])), None)
                for k, v in res.items()}
        out["builds"][b.name] = row
        print(json.dumps(row), flush=True)

    # the timed calls: phase 4's first projection match, phase 5's first
    # keyframe's epipolar match and the triangulation after it
    pargs = projection_args(*proj[0][1:])
    run5 = [c for c in epi if c[0] == "hybrid"] or epi
    margs, mkw, feats, cam, optimal = epipolar_args(*run5[0][1:])
    ms = {b.name: b.hm.match_epipolar_cuda(*margs, **mkw) for b in builds}
    timed = {
        "hamming_projection": (lambda b: b.hm.match_projection_cuda(*pargs), "hamming_match.cu"),
        "hamming_epipolar": (lambda b: b.hm.match_epipolar_cuda(*margs, **mkw),
                             "hamming_match.cu"),
        "triangulate": (lambda b: b.tr.triangulate_cuda(*feats, ms[b.name].best, ms[b.name].ok,
                                                         ms[b.name].geom, cam, optimal),
                        "triangulate.cu")}
    out["shapes"] = {"hamming_projection": [pargs[0].shape[0], pargs[7].shape[0]],
                     "hamming_epipolar": [margs[0].shape[0], margs[3].shape[0]],
                     "triangulate": [feats[0].shape[0], bool(optimal)]}
    for b in builds:
        stamps = pair_stamps(b, timed, a.reps)
        out["builds"][b.name]["stamps"] = stamps
        for name in timed:
            print(json.dumps({"build": b.name, "stamps": name,
                              **(stamps[name] if stamps else {"none": True}), "card": card}),
                  flush=True)
    floor = cs.launch_floor()
    times = {n: {b.name: {"cold": [], "warm": []} for b in builds} for n in timed}
    for b in builds + builds[::-1]:
        for n, (fn, _) in timed.items():
            times[n][b.name]["cold"].append(cs.cuda_ms(lambda: fn(b)))
            times[n][b.name]["warm"].append(cs.cuda_ms(lambda: fn(b), cold=False))
    out.update(ms=times, floor=floor)
    print(json.dumps({"ms": times, **floor, "shapes": out["shapes"], "card": card}), flush=True)
    return out


class KfBuild:
    """The keyframe kernels of one tree: its wrapper module `kfp` (for
    another tree, its ops/kf_programs.py loaded from its files and pointed
    at its own csrc/); inside `sources(dir)`, the wrappers launch the
    libraries built from the sources in `dir`."""

    def __init__(self, name: str, tree: Path | None = None):
        self.name = name
        if tree is None:
            self.kfp, self.csrc = tree_kfp, kb.CSRC
        else:
            pkg = tree / "libcml_tpu_torch"
            self.csrc = pkg / "csrc"
            self.kfp = _load_module(f"_kf_programs_{name}", pkg / "ops" / "kf_programs.py")
            self.kfp.ACTIVATE_SOURCE = self.csrc / self.kfp.ACTIVATE_SOURCE.name
            self.kfp.REFRESH_SOURCE = self.csrc / self.kfp.REFRESH_SOURCE.name

    @property
    def sources_now(self) -> tuple[Path, Path]:
        return self.kfp.ACTIVATE_SOURCE, self.kfp.REFRESH_SOURCE

    @contextlib.contextmanager
    def sources(self, csrc: Path):
        before = self.sources_now
        self.kfp.ACTIVATE_SOURCE, self.kfp.REFRESH_SOURCE = (csrc / p.name for p in before)
        try:
            yield
        finally:
            self.kfp.ACTIVATE_SOURCE, self.kfp.REFRESH_SOURCE = before


# Stage marks that a keyframe source may lack (commit cb7cc16's carry only
# phase1-4, scans and scatter): each (anchor, name, indent) puts `// stage: name`
# after the line that ends the anchor's first occurrence, where the mark is
# missing and the anchor is present
KF_MARKS = {
    "kf_activate.cu": (
        ("  const int gtid = blockIdx.x * THREADS + threadIdx.x, gstride = gridDim.x * THREADS;",
         "activate_start", 2),
        ("            make_float4(cw[4 * k], cw[4 * k + 1], cw[4 * k + 2], cw[4 * k + 3]);\n"
         "    }\n  }", "candidates", 2),
        ("  if (!s_last) return;", "ticket", 2)),
    "kf_refresh.cu": (
        ("  bool did = false;", "refresh_start", 2),),
}


def add_kf_marks(name: str, text: str) -> str:
    """KF_MARKS put into a keyframe source where they are missing."""
    for anchor, mark, indent in KF_MARKS.get(name, ()):
        if f"// stage: {mark}\n" in text or anchor not in text:
            continue
        i = text.index(anchor)
        j = text.index("\n", i + len(anchor) - 1) + 1
        text = text[:j] + " " * indent + f"// stage: {mark}\n" + text[j:]
    return text


def kf_stamps(build: KfBuild, calls: dict, reps: int) -> dict | None:
    """The build's stage stamps on each named call (stage_report over `reps`
    calls of a copy of its csrc/ with its `// stage:` marks made stamps).
    `calls`: name -> (fn(build), source name)."""
    copy, stages = instrument(build, kb.BUILD_DIR / "kf_stages" / build.name, prefix=("kf_",),
                              edit=add_kf_marks)
    if not stages:
        return None
    kb.build_many([copy / p.name for p in build.sources_now])
    named = {n: (lambda fn=fn: fn(build), src) for n, (fn, src) in calls.items()}
    return {**stage_report(build, copy, stages, named, reps), "blocks_held": MAXB}


def kf_call(kfp, name: str, args: tuple, kw: dict):
    """A captured keyframe-program call (a KF_SITES name) through `kfp`'s
    kernel wrappers, as the dispatcher makes it on the card."""
    fn = {"_activate_and_clear": odometry._activate_and_clear,
          "_refresh_after_kf": odometry._refresh_after_kf, "add_points": win_mod.add_points,
          "_tracker_ref_in_frame": odometry._tracker_ref_in_frame,
          "_working_rho_range": odometry._working_rho_range,
          "select_points": selector.select_points, "seed_immatures": tracer.seed_immatures}[name]
    x = inspect.signature(fn).bind(*args, **kw)
    x.apply_defaults()
    A = x.arguments
    if name == "_activate_and_clear":
        return kfp.kf_activate_cuda(A["window"].ba, A["window"].images, A["cfg"],
                                    arena=A["immature"])
    if name == "add_points":
        return kfp.kf_activate_cuda(A["window"].ba, A["window"].images, A["cfg"],
                                    points=(A["uv"], A["idepth"], A["valid"], A["slot"]))
    if name == "_refresh_after_kf":
        return kfp.refresh_cuda(A["window"].ba, int(A["slot"]), A["kf_pyr"], A["immature"],
                                A["cam"], A["cfg"])
    if name == "_tracker_ref_in_frame":
        return kfp.tracker_ref_cuda(A["kf_pyr"], A["cam"], A["cfg"], ba=A["window"].ba,
                                    slot=int(A["slot"]))
    if name == "_working_rho_range":
        return kfp.rho_range_cuda(A["ba"], A["cfg"])
    if name == "select_points":
        return kfp.select_cuda(*A.values())
    return kfp.seed_cuda(*A.values())


def tensor_digest(x, h=None):
    """One sha256 over every tensor in `x` (dicts in key order, sequences
    in order)."""
    h = h or hashlib.sha256()
    if isinstance(x, dict):
        for k in sorted(x):
            h.update(k.encode())
            tensor_digest(x[k], h)
    elif isinstance(x, (tuple, list)):
        for y in x:
            tensor_digest(y, h)
    elif torch.is_tensor(x):
        h.update(x.contiguous().cpu().numpy().tobytes())
    elif x is not None:
        h.update(repr(x).encode())
    return h


def capture_kf(dev, frames: int) -> list:
    """Every keyframe-program call (cloned arguments, chip_smoke.KfCapture)
    of DirectOdometry on the smoke's first `frames` frames."""
    cam, _, imgs = wl.render_frames(dev, frames)
    with cs.KfCapture() as cap:
        cap.run = "direct"
        odo = DirectOdometry(cam, wl.BENCH_CFG)
        for i, (img, _) in enumerate(imgs):
            odo.process(img.cpu().numpy(), float(i))
        torch.cuda.synchronize()
    return cap.calls["direct"]


def kf_main(a, dev, card: str) -> dict:
    """--kf: both keyframe kernels of each build on every captured call."""
    builds = [KfBuild("tree")] + ([KfBuild("parent", a.parent.resolve())] if a.parent else [])
    built = kb.build_many([p for b in builds for p in b.sources_now], verbose=True)
    out = {"card": card, "ptxas": {f"{p.parent.parent.parent.name}/{p.name}":
                                   [ln.strip() for ln in log.splitlines()
                                    if "registers" in ln or "spill" in ln or "smem" in ln]
                                   for p, _, log in built}, "builds": {}}
    print(json.dumps(out), flush=True)
    calls = capture_kf(dev, a.frames)
    out["calls"] = dict(Counter(name for name, _, _ in calls))
    print(json.dumps({"calls": out["calls"]}), flush=True)
    results = {}
    for b in builds:
        res = {}
        for name, args, kw in calls:
            res.setdefault(name, []).append(tensor_digest(kf_call(b.kfp, name, args, kw))
                                            .hexdigest())
        torch.cuda.synchronize()
        results[b.name] = res
    first = builds[0].name
    for b in builds:
        res = results[b.name]
        row = {"build": b.name, "card": card,
               "digest": {n: hashlib.sha256("".join(v).encode()).hexdigest()
                          for n, v in res.items()}}
        if b.name != first:
            row["first_differing_call"] = {
                n: next((i for i, (x, y) in enumerate(zip(v, results[first][n])) if x != y),
                        None) for n, v in res.items()}
        out["builds"][b.name] = row
        print(json.dumps(row), flush=True)

    # the timed calls: the activation that writes the most points, the
    # first refresh, and the refresh's pieces alone on its inputs
    acts = [(args, kw) for name, args, kw in calls if name == "_activate_and_clear"]
    written = []
    for args, kw in acts:
        new, _ = kf_call(tree_kfp, "_activate_and_clear", args, kw)
        written.append(int(new["point_valid"].sum() - args[0].ba.point_valid.sum()))
    act = acts[int(np.argmax(written))][0]
    window, slot, pyr, imm, cam, cfg = next(args for name, args, _ in calls
                                            if name == "_refresh_after_kf")
    slot = int(slot)
    ba = window.ba
    uv, valid, _ = tree_kfp.select_cuda(pyr[0], cfg.points_per_kf)
    lo, hi = tree_kfp.rho_range_cuda(ba, cfg)
    timed = {
        "activate": (lambda b: b.kfp.kf_activate_cuda(act[0].ba, act[0].images, act[2],
                                                      arena=act[1]), "kf_activate.cu"),
        "refresh": (lambda b: b.kfp.refresh_cuda(ba, slot, pyr, imm, cam, cfg), "kf_refresh.cu"),
        "A_reference": (lambda b: b.kfp.tracker_ref_cuda(pyr, cam, cfg, ba=ba, slot=slot),
                        "kf_refresh.cu"),
        "A_points": (lambda b: b.kfp.tracker_ref_cuda(
            pyr, cam, cfg, points=(ba.uv, ba.idepth, ba.point_valid)), "kf_refresh.cu"),
        "B_range": (lambda b: b.kfp.rho_range_cuda(ba, cfg), "kf_refresh.cu"),
        "C_select": (lambda b: b.kfp.select_cuda(pyr[0], cfg.points_per_kf), "kf_refresh.cu"),
        "D_seed": (lambda b: b.kfp.seed_cuda(imm, slot, pyr[0], uv, valid, lo, hi),
                   "kf_refresh.cu")}
    out["shapes"] = {"P": ba.uv.shape[0], "F": ba.ab.shape[0], "K": imm.valid.shape[1],
                     "image": list(pyr[0].shape[:2]), "levels": len(pyr),
                     "activation_written": max(written), "points_valid": int(ba.point_valid.sum()),
                     **tree_kfp.select_geometry(pyr[0].shape[0], pyr[0].shape[1],
                                                cfg.points_per_kf)}
    print(json.dumps({"shapes": out["shapes"]}), flush=True)
    for b in builds:
        stamps = kf_stamps(b, timed, a.reps)
        out["builds"][b.name]["stamps"] = stamps
        for name in timed:
            print(json.dumps({"build": b.name, "stamps": name,
                              **(stamps[name] if stamps else {"none": True}), "card": card}),
                  flush=True)
    floor = cs.launch_floor()
    times = {n: {b.name: {"cold": [], "warm": []} for b in builds} for n in timed}
    for b in builds + builds[::-1]:
        for n, (fn, _) in timed.items():
            times[n][b.name]["cold"].append(cs.cuda_ms(lambda: fn(b)))
            times[n][b.name]["warm"].append(cs.cuda_ms(lambda: fn(b), cold=False))
    out.update(ms=times, floor=floor)
    print(json.dumps({"ms": times, **floor, "card": card}), flush=True)
    return out


def capture_window(dev, frames: int):
    """The last run_ba call's (state, images, cam, cfg) of DirectOdometry on
    the smoke's first `frames` frames."""
    cam, _, imgs = wl.render_frames(dev, frames)
    with cs.BACapture(every=("run_ba",)) as cap:
        odo = DirectOdometry(cam, wl.BENCH_CFG)
        for i, (img, _) in enumerate(imgs):
            odo.process(img.cpu().numpy(), float(i))
        torch.cuda.synchronize()
    return cap.calls["run_ba"][-1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="another tree (a git archive of a parent commit)")
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("--orb", action="store_true",
                    help="the ORB call at budgets 512, 800 and 2000 in place of the BA window")
    ap.add_argument("--pairs", action="store_true",
                    help="the pair-test Hamming kernel and the triangulation kernel on the "
                         "hybrid's captured calls in place of the BA window")
    ap.add_argument("--kf", action="store_true",
                    help="the direct path's keyframe kernels on its captured calls in place "
                         "of the BA window")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("ba_stages: CUDA is not available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    card = cs.nvidia_smi("name,power.limit")
    if a.orb or a.pairs or a.kf:
        out = (orb_main if a.orb else pairs_main if a.pairs else kf_main)(a, dev, card)
        if a.out:
            a.out.parent.mkdir(parents=True, exist_ok=True)
            a.out.write_text(json.dumps(out, indent=1))
        return 0
    builds = [Build("tree")] + ([Build("parent", a.parent.resolve())] if a.parent else [])
    stage_dir = kb.BUILD_DIR / "ba_stages"
    copies = {b.name: instrument(b, stage_dir / b.name) for b in builds}
    sources = [p for b in builds for p in sorted(b.csrc.glob("ba_*.cu"))]
    sources += [p for copy, stages in copies.values() if stages
                for p in sorted(copy.glob("ba_*.cu"))]
    built = kb.build_many(sources, verbose=True)
    info = {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
            "window_frames": a.frames,
            "ptxas": {p.name: [ln.strip() for ln in log.splitlines()
                               if "registers" in ln or "spill" in ln or "smem" in ln]
                      for p, _, log in built}}
    print(json.dumps(info), flush=True)

    st, images, cam, cfg = capture_window(dev, a.frames)
    lam = torch.tensor(cfg.ba_lambda_init, dtype=torch.float32, device=dev)
    window = {"frames_valid": int(st.frame_valid.sum()), "points_valid": int(st.point_valid.sum()),
              "active_pairs": int(cs._active_pairs(st, images, cam, cfg)[0].sum()),
              "P": st.num_points, "F": st.num_frames}
    print(json.dumps({"window": window}), flush=True)
    want, E_want = tree_ba.run_ba_plain(st, images, cam, cfg)
    out = {**info, "window": window, "builds": {}}
    for b in builds:
        got, E = b.ba.run_ba(st, images, cam, cfg)
        torch.cuda.synchronize()
        system = b.bk.ba_sweep_cuda(st, images, cam, cfg, "system", lam=lam)
        calls = {"system_sweep": (lambda b=b: b.bk.ba_sweep_cuda(st, images, cam, cfg, "system",
                                                                 lam=lam), "ba_sweep.cu"),
                 "energy_sweep": (lambda b=b: b.bk.ba_sweep_cuda(st, images, cam, cfg, "energy"),
                                  "ba_sweep.cu"),
                 "solve": (lambda b=b, system=system: b.bk.ba_solve_cuda(system, st, cfg, lam, st),
                           "ba_solve.cu")}
        if hasattr(b.bk, "RUN_SOURCE"):
            calls["run_ba"] = (lambda b=b: b.ba.run_ba(st, images, cam, cfg), "ba_run.cu")
        copy, stages = copies[b.name]
        row = {"build": b.name, "parity": cs.ba_parity(got, E, want, E_want),
               "partials": cs.partials_measure(st, images, cam, cfg, sweep=b.bk.ba_sweep_cuda),
               "stages": stage_report(b, copy, stages, calls, a.reps) if stages else None,
               "card": card}
        print(json.dumps(row), flush=True)
        out["builds"][b.name] = row

    timed = {"run_ba": lambda b: b.ba.run_ba(st, images, cam, cfg),
             "system_sweep": lambda b: b.bk.ba_sweep_cuda(st, images, cam, cfg, "system",
                                                          lam=lam),
             "energy_sweep": lambda b: b.bk.ba_sweep_cuda(st, images, cam, cfg, "energy"),
             "solve": lambda b: b.bk.ba_solve_cuda(out_sys[b.name], st, cfg, lam, st)}
    out_sys = {b.name: b.bk.ba_sweep_cuda(st, images, cam, cfg, "system", lam=lam) for b in builds}
    times = {n: {b.name: {"cold": [], "warm": []} for b in builds} for n in timed}
    for b in builds + builds[::-1]:
        for n, fn in timed.items():
            times[n][b.name]["cold"].append(cs.cuda_ms(lambda: fn(b)))
            times[n][b.name]["warm"].append(cs.cuda_ms(lambda: fn(b), cold=False))
    out["ms"] = times
    print(json.dumps({"ms": times, "card": card}), flush=True)
    if a.out:
        a.out.parent.mkdir(parents=True, exist_ok=True)
        a.out.write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
