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
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import hashlib
import importlib.util
import json
import re
import shutil
import statistics
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from libcml_tpu_torch import workload as wl  # noqa: E402
from libcml_tpu_torch.models.direct import ba as tree_ba  # noqa: E402
from libcml_tpu_torch.ops import ba_sweep as tree_bk  # noqa: E402
from libcml_tpu_torch.ops import kernel_build as kb  # noqa: E402
from libcml_tpu_torch.ops import orb_extract as tree_oe  # noqa: E402
from libcml_tpu_torch.ops.image import build_pyramid  # noqa: E402
from libcml_tpu_torch.runtime.odometry import DirectOdometry  # noqa: E402

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
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("ba_stages: CUDA is not available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    card = cs.nvidia_smi("name,power.limit")
    if a.orb:
        out = orb_main(a, dev, card)
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
