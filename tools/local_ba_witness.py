"""The local BA kernel, its plain form, planted faults of the kernel and the
JAX package against a float64 run, on the hybrid's real run_local_ba calls;
with --parent, another tree's kernel beside this one's, bit for bit and in
time; with --stages, where each kernel's time goes.

    python3 tools/local_ba_witness.py [--frames 60 | --calls FILE] [--save FILE]
                                      [--parent DIR] [--stages]   (one CUDA card)
    JAX_PLATFORMS=cpu python3 tools/local_ba_witness.py --jax FILE              (the CPU)

On the card it runs the sequential HybridOdometry on the smoke's frames
(libcml_tpu_torch/workload.py: 640x480, bench.py's configuration;
chip_smoke.py phase 5's run) and keeps every run_local_ba call
(chip_smoke.LocalBACapture); or, with --calls, it reads the calls from an
.npz that `chip_smoke.py --save-local-ba FILE` (phase 16's calls: phases 5,
7, 10 and 12) or --save wrote. It builds csrc/local_ba.cu and three copies
of it, each with one fault planted (in a temporary directory, beside copies
of the headers it includes): `never_accepts` (no step is ever taken),
`no_huber` (every weight 1 / sigma^2), `last_hcc_dropped` (the last frame
slot's H_cc left out of the reduced system). On every call each build runs
once, and ops/local_ba.py `parity` holds it to run_local_ba_plain beside
`f64_run` (a float64 run of the plain form), as chip_smoke.py phase 16 holds
the kernel. One JSON line a call: each build's verdict (`ok`), the measures
beyond PARITY_TOL of the plain form, its distance from float64 (`vs_f64`: T,
the points' excess over their bound, the free points' pixels), the measures
within F64_TOL, the observations pruned otherwise that nothing explains, and
whether the rule before F64_TOL (no further from float64 than the plain
form) would have passed it; then the largest reading of each build. The
clean kernel must pass on every call and every fault must fail on every
call.

--parent DIR: the kernel of another tree (a parent commit unpacked with
`git archive` into a git-ignored directory; its ops/local_ba.py is loaded
from there under another module name and launches the library built from
its own csrc/, as tools/ba_stages.py's Build loads the BA wrappers) runs
every call too: its verdict and distance from float64 beside this tree's,
and whether the two kernels' outputs (T, points, validity after each
prune, each step's trace) are equal bit for bit. Then both kernels' cold and
warm device ms (chip_smoke.cuda_ms, median of 30) on the heaviest call
(chip_smoke.local_ba_work) and on the card test's map-capacity problem
(tests/test_torch_card_local_ba.py map_cap_problem: M 6, N 4,096, K 9,216),
each also with no LM step, in turns with the launch floor (an empty kernel
through the same ctypes route): this tree, the parent, the parent, this
tree.

--stages: a throwaway copy of each build's csrc/ under
libcml_tpu_torch/_build/local_ba_stages/ in which thread 0 of every block
adds, at each `// stage: NAME` mark of local_ba.cu (and ba_common.cuh), the
clock64() cycles and %globaltimer ns since the block's previous mark to
NAME's total, and the part of them that the block spent in grid barriers
(from a __syncthreads before each barrier to its end) to NAME's wait (in
shared memory, each total stored to device memory as it changes, so that a
stamp waits on no load; the kernel's `start` mark starts the clock). A
kernel without some marks gets them added at fixed lines (STAGE_ANCHORS) so
that both trees split alike. For each stage: the marks a launch passes in
block 0, and the median over blocks and STAGE_REPS launches of its
microseconds a launch (cycles at the block's measured clock), of its
barrier wait and of its work (the rest), on the heaviest call and the
map-capacity problem.

With --save, the calls and the kernel's results go to an .npz; --jax reads
it on the CPU and runs each call through the JAX package's run_local_ba
(float32, jitted as libcml_tpu/runtime/hybrid.py jits it), the port's plain
form on the CPU and a float64 run on the CPU, and prints each one's (and
the card kernel's) distance from that float64 run (infinite or NaN where a
result is not finite: the JAX package takes a step whose candidate is NaN,
ROADMAP.md section 3). Only --jax imports JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import statistics
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from libcml_tpu_torch.core.camera import PinholeCamera  # noqa: E402
from libcml_tpu_torch.core.lie import SE3  # noqa: E402
from libcml_tpu_torch.models.indirect import indirect_ba as iba  # noqa: E402
from libcml_tpu_torch.ops import kernel_build as kb  # noqa: E402
from libcml_tpu_torch.ops import local_ba as lba  # noqa: E402
from tools.ba_stages import Build, _load_module, instrument  # noqa: E402

# each fault: the line of csrc/local_ba.cu it replaces, and what replaces it
FAULTS = {
    "never_accepts": ("const bool accept = fin && E_new < E;", "const bool accept = false;"),
    "no_huber": ("const double w = o.active ? hub / s2 : 0.0;",
                 "const double w = o.active ? 1.0 / s2 : 0.0; (void)hub;"),
    "last_hcc_dropped": ("const double hcc = fi == fj ?",
                         "const double hcc = fi == fj && fi != D / 6 - 1 ?"),
}
FIELDS = ("frame_valid", "frame_fixed", "Xw", "point_valid", "obs_frame", "obs_point",
          "obs_uv", "obs_valid", "obs_sigma2")

# -- stage split -------------------------------------------------------------------------------

MAXB, NSTAGE = 1024, 32
STAGE_REPS = 20             # stamped launches behind each stage's median
# ba_stage(k) adds the cycles and ns since the block's previous mark to stage
# k, and the part spent in grid barriers (lba_wait_begin / lba_wait_end) to
# its wait, in shared memory, and stores the block's totals for k to device
# memory (stores only: a stamp waits on no load); the `start` mark zeroes the
# block's totals and starts the clock
ACC_HEAD = f"""// accumulated stage stamps (tools/local_ba_witness.py; a throwaway copy)
#include <cuda_runtime.h>
__device__ unsigned long long lba_acc[{MAXB}][{NSTAGE}][4];   // ns, cycles, wait ns, wait cycles
__device__ unsigned lba_hits[{MAXB}][{NSTAGE}];
__shared__ unsigned long long lba_sacc[{NSTAGE}][4];
__shared__ unsigned lba_shits[{NSTAGE}];
__shared__ unsigned long long lba_slast[6];   // ns, cycles; pending wait ns, cycles; wait start
__device__ __forceinline__ unsigned long long lba_ns() {{
  unsigned long long g;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g));
  return g;
}}
__device__ __forceinline__ void lba_stage_start() {{
  if (threadIdx.x == 0) {{
    for (int k = 0; k < {NSTAGE}; ++k) {{
      for (int i = 0; i < 4; ++i) lba_sacc[k][i] = 0;
      lba_shits[k] = 0;
    }}
    for (int i = 2; i < 6; ++i) lba_slast[i] = 0;
    lba_slast[0] = lba_ns();
    lba_slast[1] = (unsigned long long)clock64();
  }}
}}
__device__ __forceinline__ void ba_stage(int k) {{
  if (threadIdx.x == 0 && k < {NSTAGE}) {{
    const unsigned long long ns = lba_ns(), cyc = (unsigned long long)clock64();
    unsigned long long* L = lba_slast;
    unsigned long long* A = lba_sacc[k];
    A[0] += ns - L[0];
    A[1] += cyc - L[1];
    A[2] += L[2];
    A[3] += L[3];
    lba_shits[k] += 1;
    L[0] = ns; L[1] = cyc; L[2] = 0; L[3] = 0;
    if (blockIdx.x < {MAXB}) {{
      for (int i = 0; i < 4; ++i) lba_acc[blockIdx.x][k][i] = A[i];
      lba_hits[blockIdx.x][k] = lba_shits[k];
    }}
  }}
}}
__device__ __forceinline__ void lba_wait_begin() {{
  __syncthreads();
  if (threadIdx.x == 0) {{
    lba_slast[4] = lba_ns();
    lba_slast[5] = (unsigned long long)clock64();
  }}
}}
__device__ __forceinline__ void lba_wait_end() {{
  if (threadIdx.x == 0) {{
    lba_slast[2] += lba_ns() - lba_slast[4];
    lba_slast[3] += (unsigned long long)clock64() - lba_slast[5];
  }}
}}
"""
ACC_TAIL = """
extern "C" int lba_stage_read(void* acc, void* hits) {
  cudaError_t e = cudaDeviceSynchronize();
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(acc, lba_acc, sizeof(lba_acc));
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(hits, lba_hits, sizeof(lba_hits));
  return (int)e;
}
extern "C" int lba_stage_clear() {
  void* p = nullptr;
  cudaError_t e = cudaSuccess;
  const void* syms[2] = {(const void*)&lba_acc, (const void*)&lba_hits};
  const size_t sizes[2] = {sizeof(lba_acc), sizeof(lba_hits)};
  for (int i = 0; i < 2 && e == cudaSuccess; ++i) {
    e = cudaGetSymbolAddress(&p, syms[i]);
    if (e == cudaSuccess) e = cudaMemset(p, 0, sizes[i]);
  }
  if (e == cudaSuccess) e = cudaDeviceSynchronize();
  return (int)e;
}
"""
# marks added where a kernel lacks them (the local BA kernel before its redesign): the line
# after which each goes, and its name
STAGE_ANCHORS = (
    ("      b.lam = 1e-5f;\n      __syncthreads();\n", "first_energy"),
    ("  __syncthreads();\n  ba::SolveArgs sa = {};\n", "build"),
    ("  ba::warp_solve(sa);\n", "backsub"),
    ("      group_prune(a, g, stage == 0 ? a.obs_valid_mid : nullptr);\n    __syncthreads();\n",
     "prune"),
)
BARRIER = re.compile(r"^([ \t]*)((?:ba::)?(?:grid_barrier|grid_sync)\(bar(?:, b\.arrived)?\);)",
                     re.M)


def stage_edit(name: str, text: str) -> str:
    """local_ba.cu with STAGE_ANCHORS' marks where they are missing, the
    `start` mark a call that starts the block's clock, and each grid barrier
    between lba_wait_begin() and lba_wait_end()."""
    if name != lba.SOURCE.name:
        return text
    for anchor, mark in STAGE_ANCHORS:
        if f"// stage: {mark}\n" not in text and text.count(anchor) == 1:
            indent = re.match(r"\s*", anchor.splitlines()[-1]).group(0)
            text = text.replace(anchor, f"{anchor}{indent}// stage: {mark}\n")
    text = re.sub(r"^(\s*)// stage: start\s*$", r"\1lba_stage_start();", text, flags=re.M)
    return BARRIER.sub(r"\1lba_wait_begin();\n\1\2\n\1lba_wait_end();", text)


class LocalBABuild(Build):
    """The local BA kernel of one tree: its wrapper module `bk`
    (ops/local_ba.py; for another tree, loaded from its files with SOURCE
    pointed at its own csrc/)."""

    FIELDS = ("SOURCE",)

    def __init__(self, name: str, tree: Path | None = None):
        self.name = name
        if tree is None:
            self.bk, self.csrc = lba, kb.CSRC
        else:
            self.csrc = tree / "libcml_tpu_torch" / "csrc"
            self.bk = _load_module(f"_local_ba_{name}",
                                   tree / "libcml_tpu_torch" / "ops" / "local_ba.py")
            self.bk.SOURCE = self.csrc / self.bk.SOURCE.name


def stage_split(build: LocalBABuild, copy: Path, stages: list[str], fn) -> dict:
    """Where a launch of `fn` spends its time, stage by stage (the module
    docstring's --stages)."""
    with build.sources(copy):
        lib = kb.load(copy / lba.SOURCE.name, "lba_stage_clear", [])
        lib.lba_stage_read.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.lba_stage_read.restype = ctypes.c_int
        fn()
        torch.cuda.synchronize()
        runs = []
        for _ in range(STAGE_REPS):
            if lib.lba_stage_clear() != 0:
                raise RuntimeError("lba_stage_clear failed")
            fn()
            torch.cuda.synchronize()
            acc = np.zeros((MAXB, NSTAGE, 4), np.uint64)
            hits = np.zeros((MAXB, NSTAGE), np.uint32)
            if lib.lba_stage_read(acc.ctypes.data, hits.ctypes.data) != 0:
                raise RuntimeError("lba_stage_read failed")
            runs.append((acc.astype(np.float64), hits.astype(np.int64)))
    blocks = np.flatnonzero(runs[0][1].sum(1) > 0)
    rows, total = {}, []
    for k, name in enumerate(stages):
        us, wait, hit = [], [], int(runs[0][1][0, k])
        for acc, hits in runs:
            a = acc[blocks]
            ghz = a[:, :, 1].sum(1) / np.maximum(a[:, :, 0].sum(1), 1.0)   # cycles a ns
            us += list(a[:, k, 1] / ghz / 1e3)
            wait += list(a[:, k, 3] / ghz / 1e3)
        if hit or any(us):
            med, w = statistics.median(us), statistics.median(wait)
            rows[name] = {"marks": hit, "us": med, "wait_us": w, "work_us": med - w,
                          "us_per_mark": med / hit if hit else None}
    for acc, _ in runs:
        a = acc[blocks]
        ghz = a[:, :, 1].sum(1) / np.maximum(a[:, :, 0].sum(1), 1.0)
        total += list(a[:, :, 1].sum(1) / ghz / 1e3)
    return {"blocks": int(blocks.size), "total_us": statistics.median(total), "stages": rows}


# -- the calls ---------------------------------------------------------------------------------


def plant(build: LocalBABuild, work: Path) -> dict[str, Path]:
    """A copy of the build's csrc/ a fault, each with its line of
    local_ba.cu replaced."""
    out = {}
    for name, (old, new) in FAULTS.items():
        d = work / name
        shutil.copytree(build.csrc, d)
        src = d / lba.SOURCE.name
        text = src.read_text()
        if text.count(old) != 1:
            raise SystemExit(f"{name}: the line to replace is not in {lba.SOURCE} once")
        src.write_text(text.replace(old, new))
        out[name] = d
    return out


def _largest(acc: dict, dist: dict) -> None:
    """acc[m] = the larger of acc[m] and dist[m], a NaN read as infinite."""
    for m in lba.MEASURES:
        v = dist[m]
        acc[m] = max(acc.get(m, 0.0), float("inf") if v != v else v)


def reading(rep: dict) -> dict:
    """What a line prints of a parity report."""
    over = rep["over"]
    return {"ok": rep["ok"], "over": over,
            "vs_f64": {m: rep["kernel_vs_f64"][m] for m in lba.MEASURES},
            "within_f64": [m for m in lba.MEASURES if rep["within_f64"][m]],
            "unexplained_obs": len(rep["unexplained_obs"]),
            "rule_before_f64_tol": not rep["unexplained_obs"]
            and all(rep["nearer_f64"][m] for m in over)}


def _bits(x: torch.Tensor) -> bytes:
    return x.detach().contiguous().cpu().numpy().tobytes()


def run_build(bk, prob, cam, iters) -> tuple:
    """One traced launch of a build's kernel: its result, its first-stage
    obs_valid and its trace."""
    dev, K = prob.Xw.device, prob.obs_frame.shape[0]
    trace = torch.empty((sum(iters), len(lba.TRACE_FIELDS)), dtype=torch.float64, device=dev)
    mid = torch.empty((K,), dtype=torch.bool, device=dev)
    got = bk.local_ba_cuda(prob, cam, *iters, trace=trace, obs_valid_mid=mid)
    torch.cuda.synchronize()
    return got, mid, trace


def capture_hybrid(dev, frames: int) -> list:
    """Phase 5's run_local_ba calls: [(run, problem, camera, iterations)]."""
    import chip_smoke as cs
    from libcml_tpu_torch import workload as wl
    cam, _, imgs = wl.render_frames(dev, frames)
    with cs.LocalBACapture() as cap:
        cap.run = "hybrid"
        odo = wl.hybrid_odometry(cam)
        for i, (img, _) in enumerate(imgs):
            odo.process(img.cpu().numpy(), float(i))
        torch.cuda.synchronize()
    return [("hybrid", prob, cam_, cs._stage_iters(args, kw))
            for prob, cam_, args, kw in cap.calls.get("hybrid", [])]


def timings(builds: list, cases: dict) -> dict:
    """Cold and warm ms of each build on each case (and with no LM step),
    in turns with the launch floor: the builds in order, then in reverse."""
    import chip_smoke as cs
    out = {c: {b.name: {"cold": [], "warm": [], "no_steps_cold": []} for b in builds}
           for c in cases}
    out["floor"] = {"cold": [], "warm": []}
    for b in builds + builds[::-1]:
        for c, (prob, cam, iters) in cases.items():
            def call(b=b, prob=prob, cam=cam, iters=iters):
                return b.bk.local_ba_cuda(prob, cam, *iters)

            def none(b=b, prob=prob, cam=cam):
                return b.bk.local_ba_cuda(prob, cam, 0, 0)

            out[c][b.name]["cold"].append(cs.cuda_ms(call))
            out[c][b.name]["warm"].append(cs.cuda_ms(call, cold=False))
            out[c][b.name]["no_steps_cold"].append(cs.cuda_ms(none))
        floor = cs.launch_floor()
        out["floor"]["cold"].append(floor["floor_ms"])
        out["floor"]["warm"].append(floor["floor_warm_ms"])
    return out


def card(a) -> int:
    import chip_smoke as cs
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tests"))
    from test_torch_card_local_ba import FULL_CAM, map_cap_problem, problem_from

    if not torch.cuda.is_available():
        print("local_ba_witness: CUDA is not available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    name = cs.nvidia_smi("name,power.limit")
    work = Path(tempfile.mkdtemp(prefix="local_ba_witness_"))
    try:
        tree = LocalBABuild("tree")
        builds = [tree] + ([LocalBABuild("parent", a.parent.resolve())] if a.parent else [])
        faults = plant(tree, work)
        copies = ({b.name: instrument(b, kb.BUILD_DIR / "local_ba_stages" / b.name,
                                      prefix=("local_ba", "ba_common"), head=ACC_HEAD,
                                      tail=ACC_TAIL, edit=stage_edit) for b in builds}
                  if a.stages else {})
        sources = [*kb.SOURCES, cs.floor_source(), *(d / lba.SOURCE.name for d in faults.values()),
                   *(b.csrc / lba.SOURCE.name for b in builds[1:]),
                   *(c / lba.SOURCE.name for c, _ in copies.values())]
        # one nvcc a library: two trees' identical sources share theirs
        built = kb.build_many(list({kb.library_path(s): s for s in sources}.values()),
                              verbose=True)
        print(json.dumps({"card": name, "torch": torch.__version__, "cuda": torch.version.cuda,
                          "ptxas": {str(p.relative_to(kb.BUILD_DIR)): [
                              ln.strip() for ln in log.splitlines()
                              if "local_ba" in str(p) and ("registers" in ln or "spill" in ln)]
                              for p, _, log in built if "local_ba" in str(p)}}), flush=True)
        calls = (cs.load_local_ba_calls(a.calls, dev) if a.calls
                 else capture_hybrid(dev, a.frames))
        forms = [(b.name, b, None) for b in builds] + [(f, tree, d) for f, d in faults.items()]
        worst = {f: {} for f, _, _ in forms}
        failed = {f: 0 for f, _, _ in forms}
        same_bits, saved = 0, {}
        for k, (run, prob, cam_, iters) in enumerate(calls):
            tr_p, mid_p = [], []
            want = iba.run_local_ba_plain(prob, cam_, *iters, trace=tr_p, mid=mid_p)
            ref = lba.f64_run(prob, cam_, *iters)
            row = {"call": k, "run": run, "M": prob.T.t.shape[0], "N": prob.Xw.shape[0],
                   "K": prob.obs_frame.shape[0], "fixed_frames": int(prob.frame_fixed.sum()),
                   "plain_vs_f64": {m: lba._distances(want, ref["result"], prob, cam_)[m]
                                    for m in lba.MEASURES}}
            outs = {}
            for f, b, d in forms:
                if d is None:
                    got, mid, trace = run_build(b.bk, prob, cam_, iters)
                else:
                    with b.sources(d):
                        got, mid, trace = run_build(b.bk, prob, cam_, iters)
                rep = lba.parity(got, want, prob, cam_, ref, (mid, mid_p[0].obs_valid))
                row[f] = reading(rep)
                failed[f] += not rep["ok"]
                _largest(worst[f], rep["kernel_vs_f64"])
                outs[f] = [_bits(x) for x in (got.T.R, got.T.t, got.Xw, got.obs_valid, mid,
                                              trace)]
                if f == "tree":
                    saved.update({f"c{k}_kernel_R": got.T.R, f"c{k}_kernel_t": got.T.t,
                                  f"c{k}_kernel_Xw": got.Xw})
            if a.parent:
                row["bit_identical"] = outs["tree"] == outs["parent"]
                same_bits += row["bit_identical"]
            print(json.dumps({**row, "card": name}), flush=True)
        summary = {"calls": len(calls), "largest_vs_f64": worst, "calls_failed": failed,
                   "f64_tol": lba.F64_TOL, "parity_tol": lba.PARITY_TOL, "card": name}
        if a.parent:
            summary["calls_bit_identical_to_parent"] = same_bits
        print(json.dumps(summary), flush=True)
        if a.save:
            cs.save_local_ba_calls(a.save, calls, {"n_kernel": np.array(len(calls)), **saved})

        if a.parent or a.stages:
            _, prob, cam_, iters = max(calls, key=lambda c: cs.local_ba_work(c[1]))
            cap = problem_from(map_cap_problem())
            cap = cap.replace(T=SE3(R=cap.T.R.to(dev), t=cap.T.t.to(dev)),
                              **{f: getattr(cap, f).to(dev) for f in FIELDS})
            cases = {"heaviest": (prob, cam_, iters), "map_cap": (cap, FULL_CAM, (5, 10))}
            print(json.dumps({"cases": {c: {"M": p.T.t.shape[0], "N": p.Xw.shape[0],
                                            "K": p.obs_frame.shape[0], "iters": it,
                                            "bound": cs.local_ba_bound(p, it)[:2]}
                                        for c, (p, _, it) in cases.items()},
                              "card": name}), flush=True)
            for b in builds if a.stages else []:
                copy, stages = copies[b.name]
                split = {c: stage_split(b, copy, stages,
                                        lambda b=b, p=p, cm=cm, it=it: b.bk.local_ba_cuda(p, cm,
                                                                                           *it))
                         for c, (p, cm, it) in cases.items()}
                print(json.dumps({"build": b.name, "stages": split, "card": name}), flush=True)
            print(json.dumps({"ms": timings(builds, cases), "card": name}), flush=True)
        clean = calls and all(failed[b.name] == 0 for b in builds)
        caught = all(failed[f] == len(calls) for f in FAULTS)
        return 0 if clean and caught else 1
    finally:
        shutil.rmtree(work, ignore_errors=True)


def cpu(path: Path) -> int:
    import jax
    import jax.numpy as jnp

    import libcml_tpu.models.indirect.indirect_ba as jiba
    from libcml_tpu.core.camera import PinholeCamera as JCam
    from libcml_tpu.core.lie import SE3 as JSE3

    run_jax = jax.jit(jiba.run_local_ba, static_argnames=("stage1_iters", "stage2_iters"))
    d = np.load(path)
    worst = {}
    for k in range(int(d["n"])):
        g = lambda f: d[f"c{k}_{f}"]  # noqa: E731
        fx, fy, cx, cy, w, h = g("cam").tolist()
        cam = PinholeCamera.make(fx, fy, cx, cy, int(w), int(h))
        s1, s2 = (int(v) for v in g("iters"))
        prob = iba.IndirectBAProblem(T=SE3(R=torch.tensor(g("R")), t=torch.tensor(g("t"))),
                                     **{f: torch.tensor(g(f)) for f in FIELDS})
        ref = lba.f64_run(prob, cam, s1, s2)["result"]
        pj = jiba.IndirectBAProblem(T=JSE3(R=jnp.asarray(g("R")), t=jnp.asarray(g("t"))),
                                    **{f: jnp.asarray(g(f)) for f in FIELDS})
        oj = run_jax(pj, JCam.make(fx, fy, cx, cy, int(w), int(h)),
                     stage1_iters=s1, stage2_iters=s2)
        forms = {
            "jax": prob.replace(T=SE3(R=torch.tensor(np.asarray(oj.T.R)),
                                      t=torch.tensor(np.asarray(oj.T.t))),
                                Xw=torch.tensor(np.asarray(oj.Xw)),
                                obs_valid=torch.tensor(np.asarray(oj.obs_valid))),
            "plain_cpu": iba.run_local_ba_plain(prob, cam, s1, s2),
            # the card kernel's T and points, with the float64 run's obs_valid
            # (_distances reads the reference's)
            "card_kernel": prob.replace(T=SE3(R=torch.tensor(g("kernel_R")),
                                              t=torch.tensor(g("kernel_t"))),
                                        Xw=torch.tensor(g("kernel_Xw")))}
        row = {"call": k, "M": prob.T.t.shape[0], "N": prob.Xw.shape[0],
               "K": prob.obs_frame.shape[0]}
        for name, res in forms.items():
            dist = lba._distances(res, ref, prob, cam)
            row[name] = {m: dist[m] for m in lba.MEASURES}
            _largest(worst.setdefault(name, {}), dist)
        print(json.dumps(row), flush=True)
    print(json.dumps({"calls": int(d["n"]), "largest_vs_f64": worst,
                      "f64_tol": lba.F64_TOL}), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--calls", type=Path, default=None,
                    help="read the calls from an .npz (chip_smoke.py --save-local-ba, --save)")
    ap.add_argument("--save", type=Path, default=None)
    ap.add_argument("--parent", type=Path, default=None,
                    help="another tree (a git archive of a parent commit)")
    ap.add_argument("--stages", action="store_true", help="split each kernel's time by stage")
    ap.add_argument("--jax", type=Path, default=None, help="an .npz that --save wrote")
    a = ap.parse_args()
    return cpu(a.jax) if a.jax else card(a)


if __name__ == "__main__":
    sys.exit(main())
