"""Evaluation harness: run-the-SLAM experiment runner with a JSON result
cache, ATE/RPE batteries and parameter sweeps.

Port of libcml_tpu/eval/harness.py (reference: evaluation/slam.py —
ModSLAM process wrapper + binary-hash identity; evaluation/evaluator.py:30-41
— evo APE/RPE rmse; evaluation/database.py:18-31 — JSON result cache keyed by
(binary hash, config, dataset), "experiences never run twice" README.md:176;
evaluation/statson.py — ATE battery over sequences; evaluation/bruteforce.py
+ genetic.py — parameter sweeps).

Runs are in-process on the CUDA card unless `device="cpu"` asks for the CPU.
The "binary" identity is the hash of this package's sources (its Python,
CUDA and C++ files), so the port and the JAX package never share a cache
entry; the device is part of a run's identity too. The sweep tier is
embarrassingly parallel across hosts: each host takes a slice of the
experiment list, and results meet in the shared cache."""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import json
import os
import time
from typing import Any, Callable, Iterable

import numpy as np

from libcml_tpu_torch._device import resolve_device
from libcml_tpu_torch.eval.trajectory import ate_rmse, rpe_rmse


@functools.lru_cache(maxsize=1)
def _code_hash() -> str:
    """Hash of this package's sources (Python, CUDA, C++): the reference keys
    its cache on the binary's hash so stale results are never reused
    (slam.py getHash). Computed once per process; the source cannot change
    mid-run."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    h = hashlib.sha256()
    for dirpath, dirs, files in os.walk(root):
        dirs[:] = sorted(d for d in dirs if d != "_build")
        for f in sorted(files):
            if f.endswith((".py", ".cu", ".cpp")):
                with open(os.path.join(dirpath, f), "rb") as fh:
                    h.update(fh.read())
    return h.hexdigest()[:16]


def _config_key(config: Any) -> str:
    if dataclasses.is_dataclass(config):
        config = dataclasses.asdict(config)
    return hashlib.sha256(
        json.dumps(config, sort_keys=True, default=str).encode()
    ).hexdigest()[:16]


class ResultDatabase:
    """JSON experiment cache: (code hash, config, dataset) -> metrics.
    An experiment already in the database is never run twice
    (reference: database.py:18-31)."""

    def __init__(self, path: str = "results/experiments.json"):
        self.path = path
        self._db: dict[str, dict] = {}
        if os.path.isfile(path):
            with open(path) as f:
                self._db = json.load(f)

    def key(self, dataset: str, config: Any, extra: str = "") -> str:
        """Cache identity. `extra` carries run parameters that change the
        result but live outside the config object (max_frames, the odometry
        class) — omitting them would let a truncated run shadow a full one."""
        return f"{_code_hash()}:{_config_key(config)}:{dataset}:{extra}"

    def get(self, dataset: str, config: Any, extra: str = "") -> dict | None:
        return self._db.get(self.key(dataset, config, extra))

    def put(self, dataset: str, config: Any, metrics: dict, extra: str = ""):
        self._db[self.key(dataset, config, extra)] = metrics
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self._db, f, indent=1, sort_keys=True)
        os.replace(tmp, self.path)


def run_sequence(
    dataset_path: str,
    config: Any = None,
    odometry_factory: Callable | None = None,
    max_frames: int = 0,
    db: ResultDatabase | None = None,
    device: str | None = None,
) -> dict:
    """Run the SLAM over one sequence on `device` (the card unless the
    caller names the CPU), compute ATE/RPE vs groundtruth when available,
    cache the result. Returns the metrics dict (reference: statson.py
    per-sequence entry)."""
    from libcml_tpu_torch.data.capture import load_dataset
    from libcml_tpu_torch.models.direct.config import DirectConfig
    from libcml_tpu_torch.runtime.hybrid import HybridOdometry

    dev = resolve_device(device)
    factory = odometry_factory or HybridOdometry
    extra = f"{getattr(factory, '__qualname__', str(factory))}:{max_frames}:{dev.type}"
    if db is not None:
        hit = db.get(dataset_path, config, extra)
        if hit is not None:
            return {**hit, "cached": True}

    cap = load_dataset(dataset_path)
    cfg = config or DirectConfig()
    # full calibration: device-side rectification + photometric correction
    odo = factory(cap.calibration, cfg, device=dev)

    t0 = time.time()
    n = 0
    gt_poses = []
    for frame in cap.frames():
        odo.process(frame.image, frame.timestamp,
                    gt_pose_c2w=frame.gt_pose_c2w)
        gt_poses.append(frame.gt_pose_c2w)
        n += 1
        if max_frames and n >= max_frames:
            break
    wall = time.time() - t0

    ts, est = odo.trajectory_c2w()
    metrics: dict[str, Any] = {
        "dataset": dataset_path,
        "frames": n,
        "wall_s": round(wall, 3),
        "fps": round(n / max(wall, 1e-9), 2),
        "device": str(dev),
        "cached": False,
    }
    gts = [g for g in gt_poses if g is not None]
    if len(gts) == len(gt_poses) and len(gts) >= 3:
        gt_c2w = np.asarray(gts)
        metrics["ate_rmse"] = ate_rmse(est[:, :3, 3], gt_c2w[:, :3, 3])
        metrics["rpe_rmse"] = rpe_rmse(est, gt_c2w)
    if db is not None:
        db.put(dataset_path, config, metrics, extra)
    return metrics


def statson(
    sequences: Iterable[str],
    config: Any = None,
    db: ResultDatabase | None = None,
    **kw,
) -> list[dict]:
    """ATE battery over sequences (reference: statson.py)."""
    out = []
    for seq in sequences:
        m = run_sequence(seq, config, db=db, **kw)
        print(f"STAT ate {seq} {m.get('ate_rmse', float('nan')):.5f}")
        out.append(m)
    return out


def genetic_search(
    sequences: list[str],
    base_config: Any,
    space: dict[str, tuple],
    generations: int = 20,
    population: int = 12,
    elite: int = 3,
    mutation: float = 0.3,
    seed: int = 0,
    db: ResultDatabase | None = None,
    host_index: int = 0,
    num_hosts: int = 1,
    **kw,
) -> list[dict]:
    """Evolutionary parameter search (reference: evaluation/genetic.py —
    200-generation evolutionary sweep over SLAM parameters). `space` maps
    dotted config keys to (low, high) ranges (numeric) or tuples of choices.
    Fitness = mean ATE over `sequences` (lower is better; failed runs score
    inf). Each generation's population is sharded round-robin across hosts
    (the DCN evaluation tier); results meet in the shared cache, so
    re-evaluating an elite individual is free."""
    import random

    from libcml_tpu_torch.runtime.config import apply_config

    rng = random.Random(seed)
    keys = sorted(space)

    def sample_gene(k):
        lo_hi = space[k]
        if isinstance(lo_hi, tuple) and len(lo_hi) == 2 and all(
            isinstance(v, (int, float)) for v in lo_hi
        ):
            lo, hi = lo_hi
            v = rng.uniform(float(lo), float(hi))
            return int(round(v)) if isinstance(lo, int) and isinstance(hi, int) else v
        return rng.choice(list(lo_hi))

    def mutate(genome):
        return {
            k: (sample_gene(k) if rng.random() < mutation else v)
            for k, v in genome.items()
        }

    def crossover(a, b):
        return {k: (a[k] if rng.random() < 0.5 else b[k]) for k in keys}

    def fitness(genome):
        cfg = apply_config(base_config, genome)
        ates = []
        for seq in sequences:
            try:
                m = run_sequence(seq, cfg, db=db, **kw)
            except Exception:
                return float("inf"), None
            ates.append(m.get("ate_rmse", float("inf")))
        return float(np.mean(ates)), cfg

    pop = [{k: sample_gene(k) for k in keys} for _ in range(population)]
    history = []
    for gen in range(generations):
        scored = []
        for i, genome in enumerate(pop):
            if i % num_hosts != host_index:
                continue
            f, _ = fitness(genome)
            scored.append((f, genome))
        scored.sort(key=lambda x: x[0])
        best_f, best_g = scored[0]
        history.append({"generation": gen, "best_ate": best_f,
                        "best": dict(best_g)})
        print(f"STAT genetic {gen} {best_f:.5f}")
        elites = [g for _, g in scored[:elite]]
        children = []
        while len(children) < population - len(elites):
            children.append(mutate(crossover(rng.choice(elites),
                                             rng.choice(elites))))
        pop = elites + children
    return history


def plot_results(results: list[dict], out_path: str,
                 x_key: str = "dataset", y_key: str = "ate_rmse") -> str:
    """Bar/line chart of harness results (reference: evaluation/plotall.py /
    make2dtable.py). Uses matplotlib when available, else writes an SVG bar
    chart by hand — zero hard dependencies for a headless pod."""
    xs = [str(r.get(x_key, "?")).rsplit("/", 1)[-1] for r in results]
    ys = [float(r.get(y_key, float("nan"))) for r in results]
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(max(4, len(xs)), 3))
        ax.bar(range(len(xs)), ys)
        ax.set_xticks(range(len(xs)), xs, rotation=45, ha="right")
        ax.set_ylabel(y_key)
        fig.tight_layout()
        fig.savefig(out_path)
        plt.close(fig)
        return out_path
    except Exception:
        w, h = 80 * max(1, len(xs)), 240
        ymax = max([y for y in ys if np.isfinite(y)] + [1e-9])
        bars = []
        for i, (x, y) in enumerate(zip(xs, ys)):
            bh = 0 if not np.isfinite(y) else int(180 * y / ymax)
            bars.append(
                f'<rect x="{10 + i * 80}" y="{200 - bh}" width="60" '
                f'height="{bh}" fill="#4a7"/>'
                f'<text x="{40 + i * 80}" y="220" font-size="10" '
                f'text-anchor="middle">{x}</text>'
                f'<text x="{40 + i * 80}" y="{195 - bh}" font-size="10" '
                f'text-anchor="middle">{y:.3g}</text>'
            )
        svg = (f'<svg xmlns="http://www.w3.org/2000/svg" width="{w}" '
               f'height="{h}">' + "".join(bars) + "</svg>")
        path = out_path if out_path.endswith(".svg") else out_path + ".svg"
        with open(path, "w") as f:
            f.write(svg)
        return path


def bruteforce_sweep(
    sequences: list[str],
    base_config: Any,
    grid: dict[str, list],
    db: ResultDatabase | None = None,
    host_index: int = 0,
    num_hosts: int = 1,
    **kw,
) -> list[dict]:
    """Grid parameter sweep (reference: bruteforce.py). `grid` maps dotted
    config keys to candidate values; the cartesian product is sharded
    round-robin across hosts (the multi-host evaluation tier — each host
    owns a disjoint slice, results meet in the shared cache)."""
    import itertools

    from libcml_tpu_torch.runtime.config import apply_config

    keys = sorted(grid)
    combos = list(itertools.product(*(grid[k] for k in keys)))
    results = []
    for i, combo in enumerate(combos):
        if i % num_hosts != host_index:
            continue
        settings = dict(zip(keys, combo))
        cfg = apply_config(base_config, settings)
        for seq in sequences:
            m = run_sequence(seq, cfg, db=db, **kw)
            results.append({**m, "settings": settings})
    return results
