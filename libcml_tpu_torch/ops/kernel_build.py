"""Build and load the port's hand-written CUDA kernels (csrc/*.cu).

Each source compiles with nvcc for sm_90a into a shared library with a plain
C interface under `_build/` beside this package, named after the source and
keyed by its content hash, at first use; the wrappers bind it with ctypes.
Nothing here runs when a module is imported, so the CPU tests (no nvcc, no
card) import every wrapper freely.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
# every kernel of the port
SOURCES = (CSRC / "hamming_match.cu", CSRC / "track_lm.cu", CSRC / "pnp_lm.cu",
           CSRC / "ba_sweep.cu", CSRC / "ba_solve.cu", CSRC / "ba_run.cu",
           CSRC / "trace_epipolar.cu", CSRC / "local_ba.cu", CSRC / "orb_extract.cu",
           CSRC / "triangulate.cu", CSRC / "kf_activate.cu", CSRC / "kf_refresh.cu")


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused the kernel source."""


class KernelLaunchError(RuntimeError):
    """The CUDA launch returned an error."""


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
                 shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise KernelBuildError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def library_path(source: Path) -> Path:
    """The shared library of `source`, keyed by the content hash of the
    source and of the csrc/ headers it includes (`#include "name.cuh"`,
    and theirs in turn)."""
    h = hashlib.sha256()
    seen, todo = set(), [source]
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.add(path)
        text = path.read_bytes()
        h.update(text)
        todo += [source.parent / name.decode()
                 for name in re.findall(rb'^#include "([^"]+)"', text, flags=re.M)]
    return BUILD_DIR / f"lib{source.stem}-{h.hexdigest()[:12]}.so"


def build_many(sources, verbose: bool = False) -> list[tuple[Path, float, str]]:
    """Compile every source whose library is missing, one nvcc process each,
    all started together. Returns, per source, (library path, seconds its
    compile took (0.0 when already built), compiler output — ptxas's
    register and shared-memory report when `verbose`)."""
    jobs = []
    for source in sources:
        lib = library_path(source)
        if lib.exists():
            jobs.append((lib, None, None, None))
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
               "-o", str(tmp), str(source)]
        if verbose:
            cmd[1:1] = ["-Xptxas", "-v"]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        jobs.append((lib, tmp, proc, time.perf_counter()))
    done = [(lib, tmp, proc, *proc.communicate(), time.perf_counter() - t0)
            if proc else (lib, None, None, "", "", 0.0) for lib, tmp, proc, t0 in jobs]
    for lib, tmp, proc, _, stderr, _ in done:
        if proc is not None and proc.returncode != 0:
            raise KernelBuildError(f"nvcc failed on {lib.name} ({proc.returncode}):\n{stderr}")
    for lib, tmp, proc, _, _, _ in done:
        if proc is not None:
            os.replace(tmp, lib)   # atomic: a concurrent build never sees a partial file
    return [(lib, seconds, stdout + stderr) for lib, _, _, stdout, stderr, seconds in done]


_LIBS: dict[Path, ctypes.CDLL] = {}


def load(source: Path, symbol: str, argtypes: list) -> ctypes.CDLL:
    """The library of `source` (built at first use), with `symbol`'s
    argument types set and an int (cudaError_t) result."""
    lib = _LIBS.get(source)
    if lib is None:
        path, _, _ = build_many([source])[0]
        lib = ctypes.CDLL(str(path))
        _LIBS[source] = lib
    fn = getattr(lib, symbol)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


# csrc/grid_barrier.cuh BAR_WORDS: 8 arrival counts and the departures, one
# 128-byte line each
BARRIER_WORDS = 9 * 32
_BARRIERS: dict[tuple[torch.device, str], torch.Tensor] = {}


def grid_barrier(dev: torch.device, owner: str) -> torch.Tensor:
    """The grid barrier (csrc/grid_barrier.cuh) of the cooperative kernel
    `owner` on `dev`: its arrival counts and departure count, all 0 between
    launches (the kernel's last block out resets them). One an owner and
    device: an owner's launches on one device run in stream order."""
    key = (torch.device(dev), owner)
    c = _BARRIERS.get(key)
    if c is None:
        c = _BARRIERS[key] = torch.zeros(BARRIER_WORDS, dtype=torch.int32, device=dev)
    return c


def cluster_info(source: Path, symbol: str, device: torch.device | None = None) -> dict:
    """An LM kernel's cluster size and the clusters the card holds at once,
    from its `symbol(int* cluster, int* max_active)` query."""
    lib = load(source, symbol, [ctypes.POINTER(ctypes.c_int)] * 2)
    cluster, active = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(device or torch.device("cuda")):
        err = getattr(lib, symbol)(ctypes.byref(cluster), ctypes.byref(active))
    if err != 0:
        raise KernelLaunchError(f"{symbol} failed: CUDA error {err}")
    return {"cluster": cluster.value, "max_active_clusters": active.value}


def check_tensor(name: str, x: torch.Tensor, shape: tuple, dtype: torch.dtype,
                 device: torch.device) -> None:
    """Raise unless `x` is a contiguous `dtype` tensor of `shape` on `device`."""
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
