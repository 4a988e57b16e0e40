"""Point-sharded bundle adjustment over torch.distributed ranks.

Port of libcml_tpu/parallel/sharding.py. The JAX package shards the BA's
point arena over a device mesh and lets pjit insert the reductions; here
every rank is one process (SPMD over `torch.distributed`, one card each)
and the reductions are written out in models/direct/ba.py:

  - Storage stays replicated: every rank holds the whole window and the
    whole odometry state, since the tracker, the tracer and the working
    inverse-depth range read every point. Each rank runs the same
    `DirectOdometry` on the same frames.
  - Compute over the point axis is split: each rank linearizes, assembles
    and Schur-reduces its contiguous block of point rows (`point_sharding`).
    One all-reduce (sum) a Levenberg-Marquardt step carries the partial
    camera system, its gradient and the Schur corrections, and one the
    photometric energy of the accept test. The terms every rank holds whole
    (the marginalization prior, the gauge priors, the affine anchors, the
    mixed BA's indirect factors) are added once, after the reduction.
  - Every rank then solves the same (8F)^2 system, takes the same accept
    branch and applies the same step; the inverse-depth updates of each
    rank's rows are all-gathered, so the stored state stays bit-identical
    across ranks.

A world of one runs exactly the unsharded arithmetic plus identity
collectives. CPU tests run ranks as gloo processes; on the card each rank
uses NCCL (`torchrun --nproc_per_node=N`, or a world of one in the calling
process).
"""

from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist

from libcml_tpu_torch._device import resolve_device
from libcml_tpu_torch.core.lie import SE3


def _canonical(device: str | torch.device) -> torch.device:
    """A device with its index filled in ("cuda" -> "cuda:<current>")."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


@dataclasses.dataclass(eq=False)
class Mesh:
    """A 1-D mesh over the points axis: the process group, this process's
    rank in it, the world size, and the device this rank computes on.
    Counts the collectives it runs."""

    group: dist.ProcessGroup
    rank: int
    world_size: int
    device: torch.device
    all_reduces: int = 0
    all_gathers: int = 0

    def check_device(self, device: str | torch.device) -> None:
        """Raise unless `device` is this rank's device (nothing is copied
        across devices)."""
        if _canonical(device) != self.device:
            raise ValueError(f"the mesh computes on {self.device}, not on {device}")

    def all_reduce(self, *parts: torch.Tensor) -> tuple[torch.Tensor, ...]:
        """Sum float32 tensors over the ranks in ONE all-reduce (packed
        flat); returns them in their shapes."""
        flat = torch.cat([p.reshape(-1) for p in parts])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=self.group)
        self.all_reduces += 1
        out, at = [], 0
        for p in parts:
            out.append(flat[at:at + p.numel()].reshape(p.shape))
            at += p.numel()
        return tuple(out)

    def all_gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """Concatenate every rank's block of rows, in rank order (one
        all-gather; bool travels as uint8)."""
        send = (x.to(torch.uint8) if x.dtype == torch.bool else x).contiguous()
        parts = [torch.empty_like(send) for _ in range(self.world_size)]
        dist.all_gather(parts, send, group=self.group)
        self.all_gathers += 1
        out = torch.cat(parts)
        return out.bool() if x.dtype == torch.bool else out


def make_mesh(n_devices: int | None = None, device: str | torch.device | None = None) -> Mesh:
    """The mesh over the default process group: the one that exists (under
    `torchrun`, or one the caller made), else one made from torchrun's
    environment, else a world of one in this process. NCCL on the card (the
    rank's card made current first); gloo only when the caller asks for
    device="cpu". Raises if `n_devices` is given and differs from the world
    size."""
    on_cpu = device is not None and torch.device(device).type == "cpu"
    backend = "gloo" if on_cpu else "nccl"
    if on_cpu:
        dev = torch.device("cpu")
    else:
        dev = resolve_device(device)
        if dev.index is None:
            dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
            dist.init_process_group(backend)
        else:
            dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    if dist.get_backend() != backend:
        raise ValueError(f"the default process group uses {dist.get_backend()}; a mesh on "
                         f"{dev} needs {backend}")
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"asked for a mesh of {n_devices}, the world has {world} ranks")
    return Mesh(group=dist.group.WORLD, rank=dist.get_rank(), world_size=world, device=dev)


@dataclasses.dataclass(frozen=True)
class PointSharding:
    """Rows split in contiguous blocks over the ranks, in rank order."""

    mesh: Mesh

    def rows(self, n: int) -> slice:
        """This rank's block of `n` rows; `n` must divide evenly."""
        w = self.mesh.world_size
        if n % w:
            raise ValueError(f"{n} point rows do not divide evenly over {w} ranks")
        per = n // w
        return slice(self.mesh.rank * per, (self.mesh.rank + 1) * per)

    def local(self, x):
        """This rank's rows of a tensor (or SE3) whose leading axis is split."""
        s = self.rows(_lead(x))
        return SE3(R=x.R[s], t=x.t[s]) if isinstance(x, SE3) else x[s]


@dataclasses.dataclass(frozen=True)
class Replicated:
    """Every rank holds (and computes on) the whole array."""

    mesh: Mesh

    def local(self, x):
        return x


def point_sharding(mesh: Mesh) -> PointSharding:
    return PointSharding(mesh)


def replicated(mesh: Mesh) -> Replicated:
    return Replicated(mesh)


def _lead(x) -> int:
    return (x.t if isinstance(x, SE3) else x).shape[0]


def _to(x, device: torch.device):
    return SE3(R=x.R.to(device), t=x.t.to(device)) if isinstance(x, SE3) else x.to(device)


def ba_shardings(ba_state, mesh: Mesh) -> dict:
    """A spec per BAState field, by the JAX package's rule: a field whose
    leading dimension is the point capacity P goes over the points, the
    frame-indexed and prior fields are replicated."""
    P = ba_state.num_points
    pts, rep = point_sharding(mesh), replicated(mesh)
    return {f.name: pts if _lead(getattr(ba_state, f.name)) == P else rep
            for f in dataclasses.fields(ba_state)}


def local_rows(ba_state, mesh: Mesh | None):
    """The BAState this rank computes on: its block of point rows, the frame
    and prior fields whole (the state itself without a mesh)."""
    if mesh is None:
        return ba_state
    specs = ba_shardings(ba_state, mesh)
    return ba_state.replace(**{name: spec.local(getattr(ba_state, name))
                               for name, spec in specs.items()})


def shard_ba_state(ba_state, mesh: Mesh):
    """Check a BAState against the mesh's layout (P divides evenly over the
    ranks) and place it on the mesh's device. Storage stays whole on every
    rank; the split is of compute (module docstring)."""
    specs = ba_shardings(ba_state, mesh)
    for name, spec in specs.items():
        if isinstance(spec, PointSharding):
            spec.rows(_lead(getattr(ba_state, name)))
    return ba_state.replace(**{name: _to(getattr(ba_state, name), mesh.device)
                               for name in specs})


def sharded_ba_step(cam, cfg, mesh: Mesh):
    """run_ba over the mesh. Returns a callable (ba_state, images) ->
    (new_state, energy), run by every rank on the same (replicated) inputs."""
    from libcml_tpu_torch.models.direct import ba as ba_mod

    def step(ba_state, images):
        return ba_mod.run_ba(shard_ba_state(ba_state, mesh), images.to(mesh.device), cam, cfg,
                             mesh=mesh)

    return step
