"""State carry-over between the JAX package and this port, through numpy.

The JAX package keeps its state in pytrees of dataclasses; fetched with
`jax.device_get` and flattened with `dataclasses.asdict`, they become nested
dicts of numpy arrays. The functions here turn such dicts into this port's
dataclasses on a given device, and back into dicts of numpy arrays for
comparison, so both packages can start from identical state. Nothing here
imports either package's JAX side.

Layout rules: leaves keep their shapes and meaning. 32-bit unsigned words
(ORB descriptors) become int32 tensors holding the same bits; camera
intrinsics become Python floats.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from libcml_tpu_torch.core.camera import PinholeCamera
from libcml_tpu_torch.core.lie import SE3
from libcml_tpu_torch.models.direct.ba import BAState
from libcml_tpu_torch.models.direct.initializer import InitializerState
from libcml_tpu_torch.models.direct.tracer import ImmatureArena
from libcml_tpu_torch.models.direct.tracker import TrackerRef
from libcml_tpu_torch.models.direct.window import Window
from libcml_tpu_torch.models.indirect.matching import MatchResult
from libcml_tpu_torch.models.indirect.orb import OrbFeatures

# dataclass fields that hold another dataclass
_NESTED = {
    (BAState, "T"): SE3,
    (BAState, "T_fej"): SE3,
    (InitializerState, "T"): SE3,
    (Window, "ba"): BAState,
}


def tensor(x, device: str | torch.device = "cpu") -> torch.Tensor:
    """numpy array (or scalar) -> tensor on `device`; uint32 keeps its bits
    as int32."""
    a = np.asarray(x)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.tensor(a, device=device)


def camera(d: dict) -> PinholeCamera:
    """A PinholeCamera dict (fx, fy, cx, cy, width, height)."""
    return PinholeCamera.make(float(np.asarray(d["fx"])), float(np.asarray(d["fy"])),
                              float(np.asarray(d["cx"])), float(np.asarray(d["cy"])),
                              int(d["width"]), int(d["height"]))


def from_np(cls, d: dict, device: str | torch.device = "cpu"):
    """Build dataclass `cls` (SE3, TrackerRef, ImmatureArena, BAState,
    Window, InitializerState, OrbFeatures, MatchResult) from a dict of numpy
    arrays, every leaf on `device`."""
    if cls is PinholeCamera:
        return camera(d)
    kw = {}
    for f in dataclasses.fields(cls):
        v = d[f.name]
        sub = _NESTED.get((cls, f.name))
        kw[f.name] = from_np(sub, v, device) if sub is not None else tensor(v, device)
    return cls(**kw)


def to_np(obj: Any):
    """Dataclass of tensors (nested) -> dict of numpy arrays; tensors ->
    numpy; anything else unchanged."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: to_np(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    if isinstance(obj, (tuple, list)):
        return type(obj)(to_np(x) for x in obj)
    return obj
