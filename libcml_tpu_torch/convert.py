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


# the hybrid's map arena (HybridOdometry attributes of both packages)
HYBRID_ARENA = ("_pt_Xw", "_pt_desc", "_pt_level", "_pt_valid", "_pt_last_seen", "_pt_gen",
                "_pt_mapid")


def _u32(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.int32 else a


def hybrid_state(odo) -> dict:
    """A HybridOdometry's indirect state as numpy (works on either
    package's object): the map arena, the indirect keyframe ring, the
    relocalization store, and the vocabulary's words and idf (None before
    the first indirect keyframe). Descriptor words are uint32."""
    d = {k: np.array(getattr(odo, k)) for k in HYBRID_ARENA}
    d["_pt_desc"] = _u32(d["_pt_desc"])
    d["ind_kfs"] = [{k: np.array(v) for k, v in kf.items()} for kf in odo._ind_kfs]
    d["kf_store"] = {kf: {k: _u32(v).copy() if k == "desc" else np.array(v)
                          for k, v in st.items()} for kf, st in odo._kf_store.items()}
    voc = odo._kfdb.voc if odo._kfdb is not None else None
    d["vocabulary"] = None if voc is None else {
        "words": np.array(voc.words).view(np.uint32), "idf": np.array(voc.idf, np.float32)}
    return d


def load_hybrid_state(odo, d: dict) -> None:
    """Set a port HybridOdometry's indirect state from `hybrid_state`'s
    dict (of either package). The relocalization index is rebuilt from the
    store at its next query."""
    from libcml_tpu_torch.models.indirect.bow import BinaryVocabulary, KeyframeDatabase

    for k in HYBRID_ARENA:
        setattr(odo, k, np.array(d[k]))
    odo._pt_desc = odo._pt_desc.view(np.int32)
    odo._map_dev = None
    odo._ind_kfs = [{k: (int(v) if np.ndim(v) == 0 else np.array(v)) for k, v in kf.items()}
                    for kf in d["ind_kfs"]]
    odo._kf_store = {int(kf): {k: v.view(np.int32).copy() if k == "desc" else np.array(v)
                               for k, v in st.items()} for kf, st in d["kf_store"].items()}
    voc = d["vocabulary"]
    odo._kfdb = None if voc is None else KeyframeDatabase(
        BinaryVocabulary(voc["words"], voc["idf"]))
    odo._kfdb_pending = list(odo._kf_store)


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
