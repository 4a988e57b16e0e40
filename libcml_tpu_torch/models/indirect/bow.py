"""Bag-of-binary-words vocabulary, BoW vectors and relocalization retrieval.

PyTorch port of libcml_tpu/models/indirect/bow.py (the reference's DBoW2
TemplatedVocabulary.h / TemplatedDatabase.h / ScoringObject.cpp L1 scoring,
and Relocalization.{h,cpp}:10 candidate retrieval), with its DBoW2 text
export and load. DBoW2's tree is kept only as the training procedure
(hierarchical k-medians over binary strings, host numpy, copied as it is);
word lookup is one Hamming argmin of the descriptors against the leaf words
on the tensors' device. The inverted file stays a host structure.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from libcml_tpu_torch.models.indirect.orb import hamming_matrix

# the port's own vocabulary cache, beside the built kernels
DEFAULT_CACHE = Path(__file__).resolve().parents[2] / "_build" / "orb_vocabulary.npz"


# ---------------------------------------------------------------------------
# Vocabulary training (host numpy)
# ---------------------------------------------------------------------------


def _unpack_bits(words: np.ndarray) -> np.ndarray:
    """(N, 8) uint32 -> (N, 256) uint8 bits."""
    b = words.astype(">u4").view(np.uint8).reshape(len(words), -1)
    return np.unpackbits(b, axis=1)


def _pack_bits(bits: np.ndarray) -> np.ndarray:
    """(N, 256) bits -> (N, 8) uint32 words."""
    by = np.packbits(bits.astype(np.uint8), axis=1)
    return by.view(">u4").astype(np.uint32)


def _majority(bits: np.ndarray, w: np.ndarray) -> np.ndarray:
    """Weighted bitwise-majority centroid — the Hamming-space mean."""
    s = (bits * w[:, None]).sum(axis=0)
    return (s * 2 > w.sum()).astype(np.uint8)


def train_vocabulary(descriptors: np.ndarray, k: int = 10, depth: int = 3, iters: int = 8,
                     seed: int = 0) -> "BinaryVocabulary":
    """Hierarchical k-medians over binary descriptors (host-side, offline —
    mirrors DBoW2 training, TemplatedVocabulary.h). descriptors: (N, 8)
    32-bit words (uint32, or int32 bit patterns). Returns a vocabulary with
    up to k**depth leaf words."""
    rng = np.random.default_rng(seed)
    bits = _unpack_bits(np.asarray(descriptors).view(np.uint32))

    def cluster(idx: np.ndarray, level: int) -> list[np.ndarray]:
        sub = bits[idx]
        if level == depth or len(idx) <= k:
            return [_majority(sub, np.ones(len(idx)))] if len(idx) else []
        # k-medians with k-means++-style seeding on Hamming distance
        centers = sub[rng.choice(len(sub), size=min(k, len(sub)), replace=False)].copy()
        for _ in range(iters):
            d = (sub[:, None, :] != centers[None, :, :]).sum(axis=2)
            assign = d.argmin(axis=1)
            for c in range(len(centers)):
                m = assign == c
                if m.any():
                    centers[c] = _majority(sub[m], np.ones(m.sum()))
        leaves: list[np.ndarray] = []
        for c in range(len(centers)):
            m = assign == c
            if m.any():
                leaves.extend(cluster(idx[m], level + 1))
        return leaves

    leaf_bits = np.stack(cluster(np.arange(len(bits)), 0))
    words = _pack_bits(leaf_bits)
    # idf weights from the training corpus (DBoW2 TF_IDF default)
    d = (bits[:, None, :] != leaf_bits[None, :, :]).sum(axis=2) \
        if len(bits) * len(leaf_bits) < 4e7 else None
    if d is not None:
        wa = d.argmin(axis=1)
        df = np.bincount(wa, minlength=len(words)).astype(np.float64)
        idf = np.log(len(bits) / np.maximum(df, 1.0))
    else:
        idf = np.ones(len(words))
    return BinaryVocabulary(words, idf.astype(np.float32))


# ---------------------------------------------------------------------------
# Vocabulary
# ---------------------------------------------------------------------------


class BinaryVocabulary:
    """Flat leaf-word vocabulary with idf weights. `words` (W, 8) uint32 and
    `idf` (W,) float32 are host arrays; assignment runs on the device of the
    descriptors it is given."""

    def __init__(self, words: np.ndarray, idf: np.ndarray):
        self.words = np.asarray(words).view(np.uint32)
        self.idf = np.asarray(idf, np.float32)
        self.num_words = int(self.words.shape[0])
        self._dev: dict[torch.device, tuple[torch.Tensor, torch.Tensor]] = {}

    def save(self, path: str | Path):
        np.savez(path, words=self.words, idf=self.idf)

    @classmethod
    def load(cls, path: str | Path) -> "BinaryVocabulary":
        z = np.load(path)
        return cls(z["words"], z["idf"])

    def _on(self, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
        if device not in self._dev:
            self._dev[device] = (torch.as_tensor(self.words.view(np.int32)).to(device),
                                 torch.as_tensor(self.idf).to(device))
        return self._dev[device]

    def assign(self, desc: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        """(N, 8) descriptors -> (N,) word ids (-1 for invalid)."""
        words, _ = self._on(desc.device)
        wid = torch.argmin(hamming_matrix(desc, words), dim=1).to(torch.int32)
        return torch.where(valid, wid, torch.full_like(wid, -1))

    def bow_vector(self, desc: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        """L1-normalized tf-idf BoW vector (W,), dense on the device."""
        _, idf = self._on(desc.device)
        wid = self.assign(desc, valid)
        # term counts in integers: exact whatever order the device adds them
        tf = torch.zeros((self.num_words,), dtype=torch.int32, device=desc.device)
        tf = tf.index_add(0, torch.clamp(wid, min=0).long(), valid.to(torch.int32))
        v = tf.float() * idf
        return v / torch.clamp(torch.sum(torch.abs(v)), min=1e-9)


def score_l1(v1: torch.Tensor, v2: torch.Tensor) -> torch.Tensor:
    """DBoW2 L1 score in [0, 1] (ScoringObject.cpp L1Scoring) of two
    L1-normalized vectors: 1 - 0.5 |v1 - v2|_1."""
    return 1.0 - 0.5 * torch.sum(torch.abs(v1 - v2))


def default_vocabulary(cache: str | Path | None = None) -> BinaryVocabulary:
    """Self-trained stand-in for the reference's shipped ORBvoc: a compact
    vocabulary from the ORB descriptors of six rendered synthetic frames,
    trained once and cached (by default in the package's `_build/`). The
    training descriptors are extracted on the CPU, so the vocabulary is the
    same whichever device uses it later."""
    path = Path(cache) if cache is not None else DEFAULT_CACHE
    if path.is_file():
        return BinaryVocabulary.load(path)
    from libcml_tpu_torch.core.camera import PinholeCamera
    from libcml_tpu_torch.data.synthetic import SyntheticScene, forward_trajectory
    from libcml_tpu_torch.models.indirect.orb import extract_orb
    from libcml_tpu_torch.ops.image import build_pyramid

    cam = PinholeCamera.make(160.0, 160.0, 79.5, 59.5, 160, 120)
    scene = SyntheticScene.default(cam, seed=7)
    descs = []
    for R, t in forward_trajectory(6, step=0.3):
        img, _ = scene.render(R, t, supersample=1)
        f = extract_orb(build_pyramid(torch.as_tensor(np.asarray(img, np.float32)), 3),
                        budget_per_level=256)
        descs.append(f.desc.numpy()[f.valid.numpy()])
    voc = train_vocabulary(np.concatenate(descs), k=8, depth=3)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.stem}.{np.random.default_rng().integers(1 << 30)}.tmp.npz")
    voc.save(tmp)
    tmp.replace(path)       # atomic: a concurrent reader never sees a partial file
    return voc


# ---------------------------------------------------------------------------
# DBoW2 text-format export (vocabulary interchange with the reference)
# ---------------------------------------------------------------------------


def export_dbow2_text(descriptors: np.ndarray, path: str | Path, k: int = 10, depth: int = 4,
                      iters: int = 8, seed: int = 0) -> int:
    """Train a hierarchical vocabulary and write it in DBoW2's text format,
    loadable by the reference binary (reference:
    features/bow/TemplatedVocabulary.h:1318 loadFromText — header
    "k L scoring weighting", then one node per line:
    "parent isLeaf b0..b31 weight", node ids assigned in line order with
    parents always emitted before children). Host numpy, the JAX package's
    export line for line: the same descriptors give a byte-identical file.
    Returns the leaf count. Scoring 0 = L1_NORM, weighting 0 = TF_IDF (DBoW2
    enums)."""
    rng = np.random.default_rng(seed)
    bits = _unpack_bits(np.asarray(descriptors).view(np.uint32))
    n_total = len(bits)

    # nodes: list of (parent_id, is_leaf, bits(256,), weight)
    nodes: list[tuple[int, int, np.ndarray, float]] = []

    def cluster(idx: np.ndarray, level: int, parent: int) -> None:
        sub = bits[idx]
        if level == depth or len(idx) <= k:
            if len(idx) == 0:
                return
            centroid = _majority(sub, np.ones(len(idx)))
            idf = float(np.log(n_total / max(len(idx), 1)))
            nodes.append((parent, 1, centroid, max(idf, 1e-3)))
            return
        centers = sub[rng.choice(len(sub), size=min(k, len(sub)), replace=False)].copy()
        assign = np.zeros(len(sub), np.int64)
        for _ in range(iters):
            d = (sub[:, None, :] != centers[None, :, :]).sum(axis=2)
            assign = d.argmin(axis=1)
            for c in range(len(centers)):
                m = assign == c
                if m.any():
                    centers[c] = _majority(sub[m], np.ones(m.sum()))
        for c in range(len(centers)):
            m = assign == c
            if not m.any():
                continue
            my_id = len(nodes) + 1           # root is implicit node 0
            nodes.append((parent, 0, centers[c], 0.0))
            cluster(idx[m], level + 1, my_id)

    cluster(np.arange(n_total), 0, 0)

    n_leaves = 0
    with open(path, "w") as f:
        f.write(f"{k} {depth} 0 0\n")
        for parent, is_leaf, b, w in nodes:
            by = np.packbits(b.astype(np.uint8))
            f.write(f"{parent} {is_leaf} " + " ".join(str(int(x)) for x in by) + f" {w:.6f}\n")
            n_leaves += is_leaf
    return n_leaves


def load_dbow2_text(path: str | Path) -> BinaryVocabulary:
    """Load a DBoW2 text vocabulary's LEAF words as a flat BinaryVocabulary
    (assignment is one Hamming argmin over the leaves, so the interior tree
    nodes are not needed)."""
    leaves = []
    idf = []
    with open(path) as f:
        f.readline()
        for line in f:
            tok = line.split()
            if len(tok) != 35:
                continue
            if int(tok[1]) == 1:
                by = np.array([int(x) for x in tok[2:34]], np.uint8)
                leaves.append(by.view(">u4").astype(np.uint32))
                idf.append(float(tok[34]))
    return BinaryVocabulary(np.stack(leaves), np.asarray(idf, np.float32))


# ---------------------------------------------------------------------------
# Relocalization database
# ---------------------------------------------------------------------------


class KeyframeDatabase:
    """Inverted-file keyframe retrieval (reference: Relocalization.{h,cpp} /
    DBoW2 TemplatedDatabase.h): word -> set of keyframe ids, plus the stored
    BoW vectors for similarity ranking. Host-side."""

    def __init__(self, voc: BinaryVocabulary):
        self.voc = voc
        self._inv: dict[int, set[int]] = {}
        self._bow: dict[int, np.ndarray] = {}

    def add(self, kf_id: int, desc: torch.Tensor, valid: torch.Tensor):
        wid = self.voc.assign(desc, valid).cpu().numpy()
        self._bow[kf_id] = self.voc.bow_vector(desc, valid).cpu().numpy()
        for w in np.unique(wid[wid >= 0]):
            self._inv.setdefault(int(w), set()).add(kf_id)

    def remove(self, kf_id: int):
        self._bow.pop(kf_id, None)
        for s in self._inv.values():
            s.discard(kf_id)

    def query(self, desc: torch.Tensor, valid: torch.Tensor,
              max_results: int = 5) -> list[tuple[int, float]]:
        """Relocalization candidates: keyframes sharing at least 0.8x the
        best shared-word count (the ORB-SLAM rule the reference ports),
        ranked by L1 BoW similarity."""
        wid = self.voc.assign(desc, valid).cpu().numpy()
        counts: dict[int, int] = {}
        for w in np.unique(wid[wid >= 0]):
            for kf in self._inv.get(int(w), ()):
                counts[kf] = counts.get(kf, 0) + 1
        if not counts:
            return []
        min_common = max(1, int(0.8 * max(counts.values())))
        v = self.voc.bow_vector(desc, valid).cpu().numpy()
        scored = [(kf, float(1.0 - 0.5 * np.abs(v - self._bow[kf]).sum()))
                  for kf, c in counts.items() if c >= min_common]
        scored.sort(key=lambda x: -x[1])
        return scored[:max_results]
