"""The port's DBoW2 text I/O (models/indirect/bow.py export_dbow2_text,
load_dbow2_text) against the JAX package's, on the CPU.

The vocabulary is trained from the ORB descriptors of two rendered synthetic
frames (nothing is downloaded). Both packages run the same host numpy code
with the same seed, so the files they write must be byte-identical, each
must load the other's file with equal leaf words and idf, and word
assignment must agree exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import libcml_tpu.models.indirect.bow as jbow
import libcml_tpu.models.indirect.orb as jorb
import libcml_tpu_torch.models.indirect.bow as tbow
from libcml_tpu.core.camera import PinholeCamera as JCam
from libcml_tpu.data.synthetic import SyntheticScene, forward_trajectory
from libcml_tpu.ops.image import build_pyramid as jbuild_pyramid
from libcml_tpu_torch import convert

torch.set_num_threads(1)

# (k, depth): the export's defaults, and a shallow tree whose leaves sit at
# several levels (clusters of <= k descriptors stop early)
TREES = [(10, 4), (6, 2)]


@pytest.fixture(scope="module")
def descriptors():
    """uint32 ORB descriptors of two rendered 160x120 frames (3 levels, 128
    a level), extracted by the JAX package, and a valid mask for the last."""
    cam = JCam.make(110.0, 110.0, 79.5, 59.5, 160, 120)
    scene = SyntheticScene.default(cam, seed=4)
    descs, last = [], None
    for R, t in forward_trajectory(2, step=0.2):
        img, _ = scene.render(R, t)
        last = jax.device_get(jorb.extract_orb(jbuild_pyramid(jnp.asarray(img), 3),
                                               budget_per_level=128))
        descs.append(np.asarray(last.desc)[np.asarray(last.valid)])
    return np.concatenate(descs).astype(np.uint32), last


@pytest.mark.parametrize("k,depth", TREES)
def test_dbow2_files_are_byte_identical(descriptors, tmp_path, k, depth):
    desc, _ = descriptors
    pj, pt, pi = tmp_path / "jax.txt", tmp_path / "torch.txt", tmp_path / "torch_i32.txt"
    nj = jbow.export_dbow2_text(desc, str(pj), k=k, depth=depth, seed=3)
    nt = tbow.export_dbow2_text(desc, pt, k=k, depth=depth, seed=3)
    # the port's descriptors are int32 bit patterns: the same file
    ni = tbow.export_dbow2_text(desc.view(np.int32), pi, k=k, depth=depth, seed=3)
    assert nj == nt == ni > k
    assert pt.read_bytes() == pj.read_bytes() == pi.read_bytes()
    header = pt.read_text().splitlines()[0]
    assert header == f"{k} {depth} 0 0"


@pytest.mark.parametrize("k,depth", TREES)
def test_dbow2_files_cross_load(descriptors, tmp_path, k, depth):
    """Each package loads the other's file: equal leaf words and idf, and
    the same word for every descriptor of a frame."""
    desc, feats = descriptors
    pj, pt = tmp_path / "jax.txt", tmp_path / "torch.txt"
    jbow.export_dbow2_text(desc, str(pj), k=k, depth=depth)
    tbow.export_dbow2_text(desc, pt, k=k, depth=depth)
    vt = tbow.load_dbow2_text(pj)
    vj = jbow.load_dbow2_text(str(pt))
    assert vt.num_words == vj.num_words
    np.testing.assert_array_equal(vt.words, np.asarray(vj.words))
    np.testing.assert_array_equal(vt.idf, np.asarray(vj.idf))
    assert vt.words.dtype == np.uint32 and vt.idf.dtype == np.float32
    wid_t = vt.assign(convert.tensor(np.asarray(feats.desc)),
                      convert.tensor(np.asarray(feats.valid)))
    wid_j = vj.assign(feats.desc, feats.valid)
    np.testing.assert_array_equal(wid_t.numpy(), np.asarray(wid_j))
    assert (wid_t.numpy() >= 0).sum() == int(np.asarray(feats.valid).sum())
