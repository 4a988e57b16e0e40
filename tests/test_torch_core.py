"""Parity of the PyTorch port's core layer (lie, camera, image) with the JAX
package, on the CPU.

Every input is made from a seed with numpy and goes through the JAX function
and its port. Tolerances: the two packages run the same float32 formulas, so
results agree to a few float32 ulps (XLA may fuse a multiply-add where torch
rounds twice); near-singular maps (log near pi) get a looser bound, stated
where used. The host (numpy) code copied into the port must agree exactly.
"""

import ast
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import libcml_tpu.core.camera as jcam
import libcml_tpu.core.lie as jlie
import libcml_tpu.ops.image as jimg
import libcml_tpu_torch.core.camera as tcam
import libcml_tpu_torch.core.lie as tlie
import libcml_tpu_torch.ops.image as timg
from libcml_tpu_torch import _device

# The suite runs in several worker processes that share a few cores: one
# torch thread each, since with torch's default thread pool per process the
# workers' spinning threads slow each other down many times over.
torch.set_num_threads(1)

PORT = pathlib.Path(tlie.__file__).resolve().parents[1]
ROOT = PORT.parent

# f32 formulas evaluated by two frameworks: a few ulps of relative error
F32 = dict(rtol=2e-5, atol=2e-6)


def _j(x):
    return jnp.asarray(x)


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _twists(rng, n, scale=1.0):
    return (rng.normal(size=(n, 6)) * scale).astype(np.float32)


def _rot_vectors(rng, n):
    w = rng.normal(size=(n, 3))
    # |w| < pi keeps the log unique
    return (w / (1.0 + np.linalg.norm(w, axis=-1, keepdims=True)) * 3.0).astype(np.float32)


# -- lie -----------------------------------------------------------------------

LIE_CASES = {
    "skew": lambda m, w, xi: m.skew(w),
    "so3_exp": lambda m, w, xi: m.so3_exp(w),
    "so3_log": lambda m, w, xi: m.so3_log(m.so3_exp(w)),
    "so3_V": lambda m, w, xi: m.so3_V(w),
    "so3_V_inv": lambda m, w, xi: m.so3_V_inv(w),
    "se3_exp_R": lambda m, w, xi: m.se3_exp(xi).R,
    "se3_exp_t": lambda m, w, xi: m.se3_exp(xi).t,
    "se3_log": lambda m, w, xi: m.se3_log(m.se3_exp(xi)),
    "compose_inverse": lambda m, w, xi: m.se3_exp(xi).compose(m.se3_exp(0.7 * xi).inverse()).t,
    "to": lambda m, w, xi: m.se3_exp(xi).to(m.se3_exp(0.5 * xi)).R,
    "apply": lambda m, w, xi: m.se3_exp(xi).apply(xi[:, 3:]),
    "adjoint": lambda m, w, xi: m.se3_exp(xi).adjoint(),
    "matrix34": lambda m, w, xi: m.se3_exp(xi).matrix34(),
    "retract": lambda m, w, xi: m.se3_retract(m.se3_exp(xi), 0.1 * xi).t,
    "quat_roundtrip": lambda m, w, xi: m.quat_to_matrix(m.matrix_to_quat(m.so3_exp(w))),
    "slerp": lambda m, w, xi: m.slerp(m.matrix_to_quat(m.so3_exp(w)),
                                      m.matrix_to_quat(m.so3_exp(0.3 * w)), 0.25),
}


@pytest.mark.parametrize("name", sorted(LIE_CASES))
def test_lie_matches_reference(name):
    rng = np.random.default_rng(1)
    w = _rot_vectors(rng, 64)
    xi = _twists(rng, 64)
    fn = LIE_CASES[name]
    want = _np(fn(jlie, _j(w), _j(xi)))
    got = _np(fn(tlie, _t(w), _t(xi)))
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("theta", [0.0, 1e-9, 1e-4, np.pi - 1e-3, np.pi - 1e-4])
def test_so3_log_edge_angles(theta):
    """Small angles take the series branch, near-pi angles the axis branch;
    near pi the log of a float32 rotation is ill-conditioned (d log / d R ~
    1 / sin(theta)), so the bound there is 2e-3 rad."""
    axes = np.array([[1, 0, 0], [0, 1, 0], [0, 0, 1], [0.6, 0.8, 0.0],
                     [0.0, -0.6, 0.8]], np.float32)
    w = (axes * np.float32(theta)).astype(np.float32)
    want = _np(jlie.so3_log(jlie.so3_exp(_j(w))))
    got = _np(tlie.so3_log(tlie.so3_exp(_t(w))))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=2e-3 if theta > 3 else 1e-6)


def test_se3_normalized_and_identity():
    rng = np.random.default_rng(2)
    xi = _twists(rng, 16, 0.5)
    noise = (rng.normal(size=(16, 3, 3)) * 1e-3).astype(np.float32)
    Tj = jlie.se3_exp(_j(xi))
    Tt = tlie.se3_exp(_t(xi))
    Tj = jlie.SE3(R=Tj.R + _j(noise), t=Tj.t).normalized()
    Tt = tlie.SE3(R=Tt.R + _t(noise), t=Tt.t).normalized()
    np.testing.assert_allclose(_np(Tt.R), _np(Tj.R), **F32)
    I = tlie.SE3.identity((3,))
    np.testing.assert_array_equal(_np(I.R), _np(jlie.SE3.identity((3,)).R))
    np.testing.assert_array_equal(_np(I.t), np.zeros((3, 3), np.float32))


def test_se3_select_and_stack():
    rng = np.random.default_rng(3)
    a = tlie.se3_exp(_t(_twists(rng, 4)))
    b = tlie.se3_exp(_t(_twists(rng, 4)))
    pred = torch.tensor([True, False, True, False])
    s = tlie.se3_select(pred, a, b)
    np.testing.assert_array_equal(_np(s.R[0]), _np(a.R[0]))
    np.testing.assert_array_equal(_np(s.t[1]), _np(b.t[1]))
    st = tlie.se3_stack([a.index(0), b.index(3)])
    np.testing.assert_array_equal(_np(st.t), np.stack([_np(a.t[0]), _np(b.t[3])]))


# -- camera ----------------------------------------------------------------------


def _cams():
    args = (220.0, 221.5, 159.5, 119.5, 320, 240)
    return jcam.PinholeCamera.make(*args), tcam.PinholeCamera.make(*args)


@pytest.mark.parametrize("level", [0, 1, 2, 3])
def test_camera_project_unproject(level):
    cj, ct = _cams()
    cj, ct = cj.level(level), ct.level(level)
    for f in ("fx", "fy", "cx", "cy", "width", "height"):
        assert getattr(ct, f) == float(np.asarray(getattr(cj, f))), f   # f32 values, exact
    rng = np.random.default_rng(level)
    X = rng.normal(size=(200, 3)).astype(np.float32)
    X[:, 2] = np.abs(X[:, 2]) * 4 + 0.5
    X[:7, 2] = [-1.0, 0.0, 1e-13, -1e-7, 1e-7, 2e-6, 1e-5]   # behind / at the camera
    uvj, okj = cj.project(_j(X))
    uvt, okt = ct.project(_t(X))
    np.testing.assert_array_equal(_np(okt), _np(okj))
    np.testing.assert_allclose(_np(uvt), _np(uvj), rtol=2e-6, atol=1e-3)
    rho = rng.uniform(0.05, 2.0, 200).astype(np.float32)
    rho[:3] = [0.0, 1e-14, -1.0]
    uv = rng.uniform(-10, 330, (200, 2)).astype(np.float32)
    np.testing.assert_allclose(_np(ct.unproject(_t(uv), _t(rho))),
                               _np(cj.unproject(_j(uv), _j(rho))), **F32)
    np.testing.assert_allclose(_np(ct.normalized(_t(uv))), _np(cj.normalized(_j(uv))), **F32)
    for border in (0.0, 2.0, 3.5):
        np.testing.assert_array_equal(_np(ct.in_bounds(_t(uv), border)),
                                      _np(cj.in_bounds(_j(uv), border)))
    np.testing.assert_array_equal(_np(ct.K()), _np(cj.K()))


def test_camera_host_models_copied_exactly():
    rng = np.random.default_rng(4)
    xn = rng.uniform(-0.8, 0.8, (50, 2))
    for name, args in (("radtan_distort", (-0.2, 0.05, 1e-3, -2e-3)),
                       ("fov_distort", (0.9,)), ("fov_distort", (0.0,)),
                       ("equidistant_distort", (0.01, -0.02, 0.003, 0.0))):
        np.testing.assert_array_equal(getattr(tcam, name)(xn, *args),
                                      getattr(jcam, name)(xn, *args))
    inv_t = tcam.invert_distortion(lambda x: tcam.radtan_distort(x, -0.2, 0.05, 0, 0), xn)
    inv_j = jcam.invert_distortion(lambda x: jcam.radtan_distort(x, -0.2, 0.05, 0, 0), xn)
    np.testing.assert_array_equal(inv_t, inv_j)
    cj, ct = _cams()
    K = np.array([[230.0, 0, 160.0], [0, 229.0, 118.0], [0, 0, 1]])
    fn = lambda x: jcam.fov_distort(x, 0.7)   # noqa: E731
    np.testing.assert_array_equal(tcam.build_remap(ct, K, fn), jcam.build_remap(cj, K, fn))
    cal = tcam.Calibration.ideal(220.0, 221.5, 159.5, 119.5, 320, 240)
    assert cal.pinhole == ct and cal.remap is None


# -- image -----------------------------------------------------------------------


def _image(rng, H=37, W=53, C=None):
    shape = (H, W) if C is None else (H, W, C)
    return (rng.random(shape) * 255).astype(np.float32)


@pytest.mark.parametrize("channels", [None, 3])
def test_bilinear_matches_reference_including_clamps(channels):
    """The gather inside every sweep: in-range points, points far outside
    (clamped base pixel and fractions) and the exact last row/column."""
    rng = np.random.default_rng(5)
    img = _image(rng, C=channels)
    uv = rng.uniform(-5, 60, (300, 2)).astype(np.float32)
    uv[:4] = [[52.0, 36.0], [51.999, 35.5], [-1e6, 1e6], [0.0, 0.0]]
    uv = uv.reshape(30, 10, 2)
    np.testing.assert_allclose(_np(timg.bilinear(_t(img), _t(uv))),
                               _np(jimg.bilinear(_j(img), _j(uv))), rtol=1e-6, atol=1e-4)


def test_bilinear_stack_equals_per_frame_bilinear():
    rng = np.random.default_rng(6)
    imgs = _image(rng, C=3)[None].repeat(3, 0) * np.arange(1, 4, dtype=np.float32)[:, None, None, None]
    uv = rng.uniform(-2, 56, (20, 3, 8, 2)).astype(np.float32)
    got = _np(timg.bilinear_stack(_t(imgs), _t(uv)))
    for f in range(3):
        np.testing.assert_allclose(got[:, f], _np(jimg.bilinear(_j(imgs[f]), _j(uv[:, f]))),
                                   rtol=1e-6, atol=1e-4)


@pytest.mark.parametrize("shape", [(40, 64), (37, 53)])
def test_pyramids_match_reference(shape):
    rng = np.random.default_rng(7)
    img = _image(rng, *shape)
    gp_t = timg.build_gradient_pyramid(_t(img), 3)
    gp_j = jimg.build_gradient_pyramid(_j(img), 3)
    assert len(gp_t) == len(gp_j)
    for a, b in zip(gp_t, gp_j):
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-6, atol=1e-4)
    np.testing.assert_allclose(_np(timg.gradient_squared_norm(gp_t[0])),
                               _np(jimg.gradient_squared_norm(gp_j[0])), rtol=1e-6, atol=1e-3)


def test_remap_and_photometric_match_reference():
    rng = np.random.default_rng(8)
    img = _image(rng)
    remap = rng.uniform(-1, 54, (37, 53, 2)).astype(np.float32)
    np.testing.assert_allclose(_np(timg.remap_image(_t(img), _t(remap))),
                               _np(jimg.remap_image(_j(img), _j(remap))), rtol=1e-6, atol=1e-4)
    gamma = np.sort(rng.random(256) * 255).astype(np.float32)
    vig = rng.uniform(0.0, 1.0, img.shape).astype(np.float32)
    raw = img.copy()
    raw[0, :4] = [-3.0, 255.0, 254.5, 300.0]
    for g, v in ((gamma, None), (None, vig), (gamma, vig)):
        got = timg.apply_photometric(_t(raw), None if g is None else _t(g),
                                     None if v is None else _t(v))
        want = jimg.apply_photometric(_j(raw), None if g is None else _j(g),
                                      None if v is None else _j(v))
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6, atol=1e-3)


# -- package rules ------------------------------------------------------------------


def test_device_rule_without_cuda():
    """Entry points default to the card: without CUDA they raise rather than
    run on the CPU; the CPU is used only when asked for."""
    assert _device.resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert _device.resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            _device.resolve_device(None)
        with pytest.raises(RuntimeError, match="CUDA"):
            _device.resolve_device("cuda")


def test_port_imports_no_jax():
    """Neither the port nor chip_smoke.py imports jax, flax or the JAX
    package, and importing every module of the port loads none of them."""
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    for path in files:
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for n in names:
                top = n.split(".")[0]
                assert top not in ("jax", "jaxlib", "flax", "libcml_tpu"), (path, n)
    mods = sorted({".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
                   for p in PORT.rglob("*.py")})
    code = ("import sys\n" + "".join(f"import {m}\n" for m in mods)
            + "bad = [m for m in sys.modules if m.split('.')[0] in "
              "('jax', 'jaxlib', 'flax', 'libcml_tpu')]\nprint(bad)\nassert not bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_tf32_off():
    import libcml_tpu_torch  # noqa: F401

    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
