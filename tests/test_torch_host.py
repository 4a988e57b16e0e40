"""Parity of the port's host surface with the JAX package, on the CPU: the
YAML reader and apply_config, the dataset loaders, the native decoder, the
corridor renderer and KITTI writer, and the CLI.

Every input is made from a seed with numpy and goes through both packages.
Tolerances: loaders, calibration and YAML agree exactly (the same host code);
the decoder equals PIL exactly on gray PNG and PGM, and within 0.51 on RGB
(PIL rounds the BT.601 luma to an integer, the decoder keeps it as a float);
the renderer, float32 on two frameworks, within 1 gray level on >= 99.9 % of
pixels equal; the direct CLI run within 2e-3 per frame, the direct slice's
bound between the two packages.
"""

import dataclasses
import io
import json
import os
import sys
import time
import zipfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from PIL import Image

import libcml_tpu.cli as jcli
import libcml_tpu.data.capture as jcap
import libcml_tpu.runtime.config as jconfig
import libcml_tpu_torch.cli as tcli
import libcml_tpu_torch.data.capture as tcap
import libcml_tpu_torch.runtime.config as tconfig
from libcml_tpu_torch.core.camera import PinholeCamera
from libcml_tpu_torch.data import corridor
from libcml_tpu_torch.data.synthetic import SyntheticScene, forward_trajectory
from libcml_tpu_torch.native import NativePrefetcher, decode_gray
from libcml_tpu_torch.native.io import encode_png_gray

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRESETS = sorted(f for f in os.listdir(os.path.join(ROOT, "presets")) if f.endswith(".yaml"))

# tests/test_loaders.py:56-61
EUROC_SENSOR = (
    "intrinsics: [95.0, 96.0, 20.0, 16.0]\n"
    "resolution: [40, 32]\n"
    "distortion_model: radial-tangential\n"
    "distortion_coefficients: [-0.28, 0.07, 0.0002, 0.00002]\n"
)
# the layout of a published EuRoC cam0/sensor.yaml: comments, a nested
# mapping, a flow list over several lines, a string with spaces
EUROC_SENSOR_FULL = """# General sensor definitions.
sensor_type: camera
comment: VI-Sensor cam0 (MT9M034)

# Sensor extrinsics wrt. the body-frame.
T_BS:
  cols: 4
  rows: 4
  data: [0.0148655429818, -0.999880929698, 0.00414029679422, -0.0216401454975,
         0.999557249008, 0.0149672133247, 0.025715529948, -0.064676986768,
        -0.0257744366974, 0.00375618835797, 0.999660727178, 0.00981073058949,
         0.0, 0.0, 0.0, 1.0]

# Camera specific definitions.
rate_hz: 20
resolution: [752, 480]
camera_model: pinhole
intrinsics: [458.654, 457.296, 367.215, 248.375] #fu, fv, cu, cv
distortion_model: radial-tangential
distortion_coefficients: [-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05]
"""
# scalars PyYAML resolves in its YAML 1.1 way
SCALARS = ("flags: [yes, off, ~, 1e-5, .5, 0x1F, 017, 'a # b', \"q\", +3, -.inf, 1_000]\n"
           "empty:\nnested:\n  a:\n    b: 1\n  c: []\n")


# -- YAML reader and apply_config -----------------------------------------------


@pytest.mark.parametrize("name", PRESETS + ["euroc_sensor", "euroc_sensor_full", "scalars"])
def test_yaml_reader_equals_safe_load(name):
    text = {"euroc_sensor": EUROC_SENSOR, "euroc_sensor_full": EUROC_SENSOR_FULL,
            "scalars": SCALARS}.get(name)
    if text is None:
        with open(os.path.join(ROOT, "presets", name)) as f:
            text = f.read()
    assert tconfig.parse_yaml(text) == yaml.safe_load(text)


def test_yaml_reader_rejects_unsupported():
    for text in ("- a\n- b\n", "a: &x 1\n", "a: {b: 1}\n", "a:\n  b: 1\n c: 2\n"):
        with pytest.raises(ValueError):
            tconfig.parse_yaml(text)


@pytest.mark.parametrize("name", PRESETS)
def test_apply_config_equals_reference(name):
    path = os.path.join(ROOT, "presets", name)
    want = dataclasses.asdict(jconfig.load_yaml_config(jcli.SlamConfig(), path))
    got = dataclasses.asdict(tconfig.load_yaml_config(tcli.SlamConfig(), path))
    assert got == want


def test_unknown_key_raises_in_both():
    for mod, root in ((jconfig, jcli.SlamConfig()), (tconfig, tcli.SlamConfig())):
        with pytest.raises(mod.UnusedConfigKey):
            mod.apply_config(root, {"direct.max_frmes": 6})
        with pytest.raises(mod.UnusedConfigKey):
            mod.apply_config(root, {"nothing": 1})


# -- loaders (the layouts of tests/test_loaders.py) --------------------------------


def _png(arr, mode="L") -> bytes:
    buf = io.BytesIO()
    Image.fromarray(arr, mode=mode).save(buf, format="PNG")
    return buf.getvalue()


def _img(i, H=32, W=40):
    return np.random.default_rng(i).integers(0, 255, (H, W)).astype(np.uint8)


def _kitti(root):
    seq = root / "04"
    (seq / "image_0").mkdir(parents=True)
    for i in range(3):
        (seq / "image_0" / f"{i:06d}.png").write_bytes(_png(_img(i)))
    (seq / "calib.txt").write_text(
        "P0: 100.0 0.0 20.0 0.0 0.0 100.0 16.0 0.0 0.0 0.0 1.0 0.0\n")
    (seq / "times.txt").write_text("0.0\n0.1\n0.2\n")
    (seq / "poses.txt").write_text(
        "\n".join("1 0 0 %f 0 1 0 0 0 0 1 0" % (0.1 * i) for i in range(3)))
    return seq


def _euroc(root):
    cam = root / "mav0" / "cam0"
    (cam / "data").mkdir(parents=True)
    rows = []
    for i in range(3):
        name = f"{1000000000 + i * 50000000}.png"
        (cam / "data" / name).write_bytes(_png(_img(i)))
        rows.append(f"{1000000000 + i * 50000000},{name}")
    (cam / "data.csv").write_text("#ts,filename\n" + "\n".join(rows) + "\n")
    (cam / "sensor.yaml").write_text(EUROC_SENSOR)
    gt = root / "mav0" / "state_groundtruth_estimate0"
    gt.mkdir(parents=True)
    gt_rows = ["#header"] + [f"{1000000000 + i * 50000000},{0.1 * i},0.0,0.0,1.0,0.0,0.0,0.0"
                             for i in range(3)]
    (gt / "data.csv").write_text("\n".join(gt_rows) + "\n")
    return root


def _tartanair(root):
    (root / "image_left").mkdir()
    for i in range(3):
        (root / "image_left" / f"{i:06d}_left.png").write_bytes(_png(_img(i)))
    (root / "pose_left.txt").write_text(
        "\n".join("%f 0 0 0 0 0 1" % (0.5 * i) for i in range(3)) + "\n")
    return root


def _eth3d(root):
    (root / "rgb").mkdir()
    rows = []
    for i in range(3):
        rel = f"rgb/{i}.png"
        (root / rel).write_bytes(_png(_img(i)))
        rows.append(f"{i * 0.1:.1f} {rel}")
    (root / "rgb.txt").write_text("\n".join(rows) + "\n")
    (root / "calibration.txt").write_text("90.0 91.0 20.0 16.0\n")
    (root / "groundtruth.txt").write_text(
        "\n".join(f"{i*0.1:.1f} {0.2*i} 0 0 0 0 0 1" for i in range(3)) + "\n")
    return root


def _stereopolis(root):
    zpath = root / "cam.zip"
    with zipfile.ZipFile(zpath, "w") as zf:
        for i in range(2):
            zf.writestr(f"frame_{i:03d}.png", _png(_img(i)))
        zf.writestr("calib.xml",
                    "<calib><focal>77.0</focal><ppx>20.5</ppx><ppy>15.5</ppy></calib>")
        mask = np.full((32, 40), 255, np.uint8)
        mask[:, :5] = 0
        zf.writestr("mask.png", _png(mask))
    return zpath


def _tum_zip(root):
    (root / "times.txt").write_text(
        "\n".join(f"{i:05d} {i * 0.05:.3f} 10.0" for i in range(3)) + "\n")
    (root / "camera.txt").write_text("0.5 0.6 0.5 0.5 0.9\n40 32\ncrop\n40 32\n")
    with zipfile.ZipFile(root / "images.zip", "w") as zf:
        for i in range(3):
            zf.writestr(f"{i:05d}.png", _png(_img(i)))
    return root


def _tum_dir(root):
    """TUM with images/, pcalib.txt and vignette.png: the photometric
    calibration's host arrays."""
    (root / "images").mkdir()
    for i in range(2):
        (root / "images" / f"{i:05d}.png").write_bytes(_png(_img(i)))
    (root / "times.txt").write_text("00000 0.0 8.0\n00001 0.05 12.0\n")
    (root / "camera.txt").write_text("0.5 0.6 0.5 0.5 0\n40 32\ncrop\n40 32\n")
    (root / "pcalib.txt").write_text(" ".join(str(1.5 * v) for v in range(256)) + "\n")
    vig = (255 * np.linspace(0.5, 1.0, 32 * 40).reshape(32, 40)).astype(np.uint8)
    (root / "vignette.png").write_bytes(_png(vig))
    return root


LAYOUTS = {"kitti": _kitti, "euroc": _euroc, "tartanair": _tartanair, "eth3d": _eth3d,
           "stereopolis_zip": _stereopolis, "tum_zip": _tum_zip, "tum_photometric": _tum_dir}


def _host(x):
    return None if x is None else np.asarray(x)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_loader_equals_reference(tmp_path, layout):
    path = str(LAYOUTS[layout](tmp_path))
    jc, tc = jcap.load_dataset(path), tcap.load_dataset(path)
    assert type(tc).__name__ == type(jc).__name__
    assert len(tc) == len(jc)
    jp, tp = jc.calibration.pinhole, tc.calibration.pinhole
    for k in ("fx", "fy", "cx", "cy", "width", "height"):
        assert float(getattr(tp, k)) == float(getattr(jp, k)), k
    for k in ("remap", "gamma", "vignette"):
        a, b = _host(getattr(jc.calibration, k)), _host(getattr(tc.calibration, k))
        assert (a is None) == (b is None), k
        if a is not None:
            np.testing.assert_array_equal(b, a, err_msg=k)
    jf, tf = list(jc.frames()), list(tc.frames())
    assert len(tf) == len(jf) == len(jc)
    for a, b in zip(jf, tf):
        assert (b.index, b.timestamp, b.exposure) == (a.index, a.timestamp, a.exposure)
        np.testing.assert_array_equal(b.image, a.image)
        assert b.image.dtype == np.float32
        assert (a.gt_pose_c2w is None) == (b.gt_pose_c2w is None)
        if a.gt_pose_c2w is not None:
            np.testing.assert_array_equal(b.gt_pose_c2w, a.gt_pose_c2w)


def test_unknown_layout_raises_in_both(tmp_path):
    (tmp_path / "whatever.txt").write_text("x")
    for mod in (jcap, tcap):
        with pytest.raises(ValueError):
            mod.load_dataset(str(tmp_path))


def test_video_without_imageio_raises(tmp_path, monkeypatch):
    from libcml_tpu_torch.data.misc import VideoCapture

    monkeypatch.setitem(sys.modules, "imageio", None)
    monkeypatch.setitem(sys.modules, "imageio.v3", None)
    (tmp_path / "clip.mp4").write_bytes(b"\0")
    with pytest.raises(NotImplementedError, match="imageio"):
        VideoCapture(str(tmp_path / "clip.mp4"))


# -- the native decoder (tests/test_native_io.py:25-66) -----------------------------


def test_decode_gray_png_equals_pil():
    arr = np.random.default_rng(0).integers(0, 255, (37, 53)).astype(np.uint8)
    data = _png(arr)
    out = decode_gray(data)
    assert out.shape == (37, 53) and out.dtype == np.float32
    np.testing.assert_array_equal(out, np.asarray(Image.open(io.BytesIO(data)), np.float32))


def test_decode_rgb_png_luma_against_pil():
    arr = np.random.default_rng(1).integers(0, 255, (21, 33, 3)).astype(np.uint8)
    data = _png(arr, mode="RGB")
    pil = np.asarray(Image.open(io.BytesIO(data)).convert("L"), np.float32)
    np.testing.assert_allclose(decode_gray(data), pil, atol=0.51)


def test_decode_pgm_equals_pil():
    arr = np.random.default_rng(2).integers(0, 255, (17, 23)).astype(np.uint8)
    data = b"P5\n# comment\n23 17\n255\n" + arr.tobytes()
    pil = np.asarray(Image.open(io.BytesIO(data)), np.float32)
    np.testing.assert_array_equal(decode_gray(data), pil)


def test_jpeg_without_pil_names_what_is_missing(monkeypatch):
    buf = io.BytesIO()
    Image.fromarray(_img(3)).save(buf, format="JPEG")
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ValueError, match="PIL"):
        decode_gray(buf.getvalue())


def test_png_writer_round_trip():
    arr = _img(4, 29, 31)
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(encode_png_gray(arr)))), arr)


def test_prefetcher_ordered_and_corrected(tmp_path):
    rng = np.random.default_rng(5)
    paths, arrs = [], []
    for i in range(9):
        arr = rng.integers(1, 255, (24, 32)).astype(np.uint8)
        p = tmp_path / f"f{i}.png"
        p.write_bytes(_png(arr))
        paths.append(str(p))
        arrs.append(arr)
    gamma = np.arange(256, dtype=np.float32) * 2.0
    vignette = np.full((24, 32), 0.5, np.float32)
    with NativePrefetcher(paths, n_workers=3, queue_cap=4, gamma=gamma,
                          vignette=vignette) as pf:
        got = list(pf)
    assert [i for i, _ in got] == list(range(9))
    for (_, img), arr in zip(got, arrs):
        np.testing.assert_allclose(img, arr.astype(np.float32) * 4.0, rtol=1e-5)


class _FailingCapture:
    """A capture of 9 frames whose frame `fail_at` cannot be read."""

    def __init__(self, fail_at):
        self.fail_at = fail_at

    def __len__(self):
        return 9

    def _load(self, i):
        if i == self.fail_at:
            raise OSError(f"cannot decode frame {i}")
        return i


@pytest.mark.parametrize("fail_at", [0, 4, 8])
def test_capture_load_error_reaches_the_consumer(fail_at):
    """A frame that fails to load raises in the consumer after the frames
    before it; its prefetch thread ends. The JAX package ends the stream
    there as if the data had run out (libcml_tpu/data/capture.py:70), a
    fault the port does not copy."""
    import threading

    cap = type("Cap", (_FailingCapture, tcap.AbstractCapture), {})(fail_at)
    got = []
    with pytest.raises(OSError, match=f"cannot decode frame {fail_at}"):
        for frame in cap.frames(prefetch=2):
            got.append(frame)
    assert got == list(range(fail_at))
    deadline = time.monotonic() + 10.0
    while any(t.name == "capture-prefetch" for t in threading.enumerate()):
        assert time.monotonic() < deadline, "the prefetch thread did not end"
        time.sleep(0.01)
    ref = type("Cap", (_FailingCapture, jcap.AbstractCapture), {})(fail_at)
    assert list(ref.frames(prefetch=2)) == list(range(fail_at))
    # a capture that loads every frame still ends normally
    ok = type("Cap", (_FailingCapture, tcap.AbstractCapture), {})(-1)
    assert list(ok.frames(prefetch=2)) == list(range(9))


# -- the corridor: renderer and KITTI writer -----------------------------------------


def test_renderer_equals_reference():
    from benchmarks.export_kitti import build_scene_and_traj, make_device_renderer
    from libcml_tpu.core.camera import PinholeCamera as JaxPinholeCamera

    W, H, fx = 160, 120, 110.0
    jscene, jposes = build_scene_and_traj(JaxPinholeCamera.make(fx, fx, W / 2 - 0.5,
                                                                H / 2 - 0.5, W, H), 3)
    jrender = make_device_renderer(jscene, jscene.cam)
    cam = corridor.corridor_camera(W, H, fx)
    render = corridor.make_renderer(corridor.scene_for(cam, extent=corridor.EXTENT), cam,
                                    torch.device("cpu"))
    poses = corridor.snake_trajectory(3)
    for (R, t), (jR, jt) in zip(poses, jposes):
        np.testing.assert_array_equal(R, jR)
        np.testing.assert_array_equal(t, jt)
        want = np.asarray(jrender(jnp.asarray(R, jnp.float32), jnp.asarray(t, jnp.float32)))
        got = render(R, t).numpy()
        d = np.abs(got.astype(int) - want.astype(int))
        assert d.max() <= 1 and (d == 0).mean() >= 0.999


def test_kitti_writer_equals_export_kitti(tmp_path, monkeypatch, capsys):
    from benchmarks import export_kitti

    ref, out = tmp_path / "ref", tmp_path / "port"
    monkeypatch.setattr(sys, "argv", ["export_kitti.py", "--frames", "3", "--width", "160",
                                      "--height", "120", "--fx", "110", "--out", str(ref)])
    export_kitti.main()
    seq = corridor.write_sequence(str(out), 3, 160, 120, 110.0, device="cpu")
    assert seq == str(out / "sequences" / "04")
    for rel in ("sequences/04/calib.txt", "sequences/04/times.txt", "poses/04.txt"):
        assert (out / rel).read_bytes() == (ref / rel).read_bytes(), rel
    for i in range(3):
        name = f"sequences/04/image_0/{i:06d}.png"
        a = np.asarray(Image.open(ref / name), np.int64)
        b = decode_gray((out / name).read_bytes()).astype(np.int64)
        assert np.abs(a - b).max() <= 1 and (a == b).mean() >= 0.999


# -- the CLI (tests/test_runtime_misc.py:76-110) -------------------------------------


@pytest.fixture(scope="module")
def kitti10(tmp_path_factory):
    """10 frames of SyntheticScene.default at 160x120 in the KITTI layout,
    with poses.txt (test_runtime_misc's sequence; rendered in float64 by
    the port's tensor renderer, which is faster than the numpy one)."""
    cam = PinholeCamera.make(110.0, 110.0, 79.5, 59.5, 160, 120)
    sc = SyntheticScene.default(cam, seed=3)
    seq = tmp_path_factory.mktemp("kitti") / "04"
    (seq / "image_0").mkdir(parents=True)
    lines = []
    for i, (R, t) in enumerate(forward_trajectory(10, step=0.08, yaw_rate=0.003)):
        img = np.clip(sc.render_device(R, t, "cpu")[0].numpy(), 0, 255).astype(np.uint8)
        (seq / "image_0" / f"{i:06d}.png").write_bytes(_png(img))
        M = np.eye(4)
        M[:3, :3], M[:3, 3] = R, t
        lines.append(" ".join(f"{v:.9f}" for v in np.linalg.inv(M)[:3].reshape(-1)))
    (seq / "calib.txt").write_text(
        "P0: 110.0 0.0 80.0 0.0 0.0 110.0 60.0 0.0 0.0 0.0 1.0 0.0\n")
    (seq / "times.txt").write_text("\n".join(f"{0.1 * i:.6f}" for i in range(10)) + "\n")
    (seq / "poses.txt").write_text("\n".join(lines) + "\n")
    return str(seq)


def _files(d):
    return sorted(os.path.relpath(os.path.join(p, f), d)
                  for p, _, fs in os.walk(d) for f in fs)


# test_runtime_misc's direct configuration, with no keyframe after the
# initialization in 10 frames: the JAX package's compiles on the CPU take
# ~6 s a frame of this file's time on their own, ~10 s more for a keyframe
SMALL_PRESET = """direct:
  num_levels: 3
  max_points: 1024
  points_per_kf: 256
  init_points: 256
  max_frames: 5
  tracker_iters: 8
  init_iters: 12
  ba_iters: 6
  kf_flow_threshold: 5.0
"""


def test_cli_direct_equals_reference(kitti10, tmp_path):
    preset = tmp_path / "small.yaml"
    preset.write_text(SMALL_PRESET)
    args = ["-d", kitti10, "-m", "direct", "-n", "10", "-c", str(preset),
            "--snapshot-every", "4", "--memory-limit", "100000"]
    assert jcli.main(args + ["-r", str(tmp_path / "jax")]) == 0
    assert tcli.main(args + ["-r", str(tmp_path / "port"), "--device", "cpu"]) == 0
    files = _files(tmp_path / "port")
    assert files == _files(tmp_path / "jax")
    assert "snapshots/map_000008.html" in files and "stats.csv" in files
    run_j = json.loads((tmp_path / "jax" / "run.json").read_text())
    run_t = json.loads((tmp_path / "port" / "run.json").read_text())
    assert run_t["frames"] == run_j["frames"] == 10
    assert run_t["device"] == "cpu" and run_t["segments"] == 0
    est_j = np.loadtxt(tmp_path / "jax" / "result_kitti.txt").reshape(-1, 3, 4)
    est_t = np.loadtxt(tmp_path / "port" / "result_kitti.txt").reshape(-1, 3, 4)
    assert est_t.shape == est_j.shape == (10, 3, 4)
    assert np.linalg.norm(est_t[:, :, 3] - est_j[:, :, 3], axis=1).max() < 2e-3


def test_cli_port_hybrid_preset(kitti10, tmp_path):
    """The hybrid through the CLI with the dso2000 preset, 8 frames."""
    out = tmp_path / "out"
    rc = tcli.main(["-d", kitti10, "-n", "8", "-m", "hybrid", "-c",
                    os.path.join(ROOT, "presets", "dso2000.yaml"), "-r", str(out), "-f", "all",
                    "-z", "--device", "cpu"])
    assert rc == 0
    run = json.loads((out / "run.json").read_text())
    assert run["frames"] == 8 and run["segments"] == 0
    assert np.isfinite(run["ate_rmse"])
    for name in ("result_tum.txt", "result_kitti.txt", "result.csv", "result_gt_tum.txt",
                 "result_gt_kitti.txt", "stats.csv"):
        assert (out / name).is_file(), name


def test_cli_defaults_to_the_card(kitti10):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        tcli.main(["-d", kitti10, "-n", "2"])


# -- the bench (libcml_tpu_torch/bench.py) ------------------------------------------


def test_bench_run_mode_on_disk(kitti10, tmp_path):
    """bench.run_mode over a KITTI sequence on disk, on the CPU: stats, the
    trajectory file, and an error profile whose worst frame bounds the ATE."""
    from libcml_tpu_torch import bench
    from libcml_tpu_torch.models.direct.config import DirectConfig

    cfg = DirectConfig(num_levels=3, max_points=1024, points_per_kf=256, init_points=256,
                       max_frames=5, tracker_iters=8, init_iters=12, ba_iters=6,
                       kf_flow_threshold=5.0)
    out = bench.run_mode(kitti10, "direct", 10, torch.device("cpu"), cfg,
                         out_dir=str(tmp_path))
    assert out["frames"] == 10 and out["segments"] == 0 and out["steady_fps"] is None
    assert out["stage_calls"]["time_preprocess"] == 10 and out["kernel_launches"] == 0
    assert np.isfinite(out["ate"]) and out["error_profile"]["ate_prefix"] == {}
    tum = np.loadtxt(tmp_path / "direct_tum.txt")
    assert tum.shape == (10, 8)
    np.testing.assert_allclose(tum[:, 0], 0.1 * np.arange(10), atol=1e-6)

    gt = np.loadtxt(os.path.join(kitti10, "poses.txt")).reshape(-1, 3, 4)[:, :, 3]
    idx = np.arange(10)
    prof = bench.error_profile(idx, tum[:, 1:4], gt, every=5)
    assert list(prof["ate_prefix"]) == ["5"] and 0 <= prof["worst_frame"] < 10
    whole = bench.error_profile(idx, tum[:, 1:4], gt, every=10)
    assert whole["ate_prefix"] == {} and prof["worst_err"] == whole["worst_err"]
    assert prof["worst_err"] >= out["ate"] - 1e-6
    assert [j[0] for j in out["error_profile"]["jumps"]] == [j[0] for j in prof["jumps"]]
    assert set(out["event_frames"]) <= set(bench.EVENTS)
    # a step of 5 times the others is one jump, at the frame it reaches
    line = np.outer(np.arange(10.0), [0.0, 0.0, 0.08])
    line[6:] += [0.0, 0.0, 0.32]
    (frame, ratio), = bench.error_profile(idx, line, line)["jumps"]
    assert frame == 6 and ratio == pytest.approx(5.0)
