"""ctypes binding for the port's native data pipeline (cml_io.cpp).

The port's own copy of libcml_tpu/native/io.py. The library is built at
first use with `g++ -O3 -shared -fPIC cml_io.cpp -lz -lpthread` into the
package's `_build/` directory (git-ignored, beside the Hamming kernel's
library), never into the user's home. It exposes:
  - decode_gray(bytes) -> (H, W) float32: PNG (8/16-bit gray, 8-bit gray +
    alpha, RGB, RGBA) and PGM/PPM, decoded in C++ with zlib's inflate;
  - read_image_gray(path): the same for a file;
  - NativePrefetcher(paths, ...): threaded ordered prefetch with the gamma
    LUT and vignette correction applied in the worker pool.

This decoder is how the port reads PNG on a machine without PIL. A format
it does not decode (JPEG, palette or interlaced PNG, TIFF) goes to PIL when
PIL is installed; without PIL it raises, naming what is missing.

Reference: the C++ capture runtime this replaces is
src/cml/capture/AbstractCapture.h:83-140 (prefetch thread + bounded queue)
and CaptureImage.cpp (decode + photometric prep)."""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import struct
import subprocess
import threading
import zlib
from io import BytesIO
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SOURCE = Path(__file__).resolve().parent / "cml_io.cpp"
BUILD_DIR = _PKG / "_build"
_LIB: ctypes.CDLL | None = None
_LOCK = threading.Lock()
_MAXPIX = 4096 * 3072


class NativeBuildError(RuntimeError):
    """g++ or zlib is missing, or the compiler refused the source."""


def library_path() -> Path:
    """The shared library's path, keyed by the source's content hash."""
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"libcml_io-{digest}.so"


def build() -> Path:
    """Compile the library if it is missing; returns its path."""
    lib = library_path()
    if lib.exists():
        return lib
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        raise NativeBuildError("the native image decoder needs g++ (not found on PATH)")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([cxx, "-O3", "-shared", "-fPIC", str(SOURCE), "-o", str(tmp),
                           "-lz", "-lpthread"], capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise NativeBuildError(
            f"g++ failed ({proc.returncode}) building {SOURCE.name}; it needs zlib's "
            f"header and library (zlib.h, -lz):\n{proc.stderr}")
    os.replace(tmp, lib)   # atomic: concurrent builders never see a partial file
    return lib


def _library() -> ctypes.CDLL:
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        lib = ctypes.CDLL(str(build()))
        lib.cmlio_open.restype = ctypes.c_void_p
        lib.cmlio_open.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
            ctypes.c_long,
        ]
        lib.cmlio_next.restype = ctypes.c_long
        lib.cmlio_next.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ]
        lib.cmlio_close.restype = None
        lib.cmlio_close.argtypes = [ctypes.c_void_p]
        lib.cmlio_decode.restype = ctypes.c_int
        lib.cmlio_decode.argtypes = [
            ctypes.c_char_p, ctypes.c_long, ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ctypes.c_long,
        ]
        _LIB = lib
        return _LIB


def native_available() -> bool:
    """True when the native library builds and loads here."""
    try:
        _library()
    except (NativeBuildError, OSError):
        return False
    return True


def _decode_pil(data: bytes, why: str) -> np.ndarray:
    try:
        from PIL import Image
    except ImportError:
        raise ValueError(f"cannot decode this image: {why}, and PIL, the decoder for "
                         "other formats (JPEG, palette PNG, TIFF), is not installed") from None
    img = Image.open(BytesIO(data))
    if img.mode != "L":
        img = img.convert("L")
    return np.asarray(img, np.float32)


def decode_gray(data: bytes) -> np.ndarray:
    """Decode PNG (8/16-bit gray, 8-bit gray + alpha, RGB(A)) or PGM/PPM
    bytes to a (H, W) float32 grayscale array with the native decoder (RGB
    to BT.601 luma); other formats through PIL when it is installed."""
    out = np.empty(_MAXPIX, np.float32)
    H = ctypes.c_int()
    W = ctypes.c_int()
    rc = _library().cmlio_decode(
        data, len(data), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.byref(H), ctypes.byref(W), _MAXPIX)
    if rc == 0:
        return out[: H.value * W.value].reshape(H.value, W.value).copy()
    return _decode_pil(data, f"the native decoder returned {rc} (it reads 8/16-bit "
                             "non-interlaced PNG and binary PGM/PPM)")


def read_image_gray(path: str | os.PathLike) -> np.ndarray:
    """(H, W) float32 grayscale of the image file at `path`."""
    with open(path, "rb") as f:
        return decode_gray(f.read())


def encode_png_gray(img: np.ndarray) -> bytes:
    """8-bit grayscale PNG bytes of an (H, W) uint8 array (every row with
    filter 0, zlib at its default level)."""
    a = np.ascontiguousarray(img, np.uint8)
    H, W = a.shape

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    raw = np.concatenate([np.zeros((H, 1), np.uint8), a], axis=1).tobytes()
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, 0, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


def write_png_gray(path: str, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png_gray(img))


class NativePrefetcher:
    """Ordered multi-threaded frame prefetcher over a list of image files.

    for idx, img in NativePrefetcher(paths, gamma=lut, vignette=v):
        ...  # img is (H, W) float32, photometrically corrected
    """

    def __init__(
        self,
        paths: list[str],
        n_workers: int = 2,
        queue_cap: int = 6,
        gamma: np.ndarray | None = None,
        vignette: np.ndarray | None = None,
    ):
        self._handle = None
        self.paths = list(paths)
        self._lib = _library()
        self._gamma = gamma
        self._vignette = vignette
        # ctypes keeps pointers only: these buffers must outlive the pipeline
        self._c_paths = (ctypes.c_char_p * len(self.paths))(
            *[os.fsencode(p) for p in self.paths])
        g = None
        if gamma is not None:
            self._g_buf = np.ascontiguousarray(gamma, np.float32)
            if self._g_buf.size != 256:
                raise ValueError(f"gamma must hold 256 entries, not {self._g_buf.size}")
            g = self._g_buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
        v, vh, vw = None, 0, 0
        if vignette is not None:
            self._v_buf = np.ascontiguousarray(vignette, np.float32)
            vh, vw = self._v_buf.shape
            v = self._v_buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
        self._handle = self._lib.cmlio_open(
            self._c_paths, len(self.paths), n_workers, queue_cap, g, v, vh, vw, _MAXPIX)

    def _python_load(self, path: str) -> np.ndarray:
        """Decode + photometric correction for one frame the native worker
        could not decode (through decode_gray, which tries PIL)."""
        img = read_image_gray(path)
        if self._gamma is not None:
            lut = np.asarray(self._gamma, np.float32)
            img = np.interp(img, np.arange(256), lut).astype(np.float32)
        if self._vignette is not None and self._vignette.shape == img.shape:
            img = img / np.maximum(self._vignette, 1e-4)
        return img

    def __iter__(self):
        if self._handle is None:
            raise RuntimeError("the prefetcher is closed")
        out = np.empty(_MAXPIX, np.float32)
        H = ctypes.c_int()
        W = ctypes.c_int()
        optr = out.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
        # frames are emitted strictly in order (cmlio_next walks
        # next_to_emit), so a counter recovers the index of a frame whose
        # native decode failed: the error code does not carry the index
        pos = 0
        while True:
            rc = self._lib.cmlio_next(self._handle, optr, ctypes.byref(H), ctypes.byref(W))
            if rc == -1:
                return
            if rc <= -1000:
                yield pos, self._python_load(self.paths[pos])
            else:
                yield int(rc), out[: H.value * W.value].reshape(H.value, W.value).copy()
            pos += 1

    def close(self):
        if self._handle is not None:
            self._lib.cmlio_close(self._handle)
            self._handle = None

    def __enter__(self) -> "NativePrefetcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):
        self.close()
