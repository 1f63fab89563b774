"""
Host image input of the port: PNG decode and a resize bit-exact with
``PIL.Image.BILINEAR`` (counterpart of the JAX package's
``textocvp_tpu/native``), in ``imgio.cpp``, bound through ``ctypes`` (which
releases the GIL during a call, so loader threads decode in parallel).

The library is compiled with ``g++ -O3`` and linked to zlib at its first
use into ``textocvp_tpu_torch/_build/``, under a name keyed by a hash of the
source and the flags, first to a file of the process's own and then renamed
into place, so that loader threads and test workers building at once never
load a half-written file. A failed build raises with the compiler's
message: nothing falls back to PIL quietly.

The PNG decode is one call: the chunk walk with the critical chunks' CRCs,
zlib's inflate of the IDAT stream, the unfilter of the five filter types
(colour types 0, 2, 3, 4 and 6 at bit depth 8) and the resize. It gives
PIL's ``Image.convert("RGB")`` bytes: the alpha dropped, gray replicated,
palette indices looked up. Interlaced files and other bit depths raise,
naming the file.

:func:`resize_bilinear_plain` is the same fixed-point resize in numpy, the
reference the tests and ``chip_smoke.py`` hold the library to; nothing on
the data path uses it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import struct
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np

_DIR = Path(__file__).resolve().parent
SOURCE = _DIR / "imgio.cpp"
BUILD_DIR = _DIR.parent / "_build"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
LIBS = ("-lz",)
PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
PRECISION_BITS = 32 - 8 - 2  # PIL's fixed point for 8 bits a channel

_lock = threading.Lock()
_lib: list = []


def _cxx() -> str:
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found (set CXX): the port's image decode and resize "
                           "(textocvp_tpu_torch/native/imgio.cpp) are compiled at first use")
    return cxx


def _command(out: Path) -> list[str]:
    return [_cxx(), *CXX_FLAGS, "-o", str(out), str(SOURCE), *LIBS]


def library_path() -> Path:
    """The library of this source and these flags."""
    h = hashlib.sha256(" ".join(_command(Path("lib.so"))[1:]).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libimgio_{h.hexdigest()[:12]}.so"


def build() -> Path:
    """Compile the library unless it is built; returns its path. Raises with
    the compiler's message."""
    so = library_path()
    if so.is_file():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    try:
        res = subprocess.run(_command(tmp), capture_output=True, text=True, timeout=300)
        if res.returncode != 0:
            raise RuntimeError(f"g++ failed to build {SOURCE.name}:\n"
                               f"{' '.join(_command(tmp))}\n{res.stderr}")
        os.rename(tmp, so)  # atomic; another process's identical build may be replaced
    finally:
        tmp.unlink(missing_ok=True)
    return so


def load() -> ctypes.CDLL:
    """The bound library, built at the first call."""
    if not _lib:
        with _lock:
            if not _lib:
                lib = ctypes.CDLL(str(build()))
                u8p, i = ctypes.c_void_p, ctypes.c_int
                lib.imgio_resize_bilinear_rgb.argtypes = [u8p, i, i, u8p, i, i]
                lib.imgio_decode_png_rgb.argtypes = [ctypes.c_char_p, ctypes.c_size_t, u8p, i, i,
                                                     ctypes.POINTER(ctypes.c_int32)]
                lib.imgio_resize_bilinear_rgb.restype = lib.imgio_decode_png_rgb.restype = i
                _lib.append(lib)
    return _lib[0]


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


# ------------------------------------------------------------------ resize
def resize_bilinear_rgb(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """(h, w, 3) uint8 -> (out_h, out_w, 3) uint8, bit-exact with
    ``PIL.Image.BILINEAR``."""
    img = np.ascontiguousarray(img, dtype=np.uint8)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"resize_bilinear_rgb takes (h, w, 3) uint8, got {img.shape}")
    out = np.empty((out_h, out_w, 3), dtype=np.uint8)
    rc = load().imgio_resize_bilinear_rgb(_ptr(img), img.shape[0], img.shape[1], _ptr(out),
                                          out_h, out_w)
    if rc != 0:
        raise ValueError(f"cannot resize {img.shape[:2]} to {(out_h, out_w)}")
    return out


def _coeffs_plain(in_size: int, out_size: int):
    """Pillow's ``precompute_coeffs`` for the triangle filter: (xmin, xcount)
    an output pixel and the fixed-point weights, as ``imgio.cpp`` has them."""
    scale_raw = in_size / out_size
    scale = max(scale_raw, 1.0)
    support = 1.0 * scale
    ksize = int(np.ceil(support)) * 2 + 1
    bounds = np.zeros((out_size, 2), dtype=np.int64)
    kk = np.zeros((out_size, ksize), dtype=np.int64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale_raw
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        w = [max(0.0, 1.0 - abs((x + xmin - center + 0.5) * (1.0 / scale)))
             for x in range(xmax)]
        ww = 0.0
        for v in w:
            ww += v
        if ww != 0.0:
            w = [v / ww for v in w]
        for x, v in enumerate(w):
            v *= 1 << PRECISION_BITS
            kk[xx, x] = int(v - 0.5 if v < 0 else v + 0.5)
        bounds[xx] = (xmin, xmax)
    return bounds, kk


def _resample_plain(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    bounds, kk = _coeffs_plain(img.shape[axis], out_size)
    idx = np.minimum(bounds[:, :1] + np.arange(kk.shape[1]), img.shape[axis] - 1)
    taps = np.take(img.astype(np.int64), idx, axis=axis)  # axis becomes (out, ksize)
    shape = [1] * taps.ndim
    shape[axis], shape[axis + 1] = kk.shape
    acc = (1 << (PRECISION_BITS - 1)) + (taps * kk.reshape(shape)).sum(axis + 1)
    return np.clip(acc >> PRECISION_BITS, 0, 255).astype(np.uint8)


def resize_bilinear_plain(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """The library's resize in numpy: the same coefficients, the same integer
    sums, the horizontal pass first through uint8."""
    img = np.asarray(img, dtype=np.uint8)
    if img.shape[:2] == (out_h, out_w):
        return img.copy()
    if out_w != img.shape[1]:
        img = _resample_plain(img, out_w, 1)
    if out_h != img.shape[0]:
        img = _resample_plain(img, out_h, 0)
    return img


# ------------------------------------------------------------------ PNG
def png_size(data: bytes, what: str = "PNG data") -> tuple[int, int]:
    """(height, width) of PNG bytes, from their header."""
    if data[:8] != PNG_SIGNATURE or len(data) < 24 or data[12:16] != b"IHDR":
        raise ValueError(f"{what}: not a PNG file (bad signature or no IHDR first)")
    w, h = struct.unpack(">II", data[16:24])
    return h, w


_ERRORS = {1: "not a PNG file (bad signature)", 2: "truncated PNG (a chunk cut short or no IEND)",
           3: "CRC error in a critical chunk", 4: "a missing or invalid IHDR chunk",
           5: "an interlaced (Adam7) PNG; the port decodes non-interlaced PNGs only",
           6: "a PNG of bit depth {depth}; the port decodes 8-bit PNGs only",
           7: "its colour type {colour} is not 0, 2, 3, 4 or 6",
           8: "a palette PNG without a PLTE chunk before its image data",
           9: "corrupt PNG image data (zlib)", 10: "its image data is shorter than its header says",
           11: "a scanline has a filter type past 4", 12: "a palette index lies past its palette",
           13: "an empty output size", 14: "out of memory"}


def _decode(data: bytes, size, what: str) -> np.ndarray:
    out_h, out_w = size or png_size(data, what)
    out = np.empty((out_h, out_w, 3), dtype=np.uint8)
    header = (ctypes.c_int32 * 4)()
    rc = load().imgio_decode_png_rgb(data, len(data), _ptr(out), out_h, out_w, header)
    if rc != 0:
        msg = _ERRORS.get(rc, f"error {rc}").format(depth=header[2], colour=header[3])
        raise ValueError(f"{what}: cannot decode the PNG: {msg}")
    return out


def decode_png_rgb(data: bytes, what: str = "PNG data") -> np.ndarray:
    """PNG bytes -> (h, w, 3) uint8, PIL's ``convert("RGB")``; raises
    ``ValueError`` naming ``what`` on a file the decoder refuses."""
    return _decode(data, None, what)


def decode_png_rgb_resized(data: bytes, out_h: int, out_w: int,
                           what: str = "PNG data") -> np.ndarray:
    """PNG bytes decoded and resized to (out_h, out_w, 3) uint8 in one call."""
    return _decode(data, (out_h, out_w), what)


# ------------------------------------------------------------------ report
def _importable(name: str) -> bool:
    import importlib.util

    try:
        return importlib.util.find_spec(name) is not None
    except (ImportError, ValueError):
        return False


def host_io() -> dict:
    """What this machine offers the host input path: the compiler, whether
    the library builds against zlib here (its error when not), PIL (JPEG
    frames), imageio and its ffmpeg backend (mp4) and tensorboard (the
    trainers' event files)."""
    cxx = os.environ.get("CXX") or shutil.which("g++")
    try:
        build()
        zlib_build = True
    except RuntimeError as e:
        zlib_build = str(e).splitlines()[-1]
    ffmpeg = _importable("imageio_ffmpeg") or shutil.which("ffmpeg") is not None
    return {"g++": cxx, "imgio_with_zlib": zlib_build, "PIL": _importable("PIL"),
            "imageio": _importable("imageio"), "ffmpeg": ffmpeg,
            "tensorboard": _importable("tensorboard"),
            "python": sys.version.split()[0]}
