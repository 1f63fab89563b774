"""
A PNG writer on the standard library (``zlib`` and ``struct``) and numpy,
for test fixtures and synthetic datasets: row y of the image takes filter
type y mod 5, so that a decoder meets all five.
It writes colour types 0, 2, 3, 4 and 6 at bit depth 8 or 16 (the array's
dtype), optionally Adam7-interlaced.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
# Adam7 passes: (first row, first column, row step, column step)
ADAM7 = ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4), (2, 0, 4, 2), (0, 1, 2, 2),
         (1, 0, 2, 1))


def _chunk(ctype: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + ctype + body
            + struct.pack(">I", zlib.crc32(body, zlib.crc32(ctype))))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def filter_rows(rows: np.ndarray, bpp: int) -> bytes:
    """Scanlines (h, stride) uint8, each prefixed by its filter type, row y
    filtered with type y mod 5."""
    x = rows.astype(np.int16)
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[:, bpp:] = b[:, :-bpp]
    preds = (0, a, b, (a + b) >> 1, _paeth(a, b, c))
    out = bytearray()
    for y in range(rows.shape[0]):
        f = y % 5
        out.append(f)
        out += ((x[y] - preds[f][y]) & 0xFF).astype(np.uint8).tobytes() if f else rows[y].tobytes()
    return bytes(out)


def encode_png(img: np.ndarray, color_type: int, palette=None, interlace: bool = False) -> bytes:
    """PNG bytes of ``img``: (h, w) or (h, w, channels) of ``color_type``,
    uint8 (bit depth 8) or uint16 (16); palette indices with ``palette``
    (n, 3) uint8 for colour type 3."""
    img = np.asarray(img)
    h, w = img.shape[:2]
    ch = CHANNELS[color_type]
    depth = 16 if img.dtype == np.uint16 else 8
    pixels = img.reshape(h, w, ch)
    if depth == 16:
        pixels = pixels.astype(">u2").view(np.uint8).reshape(h, w, 2 * ch)
    bpp = pixels.shape[2]
    if interlace:
        raw = b"".join(filter_rows(pixels[r::dr, c::dc].reshape(-1, len(range(c, w, dc)) * bpp),
                                   bpp)
                       for r, c, dr, dc in ADAM7 if r < h and c < w)
    else:
        raw = filter_rows(pixels.reshape(h, w * bpp), bpp)
    out = SIGNATURE + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color_type, 0, 0,
                                                  int(interlace)))
    if color_type == 3:
        out += _chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    return out + _chunk(b"IDAT", zlib.compress(raw)) + _chunk(b"IEND", b"")
