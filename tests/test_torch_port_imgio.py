"""The port's host image library (``textocvp_tpu_torch/native``) on the CPU:
its resize bit for bit against ``PIL.Image.BILINEAR``, the JAX package's
``native`` library and ``resize_bilinear_plain``; its PNG decoder (the chunk
walk, zlib's inflate and the C++ unfilter) bit for bit against PIL's
``convert("RGB")`` on RGB, RGBA, gray, gray + alpha and palette files whose
rows cycle through the five filter types; and the files it refuses. Limits:
none, every comparison is exact.
"""

import io
import shutil

import numpy as np
import pytest
from PIL import Image

from textocvp_tpu import native as jax_native
from textocvp_tpu_torch import native
from textocvp_tpu_torch.data import datasets
from textocvp_tpu_torch.native.png import encode_png

# tests/test_native_imgio.py's cases, then upscales, odd sizes and one pixel
RESIZE_CASES = [((48, 64), (24, 24)), ((48, 64), (336, 336)), ((48, 64), (17, 91)),
                ((48, 64), (48, 64)), ((50, 70), (33, 21)), ((60, 80), (24, 32)),
                ((240, 320), (64, 64)), ((480, 640), (336, 336)), ((31, 17), (97, 45)),
                ((7, 5), (1, 1)), ((1, 1), (3, 5)), ((48, 64), (1, 64)), ((48, 64), (48, 1))]


def _pil_resize(img, out_hw):
    return np.asarray(Image.fromarray(img).resize((out_hw[1], out_hw[0]), Image.BILINEAR))


@pytest.mark.parametrize("in_hw,out_hw", RESIZE_CASES, ids=lambda v: "x".join(map(str, v)))
def test_resize_is_pil_bilinear_bit_for_bit(in_hw, out_hw):
    img = np.random.default_rng(sum(in_hw + out_hw)).integers(0, 256, (*in_hw, 3), np.uint8)
    want = _pil_resize(img, out_hw)
    np.testing.assert_array_equal(native.resize_bilinear_rgb(img, *out_hw), want)
    np.testing.assert_array_equal(native.resize_bilinear_plain(img, *out_hw), want)
    if jax_native.available():
        np.testing.assert_array_equal(jax_native.resize_bilinear_rgb(img, *out_hw), want)


def _cases(rng):
    """(array as written, PNG colour type, palette) for every colour type."""
    yield rng.integers(0, 256, (37, 53, 3), np.uint8), 2, None
    yield rng.integers(0, 256, (31, 31, 4), np.uint8), 6, None
    yield rng.integers(0, 256, (40, 56), np.uint8), 0, None
    yield rng.integers(0, 256, (20, 30, 2), np.uint8), 4, None
    yield (rng.integers(0, 256, (29, 41), np.uint8), 3,
           rng.integers(0, 256, (256, 3), np.uint8))


def test_decode_every_colour_type_and_filter_matches_pil():
    rng = np.random.default_rng(4)
    for arr, color_type, palette in _cases(rng):
        data = encode_png(arr, color_type, palette=palette)
        want = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
        got = native.decode_png_rgb(data)
        np.testing.assert_array_equal(got, want, err_msg=f"colour type {color_type}")
        out_hw = (want.shape[0] // 2 + 3, want.shape[1] + 5)
        np.testing.assert_array_equal(native.decode_png_rgb_resized(data, *out_hw),
                                      _pil_resize(want, out_hw))
    # and PIL's own files, its filters its own
    for mode, shape in (("RGB", (48, 64, 3)), ("RGBA", (31, 31, 4)), ("L", (40, 56))):
        buf = io.BytesIO()
        Image.fromarray(rng.integers(0, 256, shape, np.uint8), mode=mode).save(buf, "PNG")
        want = np.asarray(Image.open(io.BytesIO(buf.getvalue())).convert("RGB"))
        np.testing.assert_array_equal(native.decode_png_rgb(buf.getvalue()), want)
        if jax_native.available():
            np.testing.assert_array_equal(jax_native.decode_png_rgb(buf.getvalue()), want)


def test_the_writer_cycles_every_filter_type():
    import struct
    import zlib

    arr = np.random.default_rng(5).integers(0, 256, (11, 9, 3), np.uint8)
    data = encode_png(arr, 2)
    start = data.index(b"IDAT")
    (length,) = struct.unpack(">I", data[start - 4:start])
    raw = zlib.decompress(data[start + 4:start + 4 + length])
    assert [raw[y * (9 * 3 + 1)] for y in range(11)] == [0, 1, 2, 3, 4, 0, 1, 2, 3, 4, 0]


def test_corrupt_16_bit_and_interlaced_files():
    arr = np.random.default_rng(6).integers(0, 256, (16, 24, 3), np.uint8)
    good = encode_png(arr, 2)
    idat = good.index(b"IDAT")
    flipped = good[:idat + 20] + bytes([good[idat + 20] ^ 0xFF]) + good[idat + 21:]
    for bad, what in ((good[:len(good) // 2], "truncated"), (b"GIF89a" + good[6:], "signature"),
                      (flipped, "flipped")):
        with pytest.raises(ValueError, match=what):
            native.decode_png_rgb(bad, what=what)
    with pytest.raises(ValueError, match="CRC error"):
        native.decode_png_rgb(flipped)
    with pytest.raises(ValueError, match="truncated PNG"):
        native.decode_png_rgb(good[:len(good) // 2])
    deep = encode_png(np.random.default_rng(7).integers(0, 65536, (8, 8, 3), np.uint16), 2)
    with pytest.raises(ValueError, match="deep.png: .*bit depth 16"):
        native.decode_png_rgb(deep, what="deep.png")
    laced = encode_png(arr, 2, interlace=True)
    with pytest.raises(ValueError, match="laced.png: .*interlaced"):
        native.decode_png_rgb(laced, what="laced.png")
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(laced))), arr)


def test_a_failed_build_raises_with_the_compiler_message(tmp_path, monkeypatch):
    broken = tmp_path / "imgio.cpp"
    broken.write_text(native.SOURCE.read_text() + "\nint broken(\n")
    monkeypatch.setattr(native, "SOURCE", broken)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed to build imgio.cpp"):
        native.build()
    assert not list((tmp_path / "_build").glob("*.tmp"))


def test_the_library_is_keyed_by_source_and_flags(tmp_path, monkeypatch):
    copy = tmp_path / "imgio.cpp"
    shutil.copyfile(native.SOURCE, copy)
    monkeypatch.setattr(native, "SOURCE", copy)
    first = native.library_path()
    assert first == native.library_path()
    monkeypatch.setattr(native, "CXX_FLAGS", native.CXX_FLAGS + ("-g",))
    flags = native.library_path()
    assert flags != first
    copy.write_text(copy.read_text() + "\n// edited\n")
    assert native.library_path() not in (first, flags)


def test_host_io():
    info = native.host_io()
    assert info["imgio_with_zlib"] is True
    assert set(info) >= {"g++", "PIL", "imageio", "ffmpeg", "tensorboard"}


def test_jpeg_frames_need_pil_and_pngs_do_not(tmp_path, monkeypatch):
    arr = np.random.default_rng(8).integers(0, 256, (20, 30, 3), np.uint8)
    Image.fromarray(arr).save(tmp_path / "f.jpg")
    (tmp_path / "f.png").write_bytes(encode_png(arr, 2))
    want = datasets._load_image_resized(str(tmp_path / "f.jpg"), (10, 15), as_uint8=True)
    assert want.shape == (10, 15, 3)
    monkeypatch.setitem(__import__("sys").modules, "PIL", None)
    with pytest.raises(ImportError, match="need PIL"):
        datasets._load_image_resized(str(tmp_path / "f.jpg"), (10, 15))
    got = datasets._load_image_resized(str(tmp_path / "f.png"), 10, as_uint8=True)
    np.testing.assert_array_equal(got, native.resize_bilinear_plain(arr, 10, 15))
