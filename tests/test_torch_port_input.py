"""The port's input formats and loader on the CPU, against the JAX package:
CATER over frame directories of PNGs, over ``.npy`` arrays at another size
(resized) and over mp4 (``tests/test_real_datasets.py``'s stub reader in
place of ffmpeg); CLIPort over its PNG episodes; the port's
``cli/make_npy_cache.py`` against ``scripts/make_npy_cache.py``; and
``EpochLoader`` with 0 workers, 4 threads and 2 processes. Limits: none,
every item, cache and batch is compared bit for bit.
"""

import torch_cpu_threads  # noqa: F401  (two torch threads a worker)
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest

from test_real_datasets import _StubVideoReader
from textocvp_tpu.data import datasets as jax_datasets
from textocvp_tpu.data.datasets import CATER as JaxCATER
from textocvp_tpu.data.datasets import CLIPort as JaxCLIPort
from textocvp_tpu_torch.cli import make_npy_cache
from textocvp_tpu_torch.core.config import CONFIG, build_exp_params
from textocvp_tpu_torch.data import datasets
from textocvp_tpu_torch.data.datasets import CATER, CLIPort
from textocvp_tpu_torch.data.loader import EpochLoader, load_data
from textocvp_tpu_torch.native.png import encode_png

ROOT = Path(__file__).resolve().parent.parent
H, W, FRAMES, VIDEOS = 18, 26, 9, 5


def _frames(rng, n, h, w):
    """Shaded frames with a moving square: smooth enough that a resize is not
    trivial, random enough that every filter type is exercised."""
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    base = np.stack([yy * 255 // h, xx * 255 // w, (yy + xx) * 127 // (h + w)], -1)
    out = np.empty((n, h, w, 3), np.uint8)
    for t in range(n):
        noise = rng.integers(0, 40, (h, w, 3))
        frame = base + noise
        frame[t % h:t % h + 5, t:t + 6] = rng.integers(0, 256, 3)
        out[t] = np.clip(frame, 0, 255)
    return out


def write_cater_frames(root: Path, seed=0):
    """``easy/`` with, per split, videos as PNG frame directories and as
    ``.npy`` arrays of the same frames: items ``2i`` and ``2i + 1``."""
    rng = np.random.default_rng(seed)
    mode = root / "easy"
    mode.mkdir(parents=True)
    for split in ("train", "test"):
        ann = {}
        for i in range(VIDEOS):
            video = _frames(rng, FRAMES, H, W)
            d = mode / f"{split}_{i:03d}"
            d.mkdir()
            for t, frame in enumerate(video):
                (d / f"frame_{t:05d}.png").write_bytes(encode_png(frame, 2))
            np.save(mode / f"{split}_{i:03d}.npy", video)
            ann[str(2 * i)] = {"video": d.name, "caption": "the cone is rotating"}
            ann[str(2 * i + 1)] = {"video": f"{split}_{i:03d}.npy",
                                   "caption": "the snitch is sliding"}
        (mode / f"{split}_explicit.json").write_text(json.dumps(ann))
    return root


def write_cliport_png(root: Path, splits=(("train", 3), ("test", 2)), frames=6, h=30, w=40,
                      seed=1):
    """``<split>/episodeN/color/<n>_color.png`` and ``task_description.txt``."""
    rng = np.random.default_rng(seed)
    n = 0
    for split, count in splits:
        for _ in range(count):
            ep = root / split / f"episode{n:05d}"
            (ep / "color").mkdir(parents=True)
            for t, frame in enumerate(_frames(rng, frames, h, w)):
                (ep / "color" / f"{t:06d}_color.png").write_bytes(encode_png(frame, 2))
            (ep / "task_description.txt").write_text(f"put the red block in the green bowl {n}")
            n += 1
    return root


@pytest.fixture(scope="module")
def cater_root(tmp_path_factory):
    return write_cater_frames(tmp_path_factory.mktemp("cater"))


@pytest.fixture(scope="module")
def cliport_root(tmp_path_factory):
    return write_cliport_png(tmp_path_factory.mktemp("cliport"))


def _same_items(ours, ref, epochs=(0, 1)):
    assert len(ours) == len(ref)
    for epoch in epochs:
        ours.set_epoch(epoch)
        ref.set_epoch(epoch)
        for i in range(len(ref)):
            (fo, co), (fr, cr) = ours[i], ref[i]
            assert co == cr and fo.dtype == fr.dtype and fo.shape == fr.shape
            np.testing.assert_array_equal(fo, fr, err_msg=f"item {i} epoch {epoch}")


@pytest.mark.parametrize("img_size", [(H, W), (12, 20), 16, (31, 40)],
                         ids=["native", "down", "int", "up"])
@pytest.mark.parametrize("split,random_start", [("train", True), ("test", False)])
@pytest.mark.parametrize("uint8", [False, True])
def test_cater_frame_directories_and_resized_arrays_match_jax(cater_root, img_size, split,
                                                              random_start, uint8):
    kw = dict(mode="easy", split=split, num_frames=4, img_size=img_size,
              random_start=random_start, uint8_output=uint8)
    ours = CATER(str(cater_root), **kw)
    ref = JaxCATER(str(cater_root), **kw)
    _same_items(ours, ref)
    frames, _ = ours[0]
    side = (img_size, img_size) if isinstance(img_size, int) else img_size
    assert frames.shape == (4, *side, 3) and frames.dtype == (np.uint8 if uint8 else np.float32)
    if not random_start:  # a frame directory and the array of its frames: the same item
        np.testing.assert_array_equal(ours[2][0], ours[3][0])


@pytest.mark.parametrize("img_size", [[16, 16], 20, [30, 40]], ids=["square", "int", "native"])
@pytest.mark.parametrize("uint8", [False, True])
def test_cliport_png_episodes_match_jax(cliport_root, img_size, uint8):
    for split in ("train", "test"):
        kw = dict(split=split, num_frames=4, img_size=img_size, random_start=True,
                  uint8_output=uint8)
        _same_items(CLIPort(str(cliport_root), **kw), JaxCLIPort(str(cliport_root), **kw))
    frames, _ = CLIPort(str(cliport_root), "test", num_frames=4, img_size=img_size)[0]
    # an int is the shorter side: 30 x 40 -> 20 x round(26.67)
    assert frames.shape == ((4, 20, 27, 3) if img_size == 20 else (4, *img_size, 3))


@pytest.fixture()
def stub_mp4(monkeypatch):
    """imageio.get_reader on any .mp4 reads a synthetic video whose frame t
    holds the value t, in both packages."""
    import imageio

    video = np.broadcast_to(np.arange(31, dtype=np.uint8)[:, None, None, None],
                            (31, 8, 8, 3)).copy()
    counters = {"get_data": 0, "count_frames": 0, "close": 0, "open": 0, "get_meta_data": 0,
                "iter_data": 0}

    def fake_get_reader(path, *a, **k):
        assert str(path).endswith(".mp4")
        counters["open"] += 1
        return _StubVideoReader(video, counters, cfr=counters.get("_cfr", True))

    monkeypatch.setattr(imageio, "get_reader", fake_get_reader)
    for mod in (datasets, jax_datasets):
        mod._VIDEO_LENGTH_CACHE.clear()
        mod._VIDEO_SEEK_SAFE.clear()
    yield counters
    for mod in (datasets, jax_datasets):
        mod._VIDEO_LENGTH_CACHE.clear()
        mod._VIDEO_SEEK_SAFE.clear()


@pytest.mark.parametrize("cfr", [True, False], ids=["indexed", "sequential"])
def test_mp4_route_matches_jax_with_the_stub_reader(tmp_path, stub_mp4, cfr):
    stub_mp4["_cfr"] = cfr
    mode = tmp_path / "easy"
    mode.mkdir()
    (mode / "train_explicit.json").write_text(json.dumps(
        {str(i): {"video": f"v{i}.mp4", "caption": "the cone is rotating"}
         for i in range(4)}))
    kw = dict(mode="easy", split="train", num_frames=6, img_size=(8, 8), random_start=True)
    ours, ref = CATER(str(tmp_path), **kw), JaxCATER(str(tmp_path), **kw)
    _same_items(ours, ref)
    frames, _ = ours[1]
    start = round(float(frames[0, 0, 0, 0]) * 255)
    np.testing.assert_array_equal(np.round(frames[:, 0, 0, 0] * 255), np.arange(start, start + 6))
    assert stub_mp4["close"] == stub_mp4["open"]  # every reader closed
    # the length is probed once a path in each package
    assert stub_mp4["count_frames"] == 8
    resized = CATER(str(tmp_path), **{**kw, "img_size": (4, 6), "uint8_output": True})
    _same_items(resized, JaxCATER(str(tmp_path), **{**kw, "img_size": (4, 6),
                                                    "uint8_output": True}), epochs=(0,))


def _jax_cache_script():
    spec = importlib.util.spec_from_file_location("jax_make_npy_cache",
                                                  ROOT / "scripts" / "make_npy_cache.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _same_trees(a: Path, b: Path):
    files = sorted(p.relative_to(a) for p in a.rglob("*") if p.is_file())
    assert files == sorted(p.relative_to(b) for p in b.rglob("*") if p.is_file())
    assert files
    for f in files:
        if f.suffix == ".npy":
            x, y = np.load(a / f), np.load(b / f)
            assert x.dtype == y.dtype == np.uint8
            np.testing.assert_array_equal(x, y, err_msg=str(f))
        else:
            assert (a / f).read_bytes() == (b / f).read_bytes(), f


@pytest.mark.parametrize("args", [
    ["--root", "{cater}", "--split", "train", "--img-size", "12x20", "--num-frames", "5"],
    ["--root", "{cater}", "--split", "test", "--img-size", "16"],
    ["--dataset", "cliport", "--root", "{cliport}", "--split", "train", "--img-size", "16x16"],
    ["--dataset", "cliport", "--root", "{cliport}", "--split", "test", "--img-size", "20"],
], ids=["cater-pair", "cater-int", "cliport-pair", "cliport-int"])
def test_make_npy_cache_equals_the_jax_script(cater_root, cliport_root, tmp_path, args):
    args = [a.format(cater=cater_root, cliport=cliport_root) for a in args]
    assert make_npy_cache.main([*args, "--out", str(tmp_path / "ours")]) == 0
    assert _jax_cache_script().main([*args, "--out", str(tmp_path / "jax")]) == 0
    _same_trees(tmp_path / "ours", tmp_path / "jax")


def test_the_cache_serves_what_the_frames_serve(cliport_root, tmp_path):
    make_npy_cache.main(["--dataset", "cliport", "--root", str(cliport_root), "--split", "test",
                         "--img-size", "16x16", "--out", str(tmp_path)])
    kw = dict(split="test", num_frames=6, img_size=[16, 16])
    _same_items(CLIPort(str(tmp_path), **kw), CLIPort(str(cliport_root), **kw), epochs=(0,))


class _Failing:
    """A dataset whose item 5 raises."""

    def __len__(self):
        return 9

    def __getitem__(self, i):
        if i == 5:
            raise KeyError("item 5 is broken")
        return np.zeros((2, 4, 4, 3), np.uint8), "a caption"


def test_loader_gives_the_same_batches_with_any_workers(cater_root):
    p = build_exp_params("SAVi", "CATER_Easy")
    p["dataset"].update(root=str(cater_root), img_size=[12, 20], num_frames=4,
                        random_start=True, tokenizer="CustomTokenizer")
    assert CONFIG["num_workers"] >= 0
    ds = load_data(p, "train")

    def epochs(**kw):
        loader = EpochLoader(ds, batch_size=3, shuffle=True, **kw)
        return [list(loader) for _ in range(2)]

    ref = epochs(num_workers=0)
    assert [len(e) for e in ref] == [4, 4]
    for kw in (dict(num_workers=4), dict(num_workers=1)):
        got = epochs(**kw)
        for e_got, e_ref in zip(got, ref):
            for (vg, ig), (vr, ir) in zip(e_got, e_ref):
                np.testing.assert_array_equal(vg, vr)
                assert ig["caption"] == ir["caption"]
                np.testing.assert_array_equal(ig["caption_tokens"], ir["caption_tokens"])
    # the epochs differ: set_epoch reached the dataset before any item
    assert not all(np.array_equal(a[0], b[0]) for a, b in zip(ref[0], ref[1]))


@pytest.mark.parametrize("workers", [0, 3])
def test_a_worker_exception_reaches_the_consumer(workers):
    loader = EpochLoader(_Failing(), batch_size=2, num_workers=workers)
    it = iter(loader)
    assert next(it)[0].shape == (2, 2, 4, 4, 3)
    with pytest.raises(KeyError, match="item 5 is broken"):
        list(it)
    # a consumer that stops early stops the producer
    it = iter(EpochLoader(_Failing(), batch_size=1, num_workers=workers))
    next(it)
    it.close()
