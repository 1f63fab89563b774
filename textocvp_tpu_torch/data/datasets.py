"""
Video-caption datasets of the port (counterpart of the JAX package's
``textocvp_tpu/data/datasets.py``): CATER easy/hard and CLIPort
put-block-in-bowl episodes.

CATER: ``<root>/<easy|hard>/<split>_explicit.json`` maps item indices to
``{"video": <path>, "caption": <text>}``; a video is a directory of frame
images (``.png``, ``.jpg``, ``.jpeg``, sorted by name), a (T, H, W, C)
``.npy`` / ``.npz`` array (uint8 or float in [0, 1]) or a container (mp4)
that ``imageio`` with an ffmpeg backend reads. Frames not at ``img_size``
are resized to it. The clip starts at frame 1, as the JAX package's does,
but for the train split with ``random_start``.

CLIPort: ``<root>/<split>/episodeNNNNN/`` with ``task_description.txt``,
the caption, and either ``color_cache_<size token>.npy`` (one uint8
(T, H, W, 3) array at ``img_size``, opened with mmap, written by
``cli/make_npy_cache.py``) or ``color/<n>_color.png``, the frames, decoded
and resized. The clip starts at frame 0, or on the train split with
``random_start`` at a drawn frame.

PNG frames go through the port's ``native`` library (decode and a resize
bit-exact with ``PIL.Image.BILINEAR``), so items are bit-identical to the
JAX package's. JPEG frames need PIL, and raise naming it where it is
absent. CLIPort's ``img_size`` as an ``int`` resizes the shorter side
(torchvision's ``Resize``), as a pair exactly; CATER takes an ``int`` as a
square, as the JAX package does.

Items are ``(frames, caption)`` with frames (num_frames, H, W, C): float32
in [0, 1] (uint8 times ``INV255``), or uint8 under ``uint8_output``. A
random start is drawn from ``[0, len(video) - num_frames]`` by
:func:`_random_start`, a stateless draw of (seed, epoch, item), the JAX
package's; the loader sets the epoch (``set_epoch``).
"""

from __future__ import annotations

import json
import os

import numpy as np

from textocvp_tpu_torch import native
from textocvp_tpu_torch.data.vocabularies import (
    CATER_EASY_VOCAB,
    CATER_HARD_VOCAB,
    CLIPORT_VOCAB,
    CLIPORT_VOCAB_TEST,
)
from textocvp_tpu_torch.data.wire import INV255, to_uint8_frames


def _random_start(seed: int, epoch: int, idx: int, n_choices: int) -> int:
    """Start frame of item ``idx`` in epoch ``epoch``, in [0, n_choices): a
    draw of its own for each (seed, epoch, item), the same in any order of
    calls (copy of the JAX package's ``data/datasets.py::_random_start``)."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, epoch, idx]))
    return int(rng.integers(0, n_choices))


def _size_token(img_size) -> str:
    """The resize target's token in a cache's file name: ``336`` (an int, the
    shorter side) or ``336x336`` (a list or tuple, exact); copy of the JAX
    package's ``data/datasets.py::_size_token``."""
    if isinstance(img_size, (list, tuple)):
        return "x".join(str(int(s)) for s in img_size)
    return str(int(img_size))


def _target_hw(h: int, w: int, size) -> tuple[int, int]:
    """The resize target of an (h, w) frame: an int resizes the shorter side
    (torchvision's ``Resize``), a pair is exact; copy of the JAX package's
    ``data/datasets.py::_target_hw``."""
    if isinstance(size, int):
        if h <= w:
            return size, max(1, round(w * size / h))
        return max(1, round(h * size / w)), size
    return tuple(size)


def _resize_frames(frames: np.ndarray, size) -> np.ndarray:
    """(T, H, W, C) float frames in [0, 1] resized to ``size``, float32 out:
    each frame rounded to uint8, resized by the port's resize (bit-exact with
    the JAX package's PIL ``BILINEAR``), times ``INV255``."""
    t, h, w, c = frames.shape
    new_h, new_w = _target_hw(h, w, size)
    if (new_h, new_w) == (h, w):
        return frames.astype(np.float32)
    out = np.empty((t, new_h, new_w, c), dtype=np.float32)
    for i in range(t):
        # round, do not truncate: k * INV255 * 255 can land 1 ulp below k
        frame = np.round(np.clip(frames[i], 0, 1) * 255).astype(np.uint8)
        out[i] = native.resize_bilinear_rgb(frame, new_h, new_w) * INV255
    return out


def _load_image_resized(path: str, size, as_uint8: bool = False) -> np.ndarray:
    """One image decoded and resized in the uint8 domain (``size`` None: not
    resized): (H, W, 3) float32 in [0, 1], or uint8 with ``as_uint8``. PNGs
    go through the port's ``native`` library; other images need PIL."""
    if path.lower().endswith(".png"):
        with open(path, "rb") as f:
            data = f.read()
        if size is None:
            arr8 = native.decode_png_rgb(data, what=path)
        else:
            arr8 = native.decode_png_rgb_resized(
                data, *_target_hw(*native.png_size(data, path), size), what=path)
    else:
        try:
            from PIL import Image
        except ImportError as e:
            raise ImportError(f"{path!r}: frames other than PNG need PIL, which is not "
                              "installed") from e
        with open(path, "rb") as f:
            img = Image.open(f).convert("RGB")
            if size is not None:
                new_h, new_w = _target_hw(img.height, img.width, size)
                if (new_h, new_w) != (img.height, img.width):
                    img = img.resize((new_w, new_h), Image.BILINEAR)
            arr8 = np.asarray(img, dtype=np.uint8)
    if as_uint8:
        return arr8
    return arr8.astype(np.float32) * INV255


_FRAME_EXTENSIONS = (".png", ".jpg", ".jpeg")


def _frame_files(path: str) -> list:
    return sorted(f for f in os.listdir(path) if f.lower().endswith(_FRAME_EXTENSIONS))


def _open_array(path: str):
    arr = np.load(path, mmap_mode="r" if path.endswith(".npy") else None)
    if hasattr(arr, "files"):  # npz: its first array
        arr = arr[arr.files[0]]
    return arr


def _imageio():
    try:
        import imageio
    except ImportError as e:
        raise ImportError("video containers (mp4) need imageio with an ffmpeg backend "
                          "(imageio-ffmpeg), which is not installed; re-export the videos "
                          "as frame directories or .npy arrays (cli/make_npy_cache.py)") from e
    return imageio


# Frame counts of video containers, by path: a probe reads the whole file,
# and random_start needs the length at every item. Each loader process keeps
# its own.
_VIDEO_LENGTH_CACHE: dict = {}


def _video_length(path: str) -> int:
    """Frames of a video in any format :func:`_read_video` reads; a
    container's count is probed once a path."""
    if os.path.isdir(path):
        return len(_frame_files(path))
    if path.endswith((".npy", ".npz")):
        return int(_open_array(path).shape[0])
    n = _VIDEO_LENGTH_CACHE.get(path)
    if n is None:
        reader = _imageio().get_reader(path)
        try:
            n = int(reader.count_frames())
        finally:
            reader.close()
        _VIDEO_LENGTH_CACHE[path] = n
    return n


# Whether a container's frames may be read by index (imageio seeks by time,
# exact only at a constant frame rate with true fps metadata), by path:
# checked once, the metadata's fps times duration against the frame count.
_VIDEO_SEEK_SAFE: dict = {}


def _indexed_seek_safe(reader, path: str) -> bool:
    ok = _VIDEO_SEEK_SAFE.get(path)
    if ok is None:
        try:
            meta = reader.get_meta_data()
            fps, dur = meta.get("fps"), meta.get("duration")
            ok = (bool(fps) and bool(dur)
                  and abs(round(fps * dur) - _video_length(path)) <= 1)
        except Exception:
            ok = False
        _VIDEO_SEEK_SAFE[path] = ok
    return ok


def _read_video(path: str, indices, size=None, as_uint8: bool = False) -> np.ndarray:
    """Frames ``indices`` of a video, (T, H, W, C) float32 in [0, 1] (uint8
    with ``as_uint8``): a directory of frame images (resized to ``size`` as
    they are decoded), a ``.npy`` / ``.npz`` array, or a container through
    ``imageio``. Copy of the JAX package's ``data/datasets.py::_read_video``."""
    indices = np.asarray(indices, dtype=np.int64)
    if os.path.isdir(path):
        files = _frame_files(path)
        return np.stack([_load_image_resized(os.path.join(path, files[int(i)]), size,
                                             as_uint8=as_uint8) for i in indices])
    if path.endswith((".npy", ".npz")):
        arr = np.asarray(_open_array(path)[indices])
        if as_uint8:
            return to_uint8_frames(arr)
        if arr.dtype == np.uint8:
            arr = arr.astype(np.float32) * INV255
        return arr.astype(np.float32)

    imageio = _imageio()
    try:
        reader = imageio.get_reader(path)
    except Exception as e:
        raise RuntimeError(
            f"Cannot decode {path!r}: no ffmpeg backend for imageio (imageio-ffmpeg); "
            "re-export the videos as frame directories or .npy arrays") from e

    def frame(fr):
        if as_uint8:
            return np.asarray(fr, dtype=np.uint8)
        return np.asarray(fr, dtype=np.float32) * INV255

    try:
        if _indexed_seek_safe(reader, path):
            frames = [frame(reader.get_data(int(i))) for i in indices]
        else:  # a sequential scan, exact for any container
            want = {int(i) for i in indices}
            last, got = max(want), {}
            for j, fr in enumerate(reader):
                if j in want:
                    got[j] = frame(fr)
                if j >= last:
                    break
            missing = want - got.keys()
            if missing:
                raise IndexError(f"{path!r}: frames {sorted(missing)} beyond the end of the video")
            frames = [got[int(i)] for i in indices]
    finally:
        reader.close()
    return np.stack(frames, axis=0)


class CATER:
    """CATER easy/hard video-caption dataset over frame directories, arrays
    or containers."""

    MODES = ["easy", "hard"]

    def __init__(self, root, mode, split, num_frames=16, img_size=(64, 64),
                 random_start=False, seed: int = 14, uint8_output: bool = False, **kwargs):
        if mode not in self.MODES:
            raise NameError(f"mode={mode!r} unknown. Use one of {self.MODES}")
        if split not in ["train", "val", "valid", "test", "eval"]:
            raise ValueError(f"Unknown split={split!r}")
        split = "test" if split in ("valid", "val", "test", "eval") else split
        self.random_start = random_start
        self._seed = seed
        self._epoch = 0
        self.root = os.path.join(root, mode)
        if not os.path.exists(self.root):
            raise FileNotFoundError(f"{self.root} does not exist")
        self.mode = mode
        self.split = split
        self.num_frames = num_frames
        self.img_size = tuple(img_size) if not isinstance(img_size, int) else (img_size, img_size)
        self.uint8_output = uint8_output
        with open(os.path.join(self.root, f"{split}_explicit.json")) as f:
            self.annotations = json.load(f)

    def set_epoch(self, epoch: int):
        """Advance the random-start draws (the loader calls it each epoch)."""
        self._epoch = int(epoch)

    def __len__(self) -> int:
        return len(self.annotations)

    def __getitem__(self, idx: int):
        ann = self.annotations[str(idx)]
        video_path = os.path.join(self.root, ann["video"])
        # the fixed start is frame 1, as the JAX package's (reference Cater.py)
        start = 1
        if self.random_start and self.split == "train":
            start = _random_start(self._seed, self._epoch, idx,
                                  _video_length(video_path) - self.num_frames + 1)
        frames = _read_video(video_path, np.arange(start, start + self.num_frames),
                             size=self.img_size, as_uint8=self.uint8_output)
        if frames.shape[1:3] != tuple(self.img_size):
            if frames.dtype == np.uint8:
                frames = to_uint8_frames(_resize_frames(frames.astype(np.float32) * INV255,
                                                        self.img_size))
            else:
                frames = _resize_frames(frames, self.img_size)
        return frames, ann["caption"]

    @property
    def vocabulary(self) -> dict:
        return CATER_EASY_VOCAB if self.mode == "easy" else CATER_HARD_VOCAB


class CLIPort:
    """CLIPort put-block-in-bowl episodes, from their ``color_cache`` arrays or
    their PNG frames."""

    EXCLUDE_EPISODES = ["episode07564", "episode09031", "episode13755", "episode11237"]

    def __init__(self, root, split, num_frames, img_size, random_start=False,
                 seed: int = 14, uint8_output: bool = False, **kwargs):
        if split not in ["train", "val", "valid", "test", "eval"]:
            raise ValueError(f"Unknown split={split!r}")
        split = ("val" if split in ("val", "valid")
                 else "test" if split in ("test", "eval") else split)
        self.root = os.path.join(root, split)
        if not os.path.exists(self.root):
            raise FileNotFoundError(f"{self.root} does not exist")
        self.split = split
        self.num_frames = num_frames
        self.img_size = img_size
        self.random_start = random_start if split == "train" else False
        self._seed = seed
        self._epoch = 0
        self.uint8_output = uint8_output
        self.episodes = sorted(
            (f for f in os.listdir(self.root)
             if f.startswith("episode") and f not in self.EXCLUDE_EPISODES),
            key=lambda x: int(x.split("episode")[-1]))
        self.labels = [self._load_label(e) for e in self.episodes]

    def _load_label(self, episode: str) -> str:
        with open(os.path.join(self.root, episode, "task_description.txt")) as f:
            return f.read().strip()

    def set_epoch(self, epoch: int):
        """Advance the random-start draws (the loader calls it each epoch)."""
        self._epoch = int(epoch)

    def __len__(self) -> int:
        return len(self.episodes)

    def __getitem__(self, idx: int):
        episode = self.episodes[idx]
        # the pre-decoded cache (cli/make_npy_cache.py) when there is one:
        # uint8-identical to the PNG route, and a memcpy out of the mmap
        cache = os.path.join(self.root, episode,
                             f"color_cache_{_size_token(self.img_size)}.npy")
        if os.path.exists(cache):
            arr = np.load(cache, mmap_mode="r")
            n = arr.shape[0]
        else:
            arr = None
            color_dir = os.path.join(self.root, episode, "color")
            if not os.path.isdir(color_dir):
                raise FileNotFoundError(
                    f"{episode}: neither {os.path.basename(cache)} nor a color/ directory of "
                    "PNG frames (build a cache with python -m "
                    "textocvp_tpu_torch.cli.make_npy_cache --dataset cliport)")
            frame_files = sorted(os.listdir(color_dir))
            n = len(frame_files)
        if n < self.num_frames:
            raise ValueError(f"{self.num_frames} frames required but {n} available in {episode}")
        start = 0
        if self.random_start:
            start = _random_start(self._seed, self._epoch, idx, n - self.num_frames + 1)
        if arr is not None:
            frames = np.asarray(arr[start:start + self.num_frames])
            if self.uint8_output:
                return frames, self.labels[idx]
            return frames.astype(np.float32) * INV255, self.labels[idx]
        frames = [_load_image_resized(
            os.path.join(color_dir, f"{frame_files[i].split('_')[0]}_color.png"), self.img_size,
            as_uint8=self.uint8_output) for i in range(start, start + self.num_frames)]
        return np.stack(frames), self.labels[idx]

    @property
    def vocabulary(self) -> dict:
        return CLIPORT_VOCAB_TEST if self.split == "test" else CLIPORT_VOCAB
