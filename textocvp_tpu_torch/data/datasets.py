"""
Video-caption datasets of the port, from pre-decoded arrays: CATER easy/hard
(counterpart of ``textocvp_tpu/data/datasets.py::CATER``, its ``.npy`` /
``.npz`` route) and CLIPort put-block-in-bowl episodes (``CLIPort``, its
``color_cache`` route).

CATER: ``<root>/<easy|hard>/<split>_explicit.json`` maps item indices to
``{"video": <file>, "caption": <text>}``; each video is a (T, H, W, C) array,
uint8 or float in [0, 1]. The clip starts at frame 1, as the JAX package's
does, but for the train split with ``random_start``.

CLIPort: ``<root>/<split>/episodeNNNNN/color_cache_<size token>.npy``, one
uint8 (T, H, W, 3) array an episode at ``img_size``, opened with mmap, and
``task_description.txt``, the caption. The clip starts at frame 0, or on
the train split with ``random_start`` at a drawn frame.

Items are ``(frames, caption)`` with frames (num_frames, H, W, C): float32
in [0, 1] (uint8 times ``INV255``), or uint8 under ``uint8_output``. A
random start is drawn from ``[0, len(video) - num_frames]`` by
:func:`_random_start`, a stateless draw of (seed, epoch, item), the JAX
package's; the loader sets the epoch (``set_epoch``).

mp4 containers, frame directories and CLIPort's PNG frames need
imageio/ffmpeg or PIL, and a resize to ``img_size`` needs PIL: the port does
not read them and raises, naming the format.
"""

from __future__ import annotations

import json
import os

import numpy as np

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


def _load_array(path: str):
    if not path.endswith((".npy", ".npz")):
        kind = ("frame directories" if os.path.isdir(path)
                else f"{os.path.splitext(path)[1] or 'extensionless'} files")
        raise NotImplementedError(
            f"{path!r}: the port reads CATER videos only as .npy/.npz arrays; {kind} "
            "need imageio/ffmpeg or PIL (re-export the videos as .npy arrays)")
    arr = np.load(path, mmap_mode="r" if path.endswith(".npy") else None)
    if hasattr(arr, "files"):  # npz: its first array
        arr = arr[arr.files[0]]
    return arr


class CATER:
    """CATER easy/hard video-caption dataset over ``.npy``/``.npz`` videos."""

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
        arr = _load_array(os.path.join(self.root, ann["video"]))
        start = 1
        if self.random_start and self.split == "train":
            start = _random_start(self._seed, self._epoch, idx, arr.shape[0] - self.num_frames + 1)
        frames = np.asarray(arr[start:start + self.num_frames])
        if frames.shape[0] != self.num_frames:
            raise IndexError(f"{ann['video']}: {self.num_frames} frames from frame {start} "
                             f"wanted, the video has {arr.shape[0]}")
        if frames.shape[1:3] != self.img_size:
            raise NotImplementedError(
                f"{ann['video']}: frames of {frames.shape[1:3]} would need a resize to "
                f"{self.img_size}, which needs PIL; the port reads arrays at img_size")
        if self.uint8_output:
            return to_uint8_frames(frames), ann["caption"]
        if frames.dtype == np.uint8:
            return frames.astype(np.float32) * INV255, ann["caption"]
        return frames.astype(np.float32), ann["caption"]

    @property
    def vocabulary(self) -> dict:
        return CATER_EASY_VOCAB if self.mode == "easy" else CATER_HARD_VOCAB


class CLIPort:
    """CLIPort put-block-in-bowl episodes over their ``color_cache`` arrays."""

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
        cache = os.path.join(self.root, episode,
                             f"color_cache_{_size_token(self.img_size)}.npy")
        if not os.path.exists(cache):
            raise NotImplementedError(
                f"{episode}: no {os.path.basename(cache)}; the port reads CLIPort episodes "
                "only from their pre-decoded color cache, and its PNG frames (color/) need "
                "PIL or the libpng build to decode and resize (build the cache with "
                "scripts/make_npy_cache.py --dataset cliport)")
        arr = np.load(cache, mmap_mode="r")
        n = arr.shape[0]
        if n < self.num_frames:
            raise ValueError(f"{self.num_frames} frames required but {n} available in {episode}")
        start = 0
        if self.random_start:
            start = _random_start(self._seed, self._epoch, idx, n - self.num_frames + 1)
        frames = np.asarray(arr[start:start + self.num_frames])
        if self.uint8_output:
            return frames, self.labels[idx]
        return frames.astype(np.float32) * INV255, self.labels[idx]

    @property
    def vocabulary(self) -> dict:
        return CLIPORT_VOCAB_TEST if self.split == "test" else CLIPORT_VOCAB
