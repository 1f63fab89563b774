"""
Synthetic bouncing-balls video dataset with procedural captions (copy of the
JAX package's ``textocvp_tpu/data/synthetic.py``): the repository's
CPU-runnable CATER-like set, with captions in ``SYNTHETIC_VOCAB`` for the
CustomTokenizer. Sequences are deterministic per (seed, index), and so is the
clip start of the train split: the epoch does not move it.
"""

from __future__ import annotations

import numpy as np

from textocvp_tpu_torch.data.vocabularies import SYNTHETIC_VOCAB
from textocvp_tpu_torch.data.wire import to_uint8_frames

_COLORS = {
    "red": (1.0, 0.15, 0.1),
    "green": (0.1, 1.0, 0.2),
    "blue": (0.15, 0.25, 1.0),
}


class SyntheticBalls:
    """num_balls colored balls bouncing in a box; caption describes the first
    ball's color and initial direction."""

    def __init__(
        self,
        split: str = "train",
        num_seqs: int = 64,
        num_frames: int = 8,
        img_size=(64, 64),
        total_frames: int = 32,
        num_balls: int = 3,
        random_start: bool = True,
        seed: int = 14,
        uint8_output: bool = False,
        **kwargs,
    ):
        # uint8 on the wire (data/wire.py): synthetic frames are arbitrary
        # floats, so the uint8 wire quantizes them to the 1/255 grid here
        self.uint8_output = uint8_output
        self.split = "train" if split == "train" else "test"
        self.num_seqs = num_seqs
        self.num_frames = num_frames
        self.img_size = tuple(img_size) if not isinstance(img_size, int) else (img_size, img_size)
        self.total_frames = total_frames
        self.num_balls = num_balls
        self.random_start = random_start and self.split == "train"
        self.base_seed = seed + (0 if self.split == "train" else 10_000)

    def __len__(self) -> int:
        return self.num_seqs

    def _sequence(self, idx: int) -> tuple[np.ndarray, str]:
        rng = np.random.default_rng(self.base_seed + idx)
        h, w = self.img_size
        names = list(_COLORS)
        colors = [names[rng.integers(len(names))] for _ in range(self.num_balls)]
        pos = rng.uniform(0.2, 0.8, size=(self.num_balls, 2))
        vel = rng.uniform(-0.06, 0.06, size=(self.num_balls, 2))
        vel[np.abs(vel) < 0.02] = 0.03
        radius = rng.uniform(0.08, 0.14, size=(self.num_balls,))

        yy, xx = np.mgrid[0:h, 0:w]
        yy = (yy + 0.5) / h
        xx = (xx + 0.5) / w
        frames = np.zeros((self.total_frames, h, w, 3), dtype=np.float32)
        p = pos.copy()
        v = vel.copy()
        for t in range(self.total_frames):
            img = np.zeros((h, w, 3), dtype=np.float32)
            for b in range(self.num_balls):
                d2 = (yy - p[b, 0]) ** 2 + (xx - p[b, 1]) ** 2
                mask = np.clip(1.0 - d2 / radius[b] ** 2, 0.0, 1.0)
                img += mask[..., None] * np.asarray(_COLORS[colors[b]], dtype=np.float32)
            frames[t] = np.clip(img, 0.0, 1.0)
            p = p + v
            for ax in range(2):
                bounce_lo = p[:, ax] < 0.1
                bounce_hi = p[:, ax] > 0.9
                v[bounce_lo | bounce_hi, ax] *= -1.0
                p[:, ax] = np.clip(p[:, ax], 0.1, 0.9)

        vert = "down" if vel[0, 0] > 0 else "up"
        horiz = "right" if vel[0, 1] > 0 else "left"
        caption = f"the {colors[0]} ball is moving {vert} and {horiz}"
        return frames, caption

    def __getitem__(self, idx: int):
        frames, caption = self._sequence(idx)
        if self.random_start:
            rng = np.random.default_rng(self.base_seed + 777 + idx)
            start = int(rng.integers(0, self.total_frames - self.num_frames + 1))
        else:
            start = 0
        frames = frames[start : start + self.num_frames]
        if self.uint8_output:
            frames = to_uint8_frames(frames)
        return frames, caption

    @property
    def vocabulary(self) -> dict:
        return SYNTHETIC_VOCAB
