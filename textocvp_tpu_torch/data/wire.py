"""
Video wire formats: frames arrive as uint8 or as float32 in [0, 1].

Both normalize as ``uint8 -> float32`` times ``float32(1/255)``: one float32
multiply, never a division, so the two wires give bit-identical model inputs
(a division by 255 and a multiply by its float32 reciprocal differ by one ulp
on about half the values).
"""

from __future__ import annotations

import numpy as np
import torch

# float32(1/255): the one normalization constant both wires share
INV255 = np.float32(1.0 / 255.0)


def as_float_video(x):
    """uint8 video (numpy or torch) -> float32 in [0, 1]; floats pass through."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.uint8:
            return x.to(torch.float32) * float(INV255)
        return x
    if x.dtype == np.uint8:
        return x.astype(np.float32) * INV255
    return x


def to_uint8_frames(frames: np.ndarray) -> np.ndarray:
    """float frames in [0, 1] -> uint8, clipped before rounding so that values
    outside [0, 1] saturate instead of wrapping."""
    if frames.dtype == np.uint8:
        return frames
    return np.round(np.clip(frames, 0.0, 1.0) * 255.0).astype(np.uint8)
