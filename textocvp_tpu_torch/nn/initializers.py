"""
Slot initializers. ``LearnedRandomInit`` draws fresh Gaussian noise at every
call, evaluation included, from an explicit ``torch.Generator``: a seeded
generator makes a run reproducible. (It cannot reproduce the JAX package's
``jax.random`` stream: tests and the trainer may hand it the noise itself,
``noise=``, so that gradients reach ``slots_mu`` and ``slots_sigma`` as in
the JAX package.)
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn


def _uniform_limit(slot_dim: int) -> float:
    return math.sqrt(6.0 / (1 + slot_dim))


class LearnedInit(nn.Module):
    """Fixed learned slots, tiled over the batch."""

    def __init__(self, num_slots: int, slot_dim: int):
        super().__init__()
        lim = _uniform_limit(slot_dim)
        self.slots = nn.Parameter(torch.empty(num_slots, slot_dim).uniform_(-lim, lim))

    def forward(self, batch_size: int, generator: Optional[torch.Generator] = None,
                noise=None):
        """``noise`` is taken for the signature's sake and unused."""
        return self.slots[None].expand(batch_size, *self.slots.shape)


class LearnedRandomInit(nn.Module):
    """mu + sigma * N(0, 1) with learned mu and sigma, sampled at every call."""

    def __init__(self, num_slots: int, slot_dim: int):
        super().__init__()
        lim = _uniform_limit(slot_dim)
        self.num_slots = num_slots
        self.slots_mu = nn.Parameter(torch.empty(1, 1, slot_dim).uniform_(-lim, lim))
        self.slots_sigma = nn.Parameter(torch.empty(1, 1, slot_dim).uniform_(-lim, lim))

    def forward(self, batch_size: int, generator: Optional[torch.Generator] = None,
                noise=None):
        """mu + sigma * noise; ``noise`` (batch_size, num_slots, slot_dim) when
        given, else drawn from ``generator``."""
        mu = self.slots_mu
        shape = (batch_size, self.num_slots, mu.shape[-1])
        if noise is None:
            if generator is None:
                raise ValueError("LearnedRandomInit needs a torch.Generator or the noise itself")
            noise = torch.randn(shape, generator=generator, device=generator.device,
                                dtype=mu.dtype)
        elif tuple(noise.shape) != shape:
            raise ValueError(f"noise of shape {tuple(noise.shape)}, want {shape}")
        return mu + self.slots_sigma * noise.to(mu.device, mu.dtype)


def get_initializer(mode: str, slot_dim: int, num_slots: int) -> nn.Module:
    if mode == "Learned":
        return LearnedInit(num_slots, slot_dim)
    if mode == "LearnedRandom":
        return LearnedRandomInit(num_slots, slot_dim)
    raise ValueError(f"{mode!r} is not a recognized initializer. Use 'Learned'|'LearnedRandom'")
