"""
Learning-rate schedule and optimizer of the port (counterparts of the JAX
package's ``textocvp_tpu/train/schedulers.py::build_lr_schedule`` and
``build_optimizer``, an optax chain of ``clip_by_global_norm``,
``scale_by_adam`` and ``scale_by_learning_rate``).

What the optax chain does, and this module repeats:

* the schedule is called with the number of updates made before this one,
  so with warmup the first update runs at lr 0, and the cosine index after
  warmup is ``count - warmup_steps - 1`` (the reference's held iteration);
  past ``scheduler_steps`` the cosine stays at its floor ``ETA_MIN``;
* the clip is ``g * max / norm`` when the global norm is at least ``max``
  (``(g / norm) * max``, no epsilon; ``torch.nn.utils.clip_grad_norm_``
  divides by ``norm + 1e-6``);
* Adam with b1 0.9, b2 0.999, eps 1e-8 outside the square root and none
  inside, bias corrections from the update count, then the update times
  ``-schedule(count)``.

The freeze mask of the JAX ``build_optimizer`` (``optax.multi_transform``,
ExtendedDINOSAUR's frozen ViT) has no counterpart here: the trainers hand
:class:`Adam` only the parameters that require grad, so its clip's global
norm and its updates cover the JAX ``"train"`` leaves alone.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch

ETA_MIN = 1e-7


def build_lr_schedule(training_params: dict) -> Callable[[int], float]:
    """count -> learning rate, as the JAX ``build_lr_schedule``."""
    lr = training_params["lr"]
    warmup_steps = int(training_params.get("warmup_steps", 0)) \
        if training_params.get("lr_warmup", False) else 0
    scheduler = training_params.get("scheduler", "")

    if scheduler in ("cosine_annealing", "cosine"):
        ws, t_max = warmup_steps, int(training_params.get("scheduler_steps", 1e6))

        def cos(t):
            frac = min(max(t, 0.0), t_max) / t_max
            return ETA_MIN + (lr - ETA_MIN) * 0.5 * (1.0 + math.cos(math.pi * frac))

        def schedule(count):
            c = float(count)
            if ws > 0:
                return lr * c / ws if c <= ws else cos(c - ws - 1.0)
            return cos(c)

        return schedule
    if scheduler in ("", "none", None, "constant"):
        def main(count):
            return lr
    elif scheduler == "exponential":
        steps = int(training_params.get("scheduler_steps", 10000))
        rate = training_params.get("lr_factor", 0.5)

        def main(count):
            return lr * rate ** (count / steps)
    else:
        raise NameError(f"Unknown scheduler {scheduler!r}")

    if warmup_steps > 0:
        def schedule(count):
            if count < warmup_steps:
                return lr * count / warmup_steps
            return main(count - warmup_steps)

        return schedule
    return main


def _bias_correction(decay: float, count: int) -> float:
    """optax's ``1 - decay ** count`` in float32: the power rounded once to
    float32, then the difference (1 - 0.999 ** 2 loses five digits to
    cancellation, so the rounding of the power shows in the update)."""
    power = np.float32(np.float64(np.float32(decay)) ** count)
    return float(np.float32(1) - power)


class Adam:
    """Adam over a list of parameters with optax's arithmetic, after an
    optional global-norm clip, at ``schedule(count)``. ``step()`` reads each
    parameter's ``.grad`` (a parameter without one counts as a zero
    gradient), updates the parameters in place and leaves the gradients as
    they were. ``state_dict`` / ``load_state_dict`` carry the count and the
    two moments."""

    def __init__(self, params, schedule: Callable[[int], float], clip: float | None = None,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.params = list(params)
        self.schedule = schedule
        self.clip = clip
        self.b1, self.b2, self.eps = b1, b2, eps
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    def zero_grad(self):
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> dict:
        """One update; returns {"lr", "grad_norm", "clipped"}."""
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in self.params]
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        clipped = False
        if self.clip is not None:
            n = norm.item()
            if not n < self.clip:
                grads = [(g / norm) * self.clip for g in grads]
                clipped = True
        b1, b2 = self.b1, self.b2
        for m, g in zip(self.mu, grads):
            m.copy_((1 - b1) * g + b1 * m)
        for v, g in zip(self.nu, grads):
            v.copy_((1 - b2) * (g * g) + b2 * v)
        count = self.count + 1
        bc1, bc2 = _bias_correction(b1, count), _bias_correction(b2, count)
        lr = self.schedule(self.count)
        for p, m, v in zip(self.params, self.mu, self.nu):
            update = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
            p.add_(update * float(np.float32(-lr)))
        self.count = count
        return {"lr": lr, "grad_norm": norm, "clipped": clipped}

    def state_dict(self) -> dict:
        return {"count": self.count, "mu": [m.detach().cpu() for m in self.mu],
                "nu": [v.detach().cpu() for v in self.nu]}

    def load_state_dict(self, state: dict):
        if len(state["mu"]) != len(self.params) or len(state["nu"]) != len(self.params):
            raise ValueError(f"optimizer state for {len(state['mu'])} parameters, "
                             f"the model has {len(self.params)}")
        self.count = int(state["count"])
        for dst, src in zip(self.mu + self.nu, list(state["mu"]) + list(state["nu"])):
            if dst.shape != src.shape:
                raise ValueError(f"optimizer state of shape {tuple(src.shape)}, "
                                 f"the parameter has {tuple(dst.shape)}")
            dst.copy_(src)


def build_optimizer(training_params: dict, params) -> tuple[Adam, Callable[[int], float]]:
    """Adam + the optional clip (``gradient_clipping``, ``clipping_max_value``)
    + the schedule, over ``params``."""
    schedule = build_lr_schedule(training_params)
    clip = (training_params["clipping_max_value"]
            if training_params.get("gradient_clipping", False) else None)
    return Adam(params, schedule, clip=clip), schedule
