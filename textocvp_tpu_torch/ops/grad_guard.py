"""
Refusal of gradients that a forward-only CUDA kernel would drop.

The slot-attention and conv5 kernels have no backward yet. Called with grad
enabled on an input or parameter that requires grad, a launch would return
outputs without autograd history, and every parameter upstream would silently
get no gradient. Their CUDA wrappers call :func:`refuse_grad` first, so such a
call raises instead. Under ``torch.no_grad()`` or ``torch.inference_mode()``,
or with inputs that require no grad, it does nothing. The check looks only at
the autograd state, so it runs on tensors of any device.
"""

from __future__ import annotations

import torch


def refuse_grad(op: str, *tensors: torch.Tensor) -> None:
    """Raise if autograd would record through ``op``: grad is enabled and one
    of ``tensors`` requires grad."""
    if not torch.is_grad_enabled():
        return
    for i, t in enumerate(tensors):
        if t.requires_grad:
            raise RuntimeError(
                f"{op}: the CUDA kernel has no backward, and tensor {i} of its inputs "
                f"{tuple(t.shape)} requires grad; run it under torch.no_grad() or "
                f"torch.inference_mode(), or pass detached tensors")
