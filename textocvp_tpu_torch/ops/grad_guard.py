"""
Refusal of gradients that a forward-only CUDA kernel would drop.

The ViT attention kernel has no backward: the ViT is frozen, and nothing
differentiates it. Called with grad enabled on an input that requires grad, a
launch would return an output without autograd history, and every parameter
upstream would silently get no gradient. Its CUDA wrapper calls
:func:`refuse_grad` first, so such a call raises instead. Under
``torch.no_grad()`` or ``torch.inference_mode()``, or with inputs that
require no grad (a frozen ViT's), it does nothing. The check looks only at
the autograd state, so it runs on tensors of any device. (The slot-attention
and conv5 kernels record their gradients through ``torch.autograd.Function``;
conv5's bf16 launcher calls :func:`refuse_grad` too, for a direct call
outside that Function.) :func:`needs_grad` tells the wrappers when autograd
would record: only then do they take their autograd path; otherwise they
call their op of the ``textocvp_torch`` library (``torch.library``), which
``torch.export`` records as one node.
"""

from __future__ import annotations

import torch


def needs_grad(*tensors: torch.Tensor) -> bool:
    """True if autograd would record an op on ``tensors``: grad is enabled and
    one of them requires grad."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def refuse_grad(op: str, *tensors: torch.Tensor) -> None:
    """Raise if autograd would record through ``op``: grad is enabled and one
    of ``tensors`` requires grad."""
    if not needs_grad(*tensors):
        return
    for i, t in enumerate(tensors):
        if t.requires_grad:
            raise RuntimeError(
                f"{op}: the CUDA kernel has no backward, and tensor {i} of its inputs "
                f"{tuple(t.shape)} requires grad; run it under torch.no_grad() or "
                f"torch.inference_mode(), or pass detached tensors")
