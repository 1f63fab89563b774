"""
Attention core of the ViT encoder: the CUDA kernel of ``csrc/vit_attention.cu``
and its plain PyTorch version.

The kernel replaces the Pallas TPU flash attention that the JAX package
reaches from ``textocvp_tpu/nn/vit.py::_attention`` (arms ``"flash"`` and
``"flash_tuned"``); the plain version is that function's XLA arm: einsum,
float32 softmax, einsum. The source file says what bounds the kernel on an
H100 and how its design answers.

* q, k, v and the result are (B, h, n, dh), the layout of the JAX
  ``_attention``; the kernel takes dh = 64 and any n.
* :func:`vit_attention` dispatches on the tensor's device: a CPU tensor runs
  :func:`vit_attention_plain`, a CUDA tensor launches the kernel through
  :func:`vit_attention_cuda` or raises. There is no fallback.
* Forward only: the ViT is frozen, and nothing differentiates it. Under grad
  with an input that requires grad the CUDA wrapper raises
  (:func:`grad_guard.refuse_grad`) rather than return an output without
  autograd history.
"""

from __future__ import annotations

import ctypes

import torch

from textocvp_tpu_torch.ops import build
from textocvp_tpu_torch.ops.grad_guard import refuse_grad


def vit_attention_plain(q, k, v, scale: float):
    """softmax(q k^T * scale) v over the last two axes; the softmax in float32."""
    dots = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    attn = torch.softmax(dots.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", attn, v)


_lib = None


def load_library():
    """The kernel's shared library (built by :mod:`ops.build` at first use), bound."""
    global _lib
    if _lib is None:
        lib = build.load_library("vit_attention")
        lib.va_forward.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [
            ctypes.c_float, ctypes.c_void_p]
        lib.va_forward.restype = ctypes.c_int
        lib.va_head_dim.argtypes = []
        lib.va_head_dim.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(q, k, v, head_dim: int):
    if not q.is_cuda:
        raise ValueError(f"q must lie on a CUDA device, got {q.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} must lie on {q.device} with q, got {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.dim() != 4 or t.shape != q.shape:
            raise ValueError(f"want q, k, v of one shape (B, h, n, dh); got "
                             f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if q.shape[-1] != head_dim:
        raise ValueError(f"the kernel takes dh = {head_dim}, got {q.shape[-1]}")
    if q.shape[2] < 1 or not 1 <= q.shape[0] * q.shape[1] <= 65535:
        raise ValueError(f"the kernel takes n >= 1 and 1..65535 frame-heads, got {tuple(q.shape)}")


def vit_attention_cuda(q, k, v, scale: float):
    """Launch the CUDA kernel on the current stream; raises on what it does not
    take and under grad."""
    lib = load_library()
    _check(q, k, v, lib.va_head_dim())
    refuse_grad("ViT attention", q, k, v)
    b, h, n, _ = q.shape
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = lib.va_forward(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                             b * h, n, float(scale), stream)
    if err != 0:
        raise RuntimeError(f"ViT attention kernel launch failed: cudaError {err}")
    vit_attention_cuda.launches += 1
    return out


vit_attention_cuda.launches = 0


def vit_attention(q, k, v, scale: float):
    """The plain version for CPU tensors, the CUDA kernel for CUDA tensors."""
    if q.device.type == "cpu":
        return vit_attention_plain(q, k, v, scale)
    return vit_attention_cuda(q, k, v, scale)
