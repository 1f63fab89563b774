"""
5x5 convolution of SAVi's decoder tail: the CUDA kernel of ``csrc/conv5.cu``
and its plain PyTorch version.

The kernel replaces the Pallas TPU kernel ``bench_pallas_conv.py::
_conv5_kernel`` (launched by ``conv5_pallas``); the plain version repeats
that kernel's ``dots15`` arithmetic without its two-columns-per-128-lanes
packing: 25 shifted views of the zero-padded input, each times its
(Cin, Cout) weight slice, summed in float32. The source file says what
bounds the kernel on an H100 and how its design answers.

* Layout of the JAX package: ``x`` is NHWC (N, H, W, Cin) float32, ``w`` is
  HWIO (5, 5, Cin, Cout), ``b`` is (Cout,); the result is NHWC (N, H, W,
  Cout) with zero "same" padding of 2, the bias, then a ReLU if ``relu``.
* The kernel takes Cin = Cout = 64 at any N, H, W >= 1; the plain version
  any channel counts.
* :func:`conv5` dispatches on the tensor's device: a CPU tensor runs
  :func:`conv5_plain`, a CUDA tensor launches the kernel through
  :func:`conv5_cuda` or raises. There is no fallback to cuDNN.
* Forward only; raises under grad (:func:`grad_guard.refuse_grad`): with grad
  enabled, an input that requires grad would get none.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from textocvp_tpu_torch.ops import build
from textocvp_tpu_torch.ops.grad_guard import refuse_grad

KERNEL_SIZE = 5
CHANNELS = 64  # the kernel's input and output channels


def conv5_plain(x, w, b, relu: bool = True):
    """Sum over the 25 taps of ``pad(x)[shifted] @ w[dy, dx]``, + b, [ReLU]."""
    n, h, wd, _ = x.shape
    pad = KERNEL_SIZE // 2
    xp = F.pad(x, (0, 0, pad, pad, pad, pad))  # C untouched, then W, then H
    acc = torch.zeros((n, h, wd, w.shape[-1]), dtype=torch.float32, device=x.device)
    for dy in range(KERNEL_SIZE):
        for dx in range(KERNEL_SIZE):
            acc += torch.matmul(xp[:, dy:dy + h, dx:dx + wd], w[dy, dx])
    acc += b
    return acc.relu_() if relu else acc


_lib = None


def load_library():
    """The kernel's shared library (built by :mod:`ops.build` at first use), bound."""
    global _lib
    if _lib is None:
        lib = build.load_library("conv5")
        # n is 64-bit: N * H * W * 64 passes 2**31 at the eval shape
        lib.conv5_forward.argtypes = [ctypes.c_void_p] * 4 + [
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.conv5_forward.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(x, w, b):
    if not x.is_cuda:
        raise ValueError(f"x must lie on a CUDA device, got {x.device}")
    for name, t in (("x", x), ("w", w), ("b", b)):
        if t.device != x.device:
            raise ValueError(f"{name} must lie on {x.device} with x, got {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous ({name} of x: NHWC memory)")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    c = CHANNELS
    if x.dim() != 4 or x.shape[-1] != c or min(x.shape) < 1:
        raise ValueError(f"the kernel takes x of shape (N, H, W, {c}) with N, H, W >= 1, "
                         f"got {tuple(x.shape)}")
    if tuple(w.shape) != (KERNEL_SIZE, KERNEL_SIZE, c, c):
        raise ValueError(f"the kernel takes w of shape (5, 5, {c}, {c}), got {tuple(w.shape)}")
    if tuple(b.shape) != (c,):
        raise ValueError(f"the kernel takes b of shape ({c},), got {tuple(b.shape)}")
    if x.shape[1] * x.shape[2] * c >= 2 ** 31:
        raise ValueError(f"a frame of {tuple(x.shape[1:])} is too large for the kernel")


def conv5_cuda(x, w, b, relu: bool = True):
    """Launch the CUDA kernel on the current stream; raises on what it does not
    take and under grad."""
    _check(x, w, b)
    refuse_grad("conv5", x, w, b)
    lib = load_library()
    n, h, wd, _ = x.shape
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = lib.conv5_forward(x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(),
                                n, h, wd, int(bool(relu)), stream)
    if err != 0:
        raise RuntimeError(f"conv5 kernel launch failed: cudaError {err}")
    conv5_cuda.launches += 1
    return out


conv5_cuda.launches = 0


def conv5(x, w, b, relu: bool = True):
    """The plain version for CPU tensors, the CUDA kernel for CUDA tensors."""
    if x.device.type == "cpu":
        return conv5_plain(x, w, b, relu)
    return conv5_cuda(x, w, b, relu)
