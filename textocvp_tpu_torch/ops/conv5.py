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
  :func:`conv5_plain` (plain autograd), a CUDA tensor goes through
  :class:`Conv5Function`, whose forward launches the kernel through
  :func:`conv5_cuda` or raises. There is no fallback to cuDNN.
* The gradient (the JAX package's decoder trains through XLA convs; the
  Pallas probe has none). With ``g'`` the output gradient masked by the ReLU
  (``g * (y > 0)``, 0 at 0 as in JAX and torch):
  - the input gradient is itself a 5x5 stride-1 pad-2 conv of ``g'``, with
    the taps rotated 180 degrees and Cin and Cout swapped: a second launch of
    the same kernel, with a zero bias and no ReLU
    (:func:`conv5_input_grad_cuda`, counted apart; ``conv5_cuda.launches``
    counts it too);
  - the weight gradient is 25 products over all pixels,
    ``pad(x)[:, dy:dy+H, dx:dx+W]^T @ g'`` (:func:`conv5_weight_grad`, batched
    ``torch.matmul`` on strided views: the JAX package leaves this product
    to XLA);
  - the bias gradient is ``g'`` summed over N, H and W.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from textocvp_tpu_torch.ops import build

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
    take. No autograd: :func:`conv5` records the gradient through
    :class:`Conv5Function`."""
    _check(x, w, b)
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


def conv5_input_grad_cuda(g, w_rot, b_zero, relu: bool = False):
    """The input gradient's launch of the kernel: :func:`conv5_cuda` of the
    masked output gradient with the rotated weights; counted in its own
    ``launches`` as well as in ``conv5_cuda.launches``."""
    out = conv5_cuda(g, w_rot, b_zero, relu)
    conv5_input_grad_cuda.launches += 1
    return out


conv5_input_grad_cuda.launches = 0


def conv5_weight_grad(x, g):
    """dW (5, 5, Cin, Cout) of the 5x5 pad-2 conv of x (N, H, W, Cin) with
    output gradient g (N, H, W, Cout): ``dW[dy, dx] = sum over pixels of
    pad(x)[p + (dy, dx)] g[p]^T``.

    Both are laid out on the padded grid of (H + 4) x (W + 4) pixels a frame,
    x with its zero border and g in the top-left H x W corner with zeros
    around it. On that grid the tap (dy, dx) shifts x by a constant number of
    pixels, ``dy * (W + 4) + dx``, so each tap's operand is a contiguous slice
    of the flattened padded x: one batched product a tap (a batch entry a
    frame, summed), with no copy of the shifted views. The padded grid costs
    (H + 4)(W + 4) / HW more products (13 % at 64 x 64). Each call adds one
    to ``conv5_weight_grad.calls`` (behind a frozen decoder there is none)."""
    conv5_weight_grad.calls += 1
    n, h, wd, cin = x.shape
    pad = KERNEL_SIZE // 2
    hp, wp = h + 2 * pad, wd + 2 * pad
    frame = hp * wp
    tail = (KERNEL_SIZE - 1) * (wp + 1)  # the largest shift
    xflat = x.new_zeros((n * frame + tail, cin))
    xflat[:n * frame].view(n, hp, wp, cin)[:, pad:pad + h, pad:pad + wd] = x
    gext = g.new_zeros((n, hp, wp, g.shape[-1]))
    gext[:, :h, :wd] = g
    gext = gext.view(n, frame, -1)
    taps = []
    for dy in range(KERNEL_SIZE):
        for dx in range(KERNEL_SIZE):
            shift = dy * wp + dx
            xs = xflat[shift:shift + n * frame].view(n, frame, cin)
            taps.append(torch.matmul(xs.transpose(1, 2), gext).sum(0))
    return torch.stack(taps).view(KERNEL_SIZE, KERNEL_SIZE, cin, -1)


conv5_weight_grad.calls = 0


class Conv5Function(torch.autograd.Function):
    """The conv with a gradient. ``apply(x, w, b, relu, conv, input_grad_conv)``:
    ``conv(x, w, b, relu)`` computes the forward without autograd (the kernel's
    :func:`conv5_cuda` on the card; the tests pass :func:`conv5_plain`), and
    ``input_grad_conv(g', w_rot, zeros, False)`` the input gradient
    (:func:`conv5_input_grad_cuda` on the card)."""

    @staticmethod
    def forward(ctx, x, w, b, relu, conv, input_grad_conv):
        y = conv(x, w, b, relu)
        ctx.save_for_backward(x, w, y)
        ctx.relu, ctx.input_grad_conv = relu, input_grad_conv
        return y

    @staticmethod
    def backward(ctx, g):
        x, w, y = ctx.saved_tensors
        # autograd may hand a strided gradient (it comes back through the
        # final conv's permute); the kernel takes NHWC memory
        g = g.contiguous()
        if ctx.relu:
            g = torch.where(y > 0, g, 0.0)
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            w_rot = w.flip(0, 1).transpose(2, 3).contiguous()
            dx = ctx.input_grad_conv(g, w_rot, w.new_zeros(w.shape[2]), False)
        if ctx.needs_input_grad[1]:
            dw = conv5_weight_grad(x, g)
        if ctx.needs_input_grad[2]:
            db = g.sum((0, 1, 2))
        return dx, dw, db, None, None, None


def conv5(x, w, b, relu: bool = True):
    """The plain version for CPU tensors; for CUDA tensors the kernel, through
    :class:`Conv5Function` so that autograd records its gradient."""
    if x.device.type == "cpu":
        return conv5_plain(x, w, b, relu)
    return Conv5Function.apply(x, w, b, relu, conv5_cuda, conv5_input_grad_cuda)
