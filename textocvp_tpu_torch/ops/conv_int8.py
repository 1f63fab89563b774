"""
int8 k x k stride-1 "same" convolution of the opt-in int8 decode
(``tpu.decode_quant``): the CUDA kernel of ``csrc/conv_int8.cu`` and its
plain PyTorch version, with the quantizers the int8 paths share.

It replaces no TPU kernel: the JAX package computes this conv with XLA
(``textocvp_tpu/nn/decoders.py::ConvDecoder._quantize_conv``). PyTorch has
no int8 convolution on CUDA, so the port has a kernel of its own; the source
file says what bounds it on an H100 and how its design answers.

* Layout of the JAX package: ``x_q`` is NHWC (N, H, W, Cin) int8, ``w_q`` is
  HWIO (k, k, Cin, Cout) int8, ``a_scale`` a float32 scalar tensor (the
  per-tensor activation scale), ``w_scale`` and ``bias`` (Cout,) float32.
  The result is NHWC (N, H, W, Cout) float32: the int32 sum over the k * k
  taps (zero "same" padding of k // 2), times ``a_scale * w_scale`` (that
  product formed first), plus ``bias``, then a ReLU if ``relu``.
* The kernel takes k in {3, 5}, Cin a multiple of 64 and Cout a multiple of
  64 (SAVi's 5x5 64 -> 64 tail; the 3x3 convs of ExtendedDINOSAUR's CNN
  head, 768 -> 1024 -> 512 -> 256 -> 128); the plain version any sizes. The
  wrapper hands it the weights tiled for its plan (:func:`weight_tiles`).
* The plain version sums the 9 or 25 shifted products in float64. Every
  partial sum is an integer below 2^53, so the float64 sums are the exact
  int32 sums, on the CPU and on the card alike; the float32 epilogue is then
  the kernel's, operation for operation. Kernel and plain version agree bit
  for bit.
* :func:`conv_int8` dispatches on the tensor's device through the op
  ``torch.ops.textocvp_torch.conv_int8`` (``torch.library.custom_op``, one
  node under ``torch.export``): the plain version for a CPU tensor, the
  kernel (:func:`conv_int8_cuda`) for a CUDA tensor or an error. There is no
  fallback. It has no gradient and refuses to run where autograd would record
  (the int8 decode runs under ``no_grad`` / ``inference_mode``).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from textocvp_tpu_torch.ops import build
from textocvp_tpu_torch.ops.grad_guard import refuse_grad

KERNEL_SIZES = (3, 5)


def divide(x, d):
    """``x / d`` rounded as IEEE division, on the CPU and on the card alike:
    ``d`` a tensor on ``x``'s device (PyTorch divides a CUDA tensor by a
    Python number or a CPU scalar as a product with its reciprocal, one bit
    off the quotient now and then, which would move a value across a .5
    rounding boundary)."""
    if not torch.is_tensor(d):
        d = torch.full((), d, dtype=x.dtype, device=x.device)
    return x / d.to(x.device)


def quantize_activation(x, a_scale):
    """Per-tensor symmetric int8: ``clip(round(x / a_scale), -127, 127)``,
    rounding half to even as ``jnp.round`` does."""
    return torch.round(divide(x.float(), a_scale)).clamp_(-127, 127).to(torch.int8)


def quantize_weight(w, dims, amax=None):
    """Symmetric int8 weights with one scale a slice along the axes not in
    ``dims``: ``w_scale = max(max |w| over dims, 1e-30) / 127`` and ``w_q =
    round(w / w_scale)``; ``amax`` (keepdim) in place of ``max |w|`` when
    ``w`` is a shard of a larger weight. Returns (w_q int8, w_scale float32)
    with ``w_scale`` reduced over ``dims``."""
    w = w.float()
    if amax is None:
        amax = w.abs().amax(dim=dims, keepdim=True)
    w_scale = divide(torch.clamp(amax, min=1e-30), 127.0)
    return torch.round(w / w_scale).to(torch.int8), w_scale.squeeze(dims)


def dequantize(acc, a_scale, w_scale, bias):
    """The int8 paths' float32 epilogue of an exact integer sum ``acc`` (int32
    or float64): ``float32(acc) * (a_scale * w_scale) + bias``."""
    return acc.to(torch.float32) * (a_scale * w_scale) + bias


def conv_int8_plain(x_q, w_q, a_scale, w_scale, bias, relu: bool = False):
    """The shifted products in float64 (exact), then :func:`dequantize`."""
    k = w_q.shape[0]
    pad = k // 2
    n, h, wd, _ = x_q.shape
    xp = F.pad(x_q.to(torch.float64), (0, 0, pad, pad, pad, pad))
    w = w_q.to(torch.float64)
    acc = torch.zeros((n, h, wd, w.shape[-1]), dtype=torch.float64, device=x_q.device)
    for dy in range(k):
        for dx in range(k):
            acc += torch.matmul(xp[:, dy:dy + h, dx:dx + wd], w[dy, dx])
    y = dequantize(acc, a_scale, w_scale, bias)
    return y.relu_() if relu else y


_lib = None


def load_library():
    """The kernel's shared library (built by :mod:`ops.build` at first use), bound."""
    global _lib
    if _lib is None:
        lib = build.load_library("conv_int8")
        lib.conv_int8_forward.argtypes = [ctypes.c_void_p] * 6 + [
            ctypes.c_longlong] + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        lib.conv_int8_forward.restype = ctypes.c_int
        lib.conv_int8_plan.argtypes = [ctypes.c_longlong] + [ctypes.c_int] * 5 + [
            ctypes.POINTER(ctypes.c_int)] * 2
        lib.conv_int8_plan.restype = ctypes.c_int
        for fn in (lib.conv_int8_ci_tile, lib.conv_int8_co_tile):
            fn.argtypes = []
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(x_q, w_q, a_scale, w_scale, bias, lib):
    if not x_q.is_cuda:
        raise ValueError(f"x_q must lie on a CUDA device, got {x_q.device}")
    want = {"x_q": torch.int8, "w_q": torch.int8, "a_scale": torch.float32,
            "w_scale": torch.float32, "bias": torch.float32}
    for name, t in zip(want, (x_q, w_q, a_scale, w_scale, bias)):
        if t.device != x_q.device:
            raise ValueError(f"{name} must lie on {x_q.device} with x_q, got {t.device}")
        if t.dtype != want[name]:
            raise TypeError(f"{name} must be {want[name]}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x_q.data_ptr() % 16:
        raise ValueError("x_q must be 16-byte aligned")
    if x_q.dim() != 4 or min(x_q.shape) < 1:
        raise ValueError(f"the kernel takes x_q of shape (N, H, W, Cin), got {tuple(x_q.shape)}")
    n, h, wd, cin = x_q.shape
    k = w_q.shape[0]
    if w_q.dim() != 4 or k not in KERNEL_SIZES or tuple(w_q.shape[:3]) != (k, k, cin):
        raise ValueError(f"the kernel takes w_q of shape (k, k, {cin}, Cout) with k in "
                         f"{KERNEL_SIZES}, got {tuple(w_q.shape)}")
    cout = w_q.shape[3]
    ci, co = lib.conv_int8_ci_tile(), lib.conv_int8_co_tile()
    if cin % ci or cout % co:
        raise ValueError(f"the kernel takes Cin a multiple of {ci} and Cout of {co}, got "
                         f"{cin} -> {cout}")
    if a_scale.numel() != 1 or tuple(w_scale.shape) != (cout,) or tuple(bias.shape) != (cout,):
        raise ValueError(f"want a_scale of one value, w_scale and bias ({cout},); got "
                         f"{tuple(a_scale.shape)}, {tuple(w_scale.shape)}, {tuple(bias.shape)}")
    if h * wd * max(cin, cout) >= 2 ** 31:
        raise ValueError(f"a frame of {tuple(x_q.shape[1:])} is too large for the kernel")


def weight_tiles(w_q, ck: int, bn: int):
    """HWIO ``w_q`` as the kernel reads it: [Cout / bn][Cin / ck][k * k]
    [ck / 16][bn][16], each (output tile, input chunk) block contiguous."""
    k, _, cin, cout = w_q.shape
    w = w_q.reshape(k * k, cin // ck, ck // 16, 16, cout // bn, bn)
    return w.permute(4, 1, 0, 2, 5, 3).contiguous()


def conv_int8_cuda(x_q, w_q, a_scale, w_scale, bias, relu: bool = False):
    """Launch the CUDA kernel on the current stream; raises on what it does
    not take. ``w_q`` is HWIO; the kernel reads it tiled (:func:`weight_tiles`)."""
    lib = load_library()
    _check(x_q, w_q, a_scale, w_scale, bias, lib)
    n, h, wd, cin = x_q.shape
    k, cout = w_q.shape[0], w_q.shape[3]
    bn, ck = ctypes.c_int(), ctypes.c_int()
    if lib.conv_int8_plan(n, h, wd, cin, cout, k, ctypes.byref(bn), ctypes.byref(ck)) != 0:
        raise ValueError(f"the kernel cannot tile x_q of {tuple(x_q.shape)} with k = {k} and "
                         f"Cout = {cout}")
    w_t = weight_tiles(w_q, ck.value, bn.value)
    out = torch.empty((n, h, wd, cout), dtype=torch.float32, device=x_q.device)
    stream = torch.cuda.current_stream(x_q.device).cuda_stream
    with torch.cuda.device(x_q.device):
        err = lib.conv_int8_forward(x_q.data_ptr(), w_t.data_ptr(), a_scale.data_ptr(),
                                    w_scale.data_ptr(), bias.data_ptr(), out.data_ptr(),
                                    n, h, wd, cin, cout, k, int(bool(relu)), stream)
    if err != 0:
        raise RuntimeError(f"int8 conv kernel launch failed: cudaError {err}")
    conv_int8_cuda.launches += 1
    return out


conv_int8_cuda.launches = 0


@torch.library.custom_op("textocvp_torch::conv_int8", mutates_args=())
def conv_int8_op(x_q: torch.Tensor, w_q: torch.Tensor, a_scale: torch.Tensor,
                 w_scale: torch.Tensor, bias: torch.Tensor, relu: bool) -> torch.Tensor:
    """The conv as one op: the plain version for a CPU tensor, the kernel for
    a CUDA tensor."""
    if x_q.device.type == "cpu":
        return conv_int8_plain(x_q, w_q, a_scale, w_scale, bias, relu)
    return conv_int8_cuda(x_q, w_q, a_scale, w_scale, bias, relu)


@conv_int8_op.register_fake
def _(x_q, w_q, a_scale, w_scale, bias, relu):
    return x_q.new_empty((*x_q.shape[:-1], w_q.shape[-1]), dtype=torch.float32)


def conv_int8(x_q, w_q, a_scale, w_scale, bias, relu: bool = False):
    """The plain version for CPU tensors, the CUDA kernel for CUDA tensors
    (:func:`conv_int8_op`); raises where autograd would record."""
    refuse_grad("int8 conv", a_scale, w_scale, bias)
    return conv_int8_op(x_q, w_q, a_scale.reshape(()).float(), w_scale, bias, relu)


def quantized_conv(x, w_hwio, bias, a_scale, relu: bool = False):
    """``ConvDecoder._quantize_conv`` of the JAX package (+ the ReLU): float32
    NHWC ``x`` quantized with ``a_scale``, HWIO weights per output channel,
    through :func:`conv_int8`."""
    w_q, w_scale = quantize_weight(w_hwio, (0, 1, 2))
    return conv_int8(quantize_activation(x, a_scale).contiguous(), w_q.contiguous(), a_scale,
                     w_scale.contiguous(), bias.float().contiguous(), relu)
