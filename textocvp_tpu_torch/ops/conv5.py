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
* bfloat16 (``tpu.compute_dtype`` "bfloat16"): ``x`` bf16, ``w`` bf16 (or
  float32, rounded to bf16 as flax's ``promote_dtype`` does), ``b`` float32;
  the result is bf16. The contract of the Pallas kernel in bf16
  (``bench_pallas_conv.py:81-84``): bf16 operands, products and sums in
  float32, the float32 bias, the ReLU, one rounding to bf16. A CUDA tensor
  launches the kernel's bf16 variant (:func:`conv5_bf16_cuda`, counted in its
  own ``launches``); its gradient is below.
* The kernel takes Cin = Cout = 64 at any N, H, W >= 1; the plain version
  any channel counts.
* :func:`conv5` dispatches on the tensor's device: a CPU tensor runs
  :func:`conv5_plain` (plain autograd), a CUDA tensor goes through
  :class:`Conv5Function`, whose forward launches the kernel through
  :func:`conv5_cuda` or raises. There is no fallback to cuDNN. Where no
  gradient is recorded the call is the op ``torch.ops.textocvp_torch.conv5``
  (``torch.library.custom_op``: :func:`conv5_plain` for a CPU tensor, the
  kernel for a CUDA one), which ``torch.export`` records as one node.
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

  In bf16 :func:`conv5` casts the weights to bf16 before the Function
  (flax's ``promote_dtype``), so that autograd's cast carries the bf16
  weight gradient back to the float32 parameter, as the JAX package's bf16
  step does. Each part keeps the forward's contract, float32 sums of exact
  products and one rounding to bf16: the input gradient is a launch of the
  bf16 kernel (:func:`conv5_bf16_input_grad_cuda`, counted apart and in
  ``conv5_bf16_cuda.launches``), the weight gradient
  :func:`conv5_weight_grad_bf16`, the bias gradient the float32 sum of
  ``g'``. A bf16 CPU tensor takes the same Function with :func:`conv5_plain`
  for both convs: the plain version of the bf16 backward.
"""

from __future__ import annotations

import ctypes
from contextlib import contextmanager

import torch
import torch.nn.functional as F

from textocvp_tpu_torch.ops import build
from textocvp_tpu_torch.ops.grad_guard import needs_grad, refuse_grad

KERNEL_SIZE = 5
CHANNELS = 64  # the kernel's input and output channels


def conv5_plain(x, w, b, relu: bool = True):
    """Sum over the 25 taps of ``pad(x)[shifted] @ w[dy, dx]``, + b, [ReLU].
    A bf16 ``x`` follows the bf16 kernel's contract: ``w`` rounded to bf16,
    the products (exact in float32) and the sums in float32, the float32
    bias, the ReLU, then one rounding to bf16; not torch's bf16 matmuls,
    which round after every tap."""
    if x.dtype == torch.bfloat16:
        return conv5_plain(x.float(), w.to(torch.bfloat16).float(), b.float(),
                           relu).to(torch.bfloat16)
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
        lib.conv5_bf16_forward.argtypes = lib.conv5_forward.argtypes
        lib.conv5_bf16_forward.restype = ctypes.c_int
        lib.conv5_bf16_plan.argtypes = [ctypes.c_int] * 2 + [ctypes.POINTER(ctypes.c_int)] * 6
        lib.conv5_bf16_plan.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(x, w, b, dtype=torch.float32):
    """Raise on what the kernel of ``dtype`` does not take: x and w of
    ``dtype``, b float32."""
    if not x.is_cuda:
        raise ValueError(f"x must lie on a CUDA device, got {x.device}")
    for name, t, want in (("x", x, dtype), ("w", w, dtype), ("b", b, torch.float32)):
        if t.device != x.device:
            raise ValueError(f"{name} must lie on {x.device} with x, got {t.device}")
        if t.dtype != want:
            raise TypeError(f"{name} must be {str(want)[6:]}, got {t.dtype}")
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
    :class:`Conv5Function`. A bf16 ``x`` goes to :func:`conv5_bf16_cuda`."""
    if x.dtype == torch.bfloat16:
        return conv5_bf16_cuda(x, w, b, relu)
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


BF16_CHUNK = 16  # input channels a chunk of the bf16 kernel (wgmma's K)


def bf16_weight_tiles(w):
    """HWIO (5, 5, 64, 64) weights as the bf16 kernel reads them: [chunk of
    16 input channels][tap][8-channel block][64 output channels][8 input
    channels], each chunk's 25 taps contiguous (one bulk copy), each tap's
    (64, 16) slice wgmma's K-major A operand."""
    k, _, cin, cout = w.shape
    t = w.reshape(k * k, cin // BF16_CHUNK, BF16_CHUNK // 8, 8, cout)
    return t.permute(1, 0, 2, 4, 3).contiguous()


def bf16_plan(h: int, wd: int) -> dict:
    """The bf16 kernel's halo geometry for an (h, wd) frame (``conv5_bf16_plan``
    in ``csrc/conv5.cu``): strip width, strips, padded row, box rows, plane
    bytes, dynamic shared memory. Needs the built library."""
    vals = [ctypes.c_int() for _ in range(6)]
    err = load_library().conv5_bf16_plan(h, wd, *(ctypes.byref(v) for v in vals))
    if err != 0:
        raise ValueError(f"the bf16 kernel takes no frame of {h} x {wd}")
    return dict(zip(("ws", "strips", "wp", "rows", "plane", "smem"), (v.value for v in vals)))


def conv5_bf16_cuda(x, w, b, relu: bool = True):
    """Launch the kernel's bf16 variant on the current stream: ``x`` bf16,
    ``w`` bf16 (float32 is rounded to bf16 here), ``b`` float32 -> bf16. The
    kernel reads the weights tiled (:func:`bf16_weight_tiles`). No autograd:
    :func:`conv5` records the gradient through :class:`Conv5Function`, and a
    direct call under grad raises."""
    refuse_grad("conv5 (bf16)", x, w, b)
    w = w.to(torch.bfloat16)
    _check(x, w, b, torch.bfloat16)
    lib = load_library()
    n, h, wd, _ = x.shape
    w_t = bf16_weight_tiles(w)
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = lib.conv5_bf16_forward(x.data_ptr(), w_t.data_ptr(), b.data_ptr(), out.data_ptr(),
                                     n, h, wd, int(bool(relu)), stream)
    if err != 0:
        raise RuntimeError(f"conv5 bf16 kernel launch failed: cudaError {err}")
    conv5_bf16_cuda.launches += 1
    return out


conv5_bf16_cuda.launches = 0


def conv5_input_grad_cuda(g, w_rot, b_zero, relu: bool = False):
    """The input gradient's launch of the kernel: :func:`conv5_cuda` of the
    masked output gradient with the rotated weights; counted in its own
    ``launches`` as well as in ``conv5_cuda.launches``."""
    out = conv5_cuda(g, w_rot, b_zero, relu)
    conv5_input_grad_cuda.launches += 1
    return out


conv5_input_grad_cuda.launches = 0


def conv5_bf16_input_grad_cuda(g, w_rot, b_zero, relu: bool = False):
    """The bf16 input gradient's launch of the bf16 kernel:
    :func:`conv5_bf16_cuda` of the masked bf16 output gradient with the
    rotated bf16 weights and a float32 zero bias; counted in its own
    ``launches`` as well as in ``conv5_bf16_cuda.launches``."""
    out = conv5_bf16_cuda(g, w_rot, b_zero, relu)
    conv5_bf16_input_grad_cuda.launches += 1
    return out


conv5_bf16_input_grad_cuda.launches = 0


def _padded_grid(x, g):
    """x (N, H, W, Cin) with its zero border and g (N, H, W, Cout) in the
    top-left H x W corner with zeros around it, both on the padded grid of
    (H + 4) x (W + 4) pixels a frame and flattened to rows of channels; x
    with zero rows after it for the largest shift. Returns (x rows, g rows,
    the 25 taps' shifts in rows)."""
    n, h, wd, cin = x.shape
    pad = KERNEL_SIZE // 2
    hp, wp = h + 2 * pad, wd + 2 * pad
    frame = hp * wp
    tail = (KERNEL_SIZE - 1) * (wp + 1)  # the largest shift
    xflat = x.new_zeros((n * frame + tail, cin))
    xflat[:n * frame].view(n, hp, wp, cin)[:, pad:pad + h, pad:pad + wd] = x
    gext = g.new_zeros((n, hp, wp, g.shape[-1]))
    gext[:, :h, :wd] = g
    shifts = [dy * wp + dx for dy in range(KERNEL_SIZE) for dx in range(KERNEL_SIZE)]
    return xflat, gext.view(n * frame, -1), shifts


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
    to ``conv5_weight_grad.calls`` (behind a frozen decoder there is none).
    bf16 operands go to :func:`conv5_weight_grad_bf16`."""
    conv5_weight_grad.calls += 1
    if x.dtype == torch.bfloat16:
        return conv5_weight_grad_bf16(x, g)
    n, cin = x.shape[0], x.shape[-1]
    xflat, gext, shifts = _padded_grid(x, g)
    frame = gext.shape[0] // n
    gext = gext.view(n, frame, -1)
    taps = []
    for shift in shifts:
        xs = xflat[shift:shift + n * frame].view(n, frame, cin)
        taps.append(torch.matmul(xs.transpose(1, 2), gext).sum(0))
    return torch.stack(taps).view(KERNEL_SIZE, KERNEL_SIZE, cin, -1)


conv5_weight_grad.calls = 0


@contextmanager
def float32_reductions():
    """cuBLAS's bf16 GEMMs with every partial sum in float32 inside: PyTorch
    lets them reduce split-K partials in bf16 unless
    ``allow_bf16_reduced_precision_reduction`` is off."""
    flag = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = flag


def conv5_weight_grad_bf16(x, g):
    """dW (5, 5, Cin, Cout) in bf16 of bf16 x and g, to the forward's
    contract: float32 sums of exact products over every pixel of every
    frame, then one rounding to bf16 (the weight gradient of the JAX
    package's bf16 conv before its cast to the float32 parameter).

    On the padded grid (:func:`conv5_weight_grad`) a tap's operand is one
    contiguous slice across all frames, so each tap is one GEMM whose K runs
    over every pixel of every frame: the frame sum sits inside the GEMM's
    float32 accumulation, not in a bf16 sum of per-frame products. On the
    card the GEMM is cuBLAS's bf16 one, accumulating in float32 and, under
    :func:`float32_reductions`, reducing its split-K partials in float32,
    its result rounded once to bf16; on the CPU the same products on the
    operands cast to float32, then rounded once."""
    xflat, gext, shifts = _padded_grid(x, g)
    rows = gext.shape[0]
    if x.device.type == "cpu":
        xflat, gext = xflat.float(), gext.float()
    with float32_reductions():
        taps = [torch.matmul(xflat[s:s + rows].t(), gext).to(torch.bfloat16) for s in shifts]
    return torch.stack(taps).view(KERNEL_SIZE, KERNEL_SIZE, x.shape[-1], -1)


class Conv5Function(torch.autograd.Function):
    """The conv with a gradient. ``apply(x, w, b, relu, conv, input_grad_conv)``:
    ``conv(x, w, b, relu)`` computes the forward without autograd (the kernel's
    :func:`conv5_cuda` on the card; the tests pass :func:`conv5_plain`), and
    ``input_grad_conv(g', w_rot, zeros, False)`` the input gradient
    (:func:`conv5_input_grad_cuda` on the card). In bf16 x and w are bf16
    and b float32 (:func:`conv5`); so are their gradients."""

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
            zeros = torch.zeros(w.shape[2], dtype=torch.float32, device=w.device)
            dx = ctx.input_grad_conv(g, w_rot, zeros, False)
        if ctx.needs_input_grad[1]:
            dw = conv5_weight_grad(x, g)
        if ctx.needs_input_grad[2]:
            db = g.sum((0, 1, 2), dtype=torch.float32)
        return dx, dw, db, None, None, None


@torch.library.custom_op("textocvp_torch::conv5", mutates_args=())
def conv5_op(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, relu: bool) -> torch.Tensor:
    """The forward as one op: :func:`conv5_plain` for a CPU tensor, the
    kernel (:func:`conv5_cuda`) for a CUDA tensor."""
    if x.device.type == "cpu":
        return conv5_plain(x, w, b, relu)
    return conv5_cuda(x, w, b, relu)


@conv5_op.register_fake
def _(x, w, b, relu):
    return x.new_empty((*x.shape[:-1], w.shape[-1]))


def conv5(x, w, b, relu: bool = True):
    """The plain version for CPU tensors; for CUDA tensors the kernel, through
    :class:`Conv5Function` so that autograd records its gradient. In bf16 the
    weights are cast to bf16 first, and a CPU tensor takes the Function too,
    with :func:`conv5_plain` for both convs. Where no gradient is recorded,
    :func:`conv5_op`."""
    if not needs_grad(x, w, b):
        return conv5_op(x, w, b, relu)
    if x.dtype == torch.bfloat16:
        w = w.to(torch.bfloat16)  # promote_dtype: autograd's cast takes dW to float32
        if x.device.type == "cpu":
            return Conv5Function.apply(x, w, b, relu, conv5_plain, conv5_plain)
        return Conv5Function.apply(x, w, b, relu, conv5_bf16_cuda, conv5_bf16_input_grad_cuda)
    if x.device.type == "cpu":
        return conv5_plain(x, w, b, relu)
    return Conv5Function.apply(x, w, b, relu, conv5_cuda, conv5_input_grad_cuda)
