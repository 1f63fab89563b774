"""
int8 dense layer of the opt-in int8 paths: the JAX package's
``textocvp_tpu/nn/vit.py::_dense_int8`` (the frozen ViT's denses under
``tpu.encode_quant``) and ``MLPPatchDecoder._quantize_dense`` (the patch
decoder's denses under ``tpu.decode_quant``).

``x`` (..., in) float32 is quantized per tensor with ``a_scale``, the weight
per output column (``w_scale = max(max |w| over in, 1e-30) / 127``); the int8
x int8 product is summed exactly, then ``float32(acc) * (a_scale * w_scale) +
bias``.

The product is a plain GEMM, which the JAX package leaves to XLA's
``dot_general``: on the card it is ``torch._int_mm`` (cuBLASLt's int8 GEMM,
int32 sums), a library call as ``torch.matmul`` is for the float denses.
Under tensor parallelism (``row_group``) a row shard's partial sums meet in
one all-reduce of the integer products.

``torch._int_mm`` takes more than 16 rows and a depth and a width that are
multiples of 8: the weight gets zero output columns up to a multiple of 8
(the patch decoder's last dense has 769) and ``x`` zero rows up to 17, both
sliced off after, which is exact. On the CPU the product runs in float64,
exact as every partial sum is an integer below 2^53, so the two give the
same bits.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from textocvp_tpu_torch.ops.conv_int8 import dequantize, quantize_activation, quantize_weight
from textocvp_tpu_torch.parallel.mesh import all_reduce

MIN_ROWS = 17  # torch._int_mm takes more than 16 rows
ALIGN = 8      # ... and a depth and a width that are multiples of 8


def int8_product(x_q, w_q):
    """The exact product of int8 ``x_q`` (m, in) and ``w_q`` (out, in), (m,
    out): ``torch._int_mm`` (int32) on the card, float64 on the CPU."""
    if x_q.device.type == "cpu":
        return x_q.to(torch.float64) @ w_q.to(torch.float64).t()
    m, k = x_q.shape
    n = w_q.shape[0]
    if k % ALIGN:
        raise ValueError(f"torch._int_mm takes a depth that is a multiple of {ALIGN}, got {k}")
    w_pad = F.pad(w_q, (0, 0, 0, -n % ALIGN))
    x_pad = F.pad(x_q, (0, 0, 0, max(MIN_ROWS - m, 0)))
    return torch._int_mm(x_pad, w_pad.t())[:m, :n]


def dense_int8(x, weight, bias, a_scale, row_group=None):
    """``x @ weight.T + bias`` in int8: ``weight`` (out, in) float32, torch's
    ``nn.Linear`` layout, quantized per output row; ``x`` (..., in).

    ``row_group``: ``weight`` and ``x`` are this rank's columns of a row
    shard (``parallel/partitioning.py::RowParallelLinear``). Each output
    row's scale is then the whole row's, its max |w| max-reduced over the
    group, and the ranks' partial integer sums are summed over the group
    before the one dequantization, as XLA sums the int32 partial products of
    a contraction that the JAX package shards: exact, so the result is the
    whole layer's bit for bit."""
    amax = None
    if row_group is not None:
        amax = all_reduce(weight.detach().float().abs().amax(1, keepdim=True), row_group,
                          dist.ReduceOp.MAX)
    w_q, w_scale = quantize_weight(weight, (1,), amax)
    x_q = quantize_activation(x, a_scale).reshape(-1, x.shape[-1])
    acc = int8_product(x_q, w_q)
    if row_group is not None:
        acc = all_reduce(acc.contiguous(), row_group)
    return dequantize(acc, a_scale, w_scale, bias.float()).reshape(*x.shape[:-1], -1)


def linear_int8(layer, x, a_scale):
    """``layer`` (an ``nn.Linear``, or a tensor-parallel shard of one) in
    int8 through :func:`dense_int8`."""
    return dense_int8(x, layer.weight, layer.bias, a_scale, getattr(layer, "row_group", None))


def input_amax(layer, x):
    """``max |x|`` of ``layer``'s input, float32: over the whole input when
    ``x`` is this rank's columns of a row shard's input (its ``row_group``)."""
    amax = x.abs().amax().float()
    group = getattr(layer, "row_group", None)
    return amax if group is None else all_reduce(amax.clone(), group, dist.ReduceOp.MAX)
