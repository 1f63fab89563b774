"""
Opt-in int8 (counterpart of the JAX package's ``textocvp_tpu/models/quant.py``).

* ``tpu.decode_quant: "int8"``: SAVi's ConvDecoder tail convs before the final
  one, or ExtendedDINOSAUR's patch-decoder denses and BatchNorm-folded
  CNN-head convs, run in int8 (``nn/decoders.py``; the convs through the
  port's kernel ``csrc/conv_int8.cu``, the denses through ``torch._int_mm``).
* ``tpu.encode_quant: "int8"``: ExtendedDINOSAUR's frozen ViT denses (qkv,
  proj, fc1, fc2 of every block) run in int8 (``nn/vit.py``).

Weights are quantized per output channel from the float weights at each call;
activations per tensor with STATIC scales, calibrated once from real data:
one float pass over the first batch (the evaluators) or the first request
(the service, ``InferenceFrontend.calibrate`` / ``warmup``), each
quantized layer's input amax mapped to the int8 grid: the caller calibrates
where its scales are still None, as the JAX ``lazy_quantized_stage`` and
``lazy_encode_quantized_stage`` do on their first call. Every batch, the first
included, then runs quantized. This changes outputs, so it is opt-in per
experiment, and every ``results.json`` made with it carries the flags
``"decode_quant": "int8"`` / ``"encode_quant": "int8"``.

On a mesh each data index calibrates on its rows and the amaxes are
max-reduced over the data group, so every rank holds the scales of the
global first batch, as the JAX package's calibration on its mesh does; the
row shards of tensor parallelism take the whole layer's (``ops/dense_int8.py``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from textocvp_tpu_torch.core.config import tpu_option
from textocvp_tpu_torch.core.logger import print_
from textocvp_tpu_torch.ops.conv_int8 import divide
from textocvp_tpu_torch.parallel.mesh import all_reduce

VALID = (None, "int8")


def decode_quant_mode(exp_params: dict) -> Optional[str]:
    """Validated ``tpu.decode_quant`` (None = off, the default)."""
    mode = tpu_option(exp_params, "decode_quant")
    if mode not in VALID:
        raise ValueError(f"tpu.decode_quant must be one of {VALID}, got {mode!r}")
    model_name = (exp_params.get("model") or {}).get("model_name")
    if mode is not None and model_name not in ("SAVi", "ExtendedDINOSAUR"):
        raise ValueError(
            "tpu.decode_quant supports the SAVi ConvDecoder and the "
            "ExtendedDINOSAUR MLPPatchDecoder; this experiment uses "
            f"{model_name!r}. Unset tpu.decode_quant.")
    return mode


def encode_quant_mode(exp_params: dict) -> Optional[str]:
    """Validated ``tpu.encode_quant`` (None = off, the default): int8 for the
    frozen ViT's denses, ExtendedDINOSAUR only."""
    mode = tpu_option(exp_params, "encode_quant")
    if mode not in VALID:
        raise ValueError(f"tpu.encode_quant must be one of {VALID}, got {mode!r}")
    model_name = (exp_params.get("model") or {}).get("model_name")
    if mode is not None and model_name != "ExtendedDINOSAUR":
        raise ValueError(
            "tpu.encode_quant quantizes the frozen ViT encoder and is only "
            f"supported for ExtendedDINOSAUR; this experiment uses "
            f"{model_name!r}. Unset tpu.encode_quant.")
    return mode


def _scales(amaxes, what: str):
    scales = divide(torch.clamp(amaxes.float(), min=1e-12), 127.0)
    if not bool(torch.isfinite(scales).all()):
        raise ValueError(f"int8 {what} calibration produced non-finite scales: "
                         f"{scales.tolist()}")
    print_(f"int8 {what} calibration: {tuple(scales.shape)} scales, "
           f"max={scales.max().item():.4g} min={scales.min().item():.4g}")
    return scales


@torch.no_grad()
def calibrate_decode_scales(model, slots, group=None):
    """Per-layer activation scales (L,) float32 of the int8 decode: one float
    decode of ``slots`` (N, S, D), each quantized layer's input amax / 127.
    ``group`` (a mesh's data group): the amaxes max-reduced over it first,
    so that every rank holds the scales of the global batch's rows."""
    return _scales(all_reduce(model.decode_calibrate(slots), group, dist.ReduceOp.MAX),
                   "decode")


@torch.no_grad()
def calibrate_encode_scales(model, videos, group=None):
    """Per-block per-dense activation scales (depth, 4) float32 of the int8
    ViT encode: one float ViT pass over ``videos`` (B, T, H, W, C);
    ``group`` as :func:`calibrate_decode_scales` takes it."""
    return _scales(all_reduce(model.encode_calibrate(videos), group, dist.ReduceOp.MAX),
                   "encode")
