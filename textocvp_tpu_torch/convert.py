"""
Carry weights from the JAX package into the port.

:func:`from_jax_params` takes a JAX model's ``variables["params"]`` tree as
nested dicts of numpy arrays (``jax.device_get`` of the flax tree) and returns
the state dict of the port's module:

* Dense ``kernel`` (in, out) -> ``weight`` (out, in); Conv ``kernel`` HWIO -> OIHW;
* LayerNorm ``scale`` -> ``weight``; Embed ``embedding`` -> ``weight``;
* the flax GRU (``ir``, ``iz``, ``in`` with biases; ``hr``, ``hz`` without;
  ``hn`` with bias) -> ``torch.nn.GRUCell`` (``weight_ih`` = [ir; iz; in]ᵀ,
  ``bias_hh`` = [0; 0; b_hn]);
* flax's automatic names -> the port's attributes: ``Dense_i`` ->
  ``layers.i`` (``projection`` in a SoftPositionEmbed), ``ConvBlock_i`` ->
  ``blocks.i``, ``Conv_0`` -> ``conv`` (``final_conv`` of the decoder),
  ``block_i`` -> ``blocks.i``, ``layer_i`` -> ``layers.i``.

Every other name (T5's ``shared``, ``layer_i/attn/{q,k,v,o}``, ``ln_attn``,
``ln_ff``, ``wi``, ``wo``, ``final_ln``; the learned PE ``pe``; the slot
initializer's tables) is kept.
"""

from __future__ import annotations

import re
from collections.abc import Mapping

import numpy as np
import torch

KINDS = {"savi": "slot_attention", "predictor": "predictor"}
_GRU_GATES = ("ir", "iz", "in", "hr", "hz", "hn")


def _module_name(name: str, parent: str) -> str:
    if m := re.fullmatch(r"Dense_(\d+)", name):
        return "projection" if parent.endswith("pos_embedding") else f"layers.{m[1]}"
    if m := re.fullmatch(r"ConvBlock_(\d+)", name):
        return f"blocks.{m[1]}"
    if name == "Conv_0":
        return "final_conv" if parent == "image_decoder" else "conv"
    if m := re.fullmatch(r"(block|layer)_(\d+)", name):
        return f"{m[1]}s.{m[2]}"
    return name


def _leaf(name: str, value: np.ndarray) -> tuple[str, np.ndarray]:
    if name == "kernel":
        if value.ndim == 2:
            return "weight", value.T
        if value.ndim == 4:
            return "weight", value.transpose(3, 2, 0, 1)
        raise ValueError(f"kernel of rank {value.ndim}")
    if name in ("scale", "embedding"):
        return "weight", value
    if name == "relative_attention_bias":
        return "relative_attention_bias.weight", value
    return name, value


def _gru(tree: Mapping) -> dict:
    missing = set(_GRU_GATES) - set(tree)
    if missing:
        raise KeyError(f"GRU params lack {sorted(missing)}")
    k = {g: np.asarray(tree[g]["kernel"]).T for g in _GRU_GATES}  # (out, in)
    b_hn = np.asarray(tree["hn"]["bias"])
    return {
        "weight_ih": np.concatenate([k["ir"], k["iz"], k["in"]]),
        "bias_ih": np.concatenate([np.asarray(tree[g]["bias"]) for g in ("ir", "iz", "in")]),
        "weight_hh": np.concatenate([k["hr"], k["hz"], k["hn"]]),
        "bias_hh": np.concatenate([np.zeros_like(b_hn), np.zeros_like(b_hn), b_hn]),
    }


def convert_tree(params: Mapping, prefix: str = "", parent: str = "") -> dict:
    """Any flax params subtree -> the port's state-dict entries (float32 tensors)."""
    out = {}
    for name, value in params.items():
        if name == "gru" and isinstance(value, Mapping):
            for key, arr in _gru(value).items():
                out[f"{prefix}gru.{key}"] = torch.from_numpy(np.ascontiguousarray(arr, np.float32))
        elif isinstance(value, Mapping):
            out.update(convert_tree(value, f"{prefix}{_module_name(name, parent)}.", name))
        else:
            key, arr = _leaf(name, np.asarray(value))
            out[prefix + key] = torch.from_numpy(np.ascontiguousarray(arr, np.float32))
    return out


def from_jax_params(kind: str, params: Mapping) -> dict:
    """``kind`` is "savi" (a SAVi's params) or "predictor" (a PredictorWrapper's)."""
    if kind not in KINDS:
        raise ValueError(f"kind must be one of {sorted(KINDS)}, got {kind!r}")
    if KINDS[kind] not in params:
        raise KeyError(f"{kind} params have no {KINDS[kind]!r} subtree; got {sorted(params)}")
    return convert_tree(params)
