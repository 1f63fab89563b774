"""
Carry weights from the JAX package into the port.

:func:`from_jax_params` takes a JAX model's ``variables["params"]`` tree as
nested dicts of numpy arrays (``jax.device_get`` of the flax tree) and returns
the state dict of the port's module:

* Dense ``kernel`` (in, out) -> ``weight`` (out, in); Conv ``kernel`` HWIO -> OIHW;
* LayerNorm ``scale`` -> ``weight``; Embed ``embedding`` -> ``weight``;
* the flax GRU (``ir``, ``iz``, ``in`` with biases; ``hr``, ``hz`` without;
  ``hn`` with bias) -> the port's ``GRUCell`` (``weight_ih`` = [ir; iz; in]ᵀ,
  ``bias_ih``, ``weight_hh`` = [hr; hz; hn]ᵀ, ``bias_hn``): the same leaves,
  so a tree of gradients converts as a tree of weights does;
* flax's automatic names -> the port's attributes: ``Dense_i`` ->
  ``layers.i`` (``projection`` in a SoftPositionEmbed), ``ConvBlock_i`` and
  ``ResNetBasicBlock_i`` -> ``blocks.i``, ``Conv_0`` -> ``conv``
  (``final_conv`` of the decoder), ``Conv_k`` -> ``conv<k>``,
  ``GroupNorm_0`` -> ``norm``, ``GroupNorm_k`` -> ``norm<k>`` (the ResNet's
  stem and blocks), ``BatchNorm_0`` -> ``bn``, ``block_i`` -> ``blocks.i``, ``layer_i`` ->
  ``layers.i``, ``mlp_i`` -> ``mlps.i``, ``cnn_i`` -> ``cnns.i``;
* BatchNorm ``batch_stats`` (``mean``, ``var``) -> ``running_mean``,
  ``running_var``, with ``num_batches_tracked`` 0.

Every other name (T5's ``shared``, ``layer_i/attn/{q,k,v,o}``, ``ln_attn``,
``ln_ff``, ``wi``, ``wo``, ``final_ln``; the learned PE ``pe``; the slot
initializer's tables; the ViT's ``patch_embed``, ``cls_token``, ``pos_embed``,
``norm1``, ``qkv``, ``proj``, ``fc1``, ``fc2``, ``ls1_gamma``, ``ls2_gamma``;
the patch decoder's ``pos_embed``, ``initial_ln`` and ``cnn_final``; the
torch-style layers' ``self_attn``, ``linear1``, ``linear2``, OCVP's
``object_block``, ``time_block``, ``self_attn_obj``, ``self_attn_time``; the
text encoder's ``token_embedding``, ``position_embedding``, ``ln_in``,
``ln_out``, ``out_projection``) is kept.
"""

from __future__ import annotations

import re
from collections.abc import Mapping

import numpy as np
import torch

KINDS = {"savi": "slot_attention", "dinosaur": "patch_decoder", "predictor": "predictor"}
_GRU_GATES = ("ir", "iz", "in", "hr", "hz", "hn")


def _module_name(name: str, parent: str) -> str:
    if m := re.fullmatch(r"Dense_(\d+)", name):
        return "projection" if parent.endswith("pos_embedding") else f"layers.{m[1]}"
    if m := re.fullmatch(r"(?:ConvBlock|ResNetBasicBlock)_(\d+)", name):
        return f"blocks.{m[1]}"
    if name == "Conv_0":
        return "final_conv" if parent == "image_decoder" else "conv"
    if m := re.fullmatch(r"(Conv|GroupNorm)_(\d+)", name):
        return ("conv" if m[1] == "Conv" else "norm") + (m[2] if m[2] != "0" else "")
    if name == "BatchNorm_0":
        return "bn"
    if m := re.fullmatch(r"(block|layer|mlp|cnn)_(\d+)", name):
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
    return {
        "weight_ih": np.concatenate([k["ir"], k["iz"], k["in"]]),
        "bias_ih": np.concatenate([np.asarray(tree[g]["bias"]) for g in ("ir", "iz", "in")]),
        "weight_hh": np.concatenate([k["hr"], k["hz"], k["hn"]]),
        "bias_hn": np.asarray(tree["hn"]["bias"]),
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


def convert_batch_stats(batch_stats: Mapping) -> dict:
    """A flax ``batch_stats`` tree -> the BatchNorm buffers of the port's state dict."""
    out = {}
    for key, value in convert_tree(batch_stats).items():
        prefix, leaf = key.rsplit(".", 1)
        if leaf not in ("mean", "var"):
            raise KeyError(f"batch_stats leaf {key!r} is neither mean nor var")
        out[f"{prefix}.running_{leaf}"] = value
        out[f"{prefix}.num_batches_tracked"] = torch.tensor(0)
    return out


def from_jax_params(kind: str, params: Mapping, batch_stats: Mapping | None = None) -> dict:
    """``kind`` is "savi" (a SAVi's params), "dinosaur" (an ExtendedDINOSAUR's)
    or "predictor" (a PredictorWrapper's). ``batch_stats`` is the model's flax
    ``batch_stats`` collection, which a model with BatchNorms needs: an
    ExtendedDINOSAUR's CNN head, a SAVi's ``batch_norm`` encoder or decoder."""
    if kind not in KINDS:
        raise ValueError(f"kind must be one of {sorted(KINDS)}, got {kind!r}")
    if KINDS[kind] not in params:
        raise KeyError(f"{kind} params have no {KINDS[kind]!r} subtree; got {sorted(params)}")
    out = convert_tree(params)
    if batch_stats:
        out.update(convert_batch_stats(batch_stats))
    return out
