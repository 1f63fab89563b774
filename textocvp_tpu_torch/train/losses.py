"""
Loss registry and weighted multi-loss combination of the port (copy of the
JAX package's ``textocvp_tpu/train/losses.py``).

Each loss spec is ``{"type": name, "weight": w}``; the combined loss is the
weighted sum. Every loss is an MSE routed by keyword: ``mse`` (image
reconstruction), ``pred_img_mse``, ``pred_slot_mse``, ``pred_feature_mse``;
each computes in float32 whatever its inputs' dtype, as the JAX package's.
:func:`clip01` is the JAX trainers' ``jnp.clip`` of the 02 loss's inputs.
"""

from __future__ import annotations

from typing import Callable

import torch


def clip01(x):
    """``x`` clipped to [0, 1] as ``jnp.clip`` clips it, a maximum then a
    minimum: a value exactly at a bound passes half its gradient (the two
    sides of a tie share it), where ``Tensor.clamp`` passes all of it. In
    bfloat16 a reconstruction rounds to exactly 1.0 often enough for the
    difference to show in the step's gradients."""
    return torch.minimum(torch.maximum(x, x.new_zeros(())), x.new_ones(()))


def _mse(a, b):
    return torch.mean(torch.square(a.float() - b.float()))


def mse(pred_imgs=None, target_imgs=None, **_):
    return _mse(pred_imgs, target_imgs)


def pred_img_mse(pred_imgs=None, target_imgs=None, **_):
    return _mse(pred_imgs, target_imgs)


def pred_slot_mse(pred_slots=None, target_slots=None, **_):
    return _mse(pred_slots, target_slots)


def pred_feature_mse(preds_feats=None, targets_feats=None, **_):
    return _mse(preds_feats, targets_feats)


LOSS_DICT: dict[str, Callable] = {
    "mse": mse,
    "pred_img_mse": pred_img_mse,
    "pred_slot_mse": pred_slot_mse,
    "pred_feature_mse": pred_feature_mse,
}


def build_loss_fn(loss_specs: list[dict]) -> Callable[..., tuple[torch.Tensor, dict]]:
    """``loss_fn(**tensors) -> (total, {name: value, "_total": total})`` from
    the config's specs; an unknown loss name raises here."""
    for spec in loss_specs:
        if spec["type"] not in LOSS_DICT:
            raise NameError(f"Unknown loss {spec['type']!r}. Use one of {list(LOSS_DICT)}")

    def loss_fn(**tensors):
        values = {}
        total = 0.0
        for spec in loss_specs:
            val = LOSS_DICT[spec["type"]](**tensors)
            values[spec["type"]] = val
            total = total + spec.get("weight", 1.0) * val
        values["_total"] = total
        return total, values

    return loss_fn
