"""
ExtendedDINOSAUR video decomposition (counterpart of the JAX package's
``textocvp_tpu/models/extended_dinosaur.py``): a frozen ViT, slot attention
over its projected patch features, and the MLP patch decoder. Video is NHWC,
(B, T, H, W, C) in [0, 1], at the public functions.

The ViT runs once over all B*T frames, then LayerNorm (eps 1e-6) and the
projection MLP (mlp_encoder_dim -> ReLU -> slot_dim) and the K/V projection;
only the slot recurrence walks the frames.

The ViT is frozen, as the JAX package's ``stop_gradient`` and its trainer's
freeze of the ``image_encoder`` subtree have it: its parameters require no
grad, and it runs under ``torch.no_grad()``, out of the autograd graph. Its
weights stay in the state dict and in every checkpoint.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from textocvp_tpu_torch.models.savi import get_transition_module
from textocvp_tpu_torch.nn.blocks import MLP
from textocvp_tpu_torch.nn.decoders import get_decoder
from textocvp_tpu_torch.nn.encoders import get_encoder
from textocvp_tpu_torch.nn.initializers import get_initializer
from textocvp_tpu_torch.ops.slot_attention import SlotAttention


class ExtendedDINOSAUR(nn.Module):
    def __init__(self, img_size: int, num_slots: int, slot_dim: int, encoder: dict,
                 decoder: dict, num_iterations: int = 1, num_iterations_first: int = 3,
                 mlp_hidden: int = 128, mlp_encoder_dim: int = 768,
                 initializer: str = "LearnedRandom", transition_module: Optional[dict] = None):
        super().__init__()
        if "vit" not in encoder["encoder_name"]:
            raise ValueError("ExtendedDINOSAUR expects a ViT-based encoder")
        if decoder["decoder_name"] != "MLPPatchDecoder":
            raise ValueError("ExtendedDINOSAUR expects an 'MLPPatchDecoder'")
        self.num_slots = num_slots
        self.slot_dim = slot_dim
        self.num_iterations = num_iterations
        self.num_iterations_first = num_iterations_first

        self.slot_initializer = get_initializer(initializer, slot_dim, num_slots)
        tm = dict(transition_module or {})
        self.transition = get_transition_module(tm.pop("model_name", None), slot_dim, **tm)
        enc = {**encoder, "encoder_params": {**encoder.get("encoder_params", {}),
                                             "img_size": img_size}}
        self.image_encoder, feats = get_encoder(enc)
        self.image_encoder.requires_grad_(False)
        self.feat_proj_ln = nn.LayerNorm(feats, eps=1e-6)
        self.feat_proj_mlp = MLP(feats, [mlp_encoder_dim, slot_dim])
        dec = {**decoder, "decoder_params": {**decoder.get("decoder_params", {}),
                                             "img_size": img_size}}
        self.patch_decoder = get_decoder(dec, slot_dim)
        self.slot_attention = SlotAttention(slot_dim, slot_dim, num_slots, mlp_hidden)

    def decode(self, slots):
        """Slots (N, S, D) -> dict of recons_feats (N, P, F), masks
        (N, S, 1, gh, gw) and recons_imgs (N, H, W, 3), or None when the
        decoder reconstructs features only."""
        return self.patch_decoder(slots)

    def frozen_features(self, x):
        """The frozen ViT's features (B * T, P, F) of video (B, T, H, W, C),
        under ``torch.no_grad()``: out of the autograd graph."""
        with torch.no_grad():
            return self.image_encoder(x.reshape(-1, *x.shape[2:]))

    def decompose(self, x, initial_slots=None, generator: Optional[torch.Generator] = None,
                  img_feats=None):
        """Video (B, T, H, W, C) -> dict of slot_history (B, T, S, D),
        attn_masks (B, T, S, P) and encoded_img_feats (B, T, P, F) (the JAX
        ``decompose(..., decode=False)``).

        The initial slots are ``initial_slots`` when given, else drawn by the
        slot initializer with ``generator``. ``img_feats`` are the ViT's
        features of ``x`` (:meth:`frozen_features`) when the caller has them.
        """
        b, t = x.shape[:2]
        if img_feats is None:
            img_feats = self.frozen_features(x)
        k, v = self.slot_attention.project_inputs(self.feat_proj_mlp(self.feat_proj_ln(img_feats)))
        k = k.reshape(b, t, *k.shape[1:])
        v = v.reshape(b, t, *v.shape[1:])

        slots = self.slot_initializer(b, generator) if initial_slots is None else initial_slots
        slot_hist, attn_hist = [], []
        for step in range(t):
            iters = self.num_iterations_first if step == 0 else self.num_iterations
            slots, attn = self.slot_attention.iterate(k[:, step], v[:, step], slots, iters)
            slot_hist.append(slots)
            attn_hist.append(attn)
            if self.transition is not None:
                # after every frame, the last one included, as the JAX model does
                slots = self.transition(slots)
        return {"slot_history": torch.stack(slot_hist, 1),
                "attn_masks": torch.stack(attn_hist, 1),
                "encoded_img_feats": img_feats.reshape(b, t, *img_feats.shape[1:])}

    def forward(self, x, noise=None, generator: Optional[torch.Generator] = None,
                decode: bool = True, img_feats=None):
        """Video (B, T, H, W, C) -> the JAX ``decompose(x, decode=decode)``
        dict: slot_history, attn_masks, encoded_img_feats and, with
        ``decode``, recons_feats (B, T, P, F), masks (B, T, S, 1, gh, gw) and,
        when the decoder reconstructs images, recons_imgs (B, T, H, W, 3), all
        B * T frames decoded in one call.

        The initial slots come from the slot initializer, with ``noise``
        (B, S, D) when given (``LearnedRandom``: mu + sigma * noise, so their
        gradients reach mu and sigma), else drawn with ``generator``.
        ``img_feats`` as :meth:`decompose` takes them."""
        out = self.decompose(x, initial_slots=self.slot_initializer(x.shape[0], generator,
                                                                    noise=noise),
                             img_feats=img_feats)
        if decode:
            out.update(self.decoded(out["slot_history"]))
        return out

    def decoded(self, slot_history, decode=None) -> dict:
        """recons_feats (B, T, P, F), masks (B, T, S, 1, gh, gw) and, when
        the decoder reconstructs images, recons_imgs (B, T, H, W, 3) of
        slot_history (B, T, S, D), its B * T frames through ``decode``
        (default :meth:`decode`)."""
        b, t = slot_history.shape[:2]
        dec = (decode or self.decode)(slot_history.reshape(b * t, self.num_slots, self.slot_dim))
        out = {k: dec[k].reshape(b, t, *dec[k].shape[1:]) for k in ("recons_feats", "masks")}
        if dec["recons_imgs"] is not None:
            out["recons_imgs"] = dec["recons_imgs"].reshape(b, t, *dec["recons_imgs"].shape[1:])
        return out
