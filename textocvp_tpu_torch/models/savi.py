"""
SAVi video decomposition (counterpart of the JAX package's
``textocvp_tpu/models/savi.py``). Video is NHWC, (B, T, H, W, C) in [0, 1],
at the public functions; the conv stacks run NCHW.

The encoder, positional embedding, LN+MLP and K/V projection run once over
all B*T frames; only the slot recurrence walks the frames.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from textocvp_tpu_torch.nn.blocks import MLP, SoftPositionEmbed, TransformerBlock
from textocvp_tpu_torch.nn.decoders import get_decoder
from textocvp_tpu_torch.nn.encoders import get_encoder
from textocvp_tpu_torch.nn.initializers import get_initializer
from textocvp_tpu_torch.ops.slot_attention import SlotAttention


def get_transition_module(model_name: Optional[str], slot_dim: int, **kwargs):
    """None -> identity, 'TransformerBlock' -> post-norm transformer block."""
    if model_name in (None, ""):
        return None
    if model_name == "TransformerBlock":
        return TransformerBlock(slot_dim, kwargs.get("num_heads", 4), kwargs.get("mlp_size", 512))
    raise ValueError(f"{model_name!r} is not a recognized transition module")


class SAVi(nn.Module):
    def __init__(self, num_slots: int, slot_dim: int, encoder: dict, decoder: dict,
                 num_iterations: int = 1, num_iterations_first: int = 3,
                 in_channels: int = 3, mlp_hidden: int = 128, mlp_encoder_dim: int = 128,
                 initializer: str = "LearnedRandom", transition_module: Optional[dict] = None):
        super().__init__()
        self.num_slots = num_slots
        self.slot_dim = slot_dim
        self.num_iterations = num_iterations
        self.num_iterations_first = num_iterations_first
        self.in_channels = in_channels

        self.slot_initializer = get_initializer(initializer, slot_dim, num_slots)
        tm = dict(transition_module or {})
        self.transition = get_transition_module(tm.pop("model_name", None), slot_dim, **tm)
        self.image_encoder, feats = get_encoder(encoder, in_channels)
        self.encoder_pos_embedding = SoftPositionEmbed(
            feats, tuple(encoder["encoder_params"]["resolution"]))
        self.encoder_ln = nn.LayerNorm(feats, eps=1e-6)  # flax's default epsilon
        self.encoder_mlp = MLP(feats, [mlp_encoder_dim, mlp_encoder_dim])
        self.decoder_pos_embedding = SoftPositionEmbed(
            slot_dim, tuple(decoder["decoder_params"]["resolution"]))
        self.image_decoder = get_decoder(decoder, slot_dim)
        self.slot_attention = SlotAttention(mlp_encoder_dim, slot_dim, num_slots, mlp_hidden)

    def encode(self, x):
        """Frames (N, H, W, C) -> features (N, H*W, mlp_encoder_dim)."""
        x = self.image_encoder(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        x = self.encoder_pos_embedding(x)
        n, h, w, f = x.shape
        return self.encoder_mlp(self.encoder_ln(x.reshape(n, h * w, f)))

    def decode(self, slots, fast: bool = True):
        """Slots (N, S, D) -> dict of recons_imgs (N, H, W, C), recons
        (N, S, H, W, C) and masks (N, S, H, W, 1); the softmax over slots runs
        in float32. ``fast=False`` runs the naive broadcast, the reference the
        tests hold the fast path against."""
        n, s, d = slots.shape
        y = self.image_decoder.decode_broadcast(
            slots.reshape(n * s, d), self.decoder_pos_embedding.pos_map(), fast=fast)
        y = y.permute(0, 2, 3, 1)
        y = y.reshape(n, s, *y.shape[1:])
        recons, logits = y[..., : self.in_channels], y[..., self.in_channels:]
        masks = torch.softmax(logits.float(), dim=1).to(y.dtype)
        return {"recons_imgs": (recons * masks).sum(1), "recons": recons, "masks": masks}

    def decompose(self, x, initial_slots=None, generator: Optional[torch.Generator] = None):
        """Video (B, T, H, W, C) -> dict of slot_history (B, T, S, D) and
        attn_masks (B, T, S, H*W) (the JAX ``decompose(..., decode=False)``).

        The initial slots are ``initial_slots`` when given, else drawn by the
        slot initializer with ``generator``.
        """
        b, t = x.shape[:2]
        feats = self.encode(x.reshape(b * t, *x.shape[2:]))
        k, v = self.slot_attention.project_inputs(feats)
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
        return {"slot_history": torch.stack(slot_hist, 1), "attn_masks": torch.stack(attn_hist, 1)}

    def forward(self, x, noise=None, generator: Optional[torch.Generator] = None,
                decode: bool = True):
        """Video (B, T, H, W, C) -> the JAX ``decompose(x, decode=decode)``
        dict: slot_history, attn_masks and, with ``decode``, recons_imgs
        (B, T, H, W, C), recons_objs (B, T, S, H, W, C) and masks
        (B, T, S, H, W, 1), all B * T frames decoded in one call.

        The initial slots come from the slot initializer, with ``noise``
        (B, S, D) when given (``LearnedRandom``: mu + sigma * noise, so their
        gradients reach mu and sigma), else drawn with ``generator``."""
        out = self.decompose(x, initial_slots=self.slot_initializer(x.shape[0], generator,
                                                                    noise=noise))
        if decode:
            out.update(self.decoded(out["slot_history"]))
        return out

    def decoded(self, slot_history, decode=None) -> dict:
        """recons_imgs (B, T, H, W, C), recons_objs (B, T, S, H, W, C) and
        masks (B, T, S, H, W, 1) of slot_history (B, T, S, D), its B * T
        frames through ``decode`` (default :meth:`decode`), which decodes
        each frame apart."""
        b, t = slot_history.shape[:2]
        dec = (decode or self.decode)(slot_history.reshape(b * t, self.num_slots, self.slot_dim))
        h, w = dec["recons_imgs"].shape[1:3]
        return {"recons_imgs": dec["recons_imgs"].reshape(b, t, h, w, self.in_channels),
                "recons_objs": dec["recons"].reshape(b, t, self.num_slots, h, w,
                                                     self.in_channels),
                "masks": dec["masks"].reshape(b, t, self.num_slots, h, w, 1)}
