"""
The slot predictors and the autoregressive rollout (counterparts of the JAX
package's ``textocvp_tpu/models/predictors.py``): VanillaTransformer,
OCVPSeq and OCVPPar, which read no text, and TextOCVP with the frozen T5 or
the trained custom transformer text encoder.

Every predictor maps a window of slots (B, T, S, slot_dim), newest frame
last, to the next frame's slots (B, S, slot_dim). The rollout keeps a
zero-padded ring buffer of ``input_buffer_size`` frames; padding frames are
masked out as attention keys, which makes the fixed-shape window equivalent
to a shorter window of only the valid frames. The unconditioned predictors'
sinusoidal PE is not flipped, so they also get the count of padding frames
as ``pe_offset``: the oldest valid frame gets ``pe[0]``.

The T5 text encoder is frozen, as in the JAX package: its parameters do not
require grad, and its output is detached (the JAX ``stop_gradient``). The
custom text encoder trains with the predictor.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from textocvp_tpu_torch.nn.blocks import (
    AdaptedEncoderBlock,
    MultiHeadSelfAttention,
    SlotPositionalEncoding,
    TemporalPositionalEncoding,
    TorchStyleEncoderLayer,
)
from textocvp_tpu_torch.nn.precision import LayerNorm, Linear
from textocvp_tpu_torch.nn.t5 import T5EncoderStack, t5_config
from textocvp_tpu_torch.nn.text_encoders import TransformerTextEncoder

TEXT_ENCODERS = ("t5", "custom_tf")


class _SlotPredictor(nn.Module):
    """mlp_in -> SlotPositionalEncoding -> ``layers`` -> mlp_out on the newest
    frame, plus that frame's slots when ``residual``: the frame of the three
    unconditioned predictors."""

    def __init__(self, slot_dim: int, token_dim: int, residual: bool,
                 input_buffer_size: int, layers):
        super().__init__()
        self.residual = residual
        self.mlp_in = Linear(slot_dim, token_dim)
        self.pe = SlotPositionalEncoding(token_dim, max_len=input_buffer_size)
        self.layers = nn.ModuleList(layers)
        self.mlp_out = Linear(token_dim, slot_dim)

    def run_layers(self, x, mask):
        for layer in self.layers:
            x = layer(x, mask)
        return x

    def forward(self, slots, mask=None, pe_offset: int = 0):
        """slots (B, T, S, D), newest frame last; ``mask`` True = attend, as
        the subclass says; ``pe_offset`` the count of padding frames."""
        x = self.run_layers(self.pe(self.mlp_in(slots), pe_offset), mask)
        out = self.mlp_out(x[:, -1])
        return out + slots[:, -1] if self.residual else out


class VanillaTransformerPredictor(_SlotPredictor):
    """Joint self-attention over all T * S tokens: pre-norm torch-style
    layers. ``mask`` broadcastable to (B, T*S, T*S)."""

    def __init__(self, num_slots: int, slot_dim: int, token_dim: int = 128,
                 hidden_dim: int = 256, num_layers: int = 2, n_heads: int = 4,
                 residual: bool = False, input_buffer_size: int = 5):
        super().__init__(slot_dim, token_dim, residual, input_buffer_size,
                         [TorchStyleEncoderLayer(token_dim, n_heads, hidden_dim)
                          for _ in range(num_layers)])

    def run_layers(self, x, mask):
        b, t, s, d = x.shape
        return super().run_layers(x.reshape(b, t * s, d), mask).reshape(b, t, s, d)


class OCVPSeqLayer(nn.Module):
    """Object attention within each frame, then time attention across the
    frames of each slot. ``time_mask`` broadcastable to (B*S, T, T), True =
    attend; padding frames pass through the object attention and give
    finite values that the time mask then discards."""

    def __init__(self, token_dim: int, hidden_dim: int, n_heads: int):
        super().__init__()
        self.object_block = TorchStyleEncoderLayer(token_dim, n_heads, hidden_dim)
        self.time_block = TorchStyleEncoderLayer(token_dim, n_heads, hidden_dim)

    def forward(self, x, time_mask=None):
        b, t, s, d = x.shape
        y = self.object_block(x.reshape(b * t, s, d))
        y = y.reshape(b, t, s, d).transpose(1, 2).reshape(b * s, t, d)
        y = self.time_block(y, time_mask)
        return y.reshape(b, s, t, d).transpose(1, 2)


class OCVPParLayer(nn.Module):
    """Object and time attention in parallel on one pre-norm input, summed
    into the residual, then a pre-norm relu feed-forward. Biased
    projections, LayerNorms eps 1e-5."""

    def __init__(self, token_dim: int, hidden_dim: int, n_heads: int):
        super().__init__()
        self.norm1 = LayerNorm(token_dim, eps=1e-5)
        self.norm2 = LayerNorm(token_dim, eps=1e-5)
        self.self_attn_obj = MultiHeadSelfAttention(token_dim, n_heads, use_bias=True)
        self.self_attn_time = MultiHeadSelfAttention(token_dim, n_heads, use_bias=True)
        self.linear1 = Linear(token_dim, hidden_dim)
        self.linear2 = Linear(hidden_dim, token_dim)

    def feed_forward(self, x):
        return self.linear2(F.relu(self.linear1(x)))

    def forward(self, x, time_mask=None):
        b, t, s, d = x.shape
        y = self.norm1(x)
        y_obj = self.self_attn_obj(y.reshape(b * t, s, d)).reshape(b, t, s, d)
        y_time = self.self_attn_time(y.transpose(1, 2).reshape(b * s, t, d), time_mask)
        x = x + (y_obj + y_time.reshape(b, s, t, d).transpose(1, 2))
        return x + self.feed_forward(self.norm2(x))


class OCVPSeq(_SlotPredictor):
    """OCVP-Seq: ``num_layers`` OCVPSeqLayers; ``mask`` is their time mask."""

    def __init__(self, num_slots: int, slot_dim: int, token_dim: int = 128,
                 hidden_dim: int = 256, num_layers: int = 2, n_heads: int = 4,
                 residual: bool = False, input_buffer_size: int = 5):
        super().__init__(slot_dim, token_dim, residual, input_buffer_size,
                         [OCVPSeqLayer(token_dim, hidden_dim, n_heads)
                          for _ in range(num_layers)])


class OCVPPar(_SlotPredictor):
    """OCVP-Par: ``num_layers`` OCVPParLayers; ``mask`` is their time mask."""

    def __init__(self, num_slots: int, slot_dim: int, token_dim: int = 128,
                 hidden_dim: int = 256, num_layers: int = 2, n_heads: int = 4,
                 residual: bool = False, input_buffer_size: int = 5):
        super().__init__(slot_dim, token_dim, residual, input_buffer_size,
                         [OCVPParLayer(token_dim, hidden_dim, n_heads)
                          for _ in range(num_layers)])


class TextOCVP(nn.Module):
    """mlp_in -> learned flipped temporal PE -> ``num_layers`` AdaptedEncoderBlocks
    (self-attention over slot tokens + cross-attention to cached text K/V) ->
    mlp_out on the newest frame, plus that frame's slots when ``residual``.
    ``text_encoder_type`` "t5" (frozen) or "custom_tf" (trained)."""

    def __init__(self, num_slots: int, slot_dim: int, token_dim: int = 512, n_heads: int = 8,
                 hidden_dim: int = 2048, num_layers: int = 8, residual: bool = True,
                 input_buffer_size: int = 10, fusion_num_heads: int = 8,
                 fusion_head_dim: int = 64, fusion_mlp_size: int = 2048,
                 text_encoder_type: str = "t5", text_encoder_params: Optional[dict] = None):
        super().__init__()
        self.token_dim = token_dim
        self.residual = residual
        self.mlp_in = Linear(slot_dim, token_dim)
        self.mlp_out = Linear(token_dim, slot_dim)
        self.blocks = nn.ModuleList(
            AdaptedEncoderBlock(token_dim, n_heads, hidden_dim, fusion_num_heads,
                                fusion_head_dim, fusion_mlp_size)
            for _ in range(num_layers))
        self.pe = TemporalPositionalEncoding(token_dim, max_len=input_buffer_size + 1)
        if text_encoder_type not in TEXT_ENCODERS:
            raise ValueError(f"text_encoder_type {text_encoder_type!r}: use one of "
                             f"{TEXT_ENCODERS}")
        self.text_encoder_type = text_encoder_type
        tep = dict(text_encoder_params or {})
        if text_encoder_type == "custom_tf":
            self.text_encoder = TransformerTextEncoder(
                input_dim=tep.get("input_dim", 128), num_layers=tep.get("num_layers", 2),
                num_heads=tep.get("num_heads", 4), output_dim=token_dim,
                vocab_size=tep.get("vocab_size", 50))
        else:
            self.text_encoder = T5EncoderStack(t5_config(tep))
            self.text_encoder.requires_grad_(False)

    def encode_text(self, caption_tokens, caption_lengths=None, attn_masks=None):
        """The caption's embeddings (B, L, D): the frozen T5's, detached, from
        the ids and ``attn_masks``; the custom encoder's from the ids and
        ``caption_lengths``."""
        if caption_tokens is None:
            raise KeyError("'caption_tokens' must be provided for the text encoder")
        if self.text_encoder_type == "t5":
            if attn_masks is None:
                raise KeyError("'attn_masks' must be provided for the T5 text encoder")
            return self.text_encoder(caption_tokens, attention_mask=attn_masks).detach()
        if caption_lengths is None:
            raise KeyError("'caption_lengths' must be provided for the CustomTF encoder")
        return self.text_encoder(caption_tokens, caption_lengths)

    def precompute_text_kv(self, text_embeddings):
        """Per-layer text K/V, computed once per sequence."""
        return [blk.project_text_kv(text_embeddings) for blk in self.blocks]

    def forward(self, slots, text_kv, self_mask=None):
        """slots (B, T, S, D), newest frame last; ``self_mask`` broadcastable to
        (B, T*S, T*S), True = attend. The fusion cross-attention gets no text
        mask: padded caption tokens are attended, as in the JAX model."""
        b, t, s, _ = slots.shape
        x = self.pe(self.mlp_in(slots)).reshape(b, t * s, self.token_dim)
        for blk, kv in zip(self.blocks, text_kv):
            x = blk(x, text_kv=kv, self_mask=self_mask)
        out = self.mlp_out(x.reshape(b, t, s, self.token_dim)[:, -1])
        return out + slots[:, -1] if self.residual else out


class PredictorWrapper(nn.Module):
    """Autoregressive rollout: a text predictor encodes the caption once and
    caches each block's text K/V; then ``num_preds`` predictions over the
    masked ring buffer. Under teacher forcing the true slots
    ``slot_history[:, num_context + i]`` enter the buffer in place of
    prediction ``i``."""

    def __init__(self, predictor: nn.Module, num_context: int = 1, num_preds: int = 9,
                 input_buffer_size: Optional[int] = 10, teacher_force: bool = False):
        super().__init__()
        self.predictor = predictor
        self.num_context = num_context
        self.num_preds = num_preds
        self.teacher_force = teacher_force
        self.buffer_size = input_buffer_size if input_buffer_size else num_context

    def forward(self, slot_history, caption_tokens=None, attn_masks=None,
                num_preds: Optional[int] = None, teacher_force: Optional[bool] = None,
                caption_lengths=None):
        """slot_history (B, T, S, D) -> predicted slots (B, num_preds, S, D);
        T >= num_context, and >= num_context + num_preds under teacher
        forcing (``teacher_force``, else the constructor's). The caption
        (``caption_tokens`` with ``attn_masks`` for T5, ``caption_lengths``
        for the custom encoder) is read by TextOCVP and ignored by the
        predictors without text."""
        num_preds = self.num_preds if num_preds is None else num_preds
        teacher_force = self.teacher_force if teacher_force is None else teacher_force
        if teacher_force and slot_history.shape[1] < self.num_context + num_preds:
            raise ValueError(f"teacher forcing needs {self.num_context + num_preds} frames of "
                             f"slots, got {slot_history.shape[1]}")
        mdl = self.predictor
        text_kv = None
        if isinstance(mdl, TextOCVP):
            text_kv = mdl.precompute_text_kv(mdl.encode_text(
                caption_tokens, caption_lengths=caption_lengths, attn_masks=attn_masks))

        b, _, s, d = slot_history.shape
        L = self.buffer_size
        c = min(self.num_context, L)
        buf = slot_history.new_zeros((b, L, s, d))
        buf[:, L - c:] = slot_history[:, max(0, self.num_context - L): self.num_context]
        cnt = c
        frames = torch.arange(L, device=slot_history.device)
        preds = []
        for i in range(num_preds):
            frame_valid = frames >= L - cnt
            if text_kv is not None:
                cur = mdl(buf, text_kv, self_mask=frame_valid.repeat_interleave(s)[None, None])
            elif isinstance(mdl, VanillaTransformerPredictor):  # keys over the L*S tokens
                cur = mdl(buf, frame_valid.repeat_interleave(s)[None, None], pe_offset=L - cnt)
            else:  # OCVPSeq, OCVPPar: keys over the L frames of a slot
                cur = mdl(buf, frame_valid[None, None], pe_offset=L - cnt)
            nxt = slot_history[:, self.num_context + i] if teacher_force else cur
            buf = torch.cat([buf[:, 1:], nxt[:, None]], dim=1)
            cnt = min(cnt + 1, L)
            preds.append(cur)
        return torch.stack(preds, dim=1)
