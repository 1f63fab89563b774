"""
TextOCVP with the T5 text encoder, and the autoregressive rollout
(counterparts of ``TextOCVP`` and ``PredictorWrapper`` in the JAX package's
``textocvp_tpu/models/predictors.py``).

The rollout keeps a zero-padded ring buffer of ``input_buffer_size`` frames,
newest last; padding frames are masked out as attention keys, which makes the
fixed-shape window equivalent to a shorter window of only the valid frames.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from textocvp_tpu_torch.nn.blocks import AdaptedEncoderBlock, TemporalPositionalEncoding
from textocvp_tpu_torch.nn.t5 import T5_SMALL, T5Config, T5EncoderStack


class TextOCVP(nn.Module):
    """mlp_in -> learned flipped temporal PE -> ``num_layers`` AdaptedEncoderBlocks
    (self-attention over slot tokens + cross-attention to cached text K/V) ->
    mlp_out on the newest frame, plus that frame's slots when ``residual``."""

    def __init__(self, num_slots: int, slot_dim: int, token_dim: int = 512, n_heads: int = 8,
                 hidden_dim: int = 2048, num_layers: int = 8, residual: bool = True,
                 input_buffer_size: int = 10, fusion_num_heads: int = 8,
                 fusion_head_dim: int = 64, fusion_mlp_size: int = 2048,
                 text_encoder_params: Optional[dict] = None):
        super().__init__()
        self.token_dim = token_dim
        self.residual = residual
        self.mlp_in = nn.Linear(slot_dim, token_dim)
        self.mlp_out = nn.Linear(token_dim, slot_dim)
        self.blocks = nn.ModuleList(
            AdaptedEncoderBlock(token_dim, n_heads, hidden_dim, fusion_num_heads,
                                fusion_head_dim, fusion_mlp_size)
            for _ in range(num_layers))
        self.pe = TemporalPositionalEncoding(token_dim, max_len=input_buffer_size + 1)
        # stock configs use t5-small; geometry overrides shrink it for tests
        overrides = {k: v for k, v in (text_encoder_params or {}).items()
                     if k in T5Config.__dataclass_fields__}
        self.text_encoder = T5EncoderStack(T5Config(**overrides) if overrides else T5_SMALL)

    def encode_text(self, caption_tokens, attn_masks):
        return self.text_encoder(caption_tokens, attention_mask=attn_masks)

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
    """Autoregressive rollout: encode the caption once, cache each block's text
    K/V, then ``num_preds`` predictions over the masked ring buffer."""

    def __init__(self, predictor: TextOCVP, num_context: int = 1, num_preds: int = 9,
                 input_buffer_size: Optional[int] = 10):
        super().__init__()
        self.predictor = predictor
        self.num_context = num_context
        self.num_preds = num_preds
        self.buffer_size = input_buffer_size if input_buffer_size else num_context

    def forward(self, slot_history, caption_tokens, attn_masks, num_preds: Optional[int] = None):
        """slot_history (B, T >= num_context, S, D) -> predicted slots (B, num_preds, S, D)."""
        num_preds = self.num_preds if num_preds is None else num_preds
        text_kv = self.predictor.precompute_text_kv(
            self.predictor.encode_text(caption_tokens, attn_masks))

        b, _, s, d = slot_history.shape
        L = self.buffer_size
        c = min(self.num_context, L)
        buf = slot_history.new_zeros((b, L, s, d))
        buf[:, L - c:] = slot_history[:, max(0, self.num_context - L): self.num_context]
        cnt = c
        frames = torch.arange(L, device=slot_history.device)
        preds = []
        for _ in range(num_preds):
            key_mask = (frames >= L - cnt).repeat_interleave(s)[None, None, :]  # (1, 1, L*S)
            cur = self.predictor(buf, text_kv, self_mask=key_mask)
            buf = torch.cat([buf[:, 1:], cur[:, None]], dim=1)
            cnt = min(cnt + 1, L)
            preds.append(cur)
        return torch.stack(preds, dim=1)
