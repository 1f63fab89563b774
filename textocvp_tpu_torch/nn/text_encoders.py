"""
The custom transformer text encoder of TextOCVP_CustomTF (counterpart of the
JAX package's ``textocvp_tpu/nn/text_encoders.py::TransformerTextEncoder``).

Token + position embeddings -> LayerNorm (eps 1e-8) -> padding embeddings
zeroed -> post-norm torch-style layers (gelu, tanh approximation) with a
key-padding mask from the caption lengths -> LayerNorm (flax's eps 1e-6) ->
projection to the predictor's token width. No dropout in any mode. It is
trained with the predictor, unlike the frozen T5.

flax's ``nn.Embed`` returns NaN for an id past its table; torch raises, and
on the card as a device-side assert. So ids and caption lengths are checked
before the lookup and a bad one raises ``ValueError``.
"""

from __future__ import annotations

import torch
from torch import nn

from textocvp_tpu_torch.nn.blocks import TorchStyleEncoderLayer
from textocvp_tpu_torch.nn.precision import LayerNorm, Linear, compute_dtype


class TransformerTextEncoder(nn.Module):
    def __init__(self, input_dim: int, num_layers: int, num_heads: int, output_dim: int,
                 vocab_size: int, context_length: int = 50, padding_idx: int = 0):
        super().__init__()
        self.vocab_size = vocab_size
        self.context_length = context_length
        self.padding_idx = padding_idx
        self.token_embedding = nn.Embedding(vocab_size, input_dim)
        self.position_embedding = nn.Embedding(context_length, input_dim)
        self.ln_in = LayerNorm(input_dim, eps=1e-8)
        self.layers = nn.ModuleList(
            TorchStyleEncoderLayer(input_dim, num_heads, input_dim * 4, activation="gelu",
                                   norm_first=False)
            for _ in range(num_layers))
        self.ln_out = LayerNorm(input_dim, eps=1e-6)
        self.out_projection = Linear(input_dim, output_dim)

    def check_ids(self, text):
        """Raise ``ValueError`` for a caption longer than ``context_length`` or
        an id outside ``[0, vocab_size)``: the ids of another tokenizer (T5's
        reach 32,127) or a vocabulary larger than the table. Traced for a
        serving artifact (``serve/export.py``) only the length is checked: the
        ids are data there."""
        if text.shape[1] > self.context_length:
            raise ValueError(
                f"caption of {text.shape[1]} tokens exceeds the text encoder's "
                f"context_length={self.context_length}")
        if torch.compiler.is_compiling():
            return
        lo, hi = (int(v) for v in torch.aminmax(text))
        if lo < 0 or hi >= self.vocab_size:
            raise ValueError(
                f"caption token ids span [{lo}, {hi}], outside the text encoder's "
                f"vocab_size={self.vocab_size}: TextOCVP_CustomTF reads CustomTokenizer ids; "
                "check the dataset's 'tokenizer' in the experiment's config")

    def forward(self, text, text_length):
        """text (B, L) ids, text_length (B,) true lengths -> (B, L, output_dim)."""
        self.check_ids(text)
        b, l = text.shape
        positions = torch.arange(l, device=text.device)
        dt = compute_dtype(self)  # flax's Embed(dtype=...) casts its table
        x = self.ln_in(self.token_embedding(text).to(dt)
                       + self.position_embedding(positions).to(dt)[None])
        x = x * (text != self.padding_idx)[..., None].to(x.dtype)
        keep = (positions[None, :] + 1) <= text_length.to(text.device)[:, None]  # (B, K)
        mask = keep[:, None, :]  # (B, Q=1, K), broadcast over the queries
        for layer in self.layers:
            x = layer(x, mask)
        return self.out_projection(self.ln_out(x))
