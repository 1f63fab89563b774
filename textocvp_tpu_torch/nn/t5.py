"""
T5 encoder stack (the frozen "t5-small" text encoder of TextOCVP_T5):
RMSNorm pre-norm without bias, bias-free projections, UNscaled attention with
one relative-position bias owned by layer 0 and reused by every layer, ReLU
feed-forward, final RMSNorm. In bfloat16 (``tpu.compute_dtype``) the
embedding, the relative bias and the denses are bf16, the RMSNorms take
their statistics in float32, and the softmax runs in float32.

:func:`import_hf_t5_encoder` turns a HuggingFace ``T5EncoderModel`` state dict
into the JAX package's T5 params tree, which ``convert.from_jax_params``
carries into :class:`T5EncoderStack`.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from textocvp_tpu_torch.nn.precision import Linear, compute_dtype


@dataclass(frozen=True)
class T5Config:
    vocab_size: int = 32128
    d_model: int = 512
    d_kv: int = 64
    d_ff: int = 2048
    num_layers: int = 6
    num_heads: int = 8
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_epsilon: float = 1e-6


T5_SMALL = T5Config()


def t5_config(text_encoder_params: dict | None) -> T5Config:
    """The T5 of a TextOCVP_T5's ``text_encoder_params``: t5-small, with the
    geometry those params give (tests shrink it)."""
    overrides = {k: v for k, v in (text_encoder_params or {}).items()
                 if k in T5Config.__dataclass_fields__}
    return T5Config(**overrides) if overrides else T5_SMALL


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.eps = eps

    def forward(self, x):
        """Statistics in float32, the output in the compute dtype (JAX ``RMSNorm``)."""
        var = x.float().pow(2).mean(-1, keepdim=True)
        return (x * torch.rsqrt(var + self.eps) * self.weight).to(compute_dtype(self))


def relative_position_bucket(relative_position: torch.Tensor, num_buckets: int = 32,
                             max_distance: int = 128) -> torch.Tensor:
    """Bidirectional T5 bucketing, as the JAX package computes it: the log's
    argument carries ``+ 1e-6`` and the arithmetic is float32. HuggingFace's
    formula has no ``+ 1e-6``; at distance 16 the two truncate to different
    buckets."""
    num_buckets //= 2
    ret = (relative_position > 0).to(torch.int32) * num_buckets
    n = relative_position.abs()
    max_exact = num_buckets // 2
    is_small = n < max_exact
    val_if_large = max_exact + (
        torch.log(n.to(torch.float32) / max_exact + 1e-6)
        / math.log(max_distance / max_exact)
        * (num_buckets - max_exact)
    ).to(torch.int32)
    val_if_large = torch.clamp(val_if_large, max=num_buckets - 1)
    return ret + torch.where(is_small, n.to(torch.int32), val_if_large)


class T5SelfAttention(nn.Module):
    """T5's unscaled self-attention over ``num_heads`` heads; layer 0 owns the
    relative-position bias (its head columns, under tensor parallelism this
    rank's) and hands it to the layers after it."""

    def __init__(self, cfg: T5Config, has_relative_bias: bool = False):
        super().__init__()
        inner = cfg.num_heads * cfg.d_kv
        self.cfg = cfg
        self.num_heads = cfg.num_heads  # this rank's heads under tensor parallelism
        self.q = Linear(cfg.d_model, inner, bias=False)
        self.k = Linear(cfg.d_model, inner, bias=False)
        self.v = Linear(cfg.d_model, inner, bias=False)
        self.o = Linear(inner, cfg.d_model, bias=False)
        self.relative_attention_bias = (
            nn.Embedding(cfg.relative_attention_num_buckets, cfg.num_heads)
            if has_relative_bias else None)

    def position_bias(self, length: int, device) -> torch.Tensor:
        pos = torch.arange(length, device=device)
        rel = pos[None, :] - pos[:, None]  # key - query
        buckets = relative_position_bucket(
            rel, self.cfg.relative_attention_num_buckets,
            self.cfg.relative_attention_max_distance)
        bias = self.relative_attention_bias(buckets.long()).to(compute_dtype(self))
        return bias.permute(2, 0, 1)[None]  # (1, H, Q, K)

    def forward(self, x, mask=None, position_bias=None):
        cfg = self.cfg
        b, length, _ = x.shape
        heads = lambda t: t.reshape(b, length, self.num_heads, cfg.d_kv).transpose(1, 2)
        q, k, v = heads(self.q(x)), heads(self.k(x)), heads(self.v(x))
        scores = torch.matmul(q, k.transpose(-1, -2))  # unscaled
        if self.relative_attention_bias is not None:
            position_bias = self.position_bias(length, x.device)
        if position_bias is not None:
            scores = scores + position_bias
        if mask is not None:  # (B, K), 1 = attend
            keep = mask[:, None, None, :].bool()
            scores = scores.masked_fill(~keep, torch.finfo(scores.dtype).min)
        attn = torch.softmax(scores.float(), dim=-1).to(scores.dtype)
        y = torch.matmul(attn, v).transpose(1, 2).reshape(b, length, -1)
        return self.o(y), position_bias


class T5EncoderLayer(nn.Module):
    def __init__(self, cfg: T5Config, has_relative_bias: bool = False):
        super().__init__()
        self.ln_attn = RMSNorm(cfg.d_model, cfg.layer_norm_epsilon)
        self.attn = T5SelfAttention(cfg, has_relative_bias)
        self.ln_ff = RMSNorm(cfg.d_model, cfg.layer_norm_epsilon)
        self.wi = Linear(cfg.d_model, cfg.d_ff, bias=False)
        self.wo = Linear(cfg.d_ff, cfg.d_model, bias=False)

    def forward(self, x, mask=None, position_bias=None):
        y, position_bias = self.attn(self.ln_attn(x), mask, position_bias)
        x = x + y
        x = x + self.wo(F.relu(self.wi(self.ln_ff(x))))
        return x, position_bias


class T5EncoderStack(nn.Module):
    """Embedding + N encoder layers + final RMSNorm. Inputs: (B, L) token ids and
    an attention mask (B, L) with 1 = real token."""

    def __init__(self, cfg: T5Config = T5_SMALL):
        super().__init__()
        self.shared = nn.Embedding(cfg.vocab_size, cfg.d_model)
        self.layers = nn.ModuleList(T5EncoderLayer(cfg, i == 0) for i in range(cfg.num_layers))
        self.final_ln = RMSNorm(cfg.d_model, cfg.layer_norm_epsilon)

    def forward(self, input_ids, attention_mask=None):
        x = self.shared(input_ids.long()).to(compute_dtype(self))
        position_bias = None
        for layer in self.layers:
            x, position_bias = layer(x, attention_mask, position_bias)
        return self.final_ln(x)


def import_hf_t5_encoder(state_dict: dict, config: T5Config = T5_SMALL) -> dict:
    """A HuggingFace ``T5EncoderModel`` state dict (numpy-valued, keys such as
    ``encoder.block.0.layer.0.SelfAttention.q.weight``) -> the JAX package's
    T5 params tree of ``config.num_layers`` layers: Linear weights transposed,
    the relative-attention table in layer 0, the embedding ``shared.weight``
    or ``encoder.embed_tokens.weight``."""
    sd = {k: np.asarray(v) for k, v in state_dict.items()}

    def get(*names):
        for name in names:
            if name in sd:
                return sd[name]
        raise KeyError(f"none of {names} in the T5 state dict")

    p = {"shared": {"embedding": get("shared.weight", "encoder.embed_tokens.weight")}}
    for i in range(config.num_layers):
        pre = f"encoder.block.{i}.layer"
        attn = {n: {"kernel": get(f"{pre}.0.SelfAttention.{n}.weight").T}
                for n in ("q", "k", "v", "o")}
        if i == 0:
            attn["relative_attention_bias"] = get(
                f"{pre}.0.SelfAttention.relative_attention_bias.weight")
        p[f"layer_{i}"] = {
            "ln_attn": {"weight": get(f"{pre}.0.layer_norm.weight")},
            "ln_ff": {"weight": get(f"{pre}.1.layer_norm.weight")},
            "attn": attn,
            "wi": {"kernel": get(f"{pre}.1.DenseReluDense.wi.weight").T},
            "wo": {"kernel": get(f"{pre}.1.DenseReluDense.wo.weight").T},
        }
    p["final_ln"] = {"weight": get("encoder.final_layer_norm.weight")}
    return p
