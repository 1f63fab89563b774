"""
Building blocks of the port, each the counterpart of the JAX package's
``textocvp_tpu/nn/blocks.py`` module of the same name.

Conventions:
* ``nn.Linear`` stores ``(out, in)``; the JAX ``Dense`` kernel is ``(in, out)``
  (``textocvp_tpu_torch.convert`` transposes).
* Convolutions run NCHW; the public model functions keep the JAX package's
  NHWC layout.
* Every LayerNorm states its epsilon: torch's default (1e-5) is used by none
  of them.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def build_grid(resolution: Sequence[int], vmin: float = -1.0, vmax: float = 1.0) -> np.ndarray:
    """4-channel coordinate grid (H, W, 4): ``[grid, 1 - grid]``."""
    ranges = [np.linspace(vmin, vmax, num=res) for res in resolution]
    grid = np.meshgrid(*ranges, sparse=False, indexing="ij")
    grid = np.stack(grid, axis=-1).reshape(resolution[0], resolution[1], -1)
    grid = grid.astype(np.float32)
    return np.concatenate([grid, 1.0 - grid], axis=-1)


class MLP(nn.Module):
    """Linear -> ReLU -> ... -> Linear."""

    def __init__(self, in_features: int, features: Sequence[int]):
        super().__init__()
        dims = [in_features, *features]
        self.layers = nn.ModuleList(nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:]))

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x


class ConvBlock(nn.Module):
    """k x k conv, symmetric padding k // 2, then ReLU (NCHW)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, activation: bool = True):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out_channels, kernel_size, stride=stride,
                              padding=kernel_size // 2)
        self.activation = activation

    def forward(self, x):
        x = self.conv(x)
        return F.relu(x) if self.activation else x


class SoftPositionEmbed(nn.Module):
    """Coordinate grid projected to ``hidden_size`` channels and added to NHWC input."""

    def __init__(self, hidden_size: int, resolution: Sequence[int]):
        super().__init__()
        self.projection = nn.Linear(4, hidden_size)
        self.register_buffer("grid", torch.from_numpy(build_grid(resolution)),
                             persistent=False)

    def pos_map(self):
        """The projected positional map (H, W, hidden_size)."""
        return self.projection(self.grid)

    def forward(self, x):
        return x + self.pos_map()[None]


# --------------------------------------------------------------------------- attention


def dot_product_attention(q, k, v, scale: float, mask: Optional[torch.Tensor] = None):
    """q (..., Q, D), k/v (..., K, D); ``mask`` broadcastable to (..., Q, K), True =
    attend. A masked key gets float32's lowest value (not -inf) and the softmax
    runs in float32."""
    dots = torch.matmul(q, k.transpose(-1, -2)) * scale
    if mask is not None:
        dots = dots.masked_fill(~mask, torch.finfo(dots.dtype).min)
    attn = torch.softmax(dots.float(), dim=-1).to(dots.dtype)
    return torch.matmul(attn, v)


def split_heads(x, num_heads: int):
    """(B, N, H*Dh) -> (B, H, N, Dh)."""
    b, n, d = x.shape
    return x.reshape(b, n, num_heads, d // num_heads).transpose(1, 2)


def merge_heads(x):
    """(B, H, N, Dh) -> (B, N, H*Dh)."""
    b, h, n, dh = x.shape
    return x.transpose(1, 2).reshape(b, n, h * dh)


class MultiHeadSelfAttention(nn.Module):
    """Multi-head self-attention, bias-free q/k/v/out projections."""

    def __init__(self, emb_dim: int, num_heads: int = 8):
        super().__init__()
        if emb_dim % num_heads:
            raise ValueError(f"emb_dim {emb_dim} not divisible by {num_heads} heads")
        self.num_heads = num_heads
        self.dim_head = emb_dim // num_heads
        self.q = nn.Linear(emb_dim, emb_dim, bias=False)
        self.k = nn.Linear(emb_dim, emb_dim, bias=False)
        self.v = nn.Linear(emb_dim, emb_dim, bias=False)
        self.out = nn.Linear(emb_dim, emb_dim, bias=False)

    def forward(self, x, mask=None):
        q = split_heads(self.q(x), self.num_heads)
        k = split_heads(self.k(x), self.num_heads)
        v = split_heads(self.v(x), self.num_heads)
        if mask is not None and mask.dim() == 3:  # (B, Q, K) -> (B, 1, Q, K)
            mask = mask[:, None]
        y = dot_product_attention(q, k, v, self.dim_head ** -0.5, mask)
        return self.out(merge_heads(y))


class MultiHeadCrossAttention(nn.Module):
    """Queries attend over features: q/k/v without bias, output with bias. No
    key mask: its one caller, the TextOCVP fusion, attends padded caption
    tokens too, as the JAX model does."""

    def __init__(self, emb_dim: int, dim_head: int, num_heads: int = 8,
                 kv_dim: Optional[int] = None):
        super().__init__()
        inner = dim_head * num_heads
        kv_dim = emb_dim if kv_dim is None else kv_dim
        self.num_heads = num_heads
        self.dim_head = dim_head
        self.q = nn.Linear(emb_dim, inner, bias=False)
        self.k = nn.Linear(kv_dim, inner, bias=False)
        self.v = nn.Linear(kv_dim, inner, bias=False)
        self.out = nn.Linear(inner, emb_dim)

    def attend(self, q, k, v):
        """Attention + output projection of already-projected q/k/v (B, N, H*Dh)."""
        q = split_heads(q, self.num_heads)
        k = split_heads(k, self.num_heads)
        v = split_heads(v, self.num_heads)
        y = dot_product_attention(q, k, v, self.dim_head ** -0.5)
        return self.out(merge_heads(y))

    def project_kv(self, feats):
        return self.k(feats), self.v(feats)


class TransformerBlock(nn.Module):
    """Post-norm transformer encoder block: the SAVi transition."""

    def __init__(self, embed_dim: int, num_heads: int, mlp_size: int):
        super().__init__()
        self.attn = MultiHeadSelfAttention(embed_dim, num_heads)
        self.mlp = MLP(embed_dim, [mlp_size, embed_dim])
        self.ln_query = nn.LayerNorm(embed_dim, eps=1e-6)
        self.ln_mlp = nn.LayerNorm(embed_dim, eps=1e-6)

    def forward(self, x, mask=None):
        y = self.ln_query(self.attn(x, mask) + x)
        return self.ln_mlp(self.mlp(y) + y)


class TransformerDecoderBlock(nn.Module):
    """Cross-attention-only block: LN(q), LN(kv) -> cross-attn -> +res -> LN -> MLP -> +res,
    run with the K/V of :meth:`project_kv` computed once per caption."""

    def __init__(self, embed_dim: int, head_dim: int, kv_dim: int, num_heads: int,
                 mlp_size: int):
        super().__init__()
        self.ln_q = nn.LayerNorm(embed_dim, eps=1e-6)
        self.ln_kv = nn.LayerNorm(kv_dim, eps=1e-6)
        self.ln_mlp = nn.LayerNorm(embed_dim, eps=1e-6)
        self.cross_attn = MultiHeadCrossAttention(embed_dim, head_dim, num_heads, kv_dim)
        self.mlp = MLP(embed_dim, [mlp_size, embed_dim])

    def project_kv(self, feats):
        """Text K/V after the kv LayerNorm; the rollout computes them once."""
        return self.cross_attn.project_kv(self.ln_kv(feats))

    def call_cached(self, queries, k, v):
        """Forward with K/V from :meth:`project_kv`."""
        q = self.cross_attn.q(self.ln_q(queries))
        z = self.cross_attn.attend(q, k, v) + queries
        return self.mlp(self.ln_mlp(z)) + z


class AdaptedEncoderBlock(nn.Module):
    """TextOCVP layer: self-attention over slot tokens, cross-attention to the
    text, then an MLP whose residual is the self-attention output ``y``."""

    def __init__(self, embed_dim: int, num_heads: int, mlp_size: int,
                 fusion_num_heads: int, fusion_head_dim: int, fusion_mlp_size: int):
        super().__init__()
        self.ln_query = nn.LayerNorm(embed_dim, eps=1e-6)
        self.ln_mlp = nn.LayerNorm(embed_dim, eps=1e-6)
        self.attn = MultiHeadSelfAttention(embed_dim, num_heads)
        self.mlp = MLP(embed_dim, [mlp_size, embed_dim])
        self.cross_attention = TransformerDecoderBlock(
            embed_dim, fusion_head_dim, embed_dim, fusion_num_heads, fusion_mlp_size)

    def forward(self, x, text_kv, self_mask=None):
        y = self.attn(self.ln_query(x), self_mask) + x
        z = self.cross_attention.call_cached(y, *text_kv)
        return self.mlp(self.ln_mlp(z)) + y

    def project_text_kv(self, text_embeddings):
        return self.cross_attention.project_kv(text_embeddings)


class TemporalPositionalEncoding(nn.Module):
    """Learned per-timestep PE, flipped: the newest frame (index T-1) gets pe[0]."""

    def __init__(self, d_model: int, max_len: int = 50):
        super().__init__()
        self.pe = nn.Parameter(torch.randn(max_len, d_model) * d_model ** -0.5)

    def forward(self, x):
        t = x.shape[1]
        return x + self.pe[:t].flip(0)[None, :, None, :]
