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
* The compute dtype (``nn/precision.py``, ``tpu.compute_dtype``): the
  denses, convs and LayerNorms are ``nn/precision.py``'s; the BatchNorm and
  GroupNorm normalize in float32 and return the compute dtype; the softmaxes
  run in float32 and cast back; the PE tables are cast to the compute dtype,
  as the JAX blocks do.
"""

from __future__ import annotations

import math
import threading
from contextlib import contextmanager
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from textocvp_tpu_torch.nn.precision import (
    Conv2d,
    ConvTranspose2d,
    LayerNorm,
    Linear,
    compute_dtype,
)


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
        self.layers = nn.ModuleList(Linear(a, b) for a, b in zip(dims[:-1], dims[1:]))

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x


_STATS = threading.local()


@contextmanager
def running_stats_frozen(frozen: bool = True):
    """Inside, with ``frozen``, :class:`BatchNorm` in ``train()`` normalizes
    with the batch's statistics as always but does not move its running ones
    (the trainers' remat recompute: a replayed forward must not apply the
    momentum a second time). Per thread."""
    before = getattr(_STATS, "frozen", False)
    _STATS.frozen = bool(frozen)
    try:
        yield
    finally:
        _STATS.frozen = before


class BatchNorm(nn.BatchNorm2d):
    """flax's ``nn.BatchNorm`` over the channels of NCHW input, eps 1e-5, with
    ``torch.nn.BatchNorm2d``'s parameters and buffers.

    In ``eval()`` it normalizes with its running statistics. In ``train()``
    it normalizes with the batch's mean and biased variance, then moves the
    running statistics as flax does: ``ra = 0.99 * ra + 0.01 * batch``, the
    batch variance the biased ``E[x^2] - E[x]^2`` (``torch.nn.BatchNorm2d``
    moves them by 0.1 with the unbiased variance).

    With ``data_group`` set (``set_batchnorm_group``; data parallelism over
    more than one rank), ``train()`` normalizes with the global batch's
    mean and ``E[x^2] - E[x]^2``, summed over the group by a differentiable
    all-reduce, and moves the running statistics by those, as flax under a
    sharded ``jit`` does. Without it, ``F.batch_norm``. It normalizes in
    float32 and returns the compute dtype, as flax's ``BatchNorm(dtype=...)``."""

    data_group = None

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=1e-5, momentum=0.01)

    def forward(self, x):
        return self._normalize(x.float()).to(compute_dtype(self))

    def _normalize(self, x):
        if not self.training:
            return super().forward(x)
        if self.data_group is not None:
            return self._global_forward(x)
        y = F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)
        if getattr(_STATS, "frozen", False):
            return y
        with torch.no_grad():
            xd = x.detach()
            mean = xd.mean((0, 2, 3))
            var = (xd.square().mean((0, 2, 3)) - mean.square()).clamp_(min=0)
            self.running_mean.mul_(1 - self.momentum).add_(self.momentum * mean)
            self.running_var.mul_(1 - self.momentum).add_(self.momentum * var)
            self.num_batches_tracked.add_(1)
        return y

    def _global_forward(self, x):
        from torch import distributed as dist

        from textocvp_tpu_torch.parallel.mesh import AllReduceSum

        c = x.shape[1]
        count = x.numel() // c * dist.get_world_size(self.data_group)
        sums = AllReduceSum.apply(torch.cat([x.sum((0, 2, 3)), x.square().sum((0, 2, 3))]),
                                  self.data_group)
        mean, mean2 = sums[:c] / count, sums[c:] / count
        var = (mean2 - mean.square()).clamp(min=0)
        scale = torch.rsqrt(var + self.eps) * self.weight
        y = (x - mean[None, :, None, None]) * scale[None, :, None, None] \
            + self.bias[None, :, None, None]
        if not getattr(_STATS, "frozen", False):
            with torch.no_grad():
                self.running_mean.mul_(1 - self.momentum).add_(self.momentum * mean.detach())
                self.running_var.mul_(1 - self.momentum).add_(self.momentum * var.detach())
                self.num_batches_tracked.add_(1)
        return y


def set_batchnorm_group(module: nn.Module, group) -> None:
    """Every :class:`BatchNorm` of ``module`` normalizes over ``group`` in
    ``train()`` (None: over its own batch)."""
    for m in module.modules():
        if isinstance(m, BatchNorm):
            m.data_group = group


class ConvBlock(nn.Module):
    """k x k conv with symmetric padding k // 2 and ``stride``, then
    (BatchNorm), (max-pool) and (ReLU), NCHW, in the JAX ``ConvBlock``'s
    order. The BatchNorm is :class:`BatchNorm`, flax's: running statistics in
    ``eval()``, the batch's in ``train()``. The max-pool's window and stride
    are both ``max_pool``, without padding: a trailing row or column that
    does not fill a window is dropped, as flax's VALID pool does."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, activation: bool = True, batch_norm: bool = False,
                 max_pool: Optional[int] = None):
        super().__init__()
        self.conv = Conv2d(in_channels, out_channels, kernel_size, stride=stride,
                           padding=kernel_size // 2)
        self.bn = BatchNorm(out_channels) if batch_norm else None
        self.max_pool = max_pool or None
        self.activation = activation

    def forward(self, x):
        x = self.conv(x)
        if self.bn is not None:
            x = self.bn(x)
        if self.max_pool:
            x = F.max_pool2d(x, self.max_pool, self.max_pool)
        return F.relu(x) if self.activation else x


class GroupNorm(nn.GroupNorm):
    """flax's ``nn.GroupNorm`` over the channels of NCHW input through
    ``F.group_norm``: epsilon 1e-6 (torch's default is 1e-5), a learned
    scale (``weight``) and bias; in float32, the output in the compute dtype."""

    def __init__(self, num_groups: int, num_channels: int):
        super().__init__(num_groups, num_channels, eps=1e-6)

    def forward(self, x):
        return super().forward(x.float()).to(compute_dtype(self))


def upsample_nearest(x, scale: int):
    """Nearest-neighbour upsampling by an integer factor (NCHW): each pixel
    becomes a scale x scale square."""
    return x if scale == 1 else F.interpolate(x, scale_factor=scale, mode="nearest")


def upsample_nearest_nhwc(x, scale: int):
    """:func:`upsample_nearest` of NHWC input, NHWC and contiguous out."""
    if scale == 1:
        return x
    n, h, w, c = x.shape
    return x[:, :, None, :, None, :].expand(n, h, scale, w, scale, c).reshape(
        n, h * scale, w * scale, c)


def upsample_bilinear(x, out_hw: Sequence[int]):
    """Bilinear resize to ``out_hw`` (NCHW), half-pixel centres
    (``align_corners=False``) and no antialias filter, also when it shrinks."""
    return F.interpolate(x, size=tuple(out_hw), mode="bilinear", align_corners=False,
                         antialias=False)


class ConvTransposeBlock(nn.Module):
    """ConvTranspose (or Conv) -> (BatchNorm) -> (nearest upsample) -> (ReLU),
    NCHW: the JAX ``ConvTransposeBlock``, which no model of either package
    builds.

    The transpose arm is ``nn.ConvTranspose2d(..., padding=k // 2)``, whose
    output is ``(H - 1) * stride + k - 2 * (k // 2)`` wide, as flax's
    ``ConvTranspose`` with explicit padding ``k - 1 - k // 2`` a side. flax
    applies its kernel (k, k, in, out) to the stride-dilated input as a
    plain correlation (``transpose_kernel=False``); torch's transposed conv
    flips its weight in space, so ``conv.weight[i, o, a, b]`` is the flax
    ``kernel[k - 1 - a, k - 1 - b, i, o]``. The conv arm
    (``conv_transpose_2d=False``) is :class:`ConvBlock`'s conv."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, batch_norm: bool = False, upsample: Optional[int] = None,
                 activation: bool = True, conv_transpose_2d: bool = True):
        super().__init__()
        conv = ConvTranspose2d if conv_transpose_2d else Conv2d
        self.conv = conv(in_channels, out_channels, kernel_size, stride=stride,
                         padding=kernel_size // 2)
        self.bn = BatchNorm(out_channels) if batch_norm else None
        self.upsample = upsample or None
        self.activation = activation

    def forward(self, x):
        x = self.conv(x)
        if self.bn is not None:
            x = self.bn(x)
        if self.upsample:
            x = upsample_nearest(x, self.upsample)
        return F.relu(x) if self.activation else x


class SoftPositionEmbed(nn.Module):
    """Coordinate grid projected to ``hidden_size`` channels and added to NHWC input."""

    def __init__(self, hidden_size: int, resolution: Sequence[int]):
        super().__init__()
        self.projection = Linear(4, hidden_size)
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
    """Multi-head self-attention; q/k/v/out projections bias-free unless
    ``use_bias`` (the torch-style layers of the unconditioned predictors and
    the custom text encoder)."""

    def __init__(self, emb_dim: int, num_heads: int = 8, use_bias: bool = False):
        super().__init__()
        if emb_dim % num_heads:
            raise ValueError(f"emb_dim {emb_dim} not divisible by {num_heads} heads")
        self.num_heads = num_heads
        self.dim_head = emb_dim // num_heads
        self.q = Linear(emb_dim, emb_dim, bias=use_bias)
        self.k = Linear(emb_dim, emb_dim, bias=use_bias)
        self.v = Linear(emb_dim, emb_dim, bias=use_bias)
        self.out = Linear(emb_dim, emb_dim, bias=use_bias)

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
        self.q = Linear(emb_dim, inner, bias=False)
        self.k = Linear(kv_dim, inner, bias=False)
        self.v = Linear(kv_dim, inner, bias=False)
        self.out = Linear(inner, emb_dim)

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
        self.ln_query = LayerNorm(embed_dim, eps=1e-6)
        self.ln_mlp = LayerNorm(embed_dim, eps=1e-6)

    def forward(self, x, mask=None):
        y = self.ln_query(self.attn(x, mask) + x)
        return self.ln_mlp(self.mlp(y) + y)


class TransformerDecoderBlock(nn.Module):
    """Cross-attention-only block: LN(q), LN(kv) -> cross-attn -> +res -> LN -> MLP -> +res,
    run with the K/V of :meth:`project_kv` computed once per caption."""

    def __init__(self, embed_dim: int, head_dim: int, kv_dim: int, num_heads: int,
                 mlp_size: int):
        super().__init__()
        self.ln_q = LayerNorm(embed_dim, eps=1e-6)
        self.ln_kv = LayerNorm(kv_dim, eps=1e-6)
        self.ln_mlp = LayerNorm(embed_dim, eps=1e-6)
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
        self.ln_query = LayerNorm(embed_dim, eps=1e-6)
        self.ln_mlp = LayerNorm(embed_dim, eps=1e-6)
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
        return x + self.pe[:t].flip(0).to(compute_dtype(self))[None, :, None, :]


class TorchStyleEncoderLayer(nn.Module):
    """``torch.nn.TransformerEncoderLayer``'s arithmetic with the JAX
    package's leaves: biased ``self_attn``, ``norm1``/``norm2`` (eps 1e-5),
    ``linear1`` -> relu or gelu -> ``linear2``; pre-norm (``norm_first``) or
    post-norm. No dropout in any mode: the JAX callers never turn it on.
    The gelu is flax's, the tanh approximation."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int,
                 activation: str = "relu", norm_first: bool = True):
        super().__init__()
        if activation not in ("relu", "gelu"):
            raise ValueError(f"activation {activation!r}: use relu|gelu")
        self.activation = activation
        self.norm_first = norm_first
        self.self_attn = MultiHeadSelfAttention(d_model, nhead, use_bias=True)
        self.norm1 = LayerNorm(d_model, eps=1e-5)
        self.norm2 = LayerNorm(d_model, eps=1e-5)
        self.linear1 = Linear(d_model, dim_feedforward)
        self.linear2 = Linear(dim_feedforward, d_model)

    def feed_forward(self, x):
        h = self.linear1(x)
        h = F.relu(h) if self.activation == "relu" else F.gelu(h, approximate="tanh")
        return self.linear2(h)

    def forward(self, x, mask=None):
        if self.norm_first:
            x = x + self.self_attn(self.norm1(x), mask)
            return x + self.feed_forward(self.norm2(x))
        x = self.norm1(x + self.self_attn(x, mask))
        return self.norm2(x + self.feed_forward(x))


def sinusoid_table(max_len: int, d_model: int) -> np.ndarray:
    """The standard sinusoidal PE table (max_len, d_model), float32 (copy of
    the JAX package's ``nn/blocks.py::sinusoid_table``)."""
    position = np.arange(max_len, dtype=np.float32)[:, None]
    div_term = np.exp(np.arange(0, d_model, 2, dtype=np.float32)
                      * (-math.log(10000.0) / d_model))
    pe = np.zeros((max_len, d_model), dtype=np.float32)
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term)
    return pe


class SlotPositionalEncoding(nn.Module):
    """Sinusoidal per-frame PE shared by the slots of a frame, not flipped:
    on (B, T, S, D) frame ``i`` gets ``pe[max(i - offset, 0)]``, so with the
    ring buffer's ``offset`` (its count of padding frames) the oldest valid
    frame gets ``pe[0]`` and padding frames ``pe[0]`` too. The table is a
    constant, a non-persistent buffer: the state dict holds none of it."""

    def __init__(self, d_model: int, max_len: int = 50):
        super().__init__()
        self.register_buffer("pe", torch.from_numpy(sinusoid_table(max_len, d_model)),
                             persistent=False)

    def forward(self, x, offset: int = 0):
        idx = (torch.arange(x.shape[1], device=x.device) - offset).clamp(min=0)
        return x + self.pe[idx].to(compute_dtype(self))[None, :, None, :]


class LearnedPositionalEncoding1D(nn.Module):
    """Learned 1D PE on (B, N, D): ``x + pe[offset:offset + N]``, the table
    (max_len, token_dim) drawn from a normal truncated at 2 sigma, as flax's
    ``truncated_normal(stddev=1.0)``. With ``deterministic=False`` and
    ``dropout`` > 0 each element is zeroed with probability ``dropout`` (the
    survivors scaled by 1 / (1 - dropout)), its mask drawn from ``generator``:
    the JAX block's dropout, from another random stream."""

    def __init__(self, max_len: int, token_dim: int, dropout: float = 0.1):
        super().__init__()
        self.dropout = dropout
        self.pe = nn.Parameter(nn.init.trunc_normal_(torch.empty(max_len, token_dim),
                                                     std=1.0, a=-2.0, b=2.0))

    def forward(self, x, offset: int = 0, deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        t = x.shape[1]
        if offset < 0 or offset + t > self.pe.shape[0]:
            raise ValueError(f"positions {offset}..{offset + t - 1} outside the table of "
                             f"{self.pe.shape[0]}")
        x = x + self.pe[offset:offset + t].to(compute_dtype(self))[None]
        if self.dropout > 0 and not deterministic:
            keep = torch.rand(x.shape, generator=generator, device=x.device) >= self.dropout
            x = torch.where(keep, x / (1 - self.dropout), torch.zeros_like(x))
        return x
