"""
Frozen ViT feature extractor of ExtendedDINOSAUR (counterpart of the JAX
package's ``textocvp_tpu/nn/vit.py``), timm's layout: input NHWC in [0, 1],
output (B, P, embed_dim) patch features.

As the JAX module, and the wrapper it follows:
* the input is normalized with the ImageNet mean as both mean AND std;
* patch embedding is a patch x patch conv of stride patch, no padding;
* the class token is concatenated before ``pos_embed`` (1, P + 1, D) is added;
* pre-norm blocks (LayerNorm eps 1e-6), qkv and proj with bias, exact GELU,
  LayerScale ``ls1_gamma``/``ls2_gamma`` when the config has one;
* blocks are truncated to ``depth``; no final norm; the class token is
  stripped from the output.

In bfloat16 (``tpu.compute_dtype``) the patch embedding, the denses and the
attention run in bf16, the LayerNorms' statistics in float32, and the mean,
the class token, ``pos_embed`` and the LayerScale gammas are cast to bf16 at
the call, as the JAX module casts them.

The attention core is :func:`textocvp_tpu_torch.ops.vit_attention.vit_attention`:
the CUDA kernel for a CUDA tensor, the plain version for a CPU tensor. The
dense layers are plain GEMMs (``F.linear``), as the JAX package leaves them to
XLA, and the patch embedding is ``F.conv2d``. The opt-in int8 encode
(``tpu.encode_quant``, ``models/quant.py``): with ``quant_scales`` (depth, 4)
each block's four denses, in ``ViTBlock.DENSES`` order, run through
``ops/dense_int8.py`` (the JAX ``_dense_int8``, its result cast to the
compute dtype); the attention core stays the float kernel, in bf16 the bf16
one. ``calibrate=True`` returns the denses' input amaxes with the
features.

Under the mesh's ``model`` axis (``parallel/partitioning.py::shard_decomp_``)
each block's ``qkv`` holds this rank's heads of q, k and v, ``proj`` and
``fc2`` are row shards and ``fc1`` a column shard; the attention core runs at
the local head count, and the int8 path and its calibration take the whole
layer's scales (``ops/dense_int8.py``).

:func:`import_timm_state_dict` turns a timm ``VisionTransformer`` state dict
into the JAX package's ViT params tree (numpy, resampling ``pos_embed`` to the
model's grid with :func:`interpolate_pos_embed`), which
``convert.from_jax_params`` carries into this module.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from textocvp_tpu_torch.nn.precision import Conv2d, LayerNorm, Linear, compute_dtype
from textocvp_tpu_torch.ops.dense_int8 import input_amax, linear_int8
from textocvp_tpu_torch.ops.vit_attention import vit_attention

IMAGENET_MEAN = (0.485, 0.456, 0.406)

VIT_CONFIGS = {
    "vit_small_patch16_224_dino": dict(patch_size=16, embed_dim=384, depth=12, num_heads=6),
    "vit_small_patch8_224_dino": dict(patch_size=8, embed_dim=384, depth=12, num_heads=6),
    "vit_base_patch16_224_dino": dict(patch_size=16, embed_dim=768, depth=12, num_heads=12),
    "vit_base_patch8_224_dino": dict(patch_size=8, embed_dim=768, depth=12, num_heads=12),
    "vit_small_patch14_dinov2": dict(
        patch_size=14, embed_dim=384, depth=12, num_heads=6, layerscale_init=1e-5
    ),
    "vit_base_patch14_dinov2": dict(
        patch_size=14, embed_dim=768, depth=12, num_heads=12, layerscale_init=1e-5
    ),
}


class ViTBlock(nn.Module):
    #: the dense layers in execution order: the order of a block's int8
    #: scales and calibration amaxes
    DENSES = ("qkv", "proj", "fc1", "fc2")

    def __init__(self, embed_dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 layerscale_init: Optional[float] = None):
        super().__init__()
        d = embed_dim
        self.num_heads = num_heads  # this rank's heads once sharded (parallel/partitioning.py)
        self.head_dim = d // num_heads
        self.norm1 = LayerNorm(d, eps=1e-6)
        self.qkv = Linear(d, 3 * d)
        self.proj = Linear(d, d)
        self.norm2 = LayerNorm(d, eps=1e-6)
        self.fc1 = Linear(d, int(d * mlp_ratio))
        self.fc2 = Linear(int(d * mlp_ratio), d)
        if layerscale_init is None:
            self.ls1_gamma = self.ls2_gamma = None
        else:
            self.ls1_gamma = nn.Parameter(torch.full((d,), float(layerscale_init)))
            self.ls2_gamma = nn.Parameter(torch.full((d,), float(layerscale_init)))

    def forward(self, x, quant_scales=None, amaxes=None):
        """``quant_scales`` (4,) runs the denses in int8; each dense's input
        amax is appended to ``amaxes`` when given. Under tensor parallelism
        the block holds ``num_heads`` of the heads and its shards of the
        denses; the row layers' sums give every rank the whole output."""
        b, n, _ = x.shape
        h, dh = self.num_heads, self.head_dim
        dt = compute_dtype(self)

        def dense(i, y):
            layer = getattr(self, self.DENSES[i])
            if amaxes is not None:
                amaxes.append(input_amax(layer, y))
            if quant_scales is None:
                return layer(y)
            # float32 out of the int8 dense, cast as the JAX _dense_int8's out_dtype
            return linear_int8(layer, y, quant_scales[i]).to(dt)

        qkv = dense(0, self.norm1(x)).reshape(b, n, 3, h, dh).permute(2, 0, 3, 1, 4)
        q, k, v = (t.contiguous() for t in qkv)  # (b, h, n, dh) each
        y = vit_attention(q, k, v, dh ** -0.5)
        y = dense(1, y.transpose(1, 2).reshape(b, n, h * dh))
        x = x + (y if self.ls1_gamma is None else y * self.ls1_gamma.to(dt))
        y = dense(3, F.gelu(dense(2, self.norm2(x)), approximate="none"))
        return x + (y if self.ls2_gamma is None else y * self.ls2_gamma.to(dt))


class ViTEncoder(nn.Module):
    def __init__(self, img_size: int, patch_size: int, embed_dim: int, depth: int,
                 num_heads: int, mlp_ratio: float = 4.0, layerscale_init: Optional[float] = None):
        super().__init__()
        self.embed_dim = embed_dim
        num_patches = (img_size // patch_size) ** 2
        self.patch_embed = Conv2d(3, embed_dim, patch_size, stride=patch_size)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(torch.randn(1, num_patches + 1, embed_dim) * 0.02)
        self.blocks = nn.ModuleList(
            ViTBlock(embed_dim, num_heads, mlp_ratio, layerscale_init) for _ in range(depth))
        self.register_buffer("mean", torch.tensor(IMAGENET_MEAN), persistent=False)

    def forward(self, x, quant_scales=None, calibrate: bool = False):
        """Frames (N, H, W, 3) in [0, 1] -> patch features (N, P, embed_dim).
        ``quant_scales`` (depth, 4) runs every block's denses in int8;
        ``calibrate`` returns (features, amaxes (depth, 4)) of the float path."""
        dt = compute_dtype(self)
        mean = self.mean.to(dt)  # the JAX ViT's constants in the compute dtype
        x = (x - mean) / mean  # std := mean, the wrapper's quirk
        x = self.patch_embed(x.permute(0, 3, 1, 2)).flatten(2).transpose(1, 2)
        cls = self.cls_token.expand(x.shape[0], 1, self.embed_dim).to(x.dtype)
        x = torch.cat([cls, x], dim=1) + self.pos_embed.to(dt)
        amaxes = [] if calibrate else None
        for i, block in enumerate(self.blocks):
            x = block(x, None if quant_scales is None else quant_scales[i], amaxes)
        if calibrate:
            return x[:, 1:], torch.stack(amaxes).reshape(len(self.blocks), 4)
        return x[:, 1:]


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    """The Keys cubic kernel (a = -0.5) of ``jax.image.resize``, in float32."""
    f = np.float32
    out = ((f(1.5) * x - f(2.5)) * x) * x + f(1.0)
    out = np.where(x >= 1.0, ((f(-0.5) * x + f(2.5)) * x - f(4.0)) * x + f(2.0), out)
    return np.where(x >= 2.0, f(0.0), out).astype(f)


def cubic_resize_weights(size_in: int, size_out: int) -> np.ndarray:
    """(size_in, size_out) float32 weights of ``jax.image.resize(...,
    "bicubic")`` along one axis, bit for bit: half-pixel centres, the Keys
    cubic with a = -0.5 widened by the scale when downsampling (antialias),
    each column normalized to sum 1. ``F.interpolate(mode="bicubic")`` is a
    = -0.75 without antialias, another resample."""
    f = np.float32
    inv_scale = 1.0 / (size_out / size_in)
    sample = (np.arange(size_out, dtype=f) + f(0.5)) * f(inv_scale) - f(0.5)
    x = np.abs(sample[None, :] - np.arange(size_in, dtype=f)[:, None]) / f(max(inv_scale, 1.0))
    w = _keys_cubic(x)
    total = w.sum(0, keepdims=True, dtype=f)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(f).eps),
                 w / np.where(total != 0, total, f(1.0)), f(0.0)).astype(f)
    inside = (sample >= -0.5) & (sample <= size_in - 0.5)
    return np.where(inside[None, :], w, f(0.0))


def interpolate_pos_embed(pos_embed: np.ndarray, new_grid: int) -> np.ndarray:
    """A timm ``pos_embed`` (1, 1 + g*g, D) resampled to a ``new_grid`` square
    grid, the class position kept, as the JAX package resamples it
    (``jax.image.resize``, bicubic). The weights are JAX's bit for bit; the
    separable sums run in float64 and round once, where XLA sums in float32 in
    its own order: the two agree within 2e-6 of the largest input value, and
    this result lies within 2^-23 of it of the exact one."""
    pos_embed = np.asarray(pos_embed)
    cls_pos, patch_pos = pos_embed[:, :1], pos_embed[:, 1:]
    old_grid = int(round(patch_pos.shape[1] ** 0.5))
    if old_grid == new_grid:
        return pos_embed
    d = patch_pos.shape[-1]
    w = cubic_resize_weights(old_grid, new_grid).astype(np.float64)
    grid = patch_pos.reshape(old_grid, old_grid, d).astype(np.float64)
    grid = np.einsum("hwd,hy,wx->yxd", grid, w, w).astype(pos_embed.dtype)
    return np.concatenate([cls_pos, grid.reshape(1, new_grid * new_grid, d)], axis=1)


def import_timm_state_dict(state_dict: dict, grid_size: int, depth: int,
                           layerscale: bool) -> dict:
    """A timm ``VisionTransformer`` state dict (numpy-valued) -> the JAX
    package's ViT params tree for ``depth`` blocks over a ``grid_size`` square
    patch grid: the patch-embed kernel OIHW -> HWIO, Linear weights transposed,
    ``pos_embed`` resampled (:func:`interpolate_pos_embed`), LayerScale
    ``ls1.gamma`` / ``ls2.gamma`` when ``layerscale``. Blocks past ``depth``
    are dropped, as the model truncates them."""
    sd = {k: np.asarray(v) for k, v in state_dict.items()}

    def dense(prefix):
        return {"kernel": sd[f"{prefix}.weight"].T, "bias": sd[f"{prefix}.bias"]}

    def norm(prefix):
        return {"scale": sd[f"{prefix}.weight"], "bias": sd[f"{prefix}.bias"]}

    p = {"patch_embed": {"kernel": sd["patch_embed.proj.weight"].transpose(2, 3, 1, 0),
                         "bias": sd["patch_embed.proj.bias"]},
         "cls_token": sd["cls_token"],
         "pos_embed": interpolate_pos_embed(sd["pos_embed"], grid_size)}
    for i in range(depth):
        pre = f"blocks.{i}."
        blk = {"norm1": norm(pre + "norm1"), "norm2": norm(pre + "norm2"),
               "qkv": dense(pre + "attn.qkv"), "proj": dense(pre + "attn.proj"),
               "fc1": dense(pre + "mlp.fc1"), "fc2": dense(pre + "mlp.fc2")}
        if layerscale:
            blk["ls1_gamma"] = sd[pre + "ls1.gamma"]
            blk["ls2_gamma"] = sd[pre + "ls2.gamma"]
        p[f"block_{i}"] = blk
    return p
