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

The attention core is :func:`textocvp_tpu_torch.ops.vit_attention.vit_attention`:
the CUDA kernel for a CUDA tensor, the plain version for a CPU tensor. The
dense layers are plain GEMMs (``F.linear``), as the JAX package leaves them to
XLA, and the patch embedding is ``F.conv2d``. The JAX package's int8 path and
its timm state-dict import are not ported.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

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
    def __init__(self, embed_dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 layerscale_init: Optional[float] = None):
        super().__init__()
        d = embed_dim
        self.num_heads = num_heads
        self.norm1 = nn.LayerNorm(d, eps=1e-6)
        self.qkv = nn.Linear(d, 3 * d)
        self.proj = nn.Linear(d, d)
        self.norm2 = nn.LayerNorm(d, eps=1e-6)
        self.fc1 = nn.Linear(d, int(d * mlp_ratio))
        self.fc2 = nn.Linear(int(d * mlp_ratio), d)
        if layerscale_init is None:
            self.ls1_gamma = self.ls2_gamma = None
        else:
            self.ls1_gamma = nn.Parameter(torch.full((d,), float(layerscale_init)))
            self.ls2_gamma = nn.Parameter(torch.full((d,), float(layerscale_init)))

    def forward(self, x):
        b, n, d = x.shape
        h = self.num_heads
        qkv = self.qkv(self.norm1(x)).reshape(b, n, 3, h, d // h).permute(2, 0, 3, 1, 4)
        q, k, v = (t.contiguous() for t in qkv)  # (b, h, n, dh) each
        y = vit_attention(q, k, v, (d // h) ** -0.5)
        y = self.proj(y.transpose(1, 2).reshape(b, n, d))
        x = x + (y if self.ls1_gamma is None else y * self.ls1_gamma)
        y = self.fc2(F.gelu(self.fc1(self.norm2(x)), approximate="none"))
        return x + (y if self.ls2_gamma is None else y * self.ls2_gamma)


class ViTEncoder(nn.Module):
    def __init__(self, img_size: int, patch_size: int, embed_dim: int, depth: int,
                 num_heads: int, mlp_ratio: float = 4.0, layerscale_init: Optional[float] = None):
        super().__init__()
        self.embed_dim = embed_dim
        num_patches = (img_size // patch_size) ** 2
        self.patch_embed = nn.Conv2d(3, embed_dim, patch_size, stride=patch_size)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(torch.randn(1, num_patches + 1, embed_dim) * 0.02)
        self.blocks = nn.ModuleList(
            ViTBlock(embed_dim, num_heads, mlp_ratio, layerscale_init) for _ in range(depth))
        self.register_buffer("mean", torch.tensor(IMAGENET_MEAN), persistent=False)

    def forward(self, x):
        """Frames (N, H, W, 3) in [0, 1] -> patch features (N, P, embed_dim)."""
        x = (x - self.mean) / self.mean  # std := mean, the wrapper's quirk
        x = self.patch_embed(x.permute(0, 3, 1, 2)).flatten(2).transpose(1, 2)
        cls = self.cls_token.expand(x.shape[0], 1, self.embed_dim)
        x = torch.cat([cls, x], dim=1) + self.pos_embed
        for block in self.blocks:
            x = block(x)
        return x[:, 1:]
