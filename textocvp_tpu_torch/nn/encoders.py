"""Image encoders of the port, the counterparts of the JAX package's
``textocvp_tpu/nn/encoders.py``: the conv stacks (``ConvEncoder``,
``ConvEncoder128``), the ResNet-34 of SAVi++ (``ResNet``) and the frozen
ViTs of :mod:`textocvp_tpu_torch.nn.vit`. NCHW in and out; SAVi permutes
at its boundary.

The convs, GroupNorms and pools run through ``F.conv2d``,
``F.group_norm`` and ``F.max_pool2d``: the JAX package leaves them to XLA,
outside any Pallas kernel.
"""

from __future__ import annotations

from typing import Sequence

import torch.nn.functional as F
from torch import nn

from textocvp_tpu_torch.nn.blocks import ConvBlock, GroupNorm
from textocvp_tpu_torch.nn.precision import Conv2d
from textocvp_tpu_torch.nn.vit import VIT_CONFIGS, ViTEncoder

ENCODERS = [
    "ConvEncoder",
    "ConvEncoder128",
    "ResNet",
    "vit_small_patch16_224_dino",
    "vit_small_patch8_224_dino",
    "vit_base_patch16_224_dino",
    "vit_base_patch8_224_dino",
    "vit_small_patch14_dinov2",
    "vit_base_patch14_dinov2",
]


class SimpleConvEncoder(nn.Module):
    """Stack of k x k conv blocks with ReLU, NCHW. With ``batch_norm`` each
    conv is followed by a BatchNorm; with ``downsample_encoder`` every block
    but the last max-pools by ``downsample`` (window = stride) after it, so
    the output grid is the input's over ``downsample ** (len - 1)``."""

    def __init__(self, in_channels: int = 3, hidden_dims: Sequence[int] = (64, 64, 64, 64),
                 kernel_size: int = 5, stride: int = 1, batch_norm: bool = False,
                 downsample_encoder: bool = False, downsample: int = 2):
        super().__init__()
        dims = [in_channels, *hidden_dims]
        last = len(hidden_dims) - 1
        self.blocks = nn.ModuleList(
            ConvBlock(a, b, kernel_size, stride, batch_norm=batch_norm,
                      max_pool=downsample if downsample_encoder and i < last else None)
            for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])))
        self.out_features = dims[-1]

    def forward(self, x):
        for block in self.blocks:
            x = block(x)
        return x


class ConvEncoder128(nn.Module):
    """Four 5x5 conv blocks of 64 channels for 128 px input: the first at
    stride 2, the last without its ReLU."""

    out_features = 64

    def __init__(self, in_channels: int = 3):
        super().__init__()
        self.blocks = nn.ModuleList(
            ConvBlock(in_channels if i == 0 else 64, 64, 5, stride=2 if i == 0 else 1,
                      activation=i < 3) for i in range(4))

    forward = SimpleConvEncoder.forward


class ResNetBasicBlock(nn.Module):
    """3x3 conv (``stride``) -> GroupNorm -> ReLU -> 3x3 conv -> GroupNorm,
    plus the shortcut, then ReLU. The shortcut is the input, or a 1x1 conv
    (``stride``) and a GroupNorm when the stride or the width changes. No
    conv has a bias.

    The attributes follow flax's automatic names of the JAX block:
    ``conv`` / ``norm`` are ``Conv_0`` / ``GroupNorm_0``, ``conv1`` /
    ``norm1`` the second pair, ``conv2`` / ``norm2`` the shortcut's."""

    def __init__(self, in_channels: int, channels: int, stride: int = 1,
                 num_groups: int = 32):
        super().__init__()
        self.conv = Conv2d(in_channels, channels, 3, stride=stride, padding=1, bias=False)
        self.norm = GroupNorm(num_groups, channels)
        self.conv1 = Conv2d(channels, channels, 3, padding=1, bias=False)
        self.norm1 = GroupNorm(num_groups, channels)
        self.conv2 = self.norm2 = None
        if stride != 1 or in_channels != channels:
            self.conv2 = Conv2d(in_channels, channels, 1, stride=stride, bias=False)
            self.norm2 = GroupNorm(num_groups, channels)

    def forward(self, x):
        y = F.relu(self.norm(self.conv(x)))
        y = self.norm1(self.conv1(y))
        residual = x if self.conv2 is None else self.norm2(self.conv2(x))
        return F.relu(y + residual)


class ResNet34SAVi(nn.Module):
    """ResNet-34 as SAVi++ modifies it: a 7x7 stride-1 stem conv, GroupNorm,
    ReLU and a 3x3 stride-1 max-pool (padding 1), then BasicBlocks [3, 4, 6,
    3] whose stages after the first halve the grid, so the output grid is the
    input's over 8, with 512 channels. GroupNorm everywhere, so ``train()``
    and ``eval()`` compute alike.

    Inside SAVi, ``encoder_params.resolution`` is this output grid (8 x 8
    for 64 px frames), the size of the positional embedding.

    ``conv`` / ``norm`` are the stem's (flax's ``Conv_0`` / ``GroupNorm_0``),
    ``blocks.i`` the JAX ``ResNetBasicBlock_i``."""

    # (channels, blocks, first stride) of each stage
    STAGES = ((64, 3, 1), (128, 4, 2), (256, 6, 2), (512, 3, 2))

    def __init__(self, in_channels: int = 3, num_groups: int = 32):
        super().__init__()
        self.conv = Conv2d(in_channels, 64, 7, padding=3, bias=False)
        self.norm = GroupNorm(num_groups, 64)
        blocks, width = [], 64
        for channels, count, first_stride in self.STAGES:
            for i in range(count):
                blocks.append(ResNetBasicBlock(width, channels, first_stride if i == 0 else 1,
                                               num_groups))
                width = channels
        self.blocks = nn.ModuleList(blocks)
        self.out_features = width

    def forward(self, x):
        x = F.relu(self.norm(self.conv(x)))
        x = F.max_pool2d(x, 3, stride=1, padding=1)
        for block in self.blocks:
            x = block(x)
        return x


def get_encoder(encoder: dict, in_channels: int = 3) -> tuple[nn.Module, int]:
    """(module, width of its output features) of an ``encoder`` config, the
    JAX ``get_encoder``'s names and keys. A ViT needs
    ``encoder_params["img_size"]``; its depth is ``num_blocks`` (or
    ``encoder_num_blocks``) when given, else the config's."""
    name = encoder["encoder_name"]
    params = dict(encoder.get("encoder_params", {}))
    if name not in ENCODERS:
        raise ValueError(f"Unknown encoder_name {name!r}. Use one of {ENCODERS}")
    if name == "ConvEncoder":
        mod = SimpleConvEncoder(
            in_channels=in_channels,
            hidden_dims=tuple(params.get("num_channels", (64, 64, 64, 64))),
            kernel_size=params.get("kernel_size", 5),
            stride=params.get("stride", 1),
            batch_norm=bool(params.get("batch_norm") or False),
            downsample_encoder=bool(params.get("downsample_encoder", False)),
            downsample=params.get("downsample", 2),
        )
        return mod, mod.out_features
    if name == "ConvEncoder128":
        mod = ConvEncoder128(in_channels)
        return mod, mod.out_features
    if name == "ResNet":
        mod = ResNet34SAVi(in_channels, num_groups=params.get("num_groups", 32))
        return mod, mod.out_features
    cfg = VIT_CONFIGS[name]
    img_size = params.get("img_size")
    if img_size is None:
        raise KeyError(f"'img_size' must be provided for ViT encoder {name!r}")
    mod = ViTEncoder(
        img_size=img_size,
        patch_size=cfg["patch_size"],
        embed_dim=cfg["embed_dim"],
        depth=params.get("num_blocks") or params.get("encoder_num_blocks") or cfg["depth"],
        num_heads=cfg["num_heads"],
        layerscale_init=cfg.get("layerscale_init"),
    )
    return mod, cfg["embed_dim"]
