"""Image encoders of the port: the stride-1 conv stack (``ConvEncoder``) and
the frozen ViTs of :mod:`textocvp_tpu_torch.nn.vit`."""

from __future__ import annotations

from typing import Sequence

from torch import nn

from textocvp_tpu_torch.nn.blocks import ConvBlock
from textocvp_tpu_torch.nn.vit import VIT_CONFIGS, ViTEncoder


class SimpleConvEncoder(nn.Module):
    """Stack of same-resolution k x k conv blocks with ReLU, NCHW."""

    def __init__(self, in_channels: int = 3, hidden_dims: Sequence[int] = (64, 64, 64, 64),
                 kernel_size: int = 5, stride: int = 1):
        super().__init__()
        dims = [in_channels, *hidden_dims]
        self.blocks = nn.ModuleList(
            ConvBlock(a, b, kernel_size, stride) for a, b in zip(dims[:-1], dims[1:]))
        self.out_features = dims[-1]

    def forward(self, x):
        for block in self.blocks:
            x = block(x)
        return x


def get_encoder(encoder: dict, in_channels: int = 3) -> tuple[nn.Module, int]:
    """(module, width of its output features). A ViT needs
    ``encoder_params["img_size"]``; its depth is ``encoder_num_blocks`` (or
    ``num_blocks``) when given, else the config's."""
    name = encoder["encoder_name"]
    params = encoder.get("encoder_params", {})
    if name in VIT_CONFIGS:
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
    if name != "ConvEncoder":
        raise ValueError(f"encoder {name!r} is not ported; the port has 'ConvEncoder' "
                         f"and {sorted(VIT_CONFIGS)}")
    if params.get("batch_norm") or params.get("downsample_encoder"):
        raise ValueError("the port's ConvEncoder has no batch norm and no downsampling")
    mod = SimpleConvEncoder(
        in_channels=in_channels,
        hidden_dims=tuple(params.get("num_channels", (64, 64, 64, 64))),
        kernel_size=params.get("kernel_size", 5),
        stride=params.get("stride", 1),
    )
    return mod, mod.out_features
