"""Image encoder of the port: the stride-1 conv stack (``ConvEncoder``)."""

from __future__ import annotations

from typing import Sequence

from torch import nn

from textocvp_tpu_torch.nn.blocks import ConvBlock


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


def get_encoder(encoder: dict, in_channels: int = 3) -> SimpleConvEncoder:
    name = encoder["encoder_name"]
    params = encoder.get("encoder_params", {})
    if name != "ConvEncoder":
        raise ValueError(f"encoder {name!r} is not ported; the port has 'ConvEncoder'")
    if params.get("batch_norm") or params.get("downsample_encoder"):
        raise ValueError("the port's ConvEncoder has no batch norm and no downsampling")
    return SimpleConvEncoder(
        in_channels=in_channels,
        hidden_dims=tuple(params.get("num_channels", (64, 64, 64, 64))),
        kernel_size=params.get("kernel_size", 5),
        stride=params.get("stride", 1),
    )
