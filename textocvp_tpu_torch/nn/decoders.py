"""
Spatial-broadcast conv decoder (counterpart of ``ConvDecoder`` in the JAX
package's ``textocvp_tpu/nn/decoders.py``), NCHW inside.

``blocks[j]`` is the j-th conv applied; the JAX package names it
``ConvBlock_j`` (``hidden_dims`` is walked from its end), so ``blocks[0]``
maps ``slot_dim`` to ``hidden_dims[-1]`` channels.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from textocvp_tpu_torch.nn.blocks import ConvBlock


class ConvDecoder(nn.Module):
    def __init__(self, in_channels: int, hidden_dims: Sequence[int], kernel_size: int = 5,
                 stride: int = 1, out_channels: int = 4):
        super().__init__()
        chans = [in_channels, *reversed(hidden_dims)]
        self.blocks = nn.ModuleList(
            ConvBlock(a, b, kernel_size, stride) for a, b in zip(chans[:-1], chans[1:]))
        self.final_conv = nn.Conv2d(chans[-1], out_channels, 3, padding=1)
        self.kernel_size = kernel_size
        self.stride = stride

    def _tail(self, x):
        """Blocks after the first, then the final 3x3 conv."""
        for block in self.blocks[1:]:
            x = block(x)
        return self.final_conv(x)

    def forward(self, x):
        return self._tail(self.blocks[0](x))

    def decode_broadcast(self, slots, pos_map, fast: bool = True):
        """``forward(tile(slots) + pos_map)``, NCHW out.

        slots (N, D); pos_map (H, W, D). By linearity of the first conv,
        ``conv(tile(s) + P) = expand(conv(tile_small(s))) + conv(P) - bias``:
        the conv of the spatially constant part runs on a (4 pad + 1)-wide
        tile whose border rows and columns carry every border pattern, and
        the full map takes the tile's border rows/columns and its centre value
        everywhere inside. Exact up to float reassociation. ``fast=False`` (or
        a stride other than 1, or a map smaller than the tile) broadcasts.
        """
        h, w, d = pos_map.shape
        n = slots.shape[0]
        pad = self.kernel_size // 2
        small = 4 * pad + 1
        pos = pos_map.permute(2, 0, 1)[None]  # (1, D, H, W)
        if not fast or self.stride != 1 or h < small or w < small:
            return self(slots[:, :, None, None] + pos)

        conv1 = self.blocks[0].conv
        tile = slots[:, :, None, None].expand(n, d, small, small)
        y_small = conv1(tile)  # bias included
        y_pos = conv1(pos) - conv1.bias[None, :, None, None]

        def idx(full):
            ar = torch.arange(full, device=slots.device)
            return torch.where(ar < pad, ar,
                               torch.where(ar >= full - pad, ar - full + small, 2 * pad))

        expanded = y_small[:, :, idx(h)][:, :, :, idx(w)]
        y1 = expanded + y_pos
        x = F.relu(y1) if self.blocks[0].activation else y1
        return self._tail(x)


def get_decoder(decoder: dict, in_channels: int) -> ConvDecoder:
    name = decoder["decoder_name"]
    params = decoder.get("decoder_params", {})
    if name != "ConvDecoder":
        raise ValueError(f"decoder {name!r} is not ported; the port has 'ConvDecoder'")
    if params.get("batch_norm") or (params.get("upsample") or 1) > 1:
        raise ValueError("the port's ConvDecoder has no batch norm and no upsampling")
    return ConvDecoder(
        in_channels=in_channels,
        hidden_dims=tuple(params["num_channels"]),
        kernel_size=params.get("kernel_size", 5),
        stride=params.get("stride", 1),
    )
