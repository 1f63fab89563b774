"""
Decoders of the port (counterparts of ``ConvDecoder`` and ``MLPPatchDecoder``
in the JAX package's ``textocvp_tpu/nn/decoders.py``). NCHW inside, but
for the ``ConvDecoder`` tail, which runs NHWC.

``ConvDecoder``: ``blocks[j]`` is the j-th conv applied; the JAX package
names it ``ConvBlock_j`` (``hidden_dims`` is walked from its end), so
``blocks[0]`` maps ``slot_dim`` to ``hidden_dims[-1]`` channels.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from textocvp_tpu_torch.nn.blocks import ConvBlock, upsample_bilinear, upsample_nearest
from textocvp_tpu_torch.ops.conv5 import KERNEL_SIZE, conv5


class ConvDecoder(nn.Module):
    """Spatial-broadcast conv decoder. ``blocks[0]`` and ``final_conv`` run
    through ``F.conv2d`` (the JAX package computes both outside any Pallas
    kernel); the tail blocks, 5x5 stride-1 convs with bias and ReLU, run
    through :func:`ops.conv5.conv5` in NHWC memory: the CUDA kernel on the
    card (its gradient through ``ops.conv5.Conv5Function``), its plain
    version on the CPU. Their weights are held in HWIO, converted once per
    weight version and device when nothing needs their gradient."""

    def __init__(self, in_channels: int, hidden_dims: Sequence[int], kernel_size: int = 5,
                 stride: int = 1, out_channels: int = 4):
        super().__init__()
        if len(hidden_dims) > 1 and (kernel_size != KERNEL_SIZE or stride != 1):
            raise ValueError(f"the port's ConvDecoder runs its tail through the 5x5 stride-1 "
                             f"conv kernel; got kernel_size={kernel_size}, stride={stride}")
        chans = [in_channels, *reversed(hidden_dims)]
        self.blocks = nn.ModuleList(
            ConvBlock(a, b, kernel_size, stride) for a, b in zip(chans[:-1], chans[1:]))
        self.final_conv = nn.Conv2d(chans[-1], out_channels, 3, padding=1)
        self.kernel_size = kernel_size
        self.stride = stride
        self._hwio = (None, None)  # (key, [(w, b), ...]) of the tail blocks

    def _tail_weights(self):
        """(HWIO weight, bias) of each tail block, detached; converted again
        only when a parameter changed (load_state_dict) or moved (``to``)."""
        convs = [block.conv for block in self.blocks[1:]]
        key = tuple((c.weight.data_ptr(), c.weight._version, c.bias.data_ptr(), c.bias._version)
                    for c in convs)
        if self._hwio[0] != key:
            with torch.no_grad():
                weights = [(c.weight.detach().permute(2, 3, 1, 0).contiguous(),
                            c.bias.detach().contiguous()) for c in convs]
            self._hwio = (key, weights)
        return self._hwio[1]

    def _tail(self, x):
        """NHWC activations after ``blocks[0]`` -> the tail blocks through
        conv5 -> the final 3x3 conv; NCHW-shaped out (channels_last memory).
        With grad enabled and a tail parameter that requires grad, the HWIO
        weights are converted at this call with their autograd history, so
        the tail's gradients reach its parameters."""
        convs = [block.conv for block in self.blocks[1:]]
        if torch.is_grad_enabled() and any(p.requires_grad for c in convs for p in c.parameters()):
            weights = [(c.weight.permute(2, 3, 1, 0).contiguous(), c.bias) for c in convs]
        else:
            weights = self._tail_weights()
        for block, (w, b) in zip(self.blocks[1:], weights):
            x = conv5(x, w, b, relu=block.activation)
        return self.final_conv(x.permute(0, 3, 1, 2))

    def forward(self, x):
        y = self.blocks[0](x.contiguous(memory_format=torch.channels_last))
        return self._tail(y.permute(0, 2, 3, 1).contiguous())

    def decode_broadcast(self, slots, pos_map, fast: bool = True):
        """``forward(tile(slots) + pos_map)``, NCHW-shaped out.

        slots (N, D); pos_map (H, W, D). By linearity of the first conv,
        ``conv(tile(s) + P) = expand(conv(tile_small(s))) + conv(P) - bias``:
        the conv of the spatially constant part runs on a (4 pad + 1)-wide
        tile whose border rows and columns carry every border pattern, and
        the full map takes the tile's border rows/columns and its centre value
        everywhere inside. Exact up to float reassociation. The expanded map
        is written NHWC, the tail's layout, with no further copy. ``fast=False``
        (or a stride other than 1, or a map smaller than the tile) broadcasts.
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
        y_small = conv1(tile).permute(0, 2, 3, 1).contiguous()  # (N, small, small, C), bias in
        y_pos = (conv1(pos) - conv1.bias[None, :, None, None]).permute(0, 2, 3, 1)

        def idx(full):
            ar = torch.arange(full, device=slots.device)
            return torch.where(ar < pad, ar,
                               torch.where(ar >= full - pad, ar - full + small, 2 * pad))

        x = y_small[:, idx(h)[:, None], idx(w)[None, :]]  # (N, H, W, C)
        x.add_(y_pos)
        if self.blocks[0].activation:
            x.relu_()
        return self._tail(x)


class MLPPatchDecoder(nn.Module):
    """Spatial-broadcast MLP patch decoder of ExtendedDINOSAUR.

    Each slot is broadcast over the P patches and ``pos_embed`` (1, 1, P,
    in_dim) is added, then the optional LayerNorm (eps 1e-6) and
    ``num_layers`` denses, ReLU between them. The last dense gives per-slot
    features and one alpha logit; a float32 softmax of alpha over the slots
    mixes the features. With ``reconstruct_images`` a CNN head turns the mixed
    (gh, gw) feature grid into an image: 3x3 conv + BatchNorm + ReLU blocks,
    each followed by a x2 nearest upsample while :meth:`cnn_plan` says so,
    then a 3x3 conv to RGB and a bilinear resize to ``img_size``.

    The plain order of operations. The JAX package's serving-time
    reformulations (``fused_slot_mix``, ``subpixel_upconv3x3``) are exact up
    to summation order and are not ported.
    """

    def __init__(self, num_patches: int, in_dim: int, hidden_dim: int, out_dim: int,
                 num_layers: int = 4, initial_layer_norm: bool = False,
                 reconstruct_images: bool = False, patch_size: Optional[int] = None,
                 img_size: Optional[int] = None, num_layers_cnn: Optional[int] = None):
        super().__init__()
        self.hidden_dim = hidden_dim
        self.patch_size = patch_size
        self.img_size = img_size
        self.num_layers_cnn = num_layers_cnn
        self.grid = int(num_patches ** 0.5)
        self.pos_embed = nn.Parameter(torch.randn(1, 1, num_patches, in_dim) / in_dim ** 0.5)
        self.initial_ln = nn.LayerNorm(in_dim, eps=1e-6) if initial_layer_norm else None
        dims = [in_dim] + [hidden_dim] * (num_layers - 1) + [out_dim]
        self.mlps = nn.ModuleList(nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:]))
        self.cnns = self.cnn_final = None
        if reconstruct_images:
            chans = [out_dim - 1] + [c for c, _ in self.cnn_plan()]
            self.cnns = nn.ModuleList(ConvBlock(a, b, 3, batch_norm=True)
                                      for a, b in zip(chans[:-1], chans[1:]))
            self.cnn_final = nn.Conv2d(chans[-1], 3, 3, padding=1)

    def cnn_plan(self):
        """(out_channels, upsample after) of each CNN-head block: x2 while the
        grid is below ``img_size`` and (i + 1) * 2 < patch_size, the channels
        halving at every upsampling block after the first."""
        plan, hidden, current = [], self.hidden_dim, self.grid
        for i in range(self.num_layers_cnn):
            grow = (i + 1) * 2 < self.patch_size and current < self.img_size
            if i > 0 and grow:
                hidden //= 2
            plan.append((hidden, grow))
            if grow:
                current *= 2
        return plan

    def forward(self, slots):
        """slots (B, S, in_dim) -> dict of recons_feats (B, P, out_dim - 1),
        masks (B, S, 1, gh, gw) and recons_imgs (B, H, W, 3) or None."""
        out = self.mix(slots)
        return {"recons_imgs": self.render(out["recons_feats"]), **out}

    def mix(self, slots):
        """The per-frame part: slots (B, S, in_dim) -> dict of recons_feats
        (B, P, out_dim - 1) and masks (B, S, 1, gh, gw)."""
        b, s, _ = slots.shape
        x = slots[:, :, None, :] + self.pos_embed
        if self.initial_ln is not None:
            x = self.initial_ln(x)
        for i, dense in enumerate(self.mlps):
            x = dense(x)
            if i < len(self.mlps) - 1:
                x = F.relu(x)
        feats, alpha = x[..., :-1], x[..., -1:]
        alpha = torch.softmax(alpha.float(), dim=1).to(x.dtype)
        return {"recons_feats": (feats * alpha).sum(1),
                "masks": alpha.reshape(b, s, 1, self.grid, self.grid)}

    def render(self, recons_feats):
        """The CNN head, whose BatchNorm normalizes over all B frames:
        recons_feats (B, P, out_dim - 1) -> recons_imgs (B, H, W, 3), or None
        without ``reconstruct_images``."""
        if self.cnns is None:
            return None
        y = recons_feats
        for stage in self.render_stages():
            y = stage(y)
        return y

    def render_stages(self) -> list:
        """The CNN head as a chain of functions, cut after each block's ReLU
        and before its upsampling (the smallest activation between blocks):
        recons_feats to the grid and block 0; each later block with the
        upsampling before it; the last upsampling, the final conv and the
        resize, NHWC out. :meth:`render` composes them."""
        plan = self.cnn_plan()

        def stage(i):
            def run(y):
                if i == 0:
                    y = y.transpose(1, 2).reshape(y.shape[0], -1, self.grid, self.grid)
                elif plan[i - 1][1]:
                    y = upsample_nearest(y, 2)
                if i < len(self.cnns):
                    return self.cnns[i](y)
                y = self.cnn_final(y)
                if y.shape[-1] != self.img_size:
                    y = upsample_bilinear(y, (self.img_size, self.img_size))
                return y.permute(0, 2, 3, 1)
            return run

        return [stage(i) for i in range(len(self.cnns) + 1)]


def get_decoder(decoder: dict, in_channels: int):
    name = decoder["decoder_name"]
    params = decoder.get("decoder_params", {})
    if name == "MLPPatchDecoder":
        return MLPPatchDecoder(
            num_patches=params["num_patches"],
            in_dim=params["in_dim"],
            hidden_dim=params["hidden_dim"],
            out_dim=params["out_dim"],
            num_layers=params.get("num_layers", 4),
            initial_layer_norm=params.get("initial_layer_norm", False),
            reconstruct_images=params.get("reconstruct_images", False),
            patch_size=params.get("patch_size"),
            img_size=params.get("img_size"),
            num_layers_cnn=params.get("num_layers_cnn"),
        )
    if name != "ConvDecoder":
        raise ValueError(f"decoder {name!r} is not ported; the port has 'ConvDecoder' "
                         "and 'MLPPatchDecoder'")
    if params.get("batch_norm") or (params.get("upsample") or 1) > 1:
        raise ValueError("the port's ConvDecoder has no batch norm and no upsampling")
    return ConvDecoder(
        in_channels=in_channels,
        hidden_dims=tuple(params["num_channels"]),
        kernel_size=params.get("kernel_size", 5),
        stride=params.get("stride", 1),
    )
