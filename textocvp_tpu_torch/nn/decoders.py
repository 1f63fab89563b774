"""
Decoders of the port (counterparts of ``ConvDecoder`` and ``MLPPatchDecoder``
in the JAX package's ``textocvp_tpu/nn/decoders.py``). NCHW inside, but
for the ``ConvDecoder`` tail, which runs NHWC.

``ConvDecoder``: ``blocks[j]`` is the j-th conv applied; the JAX package
names it ``ConvBlock_j`` (``hidden_dims`` is walked from its end), so
``blocks[0]`` maps ``slot_dim`` to ``hidden_dims[-1]`` channels.

The opt-in int8 decode (``tpu.decode_quant``, ``models/quant.py``): with
``quant_scales`` (one calibrated activation scale a quantized layer) the
ConvDecoder's tail convs before the final one, and the MLP patch decoder's
denses and BatchNorm-folded CNN-head convs, run in int8
(``ops/conv_int8.py``, ``ops/dense_int8.py``), weights quantized per output
channel at each call from the float weights, as the JAX package does. Those
layers return float32 in either compute dtype, as the JAX ``_quantize_conv``
and ``_quantize_dense`` do; the patch decoder casts its last dense's output
to the compute dtype, and the final conv runs in it. ``calibrate=True``
returns the (L,) input amaxes of those layers on the compute dtype's path
instead (in bf16 through conv5's bf16 variant).

In bfloat16 (``tpu.compute_dtype``) every conv and dense runs in bf16 (the
ConvDecoder's stock tail through conv5's bf16 variant: bf16 operands, float32
accumulation, the float32 bias, one rounding), the BatchNorms and the
softmaxes over slots in float32, cast back.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from textocvp_tpu_torch.nn.blocks import (
    ConvBlock,
    upsample_bilinear,
    upsample_nearest,
    upsample_nearest_nhwc,
)
from textocvp_tpu_torch.nn.precision import Conv2d, LayerNorm, Linear, compute_dtype
from textocvp_tpu_torch.ops.conv5 import CHANNELS, KERNEL_SIZE, conv5
from textocvp_tpu_torch.ops.conv_int8 import quantized_conv
from textocvp_tpu_torch.ops.dense_int8 import input_amax, linear_int8


def check_quant_scales(quant_scales, expected: int, needs: str):
    """The JAX package's check of a calibrated scale vector's length:
    ``needs`` says what this decoder has."""
    if quant_scales.shape[0] != expected:
        raise ValueError(f"quant_scales has {quant_scales.shape[0]} entries but this {needs} "
                         "— recalibrate for this decoder config")


class ConvDecoder(nn.Module):
    """Spatial-broadcast conv decoder. ``blocks[0]`` and ``final_conv`` run
    through ``F.conv2d`` (the JAX package computes both outside any Pallas
    kernel). A tail block of the stock shape, a 5x5 stride-1 64 -> 64 conv
    with bias (the Pallas kernel's contract, ``bench_pallas_conv.py``), runs
    through :func:`ops.conv5.conv5` in NHWC memory: the CUDA kernel on the
    card (its gradient through ``ops.conv5.Conv5Function``), its plain
    version on the CPU. Its weights are held in HWIO, converted once per
    weight version and device when nothing needs their gradient. Any other
    tail block (another kernel size, stride or width, which the JAX package
    computes in XLA) runs as ``blocks[0]`` does, through
    ``nn/precision.py::Conv2d``, its gradient autograd's; each block is
    routed by its own shape, the same on every device.

    With ``batch_norm`` every block's conv is followed by a :class:`BatchNorm`
    (a tail conv then runs without its ReLU, and the BatchNorm and the ReLU
    follow it, as the JAX block orders them; no BatchNorm is folded into a
    conv). With ``upsample`` >= 2 the map is upsampled (nearest) by that
    factor after block j for every j < len(hidden_dims) - 1, so the output
    grid is the positional map's times ``upsample ** (len - 1)``."""

    def __init__(self, in_channels: int, hidden_dims: Sequence[int], kernel_size: int = 5,
                 stride: int = 1, out_channels: int = 4, batch_norm: bool = False,
                 upsample: Optional[int] = None):
        super().__init__()
        chans = [in_channels, *reversed(hidden_dims)]
        self.blocks = nn.ModuleList(
            ConvBlock(a, b, kernel_size, stride, batch_norm=batch_norm)
            for a, b in zip(chans[:-1], chans[1:]))
        self.final_conv = Conv2d(chans[-1], out_channels, 3, padding=1)
        self.kernel_size = kernel_size
        self.stride = stride
        self.batch_norm = bool(batch_norm)
        self.upsample = upsample if upsample and upsample >= 2 else None
        # which tail blocks run through conv5: the kernel's shape only
        self.on_conv5 = [kernel_size == KERNEL_SIZE and stride == 1 and a == b == CHANNELS
                         for a, b in zip(chans[1:-1], chans[2:])]
        self._hwio = (None, None)  # (key, [(w, b), ...]) of the tail blocks

    def _tail_weights(self):
        """(HWIO weight, bias) of each tail block, detached; converted again
        only when a parameter changed (load_state_dict) or moved (``to``)."""
        convs = [block.conv for block in self.blocks[1:]]
        if torch.compiler.is_compiling():
            # traced (torch.export): the conversion goes into the graph
            return [(c.weight.permute(2, 3, 1, 0).contiguous(), c.bias) for c in convs]
        key = tuple((c.weight.data_ptr(), c.weight._version, c.bias.data_ptr(), c.bias._version)
                    for c in convs)
        if self._hwio[0] != key:
            with torch.no_grad():
                weights = [(c.weight.detach().permute(2, 3, 1, 0).contiguous(),
                            c.bias.detach().contiguous()) for c in convs]
            self._hwio = (key, weights)
        return self._hwio[1]

    def _upsampled(self, x, j: int):
        """NHWC ``x`` after block ``j``, upsampled when ``upsample`` says so."""
        if self.upsample is not None and len(self.blocks) - 1 - j > 0:
            return upsample_nearest_nhwc(x, self.upsample)
        return x

    def _conv(self, j: int, x, w, b, relu: bool):
        """Tail block ``j``'s conv (+ ReLU) on NHWC ``x``: through conv5 for
        the stock shape, else through the block's ``Conv2d``; NHWC out."""
        if self.on_conv5[j - 1]:
            return conv5(x.contiguous(), w, b, relu=relu)
        y = self.blocks[j].conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        return F.relu(y) if relu else y

    def _tail(self, x, quant_scales=None):
        """NHWC activations after ``blocks[0]`` -> the tail blocks (through
        the int8 conv with ``quant_scales``), each followed by its BatchNorm
        and ReLU and the upsampling -> the final 3x3 conv; NCHW-shaped out
        (channels_last memory). With grad enabled and a tail parameter that
        requires grad, the conv5 blocks' HWIO weights are converted at this
        call with their autograd history, so the tail's gradients reach its
        parameters."""
        convs = [block.conv for block in self.blocks[1:]]
        if torch.is_grad_enabled() and any(p.requires_grad for c in convs for p in c.parameters()):
            weights = [(c.weight.permute(2, 3, 1, 0).contiguous(), c.bias) if stock
                       else (None, None) for c, stock in zip(convs, self.on_conv5)]
        else:
            weights = self._tail_weights()
        x = self._upsampled(x, 0)
        for j, (block, (w, b)) in enumerate(zip(self.blocks[1:], weights), start=1):
            relu = block.activation and block.bn is None
            if quant_scales is None:
                x = self._conv(j, x, w, b, relu)
            else:
                x = quantized_conv(x, w, b, quant_scales[j - 1], relu=relu)
            if block.bn is not None:
                x = block.bn(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
                x = (F.relu(x) if block.activation else x).contiguous()
            x = self._upsampled(x, j)
        return self.final_conv(x.permute(0, 3, 1, 2))

    def _tail_amaxes(self, x):
        """The (L,) input amaxes of the tail convs before the final one, on
        the compute dtype's path (the JAX ``_tail_amaxes``)."""
        amaxes = []
        x = self._upsampled(x, 0)
        for j, (block, (w, b)) in enumerate(zip(self.blocks[1:], self._tail_weights()), start=1):
            amaxes.append(x.abs().amax().float())
            x = self._upsampled(self._conv(j, x, w, b, block.activation), j)
        return torch.stack(amaxes)

    def forward(self, x):
        y = self.blocks[0](x.contiguous(memory_format=torch.channels_last))
        return self._tail(y.permute(0, 2, 3, 1).contiguous())

    def decode_broadcast(self, slots, pos_map, fast: bool = True, quant_scales=None,
                         calibrate: bool = False):
        """``forward(tile(slots) + pos_map)``, NCHW-shaped out.

        slots (N, D); pos_map (H, W, D). By linearity of the first conv,
        ``conv(tile(s) + P) = expand(conv(tile_small(s))) + conv(P) - bias``:
        the conv of the spatially constant part runs on a (4 pad + 1)-wide
        tile whose border rows and columns carry every border pattern, and
        the full map takes the tile's border rows/columns and its centre value
        everywhere inside. Exact up to float reassociation. The expanded map
        is written NHWC, the tail's layout, with no further copy. It
        broadcasts instead where the JAX package does: with ``batch_norm``, a
        stride other than 1 or a map smaller than the tile; and with
        ``fast=False``.

        ``quant_scales`` ((L,), L the tail convs before the final one) runs
        those convs in int8; ``calibrate`` returns their input amaxes. Both
        need the fast path, as in the JAX package.
        """
        h, w, d = pos_map.shape
        n = slots.shape[0]
        pad = self.kernel_size // 2
        small = 4 * pad + 1
        pos = pos_map.permute(2, 0, 1)[None]  # (1, D, H, W)
        if not fast or self.stride != 1 or self.batch_norm or h < small or w < small:
            if quant_scales is not None or calibrate:
                raise ValueError(
                    "int8 decode quantization requires the fast-broadcast decode structure "
                    f"(stride 1, no batch norm, resolution >= {small}px); this decoder falls "
                    "back to the generic path. Unset tpu.decode_quant for this experiment.")
            return self(slots[:, :, None, None] + pos)

        conv1 = self.blocks[0].conv
        tile = slots[:, :, None, None].expand(n, d, small, small)
        y_small = conv1(tile).permute(0, 2, 3, 1).contiguous()  # (N, small, small, C), bias in
        y_pos = conv1(pos)
        y_pos = (y_pos - conv1.bias.to(y_pos.dtype)[None, :, None, None]).permute(0, 2, 3, 1)

        def idx(full):
            ar = torch.arange(full, device=slots.device)
            return torch.where(ar < pad, ar,
                               torch.where(ar >= full - pad, ar - full + small, 2 * pad))

        if y_small.dtype != torch.float32 and y_small.requires_grad and torch.is_grad_enabled():
            # the gather's backward sums every interior pixel's gradient into
            # the tile's centre: in float32, rounded once at the cast, as the
            # JAX expand's broadcast reduces it, not in bf16 adds
            x = y_small.float()[:, idx(h)[:, None], idx(w)[None, :]].to(y_small.dtype)
        else:
            x = y_small[:, idx(h)[:, None], idx(w)[None, :]]  # (N, H, W, C)
        x.add_(y_pos)
        if self.blocks[0].activation:
            x.relu_()
        if calibrate:
            return self._tail_amaxes(x)
        if quant_scales is not None:
            check_quant_scales(quant_scales, len(self.blocks) - 1,
                               f"ConvDecoder has {len(self.blocks) - 1} hidden tail convs")
        return self._tail(x, quant_scales)


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

    Under the mesh's ``model`` axis (``parallel/partitioning.py::
    shard_decomp_``) the denses alternate column and row shards, the hidden
    width split between each pair; the LayerNorm, the softmax mix and the
    CNN head with its BatchNorm stay whole.
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
        self.initial_ln = LayerNorm(in_dim, eps=1e-6) if initial_layer_norm else None
        dims = [in_dim] + [hidden_dim] * (num_layers - 1) + [out_dim]
        self.mlps = nn.ModuleList(Linear(a, b) for a, b in zip(dims[:-1], dims[1:]))
        self.cnns = self.cnn_final = None
        if reconstruct_images:
            chans = [out_dim - 1] + [c for c, _ in self.cnn_plan()]
            self.cnns = nn.ModuleList(ConvBlock(a, b, 3, batch_norm=True)
                                      for a, b in zip(chans[:-1], chans[1:]))
            self.cnn_final = Conv2d(chans[-1], 3, 3, padding=1)

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

    def num_quant_layers(self) -> int:
        """The layers of the int8 decode: the denses, then the CNN-head blocks."""
        return len(self.mlps) + (len(self.cnns) if self.cnns is not None else 0)

    def forward(self, slots, quant_scales=None, calibrate: bool = False):
        """slots (B, S, in_dim) -> dict of recons_feats (B, P, out_dim - 1),
        masks (B, S, 1, gh, gw) and recons_imgs (B, H, W, 3) or None.

        ``quant_scales`` ((L,), :meth:`num_quant_layers`) runs the denses and
        the BatchNorm-folded CNN-head convs in int8 (running statistics); the
        final RGB conv stays float32. ``calibrate`` returns the (L,) input
        amaxes of those layers on the float path instead."""
        n_mlp = len(self.mlps)
        if quant_scales is not None:
            cnn = self.num_quant_layers() - n_mlp
            check_quant_scales(quant_scales, self.num_quant_layers(),
                               f"MLPPatchDecoder needs {self.num_quant_layers()} "
                               f"({n_mlp} MLP + {cnn} CNN)")
        amaxes = [] if calibrate else None
        out = self.mix(slots, None if quant_scales is None else quant_scales[:n_mlp], amaxes)
        if quant_scales is not None:
            return {"recons_imgs": self.render_int8(out["recons_feats"], quant_scales[n_mlp:]),
                    **out}
        if calibrate:
            if self.cnns is not None:
                self.render(out["recons_feats"], amaxes)
            return torch.stack(amaxes)
        return {"recons_imgs": self.render(out["recons_feats"]), **out}

    def mix(self, slots, quant_scales=None, amaxes=None):
        """The per-frame part: slots (B, S, in_dim) -> dict of recons_feats
        (B, P, out_dim - 1) and masks (B, S, 1, gh, gw). The denses in int8
        with ``quant_scales``; each dense's input amax appended to ``amaxes``
        when given."""
        b, s, _ = slots.shape
        x = slots[:, :, None, :] + self.pos_embed.to(compute_dtype(self))
        if self.initial_ln is not None:
            x = self.initial_ln(x)
        for i, dense in enumerate(self.mlps):
            if amaxes is not None:
                amaxes.append(input_amax(dense, x))
            if quant_scales is None:
                x = dense(x)
            else:
                x = linear_int8(dense, x, quant_scales[i])
            if i < len(self.mlps) - 1:
                x = F.relu(x)
        x = x.to(compute_dtype(self))  # an int8 dense's float32, as the JAX decoder casts it
        feats, alpha = x[..., :-1], x[..., -1:]
        alpha = torch.softmax(alpha.float(), dim=1).to(x.dtype)
        return {"recons_feats": (feats * alpha).sum(1),
                "masks": alpha.reshape(b, s, 1, self.grid, self.grid)}

    def render(self, recons_feats, amaxes=None):
        """The CNN head, whose BatchNorm normalizes over all B frames:
        recons_feats (B, P, out_dim - 1) -> recons_imgs (B, H, W, 3), or None
        without ``reconstruct_images``. Each block's input amax appended to
        ``amaxes`` when given."""
        if self.cnns is None:
            return None
        y = recons_feats
        for i, stage in enumerate(self.render_stages()):
            if amaxes is not None and i < len(self.cnns):
                # block i's input: the grid, or the last block's upsampled output
                # (the upsampling copies values, so the amax is before it)
                amaxes.append(y.abs().amax().float())
            y = stage(y)
        return y

    def render_int8(self, recons_feats, quant_scales):
        """The CNN head of the int8 decode, NHWC: each block's conv with its
        BatchNorm folded into the conv's affine (``fold_bn``) through the
        int8 conv with its ReLU, the x2 upsamplings of :meth:`cnn_plan`, then
        the float32 final conv and the resize -> recons_imgs (B, H, W, 3)."""
        if self.cnns is None:
            return None
        x = recons_feats.reshape(recons_feats.shape[0], self.grid, self.grid, -1)
        for block, (_, grow), a_scale in zip(self.cnns, self.cnn_plan(), quant_scales):
            w, b = fold_bn(block)
            x = quantized_conv(x, w, b, a_scale, relu=True)
            if grow:
                x = upsample_nearest(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)
        y = self.cnn_final(x.permute(0, 3, 1, 2))
        if y.shape[-1] != self.img_size:
            y = upsample_bilinear(y, (self.img_size, self.img_size))
        return y.permute(0, 2, 3, 1)

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


def fold_bn(block: ConvBlock):
    """A ConvBlock's conv and its BatchNorm's running statistics folded into
    one affine, exact given the statistics (the JAX ``_fold_bn``): HWIO
    kernel * s and (bias - mean) * s + beta, s = gamma / sqrt(var + eps)."""
    bn = block.bn
    s = bn.weight.float() / torch.sqrt(bn.running_var.float() + bn.eps)
    kernel = block.conv.weight.float().permute(2, 3, 1, 0) * s
    bias = (block.conv.bias.float() - bn.running_mean.float()) * s + bn.bias.float()
    return kernel, bias


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
    return ConvDecoder(
        in_channels=in_channels,
        hidden_dims=tuple(params["num_channels"]),
        kernel_size=params.get("kernel_size", 5),
        stride=params.get("stride", 1),
        batch_norm=bool(params.get("batch_norm") or False),
        upsample=params.get("upsample"),
    )
