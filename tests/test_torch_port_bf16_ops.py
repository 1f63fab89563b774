"""``tpu.compute_dtype: "bfloat16"`` of the PyTorch port on the CPU, module by
module: the plain versions of the two bf16 kernels, the slot-attention
wrapper, the blocks and the encoders, each against the JAX package in bf16
and in float32 on the same weights and numpy inputs.

The JAX references are its bf16 Pallas arms in TPU interpret mode: the conv5
kernel ``bench_pallas_conv.conv5_pallas`` with ``pack_conv5_weights(w,
bfloat16)``, the ViT's flash arm, ``SlotAttention(impl="pallas")``. The rule
(``tests/torch_bf16.py``): with e(a, b) = max|a - b| / max|JAX float32|, the
port's bf16 output lies within 2 e(JAX bf16, JAX float32) + 2**-8 of the JAX
bf16 output and within 1.5 e(JAX bf16, JAX float32) + 2**-8 of the JAX float32
one, is bfloat16, and lies more than 1e-4 from the port's own float32 output.
"""

import torch_cpu_threads  # noqa: F401  (two torch threads a worker)
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from test_torch_port_encoders import _jax_variables, _load, _nchw, _nhwc
from torch_bf16 import check_bf16

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from bench_pallas_conv import conv5_pallas, pack_conv5_weights  # noqa: E402

from textocvp_tpu.nn import blocks as jblocks  # noqa: E402
from textocvp_tpu.nn import encoders as jencoders  # noqa: E402
from textocvp_tpu.nn import vit as jax_vit  # noqa: E402
from textocvp_tpu.ops.slot_attention import SlotAttention as JaxSlotAttention  # noqa: E402
from textocvp_tpu_torch.convert import convert_tree  # noqa: E402
from textocvp_tpu_torch.nn import blocks, encoders  # noqa: E402
from textocvp_tpu_torch.nn.precision import set_compute_dtype  # noqa: E402
from textocvp_tpu_torch.ops import conv5 as c5  # noqa: E402
from textocvp_tpu_torch.ops import vit_attention as va  # noqa: E402
from textocvp_tpu_torch.ops.slot_attention import SlotAttention  # noqa: E402

BF16 = torch.bfloat16


def _perturb(tree, rng, scale=0.05):
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x) + scale * rng.standard_normal(np.shape(x)).astype(np.float32),
        tree)


def _bf(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x).to(BF16)


# ------------------------------------------------------------------ the two kernels


@pytest.mark.parametrize("relu", [True, False])
def test_conv5_plain_bf16_matches_the_pallas_kernel_in_bf16(relu):
    rng = np.random.default_rng(3)
    x = (0.5 * rng.standard_normal((2, 64, 64, 64))).astype(np.float32)
    w = (rng.standard_normal((5, 5, 64, 64)) / 40).astype(np.float32)
    b = (0.1 * rng.standard_normal((64,))).astype(np.float32)
    bp = jnp.concatenate([jnp.asarray(b), jnp.asarray(b)]).reshape(1, 128)
    with pltpu.force_tpu_interpret_mode():
        ref = {dt: conv5_pallas(jnp.asarray(x, dt), pack_conv5_weights(w, dt), bp, relu=relu,
                                form="dots15") for dt in (jnp.bfloat16, jnp.float32)}
    tx, tw, tb = torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b)
    before = c5.conv5_bf16_cuda.launches
    out = c5.conv5(tx.to(BF16), tw, tb, relu=relu)
    assert c5.conv5_bf16_cuda.launches == before  # a CPU tensor launches nothing
    check_bf16(out, c5.conv5_plain(tx, tw, tb, relu), ref[jnp.bfloat16], ref[jnp.float32])
    # the contract: float32 sums of exact products, one rounding at the end,
    # which is what the Pallas kernel gives to within one bf16 step
    rounded = c5.conv5_plain(tx.to(BF16).float(), tw.to(BF16).float(), tb, relu)
    torch.testing.assert_close(out, rounded.to(BF16), rtol=0, atol=0)
    step = 2.0 ** -8 * float(np.abs(np.asarray(ref[jnp.float32])).max())
    assert np.abs(out.float().numpy() - np.asarray(ref[jnp.bfloat16]).astype(np.float32)).max() \
        <= step


def test_vit_attention_plain_bf16_matches_the_flash_arm_in_bf16(monkeypatch):
    rng = np.random.default_rng(4)
    b, h, n, dh = 2, 4, 150, 64  # n not a multiple of 128: the flash arm pads and masks
    q, k, v = (rng.standard_normal((b, h, n, dh)).astype(np.float32) for _ in range(3))
    monkeypatch.setattr(jax_vit, "_ATTENTION_IMPL", "flash")
    with pltpu.force_tpu_interpret_mode():
        ref = {dt: jax_vit._attention(*(jnp.asarray(t, dt) for t in (q, k, v)), dh ** -0.5, dt)
               for dt in (jnp.bfloat16, jnp.float32)}
    tq, tk, tv = (torch.from_numpy(t) for t in (q, k, v))
    before = va.vit_attention_bf16_cuda.launches
    out = va.vit_attention(tq.to(BF16), tk.to(BF16), tv.to(BF16), dh ** -0.5)
    assert va.vit_attention_bf16_cuda.launches == before
    check_bf16(out, va.vit_attention_plain(tq, tk, tv, dh ** -0.5), ref[jnp.bfloat16],
               ref[jnp.float32])


def test_slot_attention_wrapper_bf16_matches_the_pallas_arm():
    """The LayerNorm and K/V projection in bf16, then the float32 refinement
    between casts, as ``SlotAttention(impl="pallas")`` runs in bf16."""
    rng = np.random.default_rng(5)
    inputs = rng.standard_normal((2, 48, 24)).astype(np.float32)
    slots = rng.standard_normal((2, 4, 32)).astype(np.float32)
    refs, outs = {}, {}
    for name, jdt, tdt in (("bf16", jnp.bfloat16, BF16), ("f32", jnp.float32, torch.float32)):
        jmod = JaxSlotAttention(dim_feats=24, dim_slots=32, num_slots=4, mlp_hidden=64,
                                impl="pallas", dtype=jdt)
        if name == "bf16":
            params = jmod.init(jax.random.PRNGKey(0), jnp.asarray(inputs), jnp.asarray(slots),
                               num_iters=1)
            params = {"params": _perturb(jax.device_get(params["params"]), rng, 0.1)}
        with pltpu.force_tpu_interpret_mode():
            k, v = jmod.apply(params, jnp.asarray(inputs, jdt),
                              method=JaxSlotAttention.project_inputs)
            refs[name] = (k, *jmod.apply(params, k, v, jnp.asarray(slots, jdt), 3,
                                         method=JaxSlotAttention.iterate))
        tmod = set_compute_dtype(SlotAttention(24, 32, 4, 64), tdt)
        tmod.load_state_dict(convert_tree(params["params"]))
        with torch.no_grad():
            tk, tv = tmod.project_inputs(torch.from_numpy(inputs))
            outs[name] = (tk, *tmod.iterate(tk, tv, torch.from_numpy(slots).to(tdt), 3))
    for i, what in enumerate(("k", "slots", "attn")):
        check_bf16(outs["bf16"][i], outs["f32"][i], refs["bf16"][i], refs["f32"][i], what)


# ------------------------------------------------------------------ blocks


def _block_case(name):
    """(JAX module factory of a dtype, port module, input shape)."""
    if name == "mlp":
        return (lambda dt: jblocks.MLP([32, 16], dtype=dt), blocks.MLP(16, [32, 16]), (2, 5, 16))
    if name == "transformer_block":
        return (lambda dt: jblocks.TransformerBlock(16, 2, 32, pre_norm=False, dtype=dt),
                blocks.TransformerBlock(16, 2, 32), (2, 5, 16))
    norm_first, act = {"torch_style_pre_relu": (True, "relu"),
                       "torch_style_post_gelu": (False, "gelu")}[name]
    return (lambda dt: jblocks.TorchStyleEncoderLayer(16, 2, 32, dropout=0.0, activation=act,
                                                      norm_first=norm_first, dtype=dt),
            blocks.TorchStyleEncoderLayer(16, 2, 32, activation=act, norm_first=norm_first),
            (2, 5, 16))


@pytest.mark.parametrize("name", ["mlp", "transformer_block", "torch_style_pre_relu",
                                  "torch_style_post_gelu"])
def test_block_bf16_matches_jax(name):
    rng = np.random.default_rng(6)
    jmod_of, tmod, shape = _block_case(name)
    x = rng.standard_normal(shape).astype(np.float32)
    params = jmod_of(jnp.float32).init(jax.random.PRNGKey(0), jnp.asarray(x))
    params = {"params": _perturb(jax.device_get(params["params"]), rng)}
    ref = {dt: jax.jit(jmod_of(dt).apply)(params, jnp.asarray(x, dt))
           for dt in (jnp.bfloat16, jnp.float32)}
    tmod.load_state_dict(convert_tree(params["params"]))
    with torch.no_grad():
        f32 = tmod(torch.from_numpy(x))
        out = set_compute_dtype(tmod, BF16)(_bf(x))
    check_bf16(out, f32, ref[jnp.bfloat16], ref[jnp.float32], name)


@pytest.mark.parametrize("offset", [0, 2])
def test_slot_positional_encoding_bf16_matches_jax(offset):
    x = np.random.default_rng(7).standard_normal((2, 4, 3, 16)).astype(np.float32)
    ref = {dt: jblocks.SlotPositionalEncoding(16, max_len=6, dropout=0.0, dtype=dt).apply(
        {}, jnp.asarray(x, dt), offset=offset) for dt in (jnp.bfloat16, jnp.float32)}
    tmod = blocks.SlotPositionalEncoding(16, max_len=6)
    f32 = tmod(torch.from_numpy(x), offset)
    out = set_compute_dtype(tmod, BF16)(_bf(x), offset)
    check_bf16(out, f32, ref[jnp.bfloat16], ref[jnp.float32])


# ------------------------------------------------------------------ encoders


ENCODERS = {
    "resnet": ({"encoder_name": "ResNet", "encoder_params": {"num_groups": 8}}, (2, 16, 16, 3)),
    "conv_encoder128": ({"encoder_name": "ConvEncoder128"}, (2, 32, 32, 3)),
    "bn_downsample": ({"encoder_name": "ConvEncoder",
                       "encoder_params": {"num_channels": [8, 12, 6], "kernel_size": 3,
                                          "batch_norm": True, "downsample_encoder": True,
                                          "downsample": 2}}, (3, 16, 16, 3)),
}


@pytest.mark.parametrize("name", sorted(ENCODERS))
def test_encoder_bf16_matches_jax(name):
    """The other encoders in eval mode (BatchNorm on its running statistics)."""
    cfg, shape = ENCODERS[name]
    rng = np.random.default_rng(8)
    x = rng.uniform(0, 1, shape).astype(np.float32)
    jmod, _ = jencoders.get_encoder(cfg)
    variables = _jax_variables(jmod, x, rng)
    ref = {dt: jax.jit(jencoders.get_encoder(cfg, dtype=dt)[0].apply)(variables, jnp.asarray(x))
           for dt in (jnp.bfloat16, jnp.float32)}
    tmod = _load(encoders.get_encoder(cfg, 3)[0], variables).eval()
    with torch.no_grad():
        f32 = tmod(_nchw(x))
        out = set_compute_dtype(tmod, BF16)(_nchw(x))
    assert out.dtype == BF16
    check_bf16(out.permute(0, 2, 3, 1), torch.from_numpy(_nhwc(f32)), ref[jnp.bfloat16],
               ref[jnp.float32], name)
