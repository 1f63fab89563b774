"""bf16 training on the CPU, module by module: conv5's bf16 backward (the
plain version of the card's, through ``Conv5Function`` with ``conv5_plain``)
against ``jax.vjp`` of the JAX ``ConvDecoder``'s tail block in bf16 and in
float32, and the slot-attention wrapper's casts carrying gradients.

* conv5: the JAX reference is ``textocvp_tpu.nn.blocks.ConvBlock`` (5 x 5,
  "same", bias, ReLU) with ``dtype`` bf16 and float32 on the same weights,
  input and cotangent; the port's dx, dW and db are each held to
  ``tests/torch_bf16.py``'s rule against their own JAX bf16 and float32
  gradients, and to the contract exactly: each is the float32 gradient of
  the bf16-rounded operands (one mask, the bf16 output's), rounded once.
* Slot attention: the kernel's arm is float32 inside; in bf16 its k, v and
  slots are cast in and the outputs out, and autograd carries the
  gradients through the casts: bf16 gradients equal to the float32
  gradients of the same (rounded) values, rounded once.
* bf16 beside int8 builds the trainer in bf16 (the trainers on a mesh in
  bf16: ``tests/test_torch_port_bf16_mesh.py``).
"""

import torch_cpu_threads  # noqa: F401  (two torch threads a worker)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_train_savi import tiny_savi_params
from torch_bf16 import check_bf16

from textocvp_tpu.nn.blocks import ConvBlock as JaxConvBlock
from textocvp_tpu_torch.core.config import build_exp_params
from textocvp_tpu_torch.core.experiment import Experiment
from textocvp_tpu_torch.nn.precision import set_compute_dtype
from textocvp_tpu_torch.ops import conv5 as c5
from textocvp_tpu_torch.ops.slot_attention import SlotAttention

BF16 = torch.bfloat16


def _jax_conv_grads(x, w, b, g, dtype):
    """(y, dx, dW, db) of the JAX tail block (conv, bias, ReLU) in ``dtype``."""
    block = JaxConvBlock(out_channels=w.shape[-1], kernel_size=5, dtype=dtype)
    params = {"Conv_0": {"kernel": jnp.asarray(w), "bias": jnp.asarray(b)}}

    def f(xx, p):
        return block.apply({"params": p}, xx)

    y, vjp = jax.vjp(f, jnp.asarray(x, dtype), params)
    dx, dp = vjp(jnp.asarray(g, y.dtype))
    return y, dx, dp["Conv_0"]["kernel"], dp["Conv_0"]["bias"]


def _port_conv_grads(x, w, b, g, dtype):
    tx = torch.from_numpy(x).to(dtype).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    tb = torch.from_numpy(b).requires_grad_()
    y = c5.conv5(tx, tw, tb)
    y.backward(torch.from_numpy(g).to(y.dtype))
    return y, tx.grad, tw.grad, tb.grad


def test_conv5_bf16_backward_matches_jax_and_its_contract():
    rng = np.random.default_rng(4)
    n, h, w_, c = 3, 12, 10, 32
    x = (0.5 * rng.standard_normal((n, h, w_, c))).astype(np.float32)
    w = (rng.standard_normal((5, 5, c, c)) / 40).astype(np.float32)
    b = (0.1 * rng.standard_normal((c,))).astype(np.float32)
    g = rng.standard_normal((n, h, w_, c)).astype(np.float32)
    ref = {dt: _jax_conv_grads(x, w, b, g, dt) for dt in (jnp.bfloat16, jnp.float32)}
    before = (c5.conv5_bf16_cuda.launches, c5.conv5_bf16_input_grad_cuda.launches)
    calls = c5.conv5_weight_grad.calls
    out = {dt: _port_conv_grads(x, w, b, g, dt) for dt in (BF16, torch.float32)}
    assert (c5.conv5_bf16_cuda.launches, c5.conv5_bf16_input_grad_cuda.launches) == before
    assert c5.conv5_weight_grad.calls == calls + 1  # the bf16 Function's; float32 is autograd's
    y, dx, dw, db = out[BF16]
    assert (y.dtype, dx.dtype, dw.dtype, db.dtype) == (BF16, BF16, torch.float32, torch.float32)
    for i, what in enumerate(("y", "dx", "dW", "db")):
        check_bf16(out[BF16][i], out[torch.float32][i], ref[jnp.bfloat16][i],
                   ref[jnp.float32][i], what, dtype_checked=i < 2)
    # the contract: float32 sums of exact products, one rounding, the mask of
    # the bf16 output
    xr = torch.from_numpy(x).to(BF16).float().requires_grad_()
    wr = torch.from_numpy(w).to(BF16).float().requires_grad_()
    br = torch.from_numpy(b).requires_grad_()
    gm = torch.where(y > 0, torch.from_numpy(g).to(BF16), 0).float()
    c5.conv5_plain(xr, wr, br, relu=False).backward(gm)
    torch.testing.assert_close(dx, xr.grad.to(BF16), rtol=0, atol=0)
    torch.testing.assert_close(dw, wr.grad.to(BF16).float(), rtol=0, atol=0)
    torch.testing.assert_close(db, br.grad, rtol=0, atol=0)


def test_conv5_bf16_weight_gradient_sums_every_frame_in_float32():
    """One rounding of the whole sum: against the float32 products of the
    same operands rounded once, bit for bit, where per-frame bf16 partial
    sums would be further off."""
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.standard_normal((16, 6, 7, 8)).astype(np.float32)).to(BF16)
    g = torch.from_numpy(rng.standard_normal((16, 6, 7, 4)).astype(np.float32)).to(BF16)
    got = c5.conv5_weight_grad(x, g)
    want = c5.conv5_weight_grad(x.float(), g.float())
    assert got.dtype == BF16 and got.shape == (5, 5, 8, 4)
    torch.testing.assert_close(got, want.to(BF16), rtol=0, atol=0)


def test_slot_attention_casts_carry_bf16_gradients():
    torch.manual_seed(2)
    mod = SlotAttention(16, 16, 3, 32)
    k, v, slots = (torch.randn(2, n, 16) for n in (20, 20, 3))
    grads = {}
    for dt in (BF16, torch.float32):
        set_compute_dtype(mod, dt)
        mod.zero_grad()
        leaves = [t.to(dt).detach().requires_grad_() for t in (k, v, slots)]
        out, attn = mod.iterate(*leaves, num_iters=2)
        assert out.dtype == attn.dtype == dt
        (out.float().square().sum() + attn.float().sum()).backward()
        grads[dt] = [t.grad for t in leaves] + [mod.to_q.weight.grad.clone()]
    # bf16 inputs: the float32 refinement's gradients of the rounded inputs,
    # rounded once to bf16 at the cast
    f32 = [t.to(BF16).float().requires_grad_() for t in (k, v, slots)]
    mod.zero_grad()
    out, attn = mod.iterate(*f32, num_iters=2)
    (out.to(BF16).float().square().sum() + attn.to(BF16).float().sum()).backward()
    for got, want in zip(grads[BF16][:3], f32):
        assert got.dtype == BF16
        torch.testing.assert_close(got, want.grad.to(BF16), rtol=0, atol=0)
    assert grads[BF16][3].dtype == torch.float32 and grads[BF16][3].abs().max() > 0


@pytest.mark.parametrize("key", ["decode_quant", "encode_quant"])
def test_bf16_training_with_int8_builds(key, tmp_path):
    """A bf16 experiment with an int8 option trains in bf16, as the JAX
    trainers do: int8 applies where the experiment is evaluated or served."""
    from textocvp_tpu_torch.train.trainer import DecompTrainer

    params = tiny_savi_params(build_exp_params)
    params["tpu"] = {"compute_dtype": "bfloat16", key: "int8"}
    Experiment(tmp_path).save_params(params)
    tr = DecompTrainer(tmp_path, device="cpu")
    tr.setup_model()
    assert tr.model.compute_dtype == BF16
    assert {p.dtype for p in tr.model.parameters()} == {torch.float32}
