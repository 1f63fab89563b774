"""Gradients of the port's two kernels' autograd Functions on the CPU, against
the JAX package.

* ``SlotAttentionFunction``, run with the plain forward, against ``jax.vjp``
  of the JAX ``slot_attention_iterations`` (the Pallas kernel in TPU
  interpret mode, its custom VJP recomputing through the XLA twin), as
  ``tests/test_pallas_kernel.py`` runs it: 1 and 3 iterations, a cotangent on
  the slots, on the attention, or on both. rtol 2e-4 / atol 2e-5, the JAX
  package's own Pallas-vs-XLA gradient tolerance.
* ``Conv5Function``, run with ``conv5_plain`` as its forward and as its
  input-gradient conv, against ``jax.vjp`` of ``bench_pallas_conv.conv5_xla``
  with the ReLU on and off and with a non-contiguous output gradient. rtol
  1e-4 / atol 1e-4: float32, sums over 25 taps and 16 channels (input) or
  all pixels (weight and bias), values of order 1 to 10.
* The pieces on their own: the weight gradient against
  ``torch.nn.grad.conv2d_weight``, the fast decode's gradients against the
  naive broadcast's, the Functions' bookkeeping.
"""

import torch_cpu_threads  # noqa: F401  (two torch threads a worker)
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax.experimental.pallas import tpu as pltpu

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from bench_pallas_conv import conv5_xla  # noqa: E402

from textocvp_tpu.ops.pallas.slot_attention_kernel import (  # noqa: E402
    slot_attention_iterations as jax_slot_attention_iterations,
)
from textocvp_tpu.ops.slot_attention import SlotAttention as JaxSlotAttention  # noqa: E402
from textocvp_tpu_torch.convert import convert_tree  # noqa: E402
from textocvp_tpu_torch.ops import conv5 as c5  # noqa: E402
from textocvp_tpu_torch.ops import slot_attention_kernel as sak  # noqa: E402
from textocvp_tpu_torch.ops.slot_attention import SlotAttention  # noqa: E402

B, N, S, D, MLP = 2, 40, 4, 32, 64
SCALE, EPS = D ** -0.5, 1e-8


@pytest.fixture(scope="module")
def slot_case():
    rng = np.random.default_rng(21)
    jmod = JaxSlotAttention(dim_feats=D, dim_slots=D, num_slots=S, mlp_hidden=MLP)
    inputs = rng.standard_normal((B, N, D)).astype(np.float32)
    slots = rng.standard_normal((B, S, D)).astype(np.float32)
    params = jmod.init(jax.random.PRNGKey(0), jnp.asarray(inputs), jnp.asarray(slots), num_iters=1)
    params = jax.tree_util.tree_map(
        lambda x: np.asarray(x) + 0.1 * rng.standard_normal(np.shape(x)).astype(np.float32),
        jax.device_get(params["params"]))
    tmod = SlotAttention(D, D, S, MLP)
    tmod.load_state_dict(convert_tree(params))
    k = rng.standard_normal((B, N, D)).astype(np.float32)
    v = rng.standard_normal((B, N, D)).astype(np.float32)
    g_slots = rng.standard_normal((B, S, D)).astype(np.float32)
    g_attn = rng.standard_normal((B, S, N)).astype(np.float32)
    return params, tmod, k, v, slots, g_slots, g_attn


@pytest.mark.parametrize("cotangent", ["slots", "attn", "both"])
@pytest.mark.parametrize("num_iters", [1, 3])
def test_slot_attention_function_matches_jax_vjp(slot_case, num_iters, cotangent):
    params, tmod, k, v, slots, g_slots, g_attn = slot_case
    gs = g_slots if cotangent != "attn" else np.zeros_like(g_slots)
    ga = g_attn if cotangent != "slots" else np.zeros_like(g_attn)

    def fused(k_, v_, s_, p_):
        return jax_slot_attention_iterations(k_, v_, s_, num_iters, p_, SCALE, EPS)

    with pltpu.force_tpu_interpret_mode():
        (ref_slots, ref_attn), vjp = jax.vjp(fused, jnp.asarray(k), jnp.asarray(v),
                                             jnp.asarray(slots), params)
        rk, rv, rs, rp = vjp((jnp.asarray(gs), jnp.asarray(ga)))

    tk, tv, ts = (torch.from_numpy(a.copy()).requires_grad_() for a in (k, v, slots))
    p = tmod.iteration_params()
    out, attn = sak.SlotAttentionFunction.apply(
        tk, tv, ts, num_iters, SCALE, EPS, sak.slot_attention_plain,
        *(p[name] for name in sak._PARAM_ORDER))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref_slots), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(attn.detach().numpy(), np.asarray(ref_attn), rtol=1e-4, atol=1e-5)
    outs, grads = [], []
    if cotangent != "attn":
        outs.append(out)
        grads.append(torch.from_numpy(g_slots))
    if cotangent != "slots":
        outs.append(attn)
        grads.append(torch.from_numpy(g_attn))
    names = [n for n, _ in tmod.named_parameters()]
    got = torch.autograd.grad(outs, [tk, tv, ts, *tmod.parameters()], grads, allow_unused=True)
    tol = dict(rtol=2e-4, atol=2e-5)

    def dense(g, like):  # None: the output does not depend on it (v at 1 iteration, attn only)
        return np.zeros(np.shape(like), np.float32) if g is None else g.numpy()

    for g, r, what in zip(got[:3], (rk, rv, rs), "kvs"):
        np.testing.assert_allclose(dense(g, r), np.asarray(r), **tol, err_msg=what)
    ref = convert_tree(jax.device_get(rp))
    for name, g in zip(names, got[3:]):
        if name.startswith(("norm_input", "to_k", "to_v")):  # not in the refinement
            assert g is None, name
            continue
        np.testing.assert_allclose(dense(g, ref[name]), ref[name].numpy(), **tol, err_msg=name)


def test_slot_attention_function_without_cotangents_or_grads_returns_none(slot_case):
    _, tmod, k, v, slots, _, _ = slot_case
    p = {n: t.detach() for n, t in tmod.iteration_params().items()}
    tk = torch.from_numpy(k.copy()).requires_grad_()
    out, attn = sak.SlotAttentionFunction.apply(
        tk, torch.from_numpy(v), torch.from_numpy(slots), 2, SCALE, EPS,
        sak.slot_attention_plain, *(p[name] for name in sak._PARAM_ORDER))
    # only k requires grad, only attn is used
    (gk,) = torch.autograd.grad(attn.sum(), [tk])
    with torch.enable_grad():
        ref = torch.from_numpy(k.copy()).requires_grad_()
        _, ref_attn = sak.slot_attention_plain(ref, torch.from_numpy(v), torch.from_numpy(slots),
                                               p, 2, SCALE, EPS)
        (gref,) = torch.autograd.grad(ref_attn.sum(), [ref])
    torch.testing.assert_close(gk, gref, rtol=0, atol=0)
    assert out.grad_fn is not None


def _conv_case(n=2, h=9, w=11, c=16, seed=0):
    rng = np.random.default_rng(seed)
    x = (0.5 * rng.standard_normal((n, h, w, c))).astype(np.float32)
    wt = (rng.standard_normal((5, 5, c, c)) / np.sqrt(25 * c)).astype(np.float32)
    b = (0.1 * rng.standard_normal((c,))).astype(np.float32)
    g = rng.standard_normal((n, h, w, c)).astype(np.float32)
    return x, wt, b, g


@pytest.mark.parametrize("strided_g", [False, True])
@pytest.mark.parametrize("relu", [True, False])
def test_conv5_function_matches_jax_vjp(relu, strided_g):
    x, wt, b, g = _conv_case()
    y_ref, vjp = jax.vjp(lambda x_, w_, b_: conv5_xla(x_, w_, b_, relu=relu, chunks=1),
                         jnp.asarray(x), jnp.asarray(wt), jnp.asarray(b))
    rx, rw, rb = vjp(jnp.asarray(g))
    tx, tw, tb = (torch.from_numpy(a.copy()).requires_grad_() for a in (x, wt, b))
    y = c5.Conv5Function.apply(tx, tw, tb, relu, c5.conv5_plain, c5.conv5_plain)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_ref), rtol=1e-5, atol=2e-5)
    tg = torch.from_numpy(g.copy())
    if strided_g:  # the NHWC view of an NCHW tensor, as autograd hands it back
        tg = tg.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
        assert not tg.is_contiguous()
    got = torch.autograd.grad(y, (tx, tw, tb), tg)
    for a, r, what in zip(got, (rx, rw, rb), ("x", "w", "b")):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=1e-4, atol=1e-4, err_msg=what)


@pytest.mark.parametrize("n,h,w,cin,cout", [(2, 9, 11, 16, 8), (1, 1, 1, 4, 4), (3, 6, 5, 3, 7)])
def test_conv5_weight_grad_matches_conv2d_weight(n, h, w, cin, cout):
    gen = torch.Generator().manual_seed(n * 100 + h)
    x = torch.randn((n, h, w, cin), generator=gen)
    g = torch.randn((n, h, w, cout), generator=gen)
    got = c5.conv5_weight_grad(x, g)
    ref = torch.nn.grad.conv2d_weight(x.permute(0, 3, 1, 2), (cout, cin, 5, 5),
                                      g.permute(0, 3, 1, 2), padding=2)
    torch.testing.assert_close(got, ref.permute(2, 3, 1, 0), rtol=1e-5, atol=1e-4)


def test_conv5_function_launches_the_input_gradient_conv_only_when_x_needs_it():
    x, wt, b, g = _conv_case(n=1, h=6, w=6, c=4)
    calls = []

    def input_grad_conv(*args):
        calls.append(args[1].shape)
        return c5.conv5_plain(*args)

    tw = torch.from_numpy(wt).requires_grad_()
    y = c5.Conv5Function.apply(torch.from_numpy(x), tw, torch.from_numpy(b), True,
                               c5.conv5_plain, input_grad_conv)
    y.backward(torch.from_numpy(g))
    assert calls == [] and tw.grad is not None
    tx = torch.from_numpy(x.copy()).requires_grad_()
    y = c5.Conv5Function.apply(tx, torch.from_numpy(wt), torch.from_numpy(b), True,
                               c5.conv5_plain, input_grad_conv)
    y.backward(torch.from_numpy(g))
    assert calls == [(5, 5, 4, 4)] and tx.grad is not None


def test_cpu_conv5_has_no_function_in_its_graph():
    """On the CPU ``conv5`` is the plain version, autograd through its ops."""
    x, wt, b, _ = _conv_case(n=1, h=6, w=6, c=4)
    y = c5.conv5(torch.from_numpy(x).requires_grad_(), torch.from_numpy(wt), torch.from_numpy(b))
    assert "Conv5Function" not in type(y.grad_fn).__name__


def test_decode_broadcast_gradients_equal_the_naive_broadcast():
    """The fast decode (the first conv on a tile, gathered to the full map)
    gives the naive broadcast's gradients in every decoder parameter and the
    slots."""
    from textocvp_tpu_torch.models.factory import random_init_
    from textocvp_tpu_torch.nn.decoders import ConvDecoder

    dec = random_init_(ConvDecoder(8, [6, 6, 6]), torch.Generator().manual_seed(3))
    gen = torch.Generator().manual_seed(4)
    slots = torch.randn((5, 8), generator=gen, requires_grad=True)
    pos = torch.randn((12, 12, 8), generator=gen, requires_grad=True)
    grads = []
    for fast in (True, False):
        y = dec.decode_broadcast(slots, pos, fast=fast)
        leaves = [slots, pos, *dec.parameters()]
        grads.append(torch.autograd.grad(y.square().sum(), leaves))
    for a, r in zip(*grads):
        torch.testing.assert_close(a, r, rtol=1e-4, atol=1e-4)


def test_vit_attention_cpu_path_keeps_its_gradient():
    from textocvp_tpu_torch.ops import vit_attention as va

    q = torch.randn((1, 2, 5, 8), requires_grad=True)
    out = va.vit_attention(q, q.detach(), q.detach(), 0.3)
    (g,) = torch.autograd.grad(out.sum(), q)
    ref = F.scaled_dot_product_attention(q, q.detach(), q.detach(), scale=0.3)
    (gr,) = torch.autograd.grad(ref.sum(), q)
    torch.testing.assert_close(g, gr, rtol=1e-5, atol=1e-6)
