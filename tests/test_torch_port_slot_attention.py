"""Slot attention of the PyTorch port against the JAX package on the CPU.

The port's plain version (what a CPU tensor runs) is held against the JAX
``SlotAttention`` XLA path and against the Pallas TPU kernel in interpret
mode, on the same weights (carried by ``convert_tree``) and the same numpy
inputs. Tolerance rtol 1e-4 / atol 1e-5: float32 on both sides, sums taken in
different orders.
"""

import torch_cpu_threads  # noqa: F401  (two torch threads a worker)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from textocvp_tpu.ops.slot_attention import SlotAttention as JaxSlotAttention
from textocvp_tpu_torch.convert import convert_tree
from textocvp_tpu_torch.ops import slot_attention_kernel as sak
from textocvp_tpu_torch.ops.slot_attention import SlotAttention

B, N, S, FEATS, D, MLP = 2, 48, 4, 24, 32, 64
RTOL, ATOL = 1e-4, 1e-5


def _perturb(tree, rng, scale=0.1):
    """Every leaf + small noise, so biases and norm parameters are not trivial."""
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x) + scale * rng.standard_normal(np.shape(x)).astype(np.float32),
        tree)


@pytest.fixture(scope="module")
def models():
    rng = np.random.default_rng(3)
    inputs = rng.standard_normal((B, N, FEATS)).astype(np.float32)
    slots = rng.standard_normal((B, S, D)).astype(np.float32)
    jmod = JaxSlotAttention(dim_feats=FEATS, dim_slots=D, num_slots=S, mlp_hidden=MLP)
    params = jmod.init(jax.random.PRNGKey(0), jnp.asarray(inputs), jnp.asarray(slots), num_iters=1)
    params = {"params": _perturb(jax.device_get(params["params"]), rng)}
    tmod = SlotAttention(FEATS, D, S, MLP)
    tmod.load_state_dict(convert_tree(params["params"]))
    k, v = jmod.apply(params, jnp.asarray(inputs), method=JaxSlotAttention.project_inputs)
    return jmod, params, tmod, inputs, slots, np.array(k), np.array(v)


def test_project_inputs_match(models):
    jmod, params, tmod, inputs, _, k, v = models
    with torch.no_grad():
        tk, tv = tmod.project_inputs(torch.from_numpy(inputs))
    np.testing.assert_allclose(tk.numpy(), k, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tv.numpy(), v, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("num_iters", [1, 3])
@pytest.mark.parametrize("reference", ["xla", "pallas_interpret"])
def test_plain_matches_jax(models, num_iters, reference):
    jmod, params, tmod, _, slots, k, v = models
    args = (jnp.asarray(k), jnp.asarray(v), jnp.asarray(slots), num_iters)
    if reference == "xla":
        ref_slots, ref_attn = jmod.apply(params, *args, method=JaxSlotAttention.iterate)
    else:
        pmod = JaxSlotAttention(dim_feats=FEATS, dim_slots=D, num_slots=S, mlp_hidden=MLP,
                                impl="pallas")
        with pltpu.force_tpu_interpret_mode():
            ref_slots, ref_attn = pmod.apply(params, *args, method=JaxSlotAttention.iterate)
    with torch.no_grad():
        out, attn = tmod.iterate(torch.from_numpy(k), torch.from_numpy(v),
                                 torch.from_numpy(slots), num_iters)
    assert attn.shape == (B, S, N)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_slots), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(attn.numpy(), np.asarray(ref_attn), rtol=RTOL, atol=ATOL)


def test_cpu_tensor_runs_plain_version_without_launching(models):
    _, _, tmod, _, slots, k, v = models
    before = sak.slot_attention_cuda.launches
    with torch.no_grad():
        out, attn = tmod.iterate(torch.from_numpy(k), torch.from_numpy(v),
                                 torch.from_numpy(slots), 2)
        ref, ref_attn = sak.slot_attention_plain(
            torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(slots),
            tmod.iteration_params(), 2, FEATS ** -0.5, 1e-8)
    assert sak.slot_attention_cuda.launches == before
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    torch.testing.assert_close(attn, ref_attn, rtol=0, atol=0)


def test_attention_is_a_softmax_over_slots_plus_eps(models):
    _, _, tmod, _, slots, k, v = models
    with torch.no_grad():
        _, attn = tmod.iterate(torch.from_numpy(k), torch.from_numpy(v),
                               torch.from_numpy(slots), 1)
    np.testing.assert_allclose(attn.sum(1).numpy(), 1 + S * 1e-8, rtol=1e-6)


def test_cuda_wrapper_refuses_cpu_tensors(models, monkeypatch):
    """The CUDA entry point never computes on a CPU tensor: it raises."""
    _, _, tmod, _, slots, k, v = models

    class _Lib:  # stands in for the built library, which needs nvcc
        sa_width = staticmethod(lambda: 128)
        sa_max_slots = staticmethod(lambda: 12)

    monkeypatch.setattr(sak, "load_library", lambda: _Lib)
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA device"):
        sak.slot_attention_cuda(torch.from_numpy(k), torch.from_numpy(v),
                                torch.from_numpy(slots), tmod.iteration_params(), 1, 0.1)
