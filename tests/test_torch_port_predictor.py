"""T5 text encoder and the TextOCVP rollout of the PyTorch port against the
JAX package on the CPU, at a small size (2-layer T5 of width 64, 2-layer
TextOCVP of width 64, 3 predictions over a buffer of 4 frames).

Weights: the JAX init plus noise, carried by ``from_jax_params``. Tolerances:
rtol 1e-4 / atol 1e-5 for one pass; the rollout feeds each prediction back as
input, so float32 rounding differences compound over the steps and its
tolerance is rtol 1e-3 / atol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from textocvp_tpu.core.config import add_predictor_params as jax_add_predictor_params
from textocvp_tpu.core.config import build_exp_params as jax_build_exp_params
from textocvp_tpu.models import setup_predictor as jax_setup_predictor
from textocvp_tpu.nn.blocks import AdaptedEncoderBlock as JaxAdaptedEncoderBlock
from textocvp_tpu.nn.t5 import T5Config as JaxT5Config
from textocvp_tpu.nn.t5 import T5EncoderStack as JaxT5EncoderStack
from textocvp_tpu.nn.t5 import relative_position_bucket as jax_bucket
from textocvp_tpu_torch.convert import convert_tree, from_jax_params
from textocvp_tpu_torch.core.config import add_predictor_params, build_exp_params
from textocvp_tpu_torch.models import setup_predictor
from textocvp_tpu_torch.nn.blocks import AdaptedEncoderBlock
from textocvp_tpu_torch.nn.t5 import T5Config, T5EncoderStack, relative_position_bucket

RTOL, ATOL = 1e-4, 1e-5
T5_TINY = dict(vocab_size=512, d_model=64, d_kv=16, num_heads=4, d_ff=128, num_layers=2)
B, S, D, L, NUM_PREDS = 2, 4, 32, 4, 3


def _perturb(tree, rng, scale=0.05):
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x) + scale * rng.standard_normal(np.shape(x)).astype(np.float32),
        tree)


def tiny_predictor_params(build, add, num_context=1):
    p = add(build("SAVi", "CATER_Easy"), "TextOCVP_T5")
    p["model"]["model_params"].update(num_slots=S, slot_dim=D)
    pp = p["predictor"]["predictor_params"]
    pp["predictor_params"].update(token_dim=64, n_heads=4, hidden_dim=128, num_layers=2)
    pp["fusion_params"].update(num_heads=4, head_dim=16, mlp_size=128)
    pp["text_encoder_params"] = dict(T5_TINY)
    p["prediction_params"].update(num_context=num_context, num_preds=NUM_PREDS,
                                  input_buffer_size=L)
    return p


def test_relative_position_bucket_matches_jax_at_every_distance():
    rel = np.arange(-200, 201, dtype=np.int32)
    ref = np.asarray(jax_bucket(jnp.asarray(rel), 32, 128))
    out = relative_position_bucket(torch.from_numpy(rel), 32, 128).numpy()
    np.testing.assert_array_equal(out, ref)
    # the JAX formula's +1e-6 puts distance 16 in bucket 8 + trunc(log(2+1e-6)/log(8)*8)
    assert out[200 + 16] == 16 + 10 and out[200 - 16] == 10


@pytest.mark.parametrize("length", [7, 20])
def test_t5_encoder_matches_jax_with_padding(length):
    rng = np.random.default_rng(length)
    ids = rng.integers(2, 500, size=(2, length)).astype(np.int32)
    mask = np.ones((2, length), np.int32)
    mask[1, length // 2:] = 0  # padded caption
    ids[1, length // 2:] = 0
    jstack = JaxT5EncoderStack(config=JaxT5Config(**T5_TINY))
    params = jstack.init(jax.random.PRNGKey(0), jnp.asarray(ids), jnp.asarray(mask))
    params = {"params": _perturb(jax.device_get(params["params"]), rng)}
    ref = jstack.apply(params, jnp.asarray(ids), jnp.asarray(mask))
    tstack = T5EncoderStack(T5Config(**T5_TINY))
    tstack.load_state_dict(convert_tree(params["params"]))
    with torch.no_grad():
        out = tstack(torch.from_numpy(ids), torch.from_numpy(mask))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)


def test_adapted_encoder_block_matches_with_cached_text_kv():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 8, 32)).astype(np.float32)
    text = rng.standard_normal((2, 5, 32)).astype(np.float32)
    mask = np.repeat(np.arange(2) >= 1, 4)[None, None, :]  # first frame masked out
    jblk = JaxAdaptedEncoderBlock(embed_dim=32, num_heads=4, mlp_size=64, fusion_num_heads=2,
                                  fusion_head_dim=16, fusion_mlp_size=64)
    params = jblk.init(jax.random.PRNGKey(0), jnp.asarray(x), text_embeddings=jnp.asarray(text))
    params = {"params": _perturb(jax.device_get(params["params"]), rng)}
    kv = jblk.apply(params, jnp.asarray(text), method="project_text_kv")
    ref = jblk.apply(params, jnp.asarray(x), text_kv=kv, self_mask=jnp.asarray(mask))
    tblk = AdaptedEncoderBlock(32, 4, 64, 2, 16, 64)
    tblk.load_state_dict(convert_tree(params["params"]))
    with torch.no_grad():
        tkv = tblk.project_text_kv(torch.from_numpy(text))
        out = tblk(torch.from_numpy(x), text_kv=tkv, self_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("num_context", [1, 2])
def test_rollout_matches_jax(num_context):
    rng = np.random.default_rng(20 + num_context)
    history = rng.standard_normal((B, num_context, S, D)).astype(np.float32)
    ids = rng.integers(2, 500, size=(B, 9)).astype(np.int32)
    mask = np.ones((B, 9), np.int32)
    mask[0, 6:] = 0
    ids[0, 6:] = 0
    jpred = jax_setup_predictor(
        tiny_predictor_params(jax_build_exp_params, jax_add_predictor_params, num_context))
    variables = jpred.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(history),
                           caption_tokens=jnp.asarray(ids), attn_masks=jnp.asarray(mask))
    variables = {"params": _perturb(jax.device_get(variables["params"]), rng)}
    ref = jpred.apply(variables, jnp.asarray(history), caption_tokens=jnp.asarray(ids),
                      attn_masks=jnp.asarray(mask))
    tpred = setup_predictor(tiny_predictor_params(build_exp_params, add_predictor_params,
                                                  num_context)).eval()
    tpred.load_state_dict(from_jax_params("predictor", variables["params"]))
    with torch.no_grad():
        out = tpred(torch.from_numpy(history), torch.from_numpy(ids), torch.from_numpy(mask))
    assert out.shape == (B, NUM_PREDS, S, D)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-3, atol=1e-4)


def test_unported_predictor_raises():
    p = tiny_predictor_params(build_exp_params, add_predictor_params)
    p["predictor"]["predictor_name"] = "SlotFormer"  # a predictor neither package has
    with pytest.raises(NameError, match="not ported"):
        setup_predictor(p)
