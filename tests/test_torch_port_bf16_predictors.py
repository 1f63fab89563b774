"""``tpu.compute_dtype: "bfloat16"`` of the PyTorch port's predictors on the
CPU: a TextOCVP_T5 rollout (the T5's RMSNorm, relative bias and masked
softmax, the fusion blocks, the ring buffer in the slots' dtype) and one of
each of the four other predictors, against the JAX ``PredictorWrapper`` in
bf16 and in float32 on the same weights, slots and captions, with
``tests/torch_bf16.py``'s rule.
"""

import torch_cpu_threads  # noqa: F401  (two torch threads a worker)
import os

os.environ.setdefault("HF_HUB_OFFLINE", "1")
os.environ.setdefault("TRANSFORMERS_OFFLINE", "1")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
from test_torch_port_bf16_models import with_dtype  # noqa: E402
from test_torch_port_predictor import _perturb  # noqa: E402
from test_torch_port_predictors import (  # noqa: E402
    NUM_PREDS,
    OTHERS,
    B,
    D,
    S,
    captions,
    jax_text,
    tiny_params,
    torch_text,
)
from torch_bf16 import check_bf16  # noqa: E402

from textocvp_tpu.core.config import add_predictor_params as jax_add_predictor_params  # noqa: E402
from textocvp_tpu.core.config import build_exp_params as jax_build_exp_params  # noqa: E402
from textocvp_tpu.models import setup_predictor as jax_setup_predictor  # noqa: E402
from textocvp_tpu_torch.convert import from_jax_params  # noqa: E402
from textocvp_tpu_torch.core.config import add_predictor_params, build_exp_params  # noqa: E402
from textocvp_tpu_torch.models import setup_predictor  # noqa: E402

DTYPES = ("bfloat16", "float32")


def t5_params(build, add):
    """A TextOCVP_T5 with a 2-layer T5 of width 32 (vocabulary 32128)."""
    p = add(build("SAVi", "CATER_Easy"), "TextOCVP_T5")
    p["model"]["model_params"].update(num_slots=S, slot_dim=D)
    pp = p["predictor"]["predictor_params"]
    pp["predictor_params"].update(token_dim=32, n_heads=2, hidden_dim=64, num_layers=2)
    pp["fusion_params"].update(num_heads=2, head_dim=16, mlp_size=64)
    pp["text_encoder_params"] = dict(vocab_size=32128, d_model=32, d_kv=16, num_heads=2,
                                     d_ff=64, num_layers=2)
    p["prediction_params"].update(num_context=2, num_preds=NUM_PREDS, input_buffer_size=4)
    return p


def _params(name, build, add):
    return t5_params(build, add) if name == "TextOCVP_T5" else tiny_params(build, add, name, 2)


def _text(name, rng):
    """(JAX, torch) caption inputs of predictor ``name``: T5 ids with a mask
    (the second caption padded), else CustomTokenizer ids and lengths."""
    if name != "TextOCVP_T5":
        ids, lengths = captions()
        return jax_text(ids, lengths), torch_text(ids, lengths)
    ids = rng.integers(1, 32128, (B, 7)).astype(np.int32)
    masks = np.ones((B, 7), np.int32)
    masks[1, 4:] = 0
    return ({"caption_tokens": jnp.asarray(ids), "attn_masks": jnp.asarray(masks)},
            {"caption_tokens": torch.from_numpy(ids), "attn_masks": torch.from_numpy(masks)})


@pytest.mark.parametrize("name", ["TextOCVP_T5", *OTHERS])
def test_rollout_bf16_matches_jax(name):
    rng = np.random.default_rng(12)
    history = rng.standard_normal((B, 2, S, D)).astype(np.float32)
    jtext, ttext = _text(name, rng)
    refs, outs, params = {}, {}, None
    for dt in DTYPES:
        jw = jax_setup_predictor(with_dtype(_params(name, jax_build_exp_params,
                                                    jax_add_predictor_params), dt, True))
        jdt = jnp.bfloat16 if dt == "bfloat16" else jnp.float32
        if params is None:
            init = jw.init({"params": jax.random.PRNGKey(3)}, jnp.zeros((1, 2, S, D)),
                           **{k: v[:1] for k, v in jtext.items()})
            params = _perturb(jax.device_get(init["params"]), rng)
        refs[dt] = jax.jit(lambda p, h, t: jw.apply({"params": p}, h, **t))(
            params, jnp.asarray(history, jdt), jtext)
        tw = setup_predictor(with_dtype(_params(name, build_exp_params, add_predictor_params),
                                        dt, False)).eval()
        tw.load_state_dict(from_jax_params("predictor", params), strict=True)
        with torch.no_grad():
            outs[dt] = tw(torch.from_numpy(history).to(getattr(torch, dt)), **ttext)
    assert outs["bfloat16"].shape == (B, NUM_PREDS, S, D)
    check_bf16(outs["bfloat16"], outs["float32"], refs["bfloat16"], refs["float32"], name)
