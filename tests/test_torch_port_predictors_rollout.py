"""The whole rollout of each of the port's four other predictors against
the JAX ``PredictorWrapper`` on the CPU, at ``test_torch_port_predictors.py``'s
small size: each prediction fed back as input, so float32 rounding
compounds over the steps, rtol 1e-3 / atol 1e-4."""

import torch_cpu_threads  # noqa: F401  (two torch threads a worker)
import os

os.environ.setdefault("HF_HUB_OFFLINE", "1")
os.environ.setdefault("TRANSFORMERS_OFFLINE", "1")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
from test_torch_port_predictors import (  # noqa: E402
    B,
    D,
    NUM_PREDS,
    OTHERS,
    S,
    captions,
    jax_predictor,
    jax_text,
    port_predictor,
    torch_text,
)


@pytest.mark.parametrize("num_context", [1, 2])
@pytest.mark.parametrize("name", OTHERS)
def test_rollout_matches_jax(name, num_context):
    """The whole rollout against the JAX ``PredictorWrapper``; every predictor
    is handed the caption, which the unconditioned ones ignore."""
    rng = np.random.default_rng(20 + num_context)
    history = rng.standard_normal((B, num_context, S, D)).astype(np.float32)
    ids, lengths = captions()
    jw, params = jax_predictor(name, num_context, 2)
    ref = jw.apply({"params": params}, jnp.asarray(history), **jax_text(ids, lengths))
    tw = port_predictor(name, num_context, params)
    with torch.no_grad():
        out = tw(torch.from_numpy(history), **torch_text(ids, lengths))
    assert out.shape == (B, NUM_PREDS, S, D)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-3, atol=1e-4)
