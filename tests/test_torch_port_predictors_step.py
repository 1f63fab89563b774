"""One step of each of the port's four other predictors against the JAX
package on the CPU, and the rollout's masked ring buffer against a
dynamic window, at ``test_torch_port_predictors.py``'s small size and
tolerances (one pass rtol 1e-4 / atol 1e-5)."""

import torch_cpu_threads  # noqa: F401  (two torch threads a worker)
import os

os.environ.setdefault("HF_HUB_OFFLINE", "1")
os.environ.setdefault("TRANSFORMERS_OFFLINE", "1")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
from test_torch_port_predictors import (  # noqa: E402
    ATOL,
    B,
    D,
    L,
    OTHERS,
    RTOL,
    S,
    captions,
    jax_predictor,
    jax_text,
    port_predictor,
    tiny_params,
    torch_text,
)

from textocvp_tpu_torch.core.config import add_predictor_params, build_exp_params  # noqa: E402
from textocvp_tpu_torch.models import setup_predictor  # noqa: E402


# -------------------------------------------------------------- predictors


def _window(rng, num_context):
    """A full buffer of L frames whose first L - num_context are padding."""
    return rng.standard_normal((B, L, S, D)).astype(np.float32), L - num_context


@pytest.mark.parametrize("num_context", [1, 2])
@pytest.mark.parametrize("name", OTHERS)
def test_one_step_matches_jax(name, num_context):
    """One call of the predictor on a buffer with L - c padding frames, with
    the mask and PE offset the rollout hands it."""
    rng = np.random.default_rng(40 + num_context)
    jw, params = jax_predictor(name, num_context, 1)
    tw = port_predictor(name, num_context, params)
    buf, pad = _window(rng, num_context)
    valid = np.arange(L) >= pad
    ids, lengths = captions()

    def jax_step(mdl, buf):
        p = mdl.predictor
        if name == "TextOCVP_CustomTF":
            kv = p.precompute_text_kv(p.encode_text(**jax_text(ids, lengths)))
            return p(buf, text_kv=kv, self_mask=jnp.asarray(np.repeat(valid, S))[None, None])
        if name == "VanillaTransformer":
            return p(buf, self_mask=jnp.asarray(np.repeat(valid, S))[None, None], pe_offset=pad)
        return p(buf, time_mask=jnp.asarray(valid)[None, None], pe_offset=pad)

    ref = jw.apply({"params": params}, jnp.asarray(buf), method=jax_step)
    p = tw.predictor
    with torch.no_grad():
        if name == "TextOCVP_CustomTF":
            kv = p.precompute_text_kv(p.encode_text(**torch_text(ids, lengths)))
            out = p(torch.from_numpy(buf), kv,
                    self_mask=torch.from_numpy(np.repeat(valid, S))[None, None])
        elif name == "VanillaTransformer":
            out = p(torch.from_numpy(buf), torch.from_numpy(np.repeat(valid, S))[None, None],
                    pe_offset=pad)
        else:
            out = p(torch.from_numpy(buf), torch.from_numpy(valid)[None, None], pe_offset=pad)
    assert out.shape == (B, S, D)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("num_context", [1, 2])
@pytest.mark.parametrize("name", OTHERS)
def test_static_rollout_matches_a_dynamic_window(name, num_context):
    """The masked ring buffer against a sliding window of only the valid
    frames (at most L), in the port: each step's window is as long as the
    frames it has, with no mask and no PE offset."""
    torch.manual_seed(num_context)
    tw = setup_predictor(tiny_params(build_exp_params, add_predictor_params, name,
                                     num_context)).eval()
    for p in tw.parameters():  # away from the init, as a trained predictor is
        p.data.add_(0.05 * torch.randn_like(p))
    hist = torch.randn(B, num_context, S, D)
    ids, lengths = captions()
    text = torch_text(ids, lengths)
    preds = 5
    with torch.no_grad():
        out = tw(hist, num_preds=preds, **text)
        p = tw.predictor
        kv = (p.precompute_text_kv(p.encode_text(**text))
              if name == "TextOCVP_CustomTF" else None)
        window, manual = list(hist.unbind(1)), []
        for _ in range(preds):
            x = torch.stack(window, dim=1)
            cur = p(x, kv) if kv is not None else p(x)
            manual.append(cur)
            window = (window + [cur])[-L:]
    assert out.shape == (B, preds, S, D)
    torch.testing.assert_close(out, torch.stack(manual, dim=1), rtol=3e-5, atol=3e-5)
