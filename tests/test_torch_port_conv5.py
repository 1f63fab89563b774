"""The decoder-tail 5x5 conv of the PyTorch port on the CPU: ``conv5_plain``
against the JAX package's Pallas kernel ``bench_pallas_conv.conv5_pallas`` (in
TPU interpret mode) and against its XLA conv ``conv5_xla``; the dispatch of
``conv5``; and SAVi's decode with 64-channel tail widths against the JAX
``decode`` on the same weights.

Tolerance 2e-5 absolute: float32 on both sides, 1600-term sums in other
orders, outputs of order 1. The kernel itself runs only on the card
(``tests/test_torch_port_gpu.py``); shapes of 2 frames cannot catch a 32-bit
offset or a grid limit there, which ``chip_smoke.py`` checks at N = 9728.
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

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from bench_pallas_conv import conv5_pallas, conv5_xla, pack_conv5_weights  # noqa: E402

from textocvp_tpu.core.config import build_exp_params as jax_build_exp_params  # noqa: E402
from textocvp_tpu.models import setup_model as jax_setup_model  # noqa: E402
from textocvp_tpu_torch.convert import from_jax_params  # noqa: E402
from textocvp_tpu_torch.core.config import build_exp_params  # noqa: E402
from textocvp_tpu_torch.models import setup_model  # noqa: E402
from textocvp_tpu_torch.nn import decoders  # noqa: E402
from textocvp_tpu_torch.ops import conv5 as c5  # noqa: E402

ATOL = 2e-5


def _inputs(n=2, h=64, w=64, c=64, seed=0):
    """Drawn as the probe draws them: x 0.5 N(0, 1), w N(0, 1)/sqrt(1600), b 0.1 N(0, 1)."""
    rng = np.random.default_rng(seed)
    x = (0.5 * rng.standard_normal((n, h, w, c))).astype(np.float32)
    wt = (rng.standard_normal((5, 5, c, c)) / np.sqrt(25 * c)).astype(np.float32)
    b = (0.1 * rng.standard_normal((c,))).astype(np.float32)
    return x, wt, b


def _plain(x, wt, b, relu):
    with torch.no_grad():
        return c5.conv5_plain(torch.from_numpy(x), torch.from_numpy(wt), torch.from_numpy(b),
                              relu=relu).numpy()


@pytest.fixture(scope="module")
def frames():
    return _inputs()


@pytest.mark.parametrize("relu", [True, False])
def test_plain_matches_the_pallas_kernel(frames, relu):
    x, wt, b = frames
    wp = pack_conv5_weights(wt, jnp.float32)
    bp = jnp.concatenate([jnp.asarray(b), jnp.asarray(b)]).reshape(1, 128)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(conv5_pallas(jnp.asarray(x), wp, bp, relu=relu, form="dots15"))
    out = _plain(x, wt, b, relu)
    assert out.shape == ref.shape == x.shape
    np.testing.assert_allclose(out, ref, rtol=0, atol=ATOL)
    if relu:
        assert (out >= 0).all() and (out > 0).mean() > 0.3


@pytest.mark.parametrize("relu", [True, False])
def test_plain_matches_the_xla_conv(frames, relu):
    x, wt, b = frames
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(conv5_xla(jnp.asarray(x), jnp.asarray(wt), jnp.asarray(b),
                                   relu=relu, chunks=1))
    np.testing.assert_allclose(_plain(x, wt, b, relu), ref, rtol=0, atol=ATOL)


@pytest.mark.parametrize("shape", [(3, 5, 7, 8), (1, 1, 1, 64), (2, 17, 70, 64)])
def test_plain_matches_conv2d_at_ragged_shapes(shape):
    n, h, w, c = shape
    x, wt, b = _inputs(n, h, w, c, seed=1)
    ref = torch.nn.functional.conv2d(torch.from_numpy(x).permute(0, 3, 1, 2),
                                     torch.from_numpy(wt).permute(3, 2, 0, 1),
                                     torch.from_numpy(b), padding=2).permute(0, 2, 3, 1)
    np.testing.assert_allclose(_plain(x, wt, b, relu=False), ref.numpy(), rtol=0, atol=ATOL)


def test_cpu_tensors_run_the_plain_version_and_cuda_only_launches(frames):
    x, wt, b = (torch.from_numpy(a) for a in frames)
    before = c5.conv5_cuda.launches
    torch.testing.assert_close(c5.conv5(x, wt, b), c5.conv5_plain(x, wt, b), rtol=0, atol=0)
    assert c5.conv5_cuda.launches == before
    with pytest.raises(ValueError, match="CUDA device"):
        c5.conv5_cuda(x, wt, b)
    assert c5.conv5_cuda.launches == before


def _tail_params(build, res=16):
    p = build("SAVi", "CATER_Easy")
    mp = p["model"]["model_params"]
    mp.update(num_slots=3, slot_dim=32, mlp_hidden=64, mlp_encoder_dim=32)
    mp["encoder"]["encoder_params"].update(num_channels=[8], resolution=[res, res])
    # the flagship decoder widths: a 32 -> 64 first conv and three 64 -> 64 tail convs
    mp["decoder"]["decoder_params"].update(num_channels=[64, 64, 64, 64], resolution=[res, res])
    p["dataset"]["img_size"] = [res, res]
    return p


def test_savi_decode_with_the_flagship_tail_matches_jax(monkeypatch):
    rng = np.random.default_rng(3)
    jmodel = jax_setup_model(_tail_params(jax_build_exp_params))
    variables = jmodel.init({"params": jax.random.PRNGKey(0), "slots": jax.random.PRNGKey(1)},
                            jnp.zeros((1, 1, 16, 16, 3)), decode=True)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(np.shape(a)).astype(np.float32),
        jax.device_get(variables["params"]))
    tmodel = setup_model(_tail_params(build_exp_params)).eval()
    tmodel.load_state_dict(from_jax_params("savi", params))
    slots = rng.standard_normal((4, 3, 32)).astype(np.float32)
    ref = jmodel.apply({"params": params}, jnp.asarray(slots), method="decode")

    calls = []
    real = decoders.conv5

    def spy(x, w, b, relu=True):
        calls.append((tuple(x.shape), x.is_contiguous(), tuple(w.shape), relu))
        return real(x, w, b, relu)

    monkeypatch.setattr(decoders, "conv5", spy)
    with torch.no_grad():
        out = tmodel.decode(torch.from_numpy(slots))
    # the three tail convs, NHWC and contiguous (no copy), HWIO weights, ReLU on
    assert calls == [((12, 16, 16, 64), True, (5, 5, 64, 64), True)] * 3
    for key in ("recons_imgs", "recons", "masks"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]), rtol=1e-4, atol=1e-5,
                                   err_msg=key)


def test_tail_weights_follow_a_reload():
    tmodel = setup_model(_tail_params(build_exp_params)).eval()
    dec = tmodel.image_decoder
    first = dec._tail_weights()
    assert first is dec._tail_weights()  # converted once
    torch.testing.assert_close(first[0][0], dec.blocks[1].conv.weight.permute(2, 3, 1, 0))
    state = {k: v + 1 for k, v in tmodel.state_dict().items()}
    tmodel.load_state_dict(state)
    again = dec._tail_weights()
    torch.testing.assert_close(again[0][0], dec.blocks[1].conv.weight.permute(2, 3, 1, 0))
    torch.testing.assert_close(again[2][1], dec.blocks[3].conv.bias)


def test_decoder_runs_a_tail_the_kernel_does_not_take_through_conv2d(monkeypatch):
    """A 3 x 3 tail of the kernel's width builds and never reaches conv5 (its
    parity with the JAX decoder: ``test_torch_port_conv_decoder_tails.py``)."""
    dec = decoders.ConvDecoder(32, [64, 64], kernel_size=3).eval()
    assert dec.on_conv5 == [False]
    monkeypatch.setattr(decoders, "conv5", lambda *a, **k: pytest.fail("conv5 called"))
    with torch.no_grad():
        out = dec.decode_broadcast(torch.randn(2, 32), torch.randn(8, 8, 32))
    assert out.shape == (2, 4, 8, 8)
