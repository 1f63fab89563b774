"""The port's ``ConvDecoder`` with ``batch_norm`` and ``upsample`` against
the JAX package's on the CPU, at a small size (slots of 16, three 5x5 tail
layers of 8 channels, maps of 8 and 10 pixels).

* The generic path (``forward`` / ``__call__``), BatchNorm in ``train()``
  (with the running statistics it moves) and in ``eval()``, and the x2
  upsampling after every block but the last: rtol 1e-4, atol 1e-5 (float32
  on both sides, sums in other orders); the running statistics rtol 1e-5,
  atol 1e-6.
* ``decode_broadcast`` takes the fast path or the generic one under exactly
  the JAX conditions (``batch_norm``, a map smaller than ``4 pad + 1``), with
  the same limits.
* Where JAX refuses int8 (``quant_scales`` or ``calibrate`` on a decoder
  that falls back) the port raises the same message; the upsampling decoder
  takes int8 in both: its calibrated amaxes within rtol 1e-5, its int8
  decode held to JAX's in quanta (``test_torch_port_quant.py``).
* A 3 x 3 upsampling decoder (a tail that conv5 does not take) builds and
  decodes as JAX's, with the same limits (the other tails:
  ``test_torch_port_conv_decoder_tails.py``).
"""

import torch_cpu_threads  # noqa: F401  (two torch threads a worker)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_encoders import _perturb, _stats
from test_torch_port_quant import assert_int8_close

from textocvp_tpu.nn.decoders import ConvDecoder as JaxConvDecoder
from textocvp_tpu_torch.convert import convert_batch_stats, convert_tree
from textocvp_tpu_torch.nn.decoders import ConvDecoder, get_decoder

D, HIDDEN, N = 16, (8, 8, 8), 6
RTOL, ATOL = 1e-4, 1e-5
CASES = {"bn": dict(batch_norm=True, upsample=None), "up2": dict(batch_norm=False, upsample=2),
         "bn_up2": dict(batch_norm=True, upsample=2)}


def _decoders(case, res, rng):
    """The JAX decoder with perturbed params (and statistics) and the port's
    with the same numbers."""
    jdec = JaxConvDecoder(hidden_dims=HIDDEN, **CASES[case])
    x = jnp.zeros((1, res, res, D))
    variables = jax.jit(jdec.init)(jax.random.PRNGKey(0), x)
    variables = {"params": _perturb(jax.device_get(variables["params"]), rng), **(
        {"batch_stats": _stats(jax.device_get(variables["batch_stats"]), rng)}
        if "batch_stats" in variables else {})}
    tdec = get_decoder({"decoder_name": "ConvDecoder",
                        "decoder_params": {"num_channels": list(HIDDEN), **CASES[case]}}, D)
    sd = convert_tree(variables["params"], parent="image_decoder")
    if "batch_stats" in variables:
        sd.update(convert_batch_stats(variables["batch_stats"]))
    tdec.load_state_dict(sd)
    return jdec, variables, tdec


def _apply(jdec, variables, train, method=None, **kw):
    """JAX ``apply`` under ``jit``: (output, moved batch_stats or None)."""
    def run(v, *args):
        if train:
            return jdec.apply(v, *args, method=method, train=True, mutable=["batch_stats"], **kw)
        return jdec.apply(v, *args, method=method, **kw), None
    return jax.jit(run)


def _check_stats(tdec, moved):
    state = tdec.state_dict()
    for key, value in convert_batch_stats(jax.device_get(moved["batch_stats"])).items():
        if not key.endswith("num_batches_tracked"):
            np.testing.assert_allclose(state[key].numpy(), value.numpy(), rtol=1e-5, atol=1e-6,
                                       err_msg=key)


@pytest.mark.parametrize("case, train", [("bn", True), ("bn", False), ("up2", False),
                                         ("bn_up2", True)])
def test_generic_path_matches_jax(case, train):
    rng = np.random.default_rng(1)
    jdec, variables, tdec = _decoders(case, 8, rng)
    x = rng.standard_normal((N, 8, 8, D)).astype(np.float32)
    ref, moved = _apply(jdec, variables, train)(variables, jnp.asarray(x))
    tdec.train(train)
    with torch.no_grad():
        out = tdec(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    side = 8 * (4 if CASES[case]["upsample"] else 1)
    assert out.shape == (N, side, side, 4) == np.asarray(ref).shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)
    if train:
        _check_stats(tdec, moved)


@pytest.mark.parametrize("case, res, train", [("up2", 10, False), ("up2", 8, False),
                                              ("bn_up2", 10, True), ("bn", 10, False)],
                         ids=["up2-fast", "up2-small-map", "bn_up2-train", "bn-eval"])
def test_decode_broadcast_matches_jax(case, res, train):
    """The fast path where JAX takes it (upsampling on a map of at least 9
    pixels), the generic one elsewhere."""
    rng = np.random.default_rng(2)
    jdec, variables, tdec = _decoders(case, res, rng)
    slots = rng.standard_normal((N, D)).astype(np.float32)
    pos = rng.standard_normal((res, res, D)).astype(np.float32)
    ref, moved = _apply(jdec, variables, train, method="decode_broadcast",
                        resolution=(res, res))(variables, jnp.asarray(slots), jnp.asarray(pos))
    tdec.train(train)
    with torch.no_grad():
        out = tdec.decode_broadcast(torch.from_numpy(slots), torch.from_numpy(pos))
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)
    if train:
        _check_stats(tdec, moved)


@pytest.mark.parametrize("case, res", [("bn", 10), ("bn_up2", 10), ("up2", 8)])
@pytest.mark.parametrize("what", ["quant_scales", "calibrate"])
def test_int8_refusals_match_jax(case, res, what):
    rng = np.random.default_rng(3)
    jdec, variables, tdec = _decoders(case, res, rng)
    slots = rng.standard_normal((N, D)).astype(np.float32)
    pos = rng.standard_normal((res, res, D)).astype(np.float32)
    kw = {"quant_scales": np.full(len(HIDDEN) - 1, 0.05, np.float32)} \
        if what == "quant_scales" else {"calibrate": True}
    with pytest.raises(ValueError) as jerr:
        jdec.apply(variables, jnp.asarray(slots), jnp.asarray(pos), (res, res),
                   method="decode_broadcast", **{k: (jnp.asarray(v) if k == "quant_scales"
                                                     else v) for k, v in kw.items()})
    with pytest.raises(ValueError) as terr:
        tdec.eval().decode_broadcast(torch.from_numpy(slots), torch.from_numpy(pos),
                                     **{k: (torch.from_numpy(v) if k == "quant_scales" else v)
                                        for k, v in kw.items()})
    assert str(terr.value) == str(jerr.value)


def test_upsampling_decoder_takes_int8_as_jax_does():
    rng = np.random.default_rng(4)
    jdec, variables, tdec = _decoders("up2", 10, rng)
    tdec.eval()
    slots = rng.standard_normal((N, D)).astype(np.float32)
    pos = rng.standard_normal((10, 10, D)).astype(np.float32)
    call = jax.jit(lambda v, s, p, **kw: jdec.apply(v, s, p, (10, 10), method="decode_broadcast",
                                                    **kw), static_argnames="calibrate")
    amax = np.asarray(call(variables, jnp.asarray(slots), jnp.asarray(pos), calibrate=True))
    ts, tp = torch.from_numpy(slots), torch.from_numpy(pos)
    with torch.no_grad():
        tamax = tdec.decode_broadcast(ts, tp, calibrate=True)
        np.testing.assert_allclose(tamax.numpy(), amax, rtol=1e-5)
        scales = (amax / 127).astype(np.float32)
        ref = np.asarray(jax.jit(lambda v, s, p, q: jdec.apply(
            v, s, p, (10, 10), method="decode_broadcast", quant_scales=q))(
            variables, jnp.asarray(slots), jnp.asarray(pos), jnp.asarray(scales)))
        out = tdec.decode_broadcast(ts, tp, quant_scales=torch.from_numpy(scales))
        flt = tdec.decode_broadcast(ts, tp)
    assert out.shape == (N, 4, 40, 40)
    assert_int8_close(out.permute(0, 2, 3, 1).numpy(), ref, flt.permute(0, 2, 3, 1).numpy(),
                      "int8 upsampling decode")


@pytest.mark.parametrize("res", [10, 4], ids=["fast", "generic"])
def test_tail_of_other_kernel_sizes_matches_jax(res):
    """A 3 x 3 upsampling decoder builds and decodes as the JAX one, on the
    fast path (a map of at least 5 pixels) and on the generic one; its tail
    runs through ``Conv2d``, not conv5 (``test_torch_port_conv_decoder_tails.py``
    holds the other shapes, their gradients, bf16 and int8)."""
    rng = np.random.default_rng(6)
    jdec = JaxConvDecoder(hidden_dims=HIDDEN, kernel_size=3, upsample=2)
    variables = jax.jit(jdec.init)(jax.random.PRNGKey(0), jnp.zeros((1, res, res, D)))
    variables = {"params": _perturb(jax.device_get(variables["params"]), rng)}
    tdec = ConvDecoder(D, HIDDEN, kernel_size=3, upsample=2).eval()
    tdec.load_state_dict(convert_tree(variables["params"], parent="image_decoder"))
    assert tdec.on_conv5 == [False, False]
    slots = rng.standard_normal((N, D)).astype(np.float32)
    pos = rng.standard_normal((res, res, D)).astype(np.float32)
    ref = _apply(jdec, variables, False, method="decode_broadcast", resolution=(res, res))(
        variables, jnp.asarray(slots), jnp.asarray(pos))[0]
    with torch.no_grad():
        out = tdec.decode_broadcast(torch.from_numpy(slots), torch.from_numpy(pos))
    assert out.shape == (N, 4, 4 * res, 4 * res)
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)
