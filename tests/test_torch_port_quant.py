"""Opt-in int8 of the port (``tpu.decode_quant`` / ``tpu.encode_quant``)
against the JAX package on the CPU, at a small size.

* ``conv_int8``'s plain version against ``ConvDecoder._quantize_conv`` and
  the int8 dense against ``_dense_int8`` / ``MLPPatchDecoder._quantize_dense``
  on the same float inputs: exact (max abs error 0). Both quantize with an
  IEEE division and round half to even, sum exactly (int32 in JAX, float64
  here, every partial sum an integer below 2^53) and dequantize with the
  same two float32 roundings.
* The calibrated scales against ``calibrate_decode_scales`` /
  ``calibrate_encode_scales``: rtol 1e-5, the float paths' amaxes differing
  by float rounding (measured 5e-7).
* SAVi's int8 tail on the same input activations as JAX's: rtol 1e-4 /
  atol 1e-5, the int8 convs exact and the final float conv summed in
  another order.
* The whole int8 decodes (SAVi, ExtendedDINOSAUR) and the int8 ViT encode
  against JAX's, with the same scales and inputs: the float layers before an
  int8 one (SAVi's first conv on the small tile and the positional map, the
  ViT's LayerNorms, GELU and attention) round differently in the two
  packages, so an activation within about 1e-7 of a .5 boundary is
  quantized one quantum apart, and everything it reaches moves by that
  quantum times a weight. So these hold the port to JAX in quanta: at least
  75 % of the outputs within rtol 1e-4 / atol 1e-5 (the rest are what a flip
  reaches), and the largest difference at most half of int8's own error
  against the float path (measured: 0.12-0.33 of it where flips occur, none
  on the ExtendedDINOSAUR decode).
* The mode gates raise as the JAX ones do, with the same messages.
"""

import torch_cpu_threads  # noqa: F401  (two torch threads a worker)
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_dinosaur import _perturb_stats, tiny_dinosaur_params
from test_torch_port_savi import _perturb

from textocvp_tpu.core.config import build_exp_params as jax_build_exp_params
from textocvp_tpu.models import setup_model as jax_setup_model
from textocvp_tpu.models import quant as jax_quant
from textocvp_tpu.nn.decoders import ConvDecoder as JaxConvDecoder
from textocvp_tpu.nn.decoders import MLPPatchDecoder as JaxMLPPatchDecoder
from textocvp_tpu.nn.vit import _dense_int8
from textocvp_tpu_torch.convert import from_jax_params
from textocvp_tpu_torch.core.config import build_exp_params
from textocvp_tpu_torch.models import quant, setup_model
from textocvp_tpu_torch.ops.conv_int8 import (
    conv_int8,
    conv_int8_plain,
    quantize_activation,
    quantize_weight,
    quantized_conv,
)
from textocvp_tpu_torch.ops.dense_int8 import dense_int8

RES, S, D = 16, 4, 32
RTOL, ATOL = 1e-4, 1e-5


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize("k, cin, cout, relu", [(5, 64, 64, True), (3, 24, 40, False),
                                                (3, 64, 128, True)])
def test_conv_int8_plain_is_the_jax_quantize_conv(k, cin, cout, relu):
    rng = np.random.default_rng(k + cin)
    x = rng.standard_normal((2, 9, 7, cin)).astype(np.float32)
    w = (0.1 * rng.standard_normal((k, k, cin, cout))).astype(np.float32)
    b = rng.standard_normal(cout).astype(np.float32)
    a = np.float32(np.abs(x).max() / 127)
    ref = JaxConvDecoder._quantize_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), k // 2,
                                        jnp.asarray(a))
    ref = np.maximum(np.asarray(ref), 0) if relu else np.asarray(ref)
    with torch.no_grad():
        out = quantized_conv(_t(x), _t(w), _t(b), torch.tensor(a), relu=relu)
    assert out.dtype == torch.float32 and out.shape == (2, 9, 7, cout)
    np.testing.assert_array_equal(out.numpy(), ref)


def test_conv_int8_sums_exactly_and_dispatches_through_its_op():
    """The float64 sums equal an int64 reference sum at the largest int8
    values; on the CPU the op runs the plain version; grad is refused."""
    rng = np.random.default_rng(0)
    x_q = torch.from_numpy(rng.integers(-127, 128, (1, 6, 5, 64), dtype=np.int8))
    w_q = torch.full((5, 5, 64, 64), 127, dtype=torch.int8)
    ones = torch.ones(64)
    acc = F_conv_int64(x_q, w_q)
    out = conv_int8(x_q, w_q, torch.tensor(1.0), ones, torch.zeros(64))
    np.testing.assert_array_equal(out.numpy(), acc.numpy().astype(np.float32))
    np.testing.assert_array_equal(
        out.numpy(), conv_int8_plain(x_q, w_q, torch.tensor(1.0), ones, torch.zeros(64)).numpy())
    with pytest.raises(RuntimeError, match="no backward"):
        conv_int8(x_q, w_q, torch.tensor(1.0, requires_grad=True), ones, torch.zeros(64))


def F_conv_int64(x_q, w_q):
    """The k x k same conv of int8 tensors summed in int64, as a reference."""
    k = w_q.shape[0]
    n, h, w, _ = x_q.shape
    xp = torch.nn.functional.pad(x_q.long(), (0, 0, k // 2, k // 2, k // 2, k // 2))
    acc = torch.zeros((n, h, w, w_q.shape[-1]), dtype=torch.long)
    for dy in range(k):
        for dx in range(k):
            acc += torch.einsum("nhwc,co->nhwo", xp[:, dy:dy + h, dx:dx + w], w_q[dy, dx].long())
    return acc


@pytest.mark.parametrize("which, out", [("vit", 48), ("patch_decoder", 25)])
def test_dense_int8_is_the_jax_dense(which, out):
    rng = np.random.default_rng(out)
    x = rng.standard_normal((3, 5, 40)).astype(np.float32)
    w = rng.standard_normal((40, out)).astype(np.float32)  # flax (in, out)
    b = rng.standard_normal(out).astype(np.float32)
    a = np.float32(np.abs(x).max() / 127)
    if which == "vit":
        ref = _dense_int8(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), jnp.asarray(a),
                          jnp.float32)
    else:
        ref = JaxMLPPatchDecoder._quantize_dense(jnp.asarray(x), {"kernel": w, "bias": b},
                                                 jnp.asarray(a))
    with torch.no_grad():
        got = dense_int8(_t(x), _t(w.T.copy()), _t(b), torch.tensor(a))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_quantizers_round_half_to_even_and_clip():
    x = torch.tensor([0.5, 1.5, 2.5, -0.5, -2.5, 300.0, -300.0])
    assert quantize_activation(x, torch.tensor(1.0)).tolist() == [0, 2, 2, 0, -2, 127, -127]
    w_q, w_scale = quantize_weight(torch.tensor([[1.0, -2.0], [0.0, 0.0]]), (1,))
    assert w_q.tolist() == [[64, -127], [0, 0]] and w_scale[1].item() == pytest.approx(1e-30 / 127)


def savi_params(build):
    p = build("SAVi", "CATER_Easy")
    mp = p["model"]["model_params"]
    mp.update(num_slots=S, slot_dim=D, mlp_hidden=64, mlp_encoder_dim=32)
    mp["encoder"]["encoder_params"].update(num_channels=[8, 8], resolution=[RES, RES])
    # two hidden tail convs before the final one: two int8 layers
    mp["decoder"]["decoder_params"].update(num_channels=[8, 8, 8], resolution=[RES, RES])
    mp["transition_module"] = {"model_name": "TransformerBlock", "num_heads": 2, "mlp_size": 64}
    p["dataset"]["img_size"] = [RES, RES]
    return p


def _init(jmodel, video):
    """The JAX model's variables, initialised on one frame under ``jit``
    (eager flax dispatches op by op, several times slower)."""
    return jax.jit(partial(jmodel.init, decode=True))(
        {"params": jax.random.PRNGKey(0), "slots": jax.random.PRNGKey(1)},
        jnp.asarray(video[:1, :1]))


def _jax_decode(jmodel, variables, slots, scales):
    return jax.jit(lambda v, s, q: jmodel.apply(v, s, method="decode", quant_scales=q))(
        variables, jnp.asarray(slots), jnp.asarray(scales))


@pytest.fixture(scope="module")
def savi():
    rng = np.random.default_rng(5)
    video = rng.uniform(0, 1, (2, 3, RES, RES, 3)).astype(np.float32)
    jmodel = jax_setup_model(savi_params(jax_build_exp_params))
    variables = _init(jmodel, video)
    variables = {"params": _perturb(jax.device_get(variables["params"]), rng)}
    tmodel = setup_model(savi_params(build_exp_params)).eval().requires_grad_(False)
    tmodel.load_state_dict(from_jax_params("savi", variables["params"]))
    slots = rng.standard_normal((6, S, D)).astype(np.float32)
    scales = jax_quant.calibrate_decode_scales(jmodel, variables, jnp.asarray(slots))
    return jmodel, variables, tmodel, slots, scales


@pytest.fixture(scope="module")
def dinosaur():
    rng = np.random.default_rng(5)
    video = rng.uniform(0, 1, (2, 3, 42, 42, 3)).astype(np.float32)
    jmodel = jax_setup_model(tiny_dinosaur_params(jax_build_exp_params))
    variables = _init(jmodel, video)
    variables = {"params": _perturb(jax.device_get(variables["params"]), rng),
                 "batch_stats": _perturb_stats(jax.device_get(variables["batch_stats"]), rng)}
    tmodel = setup_model(tiny_dinosaur_params(build_exp_params)).eval().requires_grad_(False)
    tmodel.load_state_dict(from_jax_params("dinosaur", variables["params"],
                                           batch_stats=variables["batch_stats"]))
    return jmodel, variables, tmodel, video


def test_calibrated_scales_match_jax(savi, dinosaur):
    jmodel, variables, tmodel, slots, scales = savi
    got = quant.calibrate_decode_scales(tmodel, _t(slots))
    assert got.shape == (2,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), scales, rtol=1e-5)
    jmodel, variables, tmodel, video = dinosaur
    slots = np.random.default_rng(9).standard_normal((3, 3, 16)).astype(np.float32)
    ref = jax_quant.calibrate_decode_scales(jmodel, variables, jnp.asarray(slots))
    got = quant.calibrate_decode_scales(tmodel, _t(slots))
    assert got.shape == (2 + 4,)  # the denses, then the CNN-head blocks
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5)
    ref = jax_quant.calibrate_encode_scales(jmodel, variables, jnp.asarray(video))
    got = quant.calibrate_encode_scales(tmodel, _t(video))
    assert got.shape == (1, 4)  # (depth, DENSES)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5)


def test_savi_int8_tail_matches_jax_on_the_same_activations(savi):
    jmodel, variables, tmodel, _, scales = savi
    x = np.random.default_rng(3).uniform(0, 2, (5, RES, RES, 8)).astype(np.float32)
    ref = jmodel.apply(variables, jnp.asarray(x), method=lambda m, x: m.image_decoder._tail_scanned(
        x, 1, quant_scales=jnp.asarray(scales)))
    with torch.no_grad():
        out = tmodel.image_decoder._tail(_t(x), _t(scales)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)


def assert_int8_close(out, ref, flt, what):
    """``out`` (the port's int8) against ``ref`` (JAX's int8) in quanta, with
    ``flt`` the port's float path on the same input (module docstring)."""
    out, ref, flt = (np.asarray(a) for a in (out, ref, flt))
    d = np.abs(out - ref)
    assert np.mean(d <= ATOL + RTOL * np.abs(ref)) >= 0.75, what
    assert d.max() <= 0.5 * np.abs(flt - ref).max(), (what, d.max(), np.abs(flt - ref).max())


def test_savi_int8_decode_matches_jax_in_quanta(savi):
    jmodel, variables, tmodel, slots, scales = savi
    ref = _jax_decode(jmodel, variables, slots, scales)
    with torch.no_grad():
        out = tmodel.decode(_t(slots), quant_scales=_t(scales))
        flt = tmodel.decode(_t(slots))
    for key in ("recons_imgs", "recons", "masks"):
        assert_int8_close(out[key], ref[key], flt[key], key)


def test_dinosaur_int8_decode_and_encode_match_jax_in_quanta(dinosaur):
    jmodel, variables, tmodel, video = dinosaur
    slots = np.random.default_rng(9).standard_normal((3, 3, 16)).astype(np.float32)
    scales = jax_quant.calibrate_decode_scales(jmodel, variables, jnp.asarray(slots))
    ref = _jax_decode(jmodel, variables, slots, scales)
    with torch.no_grad():
        out = tmodel.decode(_t(slots), quant_scales=_t(scales))
        flt = tmodel.decode(_t(slots))
    for key in ("recons_imgs", "recons_feats", "masks"):
        assert_int8_close(out[key], ref[key], flt[key], key)
    enc = jax_quant.calibrate_encode_scales(jmodel, variables, jnp.asarray(video))
    key = jax.random.PRNGKey(7)
    ref = jax.jit(lambda v, x, q: jmodel.apply(v, x, decode=False, rngs={"slots": key},
                                               encode_quant_scales=q))(
        variables, jnp.asarray(video), jnp.asarray(enc))
    init = _t(np.array(jmodel.apply(variables, 2, rngs={"slots": key},
                                    method=lambda m, b: m.slot_initializer(batch_size=b))))
    with torch.no_grad():
        out = tmodel.decompose(_t(video), initial_slots=init, encode_quant_scales=_t(enc))
        flt = tmodel.decompose(_t(video), initial_slots=init)
    for key in ("encoded_img_feats", "slot_history"):
        assert_int8_close(out[key], ref[key], flt[key], key)


def test_scales_of_the_wrong_length_raise_as_in_jax(savi, dinosaur):
    _, _, tmodel, slots, _ = savi
    with pytest.raises(ValueError, match="has 3 entries but this ConvDecoder has 2 hidden"):
        tmodel.decode(_t(slots), quant_scales=torch.ones(3))
    with pytest.raises(ValueError, match="fast-broadcast"):
        tmodel.decode(_t(slots), fast=False, quant_scales=torch.ones(2))
    _, _, dmodel, _ = dinosaur
    with pytest.raises(ValueError, match=r"needs 6 \(2 MLP \+ 4 CNN\)"):
        dmodel.decode(torch.zeros(1, 3, 16), quant_scales=torch.ones(5))


@pytest.mark.parametrize("model, key, mode", [
    ("SAVi", "decode_quant", "int4"), ("SAVi", "encode_quant", "int8"),
    ("ExtendedDINOSAUR", "encode_quant", "fp8"), ("VanillaTransformer", "decode_quant", "int8"),
    ("SAVi", "decode_quant", "int8"), ("ExtendedDINOSAUR", "encode_quant", "int8")])
def test_mode_gates_match_jax(model, key, mode):
    params = {"model": {"model_name": model}, "tpu": {key: mode}}
    gate, jax_gate = {"decode_quant": (quant.decode_quant_mode, jax_quant.decode_quant_mode),
                      "encode_quant": (quant.encode_quant_mode, jax_quant.encode_quant_mode)}[key]
    try:
        want = jax_gate(params)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            gate(params)
        assert str(got.value) == str(e)
        return
    assert gate(params) == want == "int8"
    assert gate({"model": {"model_name": model}}) is None
