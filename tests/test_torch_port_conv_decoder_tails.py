"""SAVi's ``ConvDecoder`` with tails off the conv5 kernel's shape (another
kernel size, stride or width) against the JAX package on the CPU, at a small
size (4 slots of 32): the tiny SAVi of ``test_torch_port_savi.py`` with

* ``k3``: three 3 x 3 layers of 8 channels, on the fast broadcast path;
* ``k3_up2``: the same with x2 upsampling after every block but the last,
  over an 8 px map (32 px out);
* ``k5_widths``: 5 x 5 layers of 12, 8 and 16 channels;
* ``stride2``: two 5 x 5 layers of 8 channels at stride 2, which the JAX
  package decodes on its generic path.

The weights are the JAX init plus noise, carried over by
``convert.py::from_jax_params``. Each decode (reconstruction, per-slot
reconstructions, masks) in float32: rtol 1e-4, atol 1e-5 (sums in other
orders). Its 02 gradients (the mean squared error of the reconstruction
against a fixed target, through every decoder leaf, the decoder's positional
embedding and the slots): the loss rtol 1e-5, each leaf within 1e-4 of the
largest leaf's max |g|. In bf16 the decode is held by
``tests/torch_bf16.py``'s rule. The 3 x 3 tail takes int8 as JAX does: its
calibrated scales rtol 1e-5, its decode in quanta
(``test_torch_port_quant.py::assert_int8_close``). Only a 5 x 5 stride-1
64 -> 64 tail block runs through conv5.
"""

import torch_cpu_threads  # noqa: F401  (two torch threads a worker)
import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_quant import assert_int8_close
from test_torch_port_savi import _perturb, tiny_savi_params
from torch_bf16 import check_bf16

from textocvp_tpu.core.config import build_exp_params as jax_build_exp_params
from textocvp_tpu.models import quant as jax_quant
from textocvp_tpu.models import setup_model as jax_setup_model
from textocvp_tpu_torch.convert import from_jax_params
from textocvp_tpu_torch.core.config import build_exp_params
from textocvp_tpu_torch.models import quant, setup_model
from textocvp_tpu_torch.nn import decoders
from textocvp_tpu_torch.nn.decoders import ConvDecoder

N, S, D, RES = 3, 4, 32, 16
RTOL, ATOL = 1e-4, 1e-5
GRAD_TOL = 1e-4
TAILS = {
    "k3": dict(num_channels=[8, 8, 8], kernel_size=3),
    "k3_up2": dict(num_channels=[8, 8, 8], kernel_size=3, upsample=2, resolution=[8, 8]),
    "k5_widths": dict(num_channels=[12, 8, 16]),
    "stride2": dict(num_channels=[8, 8], stride=2),
}


def tail_params(build, case, dtype="float32"):
    p = tiny_savi_params(build)
    p["model"]["model_params"]["decoder"]["decoder_params"].update(copy.deepcopy(TAILS[case]))
    p["tpu"] = {"compute_dtype": dtype}
    return p


@functools.cache
def tail_case(case):
    """The JAX SAVi with ``case``'s decoder, perturbed, and the port's in
    each compute dtype with the same weights; the slots to decode."""
    rng = np.random.default_rng(7)
    jmodel = jax_setup_model(tail_params(jax_build_exp_params, case))
    video = jnp.asarray(rng.uniform(0, 1, (1, 1, RES, RES, 3)).astype(np.float32))
    variables = jax.jit(lambda x: jmodel.init(
        {"params": jax.random.PRNGKey(0), "slots": jax.random.PRNGKey(1)}, x, decode=True))(video)
    variables = {"params": _perturb(jax.device_get(variables["params"]), rng)}
    state = from_jax_params("savi", variables["params"])
    models = {}
    for dt in ("float32", "bfloat16"):
        models[dt] = setup_model(tail_params(build_exp_params, case, dt)).eval()
        models[dt].load_state_dict(state)
    slots = rng.standard_normal((N, S, D)).astype(np.float32)
    return {"case": case, "jmodel": jmodel, "variables": variables, "models": models,
            "slots": slots}


@pytest.fixture(params=sorted(TAILS))
def tail(request):
    return tail_case(request.param)


def _jax_decode(jmodel, variables, slots, **kw):
    return jax.jit(lambda v, s: jmodel.apply(v, s, method="decode", **kw))(
        variables, jnp.asarray(slots))


def test_tail_decode_matches_jax(tail):
    ref = _jax_decode(tail["jmodel"], tail["variables"], tail["slots"])
    with torch.no_grad():
        out = tail["models"]["float32"].decode(torch.from_numpy(tail["slots"]))
    side = {"k3_up2": 32, "stride2": 4}.get(tail["case"], RES)
    assert out["recons_imgs"].shape == (N, side, side, 3)
    for key in ("recons_imgs", "recons", "masks"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]), rtol=RTOL, atol=ATOL,
                                   err_msg=key)


def test_tail_02_gradients_match_jax(tail):
    jmodel, variables = tail["jmodel"], tail["variables"]
    ref_out = _jax_decode(jmodel, variables, tail["slots"])
    target = np.random.default_rng(8).uniform(0, 1, ref_out["recons_imgs"].shape).astype(
        np.float32)

    def jax_loss(params, slots):
        out = jmodel.apply({"params": params}, slots, method="decode")
        return jnp.mean((out["recons_imgs"] - target) ** 2)

    loss, (gp, gs) = jax.jit(jax.value_and_grad(jax_loss, argnums=(0, 1)))(
        variables["params"], jnp.asarray(tail["slots"]))
    want = {k: v.numpy() for k, v in from_jax_params("savi", jax.device_get(gp)).items()
            if k.startswith(("image_decoder.", "decoder_pos_embedding."))}
    want["slots"] = np.asarray(gs)
    model = tail["models"]["float32"]
    slots = torch.from_numpy(tail["slots"]).requires_grad_()
    model.zero_grad()
    got_loss = torch.mean((model.decode(slots)["recons_imgs"] - torch.from_numpy(target)) ** 2)
    got_loss.backward()
    np.testing.assert_allclose(got_loss.item(), float(loss), rtol=1e-5)
    got = {k: p.grad for k, p in model.named_parameters() if k in want}
    got["slots"] = slots.grad
    assert set(got) == set(want) and all(g is not None for g in got.values()), set(want) - set(got)
    largest = max(float(np.abs(w).max()) for w in want.values())
    for key, w in want.items():
        err = float(np.abs(got[key].numpy() - w).max())
        assert err <= GRAD_TOL * largest, (key, err, largest)


def test_tail_bf16_decode_matches_jax(tail):
    jbf16 = jax_setup_model(tail_params(jax_build_exp_params, tail["case"], "bfloat16"))
    ref = {"bfloat16": _jax_decode(jbf16, tail["variables"], tail["slots"]),
           "float32": _jax_decode(tail["jmodel"], tail["variables"], tail["slots"])}
    with torch.no_grad():
        out = {dt: m.decode(torch.from_numpy(tail["slots"])) for dt, m in tail["models"].items()}
    for key in ("recons_imgs", "masks"):
        check_bf16(out["bfloat16"][key], out["float32"][key], ref["bfloat16"][key],
                   ref["float32"][key], key)


def test_k3_tail_takes_int8_as_jax_does():
    tail = tail_case("k3")
    jmodel, variables, model = tail["jmodel"], tail["variables"], tail["models"]["float32"]
    scales = jax_quant.calibrate_decode_scales(jmodel, variables, jnp.asarray(tail["slots"]))
    slots = torch.from_numpy(tail["slots"])
    with torch.no_grad():
        got = quant.calibrate_decode_scales(model, slots)
        np.testing.assert_allclose(got.numpy(), scales, rtol=1e-5)
        out = model.decode(slots, quant_scales=torch.from_numpy(scales))
        flt = model.decode(slots)
    ref = _jax_decode(jmodel, variables, tail["slots"], quant_scales=jnp.asarray(scales))
    for key in ("recons_imgs", "recons", "masks"):
        assert_int8_close(out[key], ref[key], flt[key], key)


@pytest.mark.parametrize("hidden, kw, want", [
    ((64, 64, 64), {}, [True, True]),
    ((32, 64, 64), {}, [True, False]),  # hidden_dims walk from the end: 64 -> 64, 64 -> 32
    ((32, 32, 32), {}, [False, False]),
    ((128, 128), {}, [False]),
    ((64, 64, 64), {"kernel_size": 3}, [False, False]),
    ((64, 64), {"stride": 2}, [False]),
])
def test_only_the_stock_tail_shape_runs_conv5(hidden, kw, want, monkeypatch):
    dec = ConvDecoder(D, hidden, **kw).eval()
    assert dec.on_conv5 == want
    calls = []
    real = decoders.conv5
    monkeypatch.setattr(decoders, "conv5", lambda *a, **k: calls.append(1) or real(*a, **k))
    with torch.no_grad():
        dec.decode_broadcast(torch.randn(2, D), torch.randn(9, 9, D))
    assert len(calls) == sum(want)
