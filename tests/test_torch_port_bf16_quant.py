"""``tpu.compute_dtype: "bfloat16"`` beside int8 (``tpu.decode_quant`` /
``tpu.encode_quant``) on the CPU, against the JAX package on the same
weights, slots and video:

* SAVi with the stock decoder tail's shape (two 5 x 5 64 -> 64 convs, so the
  bf16 calibration runs through conv5's bf16 plain version, as on the card
  through its kernel) and int8 decode (ExtendedDINOSAUR:
  ``test_torch_port_bf16_quant_dinosaur.py``).

Each side calibrates its own scales on the compute dtype's path (the JAX
``calibrate_decode_scales`` / ``calibrate_encode_scales``) and decodes with
them. The scales and the outputs are held by ``tests/torch_bf16.py``'s rule
against the JAX bf16 + int8 and float32 + int8 results: within 2 e(JAX bf16,
JAX float32) + 2**-8 of the first, 1.5 e + 2**-8 of the second, and more than
1e-4 from the port's own float32 + int8.
"""

import torch_cpu_threads  # noqa: F401  (two torch threads a worker)
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_savi import _perturb, tiny_savi_params
from torch_bf16 import check_bf16

from textocvp_tpu.core.config import build_exp_params as jax_build_exp_params
from textocvp_tpu.models import quant as jax_quant
from textocvp_tpu.models import setup_model as jax_setup_model
from textocvp_tpu_torch.convert import from_jax_params
from textocvp_tpu_torch.core.config import add_predictor_params, build_exp_params
from textocvp_tpu_torch.models import quant, setup_model, setup_predictor

DTYPES = ("bfloat16", "float32")
RES = 16


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


def _with(params, dtype, jax_side, **tpu):
    params = copy.deepcopy(params)
    params["tpu"] = {"compute_dtype": dtype, **tpu, **({"use_pallas": True} if jax_side else {})}
    return params


def savi_params(build):
    p = tiny_savi_params(build)
    p["model"]["model_params"]["decoder"]["decoder_params"].update(num_channels=[64, 64, 64])
    return p


@pytest.mark.parametrize("key", ["decode_quant", "encode_quant"])
def test_bf16_with_int8_builds(key):
    """bf16 beside either int8 option builds both models in bf16 with float32
    parameters; the mode gates read int8."""
    params = add_predictor_params(build_exp_params("ExtendedDINOSAUR", "CLIPort"),
                                  "TextOCVP_T5")
    params["tpu"] = {"compute_dtype": "bfloat16", key: "int8"}
    for mod in (setup_model(params), setup_predictor(params)):
        assert mod.compute_dtype == torch.bfloat16
        assert {p.dtype for p in mod.parameters()} == {torch.float32}
    gate = quant.decode_quant_mode if key == "decode_quant" else quant.encode_quant_mode
    assert gate(params) == "int8"


def test_savi_bf16_int8_decode_matches_jax():
    rng = np.random.default_rng(3)
    jmodels = {dt: jax_setup_model(_with(savi_params(jax_build_exp_params), dt, True,
                                         decode_quant="int8")) for dt in DTYPES}
    video = jnp.asarray(rng.uniform(0, 1, (1, 1, RES, RES, 3)).astype(np.float32))
    init = jax.jit(lambda x: jmodels["float32"].init(
        {"params": jax.random.PRNGKey(0), "slots": jax.random.PRNGKey(1)}, x, decode=True))(video)
    variables = {"params": _perturb(jax.device_get(init["params"]), rng)}
    slots = rng.standard_normal((3, 4, 32)).astype(np.float32)
    scales, refs, got_scales, outs = {}, {}, {}, {}
    for dt in DTYPES:
        scales[dt] = jax_quant.calibrate_decode_scales(jmodels[dt], variables, jnp.asarray(slots))
        refs[dt] = jax.jit(lambda v, s, q, m=jmodels[dt]: m.apply(
            v, s, method="decode", quant_scales=q))(variables, jnp.asarray(slots),
                                                    jnp.asarray(scales[dt]))
        tmodel = setup_model(_with(savi_params(build_exp_params), dt, False,
                                   decode_quant="int8")).eval()
        tmodel.load_state_dict(from_jax_params("savi", variables["params"]))
        assert tmodel.image_decoder.on_conv5 == [True, True]
        with torch.no_grad():
            got_scales[dt] = quant.calibrate_decode_scales(tmodel, _t(slots))
            outs[dt] = tmodel.decode(_t(slots), quant_scales=got_scales[dt])
    check_bf16(got_scales["bfloat16"], got_scales["float32"], scales["bfloat16"],
               scales["float32"], "decode scales", dtype_checked=False)
    for k in ("recons_imgs", "recons", "masks"):
        check_bf16(outs["bfloat16"][k], outs["float32"][k], refs["bfloat16"][k],
                   refs["float32"][k], f"int8 decode {k}")
