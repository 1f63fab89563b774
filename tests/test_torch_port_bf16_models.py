"""``tpu.compute_dtype: "bfloat16"`` of the PyTorch port on the CPU, whole
models: SAVi (the stock CATER model, the ResNet encoder, and the BatchNorm
downsampling encoder with the BatchNorm upsampling decoder) and
ExtendedDINOSAUR (ViT, slot attention, MLP patch decoder with its BatchNorm
CNN head), against the JAX package in bf16 and in float32 on the same
weights, video and slot noise (drawn on the JAX side).

The JAX references run ``"tpu": {"compute_dtype": ..., "use_pallas": true}``
under ``pltpu.force_tpu_interpret_mode()`` (the Pallas slot attention, whose
port the kernel is) and, for the ViT, its flash arm. The rule is
``tests/torch_bf16.py``'s: within 2 e(JAX bf16, JAX float32) + 2**-8 of the
JAX bf16 output, within 1.5 e(JAX bf16, JAX float32) + 2**-8 of the JAX
float32 one, bfloat16, and more than 1e-4 from the port's float32 output.
"""

import torch_cpu_threads  # noqa: F401  (two torch threads a worker)
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from test_torch_port_cliport import IMG, _perturb_stats, tiny_cliport_params
from test_torch_port_savi import tiny_savi_params
from test_torch_port_savi_variants import jax_variables, variant_params
from test_torch_port_train_savi import _jax_noise
from torch_bf16 import check_bf16

from textocvp_tpu.core.config import add_predictor_params as jax_add_predictor_params
from textocvp_tpu.core.config import build_exp_params as jax_build_exp_params
from textocvp_tpu.models import setup_model as jax_setup_model
from textocvp_tpu.nn import vit as jax_vit
from textocvp_tpu_torch.convert import from_jax_params
from textocvp_tpu_torch.core.config import add_predictor_params, build_exp_params
from textocvp_tpu_torch.models import setup_model

B, T, RES = 2, 3, 16
DTYPES = ("bfloat16", "float32")


def with_dtype(params: dict, dtype: str, jax_side: bool) -> dict:
    """``params`` computing in ``dtype``; the JAX side through its Pallas arms."""
    params = copy.deepcopy(params)
    params["tpu"] = {"compute_dtype": dtype, **({"use_pallas": True} if jax_side else {})}
    return params


def savi_params(build, variant):
    return tiny_savi_params(build) if variant == "stock" else variant_params(build, variant)


@pytest.mark.parametrize("variant", ["stock", "resnet", "bn_up"])
def test_savi_bf16_matches_jax(variant):
    rng = np.random.default_rng(5)
    video = rng.uniform(0, 1, (B, T, RES, RES, 3)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    refs, outs, variables = {}, {}, None
    for dt in DTYPES:
        jmodel = jax_setup_model(with_dtype(savi_params(jax_build_exp_params, variant), dt, True))
        with pltpu.force_tpu_interpret_mode():
            if variables is None:
                variables = jax_variables(jmodel, video, rng)
            refs[dt] = jax.jit(lambda v, x: jmodel.apply(v, x, decode=True, rngs={"slots": key}))(
                variables, jnp.asarray(video))
        noise = _jax_noise(jmodel, variables, B, key)
        tmodel = setup_model(with_dtype(savi_params(build_exp_params, variant), dt, False)).eval()
        tmodel.load_state_dict(from_jax_params("savi", variables["params"],
                                               batch_stats=variables.get("batch_stats")))
        with torch.no_grad():
            outs[dt] = tmodel(torch.from_numpy(video), noise=torch.from_numpy(np.array(noise)))
    for k in ("slot_history", "attn_masks", "recons_imgs", "masks"):
        check_bf16(outs["bfloat16"][k], outs["float32"][k], refs["bfloat16"][k],
                   refs["float32"][k], f"{variant} {k}")


def test_extended_dinosaur_bf16_matches_jax(monkeypatch, tmp_path):
    monkeypatch.setattr(jax_vit, "_ATTENTION_IMPL", "flash")
    rng = np.random.default_rng(9)
    video = rng.uniform(0, 1, (B, 2, IMG, IMG, 3)).astype(np.float32)
    refs, outs, variables = {}, {}, None
    for dt in DTYPES:
        jparams, _ = tiny_cliport_params(jax_build_exp_params, jax_add_predictor_params, tmp_path)
        jmodel = jax_setup_model(with_dtype(jparams, dt, True))
        with pltpu.force_tpu_interpret_mode():
            if variables is None:
                init = jax.jit(lambda x: jmodel.init({"params": jax.random.PRNGKey(0)}, x,
                                                     decode=True))(jnp.asarray(video))
                params = jax.tree_util.tree_map(
                    lambda x: np.asarray(x) + 0.05 * rng.standard_normal(np.shape(x)).astype(
                        np.float32), jax.device_get(init["params"]))
                variables = {"params": params,
                             "batch_stats": _perturb_stats(jax.device_get(init["batch_stats"]),
                                                           rng)}
            refs[dt] = jax.jit(lambda v, x: jmodel.apply(v, x, decode=True))(
                variables, jnp.asarray(video))
        tparams, _ = tiny_cliport_params(build_exp_params, add_predictor_params, tmp_path)
        tmodel = setup_model(with_dtype(tparams, dt, False)).eval()
        tmodel.load_state_dict(from_jax_params("dinosaur", variables["params"],
                                               batch_stats=variables["batch_stats"]))
        with torch.no_grad():
            outs[dt] = tmodel(torch.from_numpy(video))
    for k in ("encoded_img_feats", "slot_history", "attn_masks", "recons_feats", "masks",
              "recons_imgs"):
        check_bf16(outs["bfloat16"][k], outs["float32"][k], refs["bfloat16"][k],
                   refs["float32"][k], k)
