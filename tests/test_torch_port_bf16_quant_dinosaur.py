"""``tpu.compute_dtype: "bfloat16"`` beside int8 on ExtendedDINOSAUR, on the
CPU against the JAX package on the same weights and video: int8 encode
(the ViT's int8 denses return the compute dtype, as the JAX ``_dense_int8``
casts to ``out_dtype``) and int8 decode (the patch decoder's int8 denses
return float32 and its last dense is cast to the compute dtype, the CNN
head's int8 convs return float32 before the bf16 final conv, as in JAX).

Each side calibrates its own scales on the compute dtype's path and runs
with them; the scales and the outputs are held by ``tests/torch_bf16.py``'s
rule against the JAX bf16 + int8 and float32 + int8 results, as
``test_torch_port_bf16_quant.py`` holds SAVi's. The JAX references run the
Pallas arms in TPU interpret mode (slot attention; the ViT's flash
attention).
"""

import torch_cpu_threads  # noqa: F401  (two torch threads a worker)

import jax
import jax.numpy as jnp
import numpy as np
import torch
from jax.experimental.pallas import tpu as pltpu
from test_torch_port_bf16_quant import DTYPES, _t, _with
from test_torch_port_cliport import IMG, _perturb_stats, tiny_cliport_params
from test_torch_port_savi import _perturb
from torch_bf16 import check_bf16

from textocvp_tpu.core.config import add_predictor_params as jax_add_predictor_params
from textocvp_tpu.core.config import build_exp_params as jax_build_exp_params
from textocvp_tpu.models import quant as jax_quant
from textocvp_tpu.models import setup_model as jax_setup_model
from textocvp_tpu.nn import vit as jax_vit
from textocvp_tpu_torch.convert import from_jax_params
from textocvp_tpu_torch.core.config import add_predictor_params, build_exp_params
from textocvp_tpu_torch.models import quant, setup_model


def test_dinosaur_bf16_int8_encode_and_decode_match_jax(monkeypatch, tmp_path):
    monkeypatch.setattr(jax_vit, "_ATTENTION_IMPL", "flash")
    rng = np.random.default_rng(4)
    video = rng.uniform(0, 1, (2, 2, IMG, IMG, 3)).astype(np.float32)
    modes = dict(decode_quant="int8", encode_quant="int8")
    jparams, _ = tiny_cliport_params(jax_build_exp_params, jax_add_predictor_params, tmp_path)
    tparams, _ = tiny_cliport_params(build_exp_params, add_predictor_params, tmp_path)
    variables = None
    scales, refs, got_scales, outs = {}, {}, {}, {}
    for dt in DTYPES:
        jmodel = jax_setup_model(_with(jparams, dt, True, **modes))
        with pltpu.force_tpu_interpret_mode():
            if variables is None:
                init = jax.jit(lambda x: jmodel.init({"params": jax.random.PRNGKey(0)}, x,
                                                     decode=True))(jnp.asarray(video))
                variables = {"params": _perturb(jax.device_get(init["params"]), rng),
                             "batch_stats": _perturb_stats(jax.device_get(init["batch_stats"]),
                                                           rng)}
            enc = jax_quant.calibrate_encode_scales(jmodel, variables, jnp.asarray(video))
            out = jax.jit(lambda v, x, q: jmodel.apply(v, x, decode=False,
                                                       encode_quant_scales=q))(
                variables, jnp.asarray(video), jnp.asarray(enc))
            slots = out["slot_history"].reshape(-1, *out["slot_history"].shape[2:])
            dec = jax_quant.calibrate_decode_scales(jmodel, variables, slots)
            out = {**out, **jax.jit(lambda v, s, q: jmodel.apply(
                v, s, method="decode", quant_scales=q))(variables, slots, jnp.asarray(dec))}
        scales[dt], refs[dt] = {"encode": enc, "decode": dec}, out
        tmodel = setup_model(_with(tparams, dt, False, **modes)).eval()
        tmodel.load_state_dict(from_jax_params("dinosaur", variables["params"],
                                               batch_stats=variables["batch_stats"]))
        with torch.no_grad():
            enc = quant.calibrate_encode_scales(tmodel, _t(video))
            out = tmodel.decompose(_t(video), encode_quant_scales=enc)
            slots = out["slot_history"].reshape(-1, *out["slot_history"].shape[2:])
            dec = quant.calibrate_decode_scales(tmodel, slots)
            out.update(tmodel.decode(slots, quant_scales=dec))
        got_scales[dt], outs[dt] = {"encode": enc, "decode": dec}, out
    assert outs["bfloat16"]["encoded_img_feats"].dtype == torch.bfloat16
    assert outs["bfloat16"]["recons_feats"].dtype == torch.bfloat16
    for k in ("encode", "decode"):
        check_bf16(got_scales["bfloat16"][k], got_scales["float32"][k], scales["bfloat16"][k],
                   scales["float32"][k], f"{k} scales", dtype_checked=False)
    for k in ("encoded_img_feats", "slot_history", "recons_feats", "masks", "recons_imgs"):
        check_bf16(outs["bfloat16"][k], outs["float32"][k], refs["bfloat16"][k],
                   refs["float32"][k], f"int8 {k}")
