"""Tensor parallelism of ExtendedDINOSAUR in the port
(``parallel/partitioning.py::shard_decomp_``) against the JAX package's
``shard_decomp_variables``, on the tiny DINOSAUR of its own test
(``tests/test_partitioning.py::_tiny_dinosaur_params``: a 1-block ViT-S at
28 px, a 2-layer patch decoder, a 2-head transition block):

* (a) the weights the port shards, mapped by name (``convert.py``), are the
  kernels ``predictor_param_specs`` marks and ``_divisible`` keeps on a
  model axis of 2, but for ``slot_attention.mlp``, which stays whole; SAVi
  stays replicated in both packages;
* (b) the ``model=2`` forward over 2 gloo ranks (``recons_imgs``,
  ``recons_feats``) against the JAX forward on a ``data=1, model=2`` mesh,
  at the JAX test's limits (rtol and atol 2e-5); the ViT runs at 3 of its 6
  heads a rank, and ``qkv`` holds that rank's heads of q, of k and of v;
* (c) under tensor parallelism the weights the slot-attention kernel reads
  (``SlotAttention.iteration_params``) are the whole ones, and
  ``gather_state_dict`` gives back every weight bit for bit;
* int8 (``tpu.encode_quant`` / ``decode_quant``): under ``model=2`` the
  scales are one process's bit for bit and the int8 features and decode
  within 1e-5 of its largest value of one process's int8; under ``data=2``
  each rank calibrates on its rows and the scales are those of one process
  calibrated on the global batch, bit for bit.

The slot noise is drawn on the JAX side and handed to the port."""

import torch_cpu_threads  # noqa: F401  (two torch threads a worker)
import json

import jax
import numpy as np
import pytest
import torch
from test_partitioning import _tiny_dinosaur_params
from test_torch_port_cliport import _perturb, _perturb_stats
from test_torch_port_mesh import run_ranks
from test_torch_port_train_savi import _jax_noise

from textocvp_tpu.models import setup_model as jax_setup_model
from textocvp_tpu.parallel.mesh import get_mesh, replicated_sharding
from textocvp_tpu.parallel.partitioning import _divisible
from textocvp_tpu.parallel.partitioning import decomp_tp_enabled as jax_decomp_tp_enabled
from textocvp_tpu.parallel.partitioning import predictor_param_specs, shard_decomp_variables
from textocvp_tpu_torch.convert import convert_tree, from_jax_params
from textocvp_tpu_torch.core.config import build_exp_params
from textocvp_tpu_torch.models import setup_model
from textocvp_tpu_torch.models.quant import calibrate_decode_scales, calibrate_encode_scales
from textocvp_tpu_torch.parallel.partitioning import decomp_tp_enabled

B, T, RES = 2, 2, 28
WHOLE = {"slot_attention.mlp.layers.0.weight", "slot_attention.mlp.layers.1.weight"}


def tiny_params(build):
    """``_tiny_dinosaur_params`` through ``build`` (either package's)."""
    params = build("ExtendedDINOSAUR", "Synthetic")
    mp = params["model"]["model_params"]
    mp.update(img_size=RES, num_slots=3, slot_dim=16, mlp_hidden=16, mlp_encoder_dim=384)
    mp["encoder"] = {"encoder_name": "vit_small_patch14_dinov2",
                     "encoder_params": {"encoder_num_blocks": 1}}
    mp["decoder"]["decoder_params"].update(
        num_patches=4, in_dim=16, hidden_dim=32, out_dim=385, num_layers=2, patch_size=14,
        num_layers_cnn=2, reconstruct_images=True)
    mp["transition_module"] = {"model_name": "TransformerBlock", "num_heads": 2, "mlp_size": 16}
    params["dataset"].update(img_size=[RES, RES], num_frames=2)
    return params


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """The JAX model, its perturbed variables, the JAX sharded forward, and
    the ranks' runs at ``model=2`` and at ``data=2``."""
    tmp = tmp_path_factory.mktemp("dist_decomp")
    jp = _tiny_dinosaur_params()
    ours = tiny_params(build_exp_params)
    assert ours == {k: v for k, v in jp.items() if k != "tpu"}
    jmodel = jax_setup_model(jp)
    rng = np.random.default_rng(16)
    video = rng.uniform(0, 1, (B, T, RES, RES, 3)).astype(np.float32)
    variables = jax.jit(lambda x: jmodel.init({"params": jax.random.PRNGKey(1),
                                               "slots": jax.random.PRNGKey(2)}, x, decode=True,
                                              train=False))(video)
    params = _perturb(jax.device_get(variables["params"]), rng)
    stats = _perturb_stats(jax.device_get(variables["batch_stats"]), rng)
    key = jax.random.PRNGKey(3)
    noise = _jax_noise(jmodel, {"params": params}, B, key)
    mesh = get_mesh(data=1, model=2, devices=jax.devices()[:2])
    sharded = shard_decomp_variables(
        jax.device_put({"params": params, "batch_stats": stats}, replicated_sharding(mesh)), mesh)
    assert not sharded["params"]["image_encoder"]["block_0"]["qkv"]["kernel"] \
        .sharding.is_fully_replicated
    with mesh:
        out = jax.jit(lambda v, x: jmodel.apply(v, x, decode=True, train=False,
                                                rngs={"slots": key}))(sharded, video)
    weights = from_jax_params("dinosaur", params, batch_stats=stats)
    np.savez(tmp / "weights.npz", **{k: v.numpy() for k, v in weights.items()})
    (tmp / "params.json").write_text(json.dumps(ours))
    slots = rng.standard_normal((4, 3, 16)).astype(np.float32)
    np.savez(tmp / "inputs.npz", video=video, noise=noise, slots=slots)
    job = {"job": "decomp_tp", "params": str(tmp / "params.json"),
           "weights": str(tmp / "weights.npz"), "inputs": str(tmp / "inputs.npz")}
    model2, data2 = run_ranks(tmp / "ranks", [{**job, "data": 1, "model": 2},
                                              {**job, "data": 2, "model": 1}], 2)
    return {"params": params, "weights": weights, "video": video, "slots": slots,
            "jax": {k: np.asarray(out[k]) for k in ("recons_imgs", "recons_feats")},
            "model2": model2, "data2": data2}


def _single_process(case):
    model = setup_model(tiny_params(build_exp_params))
    model.load_state_dict(case["weights"])
    return model.eval()


def test_sharded_weights_are_the_jax_specs_but_slot_attention_mlp(case):
    params = case["params"]
    specs = predictor_param_specs(params)

    def marked(tree, spec):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                sub = marked(v, spec[k])
                if sub:
                    out[k] = sub
            elif tuple(spec[k]) != () and _divisible(spec[k], v.shape, 2):
                out[k] = np.zeros(v.shape, np.float32)
        return out

    want = set(convert_tree(marked(params, specs)))
    assert WHOLE <= want  # the one departure is a real one
    assert {"image_encoder.blocks.0.qkv.weight", "patch_decoder.mlps.1.weight",
            "transition.attn.out.weight", "transition.mlp.layers.0.weight"} <= want
    for out in case["model2"]:
        names = set(out["sharded"])
        full = case["weights"]
        got = {n for n in names if n.endswith("weight") and full[n].dim() == 2}
        assert got == want - WHOLE
        assert not names & WHOLE
    assert not case["data2"][0]["sharded"].size  # a model axis of 1 shards nothing
    for build, enabled in ((build_exp_params, decomp_tp_enabled), (None, jax_decomp_tp_enabled)):
        p = _tiny_dinosaur_params() if build is None else tiny_params(build)
        assert enabled(p)
        savi = {"model": {"model_params": {"encoder": {"encoder_name": "ConvEncoder"}}}}
        assert not enabled(savi)
        assert not enabled(build_exp_params("SAVi", "CATER_Easy"))


def test_model2_forward_matches_the_jax_sharded_forward(case):
    qkv = case["weights"]["image_encoder.blocks.0.qkv.weight"].numpy()  # (3d, d), [q; k; v]
    d = qkv.shape[1]
    for r, out in enumerate(case["model2"]):
        assert int(out["heads"]) == 3  # 6 heads over 2 ranks
        want = np.concatenate([qkv[j * d + r * d // 2:j * d + (r + 1) * d // 2]
                               for j in range(3)])
        np.testing.assert_array_equal(out["qkv"], want)
        for k, ref in case["jax"].items():
            np.testing.assert_allclose(out[f"out/{k}"], ref, rtol=2e-5, atol=2e-5, err_msg=k)


def test_slot_attention_kernel_weights_stay_whole_and_the_state_gathers(case):
    model = _single_process(case)
    whole = model.slot_attention.iteration_params()
    state = model.state_dict()
    for out in case["model2"]:
        for k, v in whole.items():
            np.testing.assert_array_equal(out[f"kernel/{k}"], v.detach().numpy(), err_msg=k)
        assert {k[5:] for k in out if k.startswith("full/")} == set(state)
        for k, v in state.items():
            np.testing.assert_array_equal(out[f"full/{k}"], v.numpy(), err_msg=k)


def _int8_reference(case, video, slots):
    model = _single_process(case)
    with torch.no_grad():
        enc = calibrate_encode_scales(model, video)
        dec = calibrate_decode_scales(model, slots)
        dec8 = model.decode(slots, quant_scales=dec)
        return {"enc_scales": enc, "dec_scales": dec,
                "feats8": model.frozen_features(video, enc),
                "imgs8": dec8["recons_imgs"], "recons_feats8": dec8["recons_feats"]}


def test_int8_under_model2_is_one_process_int8(case):
    ref = _int8_reference(case, torch.from_numpy(case["video"]), torch.from_numpy(case["slots"]))
    for out in case["model2"]:
        for k in ("enc_scales", "dec_scales"):
            np.testing.assert_array_equal(out[k], ref[k].numpy(), err_msg=k)
        for k in ("feats8", "imgs8", "recons_feats8"):
            want = ref[k].numpy()
            assert float(np.abs(out[k] - want).max()) <= 1e-5 * float(np.abs(want).max()), k


def test_int8_scales_under_data2_are_the_global_batch_ones(case):
    ref = _int8_reference(case, torch.from_numpy(case["video"]), torch.from_numpy(case["slots"]))
    owns = []
    for r, out in enumerate(case["data2"]):
        for k in ("enc_scales", "dec_scales"):
            np.testing.assert_array_equal(out[k], ref[k].numpy(), err_msg=k)
        owns.append(_int8_reference(case, torch.from_numpy(case["video"][r:r + 1]),
                                    torch.from_numpy(case["slots"][2 * r:2 * r + 2])))
    for k in ("enc_scales", "dec_scales"):  # a rank's own rows alone would give other scales
        assert not all(np.array_equal(own[k].numpy(), ref[k].numpy()) for own in owns), k
