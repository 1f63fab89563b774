"""SAVi with the JAX package's other encoders and decoders, whole, against
the JAX package on the CPU at a small size (4 slots of 32, 16 px frames):

* ``resnet``: the ``ResNet`` encoder (ResNet-34, 8 groups; its 2 x 2 output
  grid as ``encoder_params.resolution``) over the stock conv decoder;
* ``bn_up``: a ``ConvEncoder`` with BatchNorm and x2 max-pool downsampling
  (16 -> 4 px) and a ``ConvDecoder`` with BatchNorm and x2 upsampling
  (4 -> 16 px).

The weights are the JAX init plus noise (and running statistics moved off
flax's init), written by the JAX package's ``save_checkpoint`` and read back
by the port's ``from_jax_checkpoint``; the JAX side draws the slot noise.
``decompose`` (slots, attention, reconstructions, masks) in ``eval()``:
rtol 1e-4, atol 2e-5 (three frames of recurrence; float32 on both sides,
sums in other orders). The reference's ``.pth`` importer: an upsampling
decoder through both packages' importers, bit for bit; a BatchNorm SAVi,
which only the port's importer reads; a ``ResNet`` one, which neither reads,
refused with the encoder's name.
"""

import torch_cpu_threads  # noqa: F401  (two torch threads a worker)
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_import_structure import _prefix, _rand, tiny_savi_exp
from test_torch_port_encoders import _perturb, _stats
from test_torch_port_import import save_pth, savi_sd
from test_torch_port_savi import tiny_savi_params
from test_torch_port_train_savi import _jax_noise

from textocvp_tpu.core.config import build_exp_params as jax_build_exp_params
from textocvp_tpu.models import setup_model as jax_setup_model
from textocvp_tpu.train.checkpoints import save_checkpoint as jax_save_checkpoint
from textocvp_tpu.train.torch_import import import_checkpoint as jax_import_checkpoint
from textocvp_tpu_torch.convert import from_jax_params
from textocvp_tpu_torch.core.config import build_exp_params
from textocvp_tpu_torch.models import setup_model
from textocvp_tpu_torch.train.checkpoints import from_jax_checkpoint
from textocvp_tpu_torch.train.torch_import import import_checkpoint

B, T, RES = 2, 3, 16
RTOL, ATOL = 1e-4, 2e-5
VARIANTS = ("resnet", "bn_up")


def variant_params(build, variant: str, res: int = RES):
    """The tiny SAVi of ``test_torch_port_savi.py`` with the variant's
    encoder and decoder."""
    p = tiny_savi_params(build)
    p["dataset"]["img_size"] = [res, res]
    mp = p["model"]["model_params"]
    if variant == "resnet":
        mp["encoder"] = {"encoder_name": "ResNet",
                         "encoder_params": {"resolution": [res // 8] * 2, "num_groups": 8}}
        mp["decoder"]["decoder_params"].update(resolution=[res, res])
    else:
        mp["encoder"]["encoder_params"].update(
            num_channels=[8, 8, 8], resolution=[res // 4] * 2, batch_norm=True,
            downsample_encoder=True, downsample=2)
        mp["decoder"]["decoder_params"].update(
            num_channels=[8, 8, 8], resolution=[res // 4] * 2, batch_norm=True, upsample=2)
    return p


def jax_variables(jmodel, video, rng):
    """The JAX model's variables on ``video`` (under ``jit``), params
    perturbed, running statistics moved."""
    init = jax.jit(lambda x: jmodel.init({"params": jax.random.PRNGKey(0),
                                          "slots": jax.random.PRNGKey(1)}, x, decode=True))(
        jnp.asarray(video))
    out = {"params": _perturb(jax.device_get(init["params"]), rng)}
    if "batch_stats" in init:
        out["batch_stats"] = _stats(jax.device_get(init["batch_stats"]), rng)
    return out


@pytest.fixture(scope="module", params=VARIANTS)
def case(request, tmp_path_factory):
    variant = request.param
    rng = np.random.default_rng(5)
    video = rng.uniform(0, 1, (B, T, RES, RES, 3)).astype(np.float32)
    jmodel = jax_setup_model(variant_params(jax_build_exp_params, variant))
    variables = jax_variables(jmodel, video, rng)
    path = jax_save_checkpoint(tmp_path_factory.mktemp(variant), "ckpt",
                               {**variables, "epoch": 1, "step": 2})
    tmodel = setup_model(variant_params(build_exp_params, variant)).eval()
    tmodel.load_state_dict(from_jax_checkpoint(path, "savi"))  # strict
    return {"variant": variant, "jmodel": jmodel, "variables": variables, "tmodel": tmodel,
            "video": video, "path": path}


def test_checkpoint_carries_params_and_batch_stats(case):
    want = from_jax_params("savi", case["variables"]["params"],
                           batch_stats=case["variables"].get("batch_stats"))
    got = from_jax_checkpoint(case["path"], "savi")
    assert set(got) == set(want) == set(case["tmodel"].state_dict())
    for key, value in want.items():
        assert torch.equal(got[key], value), key
    if case["variant"] == "bn_up":
        stats = [k for k in got if k.endswith("running_var")]
        assert len(stats) == 6  # three encoder and three decoder BatchNorms
        assert not any(torch.equal(got[k], torch.ones_like(got[k])) for k in stats)


def test_decompose_matches_jax(case):
    jmodel, variables, tmodel, video = (case[k] for k in ("jmodel", "variables", "tmodel",
                                                          "video"))
    key = jax.random.PRNGKey(7)
    ref = jax.jit(lambda v, x: jmodel.apply(v, x, decode=True, rngs={"slots": key}))(
        variables, jnp.asarray(video))
    noise = _jax_noise(jmodel, variables, B, key)
    with torch.no_grad():
        out = tmodel(torch.from_numpy(video), noise=torch.from_numpy(noise))
    assert out["recons_imgs"].shape == (B, T, RES, RES, 3)
    grid = (RES // 8) ** 2 if case["variant"] == "resnet" else (RES // 4) ** 2
    assert out["attn_masks"].shape == (B, T, 4, grid)
    for k in ("slot_history", "attn_masks", "recons_imgs", "masks"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), rtol=RTOL, atol=ATOL,
                                   err_msg=k)


def test_an_encoder_grid_other_than_its_resolution_raises():
    params = variant_params(build_exp_params, "resnet")
    params["model"]["model_params"]["encoder"]["encoder_params"]["resolution"] = [RES, RES]
    model = setup_model(params)
    with pytest.raises(ValueError, match=r"\(16, 16\) frames into a \(2, 2\) grid, but "
                                         r"encoder_params.resolution is \[16, 16\]"):
        model.encode(torch.zeros(1, RES, RES, 3))


def _upsampling_exp():
    params = tiny_savi_exp()
    params["model"]["model_params"]["decoder"]["decoder_params"].update(upsample=2)
    return params


def _upsampling_sd(rng):
    """``savi_sd`` with the reference's Upsample module between the two
    decoder blocks: the second block at ``decoder.2``, the final conv at
    ``decoder.3``; every matrix and kernel over the square root of its
    fan-in, so that the activations stay of order 1."""
    sd = {k: (v / np.sqrt(v[0].size) if k.endswith("weight") and v.ndim >= 2 else v)
          for k, v in savi_sd(rng).items()}
    final = {k[len("decoder.decoder.2."):]: sd.pop(k) for k in list(sd)
             if k.startswith("decoder.decoder.2.")}
    for k in [k for k in sd if k.startswith("decoder.decoder.1.")]:
        sd["decoder.decoder.2." + k[len("decoder.decoder.1."):]] = sd.pop(k)
    sd.update(_prefix("decoder.decoder.3", final))
    return sd


def test_an_upsampling_decoder_pth_imports_as_the_jax_importer_does(tmp_path):
    params = _upsampling_exp()
    path = save_pth(tmp_path / "up.pth", _upsampling_sd(np.random.default_rng(5)))
    ours = import_checkpoint(path, params, "decomp")
    ref_state = jax_import_checkpoint(str(path), params, "decomp")
    ref = from_jax_params("savi", ref_state["params"], batch_stats=ref_state["batch_stats"])
    assert list(ours) == list(ref)
    assert all(torch.equal(ours[k], ref[k]) for k in ref)
    model = setup_model(params).eval()
    model.load_state_dict(ours)  # strict: the port builds the upsampling decoder
    jmodel = jax_setup_model(params)
    slots = np.random.default_rng(6).standard_normal((2, 4, 32)).astype(np.float32)
    want = jax.jit(lambda v, s: jmodel.apply(v, s, method="decode"))(
        {"params": ref_state["params"]}, jnp.asarray(slots))
    with torch.no_grad():
        got = model.decode(torch.from_numpy(slots))
    assert got["recons_imgs"].shape == (2, 64, 64, 3)
    np.testing.assert_allclose(got["recons_imgs"].numpy(), np.asarray(want["recons_imgs"]),
                               rtol=1e-4, atol=1e-5)


def test_a_batch_norm_pth_imports_its_statistics(tmp_path):
    """The reference's ConvBlock holds its BatchNorm at ``block.1``; the JAX
    importer reads ``block.0`` only, so its model lacks the BatchNorms."""
    params = tiny_savi_exp()
    params["model"]["model_params"]["encoder"]["encoder_params"]["batch_norm"] = True
    rng = np.random.default_rng(7)
    sd = savi_sd(rng)
    for i in range(2):
        sd.update(_prefix(f"encoder.encoder.{i}.block.1", {
            "weight": _rand(rng, 16), "bias": _rand(rng, 16), "running_mean": _rand(rng, 16),
            "running_var": np.abs(_rand(rng, 16)) + 0.5, "num_batches_tracked": np.array(3)}))
    ours = import_checkpoint(save_pth(tmp_path / "bn.pth", sd), params, "decomp")
    setup_model(params).load_state_dict(ours)  # strict
    for i in range(2):
        for ref_key, key in (("running_mean", "running_mean"), ("running_var", "running_var"),
                             ("weight", "weight")):
            assert np.array_equal(ours[f"image_encoder.blocks.{i}.bn.{key}"].numpy(),
                                  sd[f"encoder.encoder.{i}.block.1.{ref_key}"])


@pytest.mark.parametrize("name", ["ResNet", "ConvEncoder128"])
def test_a_pth_of_another_encoder_raises_naming_it(tmp_path, name):
    params = copy.deepcopy(tiny_savi_exp())
    params["model"]["model_params"]["encoder"] = {"encoder_name": name,
                                                  "encoder_params": {"resolution": [4, 4]}}
    path = save_pth(tmp_path / "x.pth", savi_sd(np.random.default_rng(5)))
    with pytest.raises(KeyError, match="num_channels"):  # the JAX importer's fault
        jax_import_checkpoint(str(path), params, "decomp")
    with pytest.raises(NotImplementedError, match=f"encoder '{name}'"):
        import_checkpoint(path, params, "decomp")
