"""ExtendedDINOSAUR of the PyTorch port against the JAX package on the CPU, at
a small size: the BatchNorm conv block, the bilinear resize, the MLP patch
decoder and the whole model.

Both packages run the same weights (the JAX init plus noise; BatchNorm
running statistics moved off 0 and 1) carried by ``from_jax_params`` on the
same numpy inputs. The JAX side draws the initial slots and the port is
handed them. Tolerances rtol 1e-4 / atol 1e-5 unless a test says otherwise:
float32 on both sides, sums in different orders.

The decoder runs at img 42 with patch 14 (a 3 x 3 grid) and 4 CNN blocks, so
the head grows 3 -> 6 -> 12 -> 24 -> 48 and the bilinear resize shrinks 48 ->
42, as 384 -> 336 does at full width.
"""

import torch_cpu_threads  # noqa: F401  (two torch threads a worker)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from textocvp_tpu.core.config import build_exp_params as jax_build_exp_params
from textocvp_tpu.models import setup_model as jax_setup_model
from textocvp_tpu.models.factory import check_image_reconstruction as jax_check
from textocvp_tpu.nn.blocks import ConvBlock as JaxConvBlock
from textocvp_tpu.nn.blocks import upsample_bilinear as jax_upsample_bilinear
from textocvp_tpu.nn.decoders import MLPPatchDecoder as JaxMLPPatchDecoder
from textocvp_tpu_torch.convert import convert_batch_stats, convert_tree, from_jax_params
from textocvp_tpu_torch.core.config import build_exp_params
from textocvp_tpu_torch.models import setup_model
from textocvp_tpu_torch.models.factory import check_image_reconstruction
from textocvp_tpu_torch.nn.blocks import ConvBlock, upsample_bilinear
from textocvp_tpu_torch.nn.decoders import MLPPatchDecoder

B, T, IMG, S, D = 2, 3, 42, 3, 16
RTOL, ATOL = 1e-4, 1e-5


def _perturb(tree, rng, scale=0.05):
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x) + scale * rng.standard_normal(np.shape(x)).astype(np.float32),
        tree)


def _perturb_stats(stats, rng):
    """Running means N(0, 0.3), running variances U(0.5, 2): no BatchNorm is the identity."""
    def leaf(path, x):
        x = np.asarray(x)
        if path[-1].key == "mean":
            return (0.3 * rng.standard_normal(x.shape)).astype(np.float32)
        return rng.uniform(0.5, 2.0, x.shape).astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, stats)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def test_batchnorm_conv_block_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 6, 6, 5)).astype(np.float32)
    jblock = JaxConvBlock(out_channels=7, kernel_size=3, batch_norm=True)
    variables = jblock.init(jax.random.PRNGKey(0), jnp.asarray(x))
    params = _perturb(jax.device_get(variables["params"]), rng)
    stats = _perturb_stats(jax.device_get(variables["batch_stats"]), rng)
    ref = jblock.apply({"params": params, "batch_stats": stats}, jnp.asarray(x))
    tblock = ConvBlock(5, 7, 3, batch_norm=True).eval()
    tblock.load_state_dict({**convert_tree(params), **convert_batch_stats(stats)})
    with torch.no_grad():
        out = tblock(_nchw(x)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("out_hw", [(42, 42), (112, 112), (5, 7)])
def test_bilinear_resize_matches_jax(out_hw):
    x = np.random.default_rng(2).standard_normal((2, 48, 48, 3)).astype(np.float32)
    ref = jax_upsample_bilinear(jnp.asarray(x), out_hw)
    out = upsample_bilinear(_nchw(x), out_hw).permute(0, 2, 3, 1)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)


DECODER = dict(num_patches=9, in_dim=D, hidden_dim=32, out_dim=25, num_layers=3,
               initial_layer_norm=True, reconstruct_images=True, patch_size=14, img_size=IMG,
               num_layers_cnn=4)


@pytest.fixture(scope="module")
def decoders():
    rng = np.random.default_rng(3)
    slots = rng.standard_normal((B, S, D)).astype(np.float32)
    variables = JaxMLPPatchDecoder(**DECODER).init(jax.random.PRNGKey(0), jnp.asarray(slots))
    variables = {"params": _perturb(jax.device_get(variables["params"]), rng),
                 "batch_stats": _perturb_stats(jax.device_get(variables["batch_stats"]), rng)}
    tdec = MLPPatchDecoder(**DECODER).eval()
    tdec.load_state_dict({**convert_tree(variables["params"]),
                          **convert_batch_stats(variables["batch_stats"])})
    return variables, tdec, slots


@pytest.mark.parametrize("jax_serving_forms", [True, False])
def test_patch_decoder_matches_jax(decoders, jax_serving_forms):
    """The port's plain order against JAX with its two serving-time
    reformulations (fused slot mix, subpixel upconv) on, as it serves, and off."""
    variables, tdec, slots = decoders
    jdec = JaxMLPPatchDecoder(**DECODER, fused_slot_mix=jax_serving_forms,
                              subpixel_upconv=jax_serving_forms)
    ref = jdec.apply(variables, jnp.asarray(slots))
    with torch.no_grad():
        out = tdec(torch.from_numpy(slots))
    assert out["recons_imgs"].shape == (B, IMG, IMG, 3)
    assert out["recons_feats"].shape == (B, 9, 24)
    assert out["masks"].shape == (B, S, 1, 3, 3)
    for key in ("recons_imgs", "recons_feats", "masks"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]), rtol=RTOL, atol=ATOL,
                                   err_msg=key)


def test_cnn_plan_matches_jax():
    full = dict(num_patches=576, in_dim=128, hidden_dim=1024, out_dim=769, patch_size=14,
                img_size=336, num_layers_cnn=4, reconstruct_images=True)
    assert MLPPatchDecoder(**{**full, "reconstruct_images": False}).cnn_plan() == \
        JaxMLPPatchDecoder(**full)._cnn_plan() == \
        [(1024, True), (512, True), (256, True), (128, True)]


def tiny_dinosaur_params(build):
    p = build("ExtendedDINOSAUR", "CLIPort")
    mp = p["model"]["model_params"]
    mp.update(img_size=IMG, num_slots=S, slot_dim=D, mlp_hidden=16, mlp_encoder_dim=32)
    mp["encoder"]["encoder_name"] = "vit_small_patch14_dinov2"
    mp["encoder"]["encoder_params"]["encoder_num_blocks"] = 1
    mp["decoder"]["decoder_params"].update(num_patches=9, in_dim=D, hidden_dim=32, out_dim=385,
                                           num_layers=2)
    mp["transition_module"] = {"model_name": "TransformerBlock", "num_heads": 2, "mlp_size": 16}
    p["dataset"]["img_size"] = [IMG, IMG]
    return p


@pytest.fixture(scope="module")
def dinosaur():
    rng = np.random.default_rng(5)
    video = rng.uniform(0, 1, (B, T, IMG, IMG, 3)).astype(np.float32)
    jmodel = jax_setup_model(tiny_dinosaur_params(jax_build_exp_params))
    variables = jmodel.init({"params": jax.random.PRNGKey(0), "slots": jax.random.PRNGKey(1)},
                            jnp.asarray(video[:1, :1]), decode=True)
    variables = {"params": _perturb(jax.device_get(variables["params"]), rng),
                 "batch_stats": _perturb_stats(jax.device_get(variables["batch_stats"]), rng)}
    tmodel = setup_model(tiny_dinosaur_params(build_exp_params)).eval()
    tmodel.load_state_dict(from_jax_params("dinosaur", variables["params"],
                                           batch_stats=variables["batch_stats"]))
    return jmodel, variables, tmodel, video


def test_config_matches_the_jax_package():
    ours = build_exp_params("ExtendedDINOSAUR", "CLIPort")
    ref = jax_build_exp_params("ExtendedDINOSAUR", "CLIPort")
    for key in ("model", "dataset", "loss"):
        assert ours[key] == ref[key], key


def test_state_dict_keys_cover_the_jax_tree(dinosaur):
    _, variables, tmodel, _ = dinosaur
    converted = from_jax_params("dinosaur", variables["params"],
                                batch_stats=variables["batch_stats"])
    assert set(converted) == set(tmodel.state_dict())
    assert "patch_decoder.cnns.3.bn.running_var" in converted


def test_decompose_matches_with_jax_drawn_slots(dinosaur):
    jmodel, variables, tmodel, video = dinosaur
    key = jax.random.PRNGKey(7)
    ref = jmodel.apply(variables, jnp.asarray(video), decode=False, rngs={"slots": key})
    init = jmodel.apply(variables, B, method=lambda m, b: m.slot_initializer(batch_size=b),
                        rngs={"slots": key})
    with torch.no_grad():
        out = tmodel.decompose(torch.from_numpy(video),
                               initial_slots=torch.from_numpy(np.array(init)))
    assert out["slot_history"].shape == (B, T, S, D)
    assert out["attn_masks"].shape == (B, T, S, 9)
    np.testing.assert_allclose(out["encoded_img_feats"].numpy(),
                               np.asarray(ref["encoded_img_feats"]), rtol=RTOL, atol=ATOL)
    # three frames of recurrence (slot attention + transition): rtol 1e-4, atol 2e-5
    for key in ("slot_history", "attn_masks"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]), rtol=RTOL, atol=2e-5,
                                   err_msg=key)


def test_decode_matches_jax(dinosaur):
    """Against the JAX model as its factory builds it: fused slot mix and
    subpixel upconv on."""
    jmodel, variables, tmodel, _ = dinosaur
    assert jmodel.fused_slot_mix and jmodel.subpixel_upconv
    slots = np.random.default_rng(9).standard_normal((3, S, D)).astype(np.float32)
    ref = jmodel.apply(variables, jnp.asarray(slots), method="decode")
    with torch.no_grad():
        out = tmodel.decode(torch.from_numpy(slots))
    for key in ("recons_imgs", "recons_feats", "masks"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]), rtol=RTOL, atol=ATOL,
                                   err_msg=key)


@pytest.mark.parametrize("change", ["features_only", "conv_encoder", "conv_decoder"])
def test_model_refuses_what_it_cannot_serve(change):
    p = tiny_dinosaur_params(build_exp_params)
    mp = p["model"]["model_params"]
    if change == "features_only":
        mp["decoder"]["decoder_params"]["reconstruct_images"] = False
        for check in (check_image_reconstruction, jax_check):
            with pytest.raises(ValueError, match="reconstruct_images"):
                check(p, purpose="serve")
        return
    if change == "conv_encoder":
        mp["encoder"] = {"encoder_name": "ConvEncoder", "encoder_params": {}}
    else:
        mp["decoder"]["decoder_name"] = "ConvDecoder"
    with pytest.raises(ValueError, match="ExtendedDINOSAUR expects"):
        setup_model(p)


def test_savi_needs_no_image_check():
    check_image_reconstruction(build_exp_params("SAVi", "CATER_Easy"))
