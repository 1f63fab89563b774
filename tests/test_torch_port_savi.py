"""SAVi of the PyTorch port against the JAX package on the CPU, at a small size.

Both packages run the same weights (the JAX init plus noise, carried by
``from_jax_params``) on the same numpy video. The JAX side draws the initial
slots and the port is handed them. Tolerances rtol 1e-4 / atol 1e-5 unless a
test says otherwise: float32 on both sides, sums in different orders.
"""

import torch_cpu_threads  # noqa: F401  (two torch threads a worker)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from textocvp_tpu.core.config import build_exp_params as jax_build_exp_params
from textocvp_tpu.models import setup_model as jax_setup_model
from textocvp_tpu.nn.blocks import TransformerBlock as JaxTransformerBlock
from textocvp_tpu.nn.blocks import build_grid as jax_build_grid
from textocvp_tpu_torch.convert import convert_tree, from_jax_params
from textocvp_tpu_torch.core.config import build_exp_params
from textocvp_tpu_torch.models import setup_model
from textocvp_tpu_torch.nn.blocks import TransformerBlock, build_grid

B, T, RES = 2, 3, 16
RTOL, ATOL = 1e-4, 1e-5


def tiny_savi_params(build):
    p = build("SAVi", "CATER_Easy")
    mp = p["model"]["model_params"]
    mp.update(num_slots=4, slot_dim=32, mlp_hidden=64, mlp_encoder_dim=32)
    mp["encoder"]["encoder_params"].update(num_channels=[8, 8], resolution=[RES, RES])
    mp["decoder"]["decoder_params"].update(num_channels=[8, 8], resolution=[RES, RES])
    mp["transition_module"] = {"model_name": "TransformerBlock", "num_heads": 2, "mlp_size": 64}
    p["dataset"]["img_size"] = [RES, RES]
    return p


def _perturb(tree, rng, scale=0.05):
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x) + scale * rng.standard_normal(np.shape(x)).astype(np.float32),
        tree)


@pytest.fixture(scope="module")
def savi():
    rng = np.random.default_rng(5)
    video = rng.uniform(0, 1, (B, T, RES, RES, 3)).astype(np.float32)
    jmodel = jax_setup_model(tiny_savi_params(jax_build_exp_params))
    variables = jmodel.init({"params": jax.random.PRNGKey(0), "slots": jax.random.PRNGKey(1)},
                            jnp.asarray(video), decode=True)
    variables = {"params": _perturb(jax.device_get(variables["params"]), rng)}
    tmodel = setup_model(tiny_savi_params(build_exp_params)).eval()
    tmodel.load_state_dict(from_jax_params("savi", variables["params"]))
    return jmodel, variables, tmodel, video


def test_build_grid_is_grid_and_one_minus_grid():
    np.testing.assert_array_equal(build_grid((5, 7)), jax_build_grid((5, 7)))
    g = build_grid((3, 3))
    np.testing.assert_allclose(g[..., 2:], 1.0 - g[..., :2])


def test_state_dict_keys_cover_the_jax_tree(savi):
    _, variables, tmodel, _ = savi
    converted = from_jax_params("savi", variables["params"])
    assert set(converted) == set(tmodel.state_dict())
    with pytest.raises(ValueError):
        from_jax_params("resnet", variables["params"])
    with pytest.raises(KeyError, match="patch_decoder"):  # a SAVi is no ExtendedDINOSAUR
        from_jax_params("dinosaur", variables["params"])


def test_encode_matches(savi):
    jmodel, variables, tmodel, video = savi
    frames = video.reshape(B * T, RES, RES, 3)
    ref = jmodel.apply(variables, jnp.asarray(frames), method="encode")
    with torch.no_grad():
        out = tmodel.encode(torch.from_numpy(frames))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)


def test_decompose_matches_with_jax_drawn_slots(savi):
    jmodel, variables, tmodel, video = savi
    key = jax.random.PRNGKey(7)
    ref = jmodel.apply(variables, jnp.asarray(video), decode=False, rngs={"slots": key})
    init = jmodel.apply(variables, B, method=lambda m, b: m.slot_initializer(batch_size=b),
                        rngs={"slots": key})
    with torch.no_grad():
        out = tmodel.decompose(torch.from_numpy(video), initial_slots=torch.from_numpy(np.array(init)))
    assert out["slot_history"].shape == (B, T, 4, 32)
    assert out["attn_masks"].shape == (B, T, 4, RES * RES)
    # three frames of recurrence (slot attention + transition): rtol 1e-4, atol 2e-5
    np.testing.assert_allclose(out["slot_history"].numpy(), np.asarray(ref["slot_history"]),
                               rtol=RTOL, atol=2e-5)
    np.testing.assert_allclose(out["attn_masks"].numpy(), np.asarray(ref["attn_masks"]),
                               rtol=RTOL, atol=2e-5)


def test_learned_random_init_uses_the_generator(savi):
    _, _, tmodel, _ = savi
    draw = lambda seed: tmodel.slot_initializer(3, torch.Generator().manual_seed(seed))
    torch.testing.assert_close(draw(1), draw(1))
    assert not torch.equal(draw(1), draw(2))
    with pytest.raises(ValueError, match="Generator"):
        tmodel.slot_initializer(3)


@pytest.mark.parametrize("fast", [True, False])
def test_decode_matches_jax(savi, fast):
    jmodel, variables, tmodel, _ = savi
    slots = np.random.default_rng(9).standard_normal((3, 4, 32)).astype(np.float32)
    ref = jmodel.apply(variables, jnp.asarray(slots), method="decode")
    with torch.no_grad():
        out = tmodel.decode(torch.from_numpy(slots), fast=fast)
    for key in ("recons_imgs", "recons", "masks"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]), rtol=RTOL, atol=ATOL,
                                   err_msg=key)


def test_fast_decode_equals_naive_broadcast(savi):
    _, _, tmodel, _ = savi
    slots = torch.from_numpy(np.random.default_rng(10).standard_normal((2, 4, 32)).astype(np.float32))
    with torch.no_grad():
        fast, naive = tmodel.decode(slots, fast=True), tmodel.decode(slots, fast=False)
    torch.testing.assert_close(fast["recons_imgs"], naive["recons_imgs"], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("masked", [False, True])
def test_post_norm_transformer_block_matches(masked):
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 5, 16)).astype(np.float32)
    mask = rng.uniform(size=(2, 5, 5)) > 0.3
    mask[..., 0] = True
    mask = mask if masked else None
    jblock = JaxTransformerBlock(embed_dim=16, num_heads=2, mlp_size=32, pre_norm=False)
    params = jblock.init(jax.random.PRNGKey(0), jnp.asarray(x))
    params = {"params": _perturb(jax.device_get(params["params"]), rng)}
    ref = jblock.apply(params, jnp.asarray(x), mask=None if mask is None else jnp.asarray(mask))
    tblock = TransformerBlock(16, 2, 32)
    tblock.load_state_dict(convert_tree(params["params"]))
    with torch.no_grad():
        out = tblock(torch.from_numpy(x), None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)


def test_unported_encoder_raises():
    """Every encoder of the JAX package's list is ported; a name outside it
    raises as it does there."""
    p = tiny_savi_params(build_exp_params)
    p["model"]["model_params"]["encoder"]["encoder_name"] = "ResNet50"
    with pytest.raises(ValueError, match="Unknown encoder_name 'ResNet50'"):
        setup_model(p)
