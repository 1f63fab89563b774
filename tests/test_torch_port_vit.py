"""The ViT of the PyTorch port against the JAX package on the CPU, at a small size.

The attention core's plain version (what a CPU tensor runs) is held against
the JAX ``_attention`` in its XLA arm and in its Pallas flash arm, run in
interpret mode as ``tests/test_vit_flash_attention.py`` runs it, to atol and
rtol 2e-5, the JAX package's own flash-vs-XLA tolerance. The encoder runs
the same weights (the JAX init plus noise, carried by ``from_jax_params``'s
tree conversion) on the same numpy frames; tolerance rtol 1e-4 / atol 1e-5,
float32 on both sides with sums in other orders.
"""

import torch_cpu_threads  # noqa: F401  (two torch threads a worker)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import textocvp_tpu.nn.vit as jax_vit
from textocvp_tpu.nn.encoders import get_encoder as jax_get_encoder
from textocvp_tpu_torch.convert import convert_tree
from textocvp_tpu_torch.nn import vit
from textocvp_tpu_torch.nn.encoders import get_encoder
from textocvp_tpu_torch.ops import vit_attention as va

RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture
def jax_attention_impl():
    """Set the JAX module's attention arm for one test and restore it after."""
    prev = jax_vit._ATTENTION_IMPL

    def set_impl(impl):
        jax_vit._ATTENTION_IMPL = impl

    yield set_impl
    jax_vit._ATTENTION_IMPL = prev


def _perturb(tree, rng, scale=0.05):
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x) + scale * rng.standard_normal(np.shape(x)).astype(np.float32),
        tree)


@pytest.mark.parametrize("n", [128, 150])
@pytest.mark.parametrize("arm", ["xla", "flash_interpret"])
def test_plain_attention_matches_jax(jax_attention_impl, n, arm):
    rng = np.random.default_rng(n)
    b, h, dh = 2, 4, 64
    q, k, v = (rng.standard_normal((b, h, n, dh)).astype(np.float32) for _ in range(3))
    if arm == "xla":
        jax_attention_impl("xla")
        ref = jax_vit._attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), dh ** -0.5,
                                 jnp.float32)
    else:
        jax_attention_impl("flash")
        with pltpu.force_tpu_interpret_mode():
            ref = jax_vit._attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                     dh ** -0.5, jnp.float32)
    before = va.vit_attention_cuda.launches
    out = va.vit_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                           dh ** -0.5)
    assert va.vit_attention_cuda.launches == before  # a CPU tensor launches nothing
    assert out.shape == (b, h, n, dh)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-5, atol=2e-5)


def test_cuda_wrapper_refuses_cpu_tensors(monkeypatch):
    """The CUDA entry point never computes on a CPU tensor: it raises."""

    class _Lib:  # stands in for the built library, which needs nvcc
        va_head_dim = staticmethod(lambda: 64)

    monkeypatch.setattr(va, "load_library", lambda: _Lib)
    q = torch.zeros((1, 2, 5, 64))
    with pytest.raises(ValueError, match="CUDA device"):
        va.vit_attention_cuda(q, q, q, 0.125)


def test_configs_match_the_jax_package():
    assert vit.VIT_CONFIGS == jax_vit.VIT_CONFIGS
    assert vit.IMAGENET_MEAN == jax_vit.IMAGENET_MEAN


@pytest.fixture(scope="module")
def encoders():
    rng = np.random.default_rng(21)
    frames = rng.uniform(0, 1, (2, 56, 56, 3)).astype(np.float32)
    # DINOv2's layout (patch 14, layerscale) at 64 wide with 4 heads and 2 blocks
    jmod = jax_vit.ViTEncoder(img_size=56, patch_size=14, embed_dim=64, depth=2, num_heads=4,
                              layerscale_init=1e-5)
    params = jmod.init(jax.random.PRNGKey(0), jnp.asarray(frames))
    params = {"params": _perturb(jax.device_get(params["params"]), rng)}
    tmod = vit.ViTEncoder(img_size=56, patch_size=14, embed_dim=64, depth=2, num_heads=4,
                          layerscale_init=1e-5)
    tmod.load_state_dict(convert_tree(params["params"]))
    return jmod, params, tmod.eval(), frames


def test_encoder_state_dict_covers_the_jax_tree(encoders):
    _, params, tmod, _ = encoders
    assert set(convert_tree(params["params"])) == set(tmod.state_dict())


def test_encoder_matches_jax(encoders, jax_attention_impl):
    jmod, params, tmod, frames = encoders
    jax_attention_impl("xla")
    ref = jmod.apply(params, jnp.asarray(frames))
    with torch.no_grad():
        out = tmod(torch.from_numpy(frames))
    # (2, 16 patches, 64): the class token is stripped, no final norm
    assert out.shape == ref.shape == (2, 16, 64)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)


def test_encoder_normalizes_with_the_mean_as_std(encoders):
    """Frames equal to the ImageNet mean normalize to 0 and frames of twice
    the mean to 1 in every channel: std := mean."""
    _, _, tmod, _ = encoders
    seen = []
    hook = tmod.patch_embed.register_forward_hook(lambda m, i, o: seen.append(i[0]))
    mean = torch.tensor(vit.IMAGENET_MEAN)
    with torch.no_grad():
        tmod(torch.stack([mean.expand(56, 56, 3), 2 * mean.expand(56, 56, 3)]))
    hook.remove()
    torch.testing.assert_close(seen[0][0], torch.zeros(3, 56, 56))
    torch.testing.assert_close(seen[0][1], torch.ones(3, 56, 56))


def test_gelu_is_exact():
    block = vit.ViTBlock(8, 2)
    fc1_out, fc2_in = [], []
    block.fc1.register_forward_hook(lambda m, i, o: fc1_out.append(o))
    block.fc2.register_forward_hook(lambda m, i, o: fc2_in.append(i[0]))
    with torch.no_grad():
        block(3 * torch.randn(1, 5, 8, generator=torch.Generator().manual_seed(0)))
    pre = fc1_out[0]
    torch.testing.assert_close(fc2_in[0], 0.5 * pre * (1 + torch.erf(pre / 2 ** 0.5)),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("num_blocks_key", ["encoder_num_blocks", "num_blocks"])
def test_get_encoder_builds_the_jax_vit(num_blocks_key):
    cfg = {"encoder_name": "vit_base_patch14_dinov2",
           "encoder_params": {num_blocks_key: 3, "img_size": 336}}
    mod, feats = get_encoder(cfg)
    jmod, jfeats = jax_get_encoder(cfg)
    assert feats == jfeats == 768
    assert len(mod.blocks) == jmod.depth == 3
    assert mod.pos_embed.shape == (1, 577, 768)
    assert mod.blocks[0].num_heads == jmod.num_heads == 12
    torch.testing.assert_close(mod.blocks[0].ls1_gamma, torch.full((768,), 1e-5))


def test_get_encoder_needs_img_size():
    with pytest.raises(KeyError, match="img_size"):
        get_encoder({"encoder_name": "vit_base_patch14_dinov2", "encoder_params": {}})
