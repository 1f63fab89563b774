"""The port's other image encoders and the library blocks no factory
reaches, against the JAX package's on the CPU, at small sizes.

* ``ResNet34SAVi`` at (2, 16, 16, 3) with 8 and 32 groups, ``ConvEncoder128``
  at 32 px, ``SimpleConvEncoder`` with BatchNorm and max-pool downsampling
  (``train()``, with the running statistics it moves, and ``eval()``): the
  JAX init plus noise carried by ``convert.py``, the same numpy input.
  float32 on both sides, sums in other orders (the ResNet's 36 convs deep):
  rtol 1e-4, atol 1e-5 of outputs of order 1 to 10; the running statistics
  rtol 1e-5, atol 1e-6.
* ``ConvTransposeBlock`` (both arms, BatchNorm and x2 upsampling) and
  ``LearnedPositionalEncoding1D`` (an offset, deterministic): the same
  limits.
* ``tpu.compute_dtype``: "bfloat16" builds both models (parameters
  float32, compute bf16) and the 02 trainer; any other name but
  "float32" raises instead of computing float32.
"""

import torch_cpu_threads  # noqa: F401  (two torch threads a worker)

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from textocvp_tpu.nn import blocks as jblocks
from textocvp_tpu.nn import encoders as jencoders
from textocvp_tpu_torch.convert import convert_batch_stats, convert_tree
from textocvp_tpu_torch.core.config import build_exp_params
from textocvp_tpu_torch.models import setup_model, setup_predictor
from textocvp_tpu_torch.nn import blocks, encoders

RTOL, ATOL = 1e-4, 1e-5


def _perturb(tree, rng, scale=0.05):
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x) + scale * rng.standard_normal(np.shape(x)).astype(np.float32),
        tree)


def _stats(tree, rng):
    """Running statistics away from flax's (0, 1) init: means of order 0.1,
    variances in [0.5, 1.5]."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _stats(v, rng)
        elif k == "mean":
            out[k] = (0.1 * rng.standard_normal(np.shape(v))).astype(np.float32)
        else:
            out[k] = rng.uniform(0.5, 1.5, np.shape(v)).astype(np.float32)
    return out


def _jax_variables(jmod, x, rng):
    """The JAX module's init on ``x``, its params perturbed and its
    ``batch_stats`` (if any) moved off the init."""
    variables = jax.jit(jmod.init)(jax.random.PRNGKey(0), jnp.asarray(x))
    out = {"params": _perturb(jax.device_get(variables["params"]), rng)}
    if "batch_stats" in variables:
        out["batch_stats"] = _stats(jax.device_get(variables["batch_stats"]), rng)
    return out


def _load(tmod, variables):
    sd = convert_tree(variables["params"])
    if "batch_stats" in variables:
        sd.update(convert_batch_stats(variables["batch_stats"]))
    tmod.load_state_dict(sd)  # strict: every leaf of both sides mapped
    return tmod


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def _nhwc(y):
    return y.detach().permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("groups", [8, 32])
def test_resnet34_savi_matches_jax(groups):
    rng = np.random.default_rng(groups)
    x = rng.uniform(0, 1, (2, 16, 16, 3)).astype(np.float32)
    cfg = {"encoder_name": "ResNet", "encoder_params": {"num_groups": groups}}
    jmod, jfeats = jencoders.get_encoder(cfg)
    tmod, tfeats = encoders.get_encoder(cfg, 3)
    assert jfeats == tfeats == 512
    variables = _jax_variables(jmod, x, rng)
    _load(tmod, variables)
    assert sum(isinstance(m, torch.nn.Conv2d) for m in tmod.modules()) == 2 * 16 + 1 + 3
    ref = jax.jit(jmod.apply)(variables, jnp.asarray(x))
    with torch.no_grad():
        out = _nhwc(tmod.train()(_nchw(x)))  # GroupNorm: train() and eval() alike
    assert out.shape == (2, 2, 2, 512)
    np.testing.assert_allclose(out, np.asarray(ref), rtol=RTOL, atol=ATOL)


def test_conv_encoder128_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)
    jmod, _ = jencoders.get_encoder({"encoder_name": "ConvEncoder128"})
    tmod, feats = encoders.get_encoder({"encoder_name": "ConvEncoder128"}, 3)
    variables = _jax_variables(jmod, x, rng)
    _load(tmod, variables)
    ref = np.asarray(jax.jit(jmod.apply)(variables, jnp.asarray(x)))
    with torch.no_grad():
        out = _nhwc(tmod(_nchw(x)))
    assert out.shape == (2, 16, 16, 64) and feats == 64
    assert (ref < 0).any()  # the last block has no ReLU
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_bn_downsampling_conv_encoder_matches_jax(train):
    rng = np.random.default_rng(2)
    x = rng.uniform(0, 1, (3, 17, 16, 3)).astype(np.float32)  # 17: the pool drops a row
    cfg = {"encoder_name": "ConvEncoder",
           "encoder_params": {"num_channels": [8, 12, 6], "kernel_size": 3, "batch_norm": True,
                              "downsample_encoder": True, "downsample": 2}}
    jmod, _ = jencoders.get_encoder(cfg)
    tmod, feats = encoders.get_encoder(cfg, 3)
    variables = _jax_variables(jmod, x, rng)
    _load(tmod, variables).train(train)
    if train:
        ref, moved = jax.jit(lambda v, x: jmod.apply(v, x, train=True, mutable=["batch_stats"]))(
            variables, jnp.asarray(x))
    else:
        ref = jax.jit(lambda v, x: jmod.apply(v, x))(variables, jnp.asarray(x))
    with torch.no_grad():
        out = _nhwc(tmod(_nchw(x)))
    assert out.shape == (3, 4, 4, 6) and feats == 6
    np.testing.assert_allclose(out, np.asarray(ref), rtol=RTOL, atol=ATOL)
    if train:
        want = convert_batch_stats(jax.device_get(moved["batch_stats"]))
        state = tmod.state_dict()
        for key, value in want.items():
            if not key.endswith("num_batches_tracked"):
                np.testing.assert_allclose(state[key].numpy(), value.numpy(), rtol=1e-5,
                                           atol=1e-6, err_msg=key)


def test_get_encoder_has_the_jax_names():
    assert encoders.ENCODERS == jencoders.ENCODERS
    with pytest.raises(ValueError, match="Unknown encoder_name 'ResNet50'"):
        encoders.get_encoder({"encoder_name": "ResNet50"})
    mod, _ = encoders.get_encoder({"encoder_name": "ConvEncoder",
                                   "encoder_params": {"num_channels": [4]}}, 5)
    assert mod.blocks[0].conv.in_channels == 5  # in_channels reaches the first conv
    mod, _ = encoders.get_encoder({"encoder_name": "ResNet"}, 4)
    assert mod.conv.in_channels == 4 and mod.norm.num_groups == 32


@pytest.mark.parametrize("transpose, train", [(True, True), (False, False)],
                         ids=["transpose-train", "conv-eval"])
def test_conv_transpose_block_matches_jax(transpose, train):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 6, 5, 4)).astype(np.float32)
    jmod = jblocks.ConvTransposeBlock(out_channels=7, kernel_size=3, stride=2, batch_norm=True,
                                      upsample=2, conv_transpose_2d=transpose)
    variables = _jax_variables(jmod, x, rng)
    tmod = blocks.ConvTransposeBlock(4, 7, 3, stride=2, batch_norm=True, upsample=2,
                                     conv_transpose_2d=transpose)
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    if transpose:  # flax's kernel, applied unflipped; torch flips its weight in space
        kernel = params["Conv_0"]["kernel"]
        sd = convert_tree({k: v for k, v in params.items() if k != "Conv_0"})
        sd["conv.weight"] = torch.from_numpy(
            np.ascontiguousarray(kernel[::-1, ::-1].transpose(2, 3, 0, 1)))
        sd["conv.bias"] = torch.from_numpy(params["Conv_0"]["bias"])
        sd.update(convert_batch_stats(variables["batch_stats"]))
        tmod.load_state_dict(sd)
    else:
        _load(tmod, variables)
    tmod.train(train)
    ref = jax.jit(lambda v, x: jmod.apply(v, x, train=train, mutable=["batch_stats"])[0])(
        variables, jnp.asarray(x))
    with torch.no_grad():
        out = _nhwc(tmod(_nchw(x)))
    # transposed: (6 - 1) * 2 + 3 - 2 = 11 rows; conv: (6 + 2 - 3) // 2 + 1 = 3; then x2
    want = (2, 22, 18, 7) if transpose else (2, 6, 6, 7)
    assert out.shape == want == np.asarray(ref).shape
    np.testing.assert_allclose(out, np.asarray(ref), rtol=RTOL, atol=ATOL)


def test_learned_positional_encoding_1d_matches_jax():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 5, 6)).astype(np.float32)
    jmod = jblocks.LearnedPositionalEncoding1D(max_len=12, token_dim=6)
    variables = jax.jit(lambda x: jmod.init(jax.random.PRNGKey(0), x))(jnp.asarray(x))
    pe = np.asarray(variables["params"]["pe"])
    assert np.abs(pe).max() <= 2.0  # flax's normal truncated at 2 sigma
    ref = jax.jit(lambda v, x: jmod.apply(v, x, offset=3))(variables, jnp.asarray(x))
    tmod = blocks.LearnedPositionalEncoding1D(12, 6)
    assert float(tmod.pe.detach().abs().max()) <= 2.0
    tmod.load_state_dict(convert_tree(jax.device_get(variables["params"])))
    with torch.no_grad():
        out = tmod(torch.from_numpy(x), offset=3)
        dropped = tmod(torch.from_numpy(x), offset=3, deterministic=False,
                       generator=torch.Generator().manual_seed(0))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)
    kept = dropped != 0
    assert 0 < float(kept.float().mean()) < 1
    torch.testing.assert_close(dropped[kept], (out / 0.9)[kept])
    with pytest.raises(ValueError, match="outside the table"):
        tmod(torch.from_numpy(x), offset=8)


def test_group_norm_is_flax_with_its_epsilon():
    """A group whose variance is of order 1e-6: torch's default epsilon
    (1e-5) would shrink it by 3x; flax's 1e-6 by 1.4x."""
    rng = np.random.default_rng(5)
    x = (1e-3 * rng.standard_normal((2, 4, 3, 8))).astype(np.float32)
    jnorm = flax.linen.GroupNorm(num_groups=4)
    variables = jax.jit(jnorm.init)(jax.random.PRNGKey(0), jnp.asarray(x))
    variables = {"params": _perturb(jax.device_get(variables["params"]), rng, 0.3)}
    ref = jax.jit(jnorm.apply)(variables, jnp.asarray(x))
    tnorm = blocks.GroupNorm(4, 8)
    tnorm.load_state_dict(convert_tree(variables["params"]))
    with torch.no_grad():
        out = _nhwc(tnorm(_nchw(x)))
    np.testing.assert_allclose(out, np.asarray(ref), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_compute_dtype_other_than_float32_raises(dtype, tmp_path):
    """float16 raises where the models are built. bfloat16 builds them, and
    the 02 trainer takes it (``test_torch_port_bf16_train*.py`` hold its
    steps)."""
    from textocvp_tpu_torch.core.config import add_predictor_params
    from textocvp_tpu_torch.core.experiment import Experiment
    from textocvp_tpu_torch.train.trainer import DecompTrainer

    params = build_exp_params("SAVi", "CATER_Easy")
    params["tpu"] = {"compute_dtype": "float32"}
    setup_model(params)  # float32 stays allowed
    params["tpu"]["compute_dtype"] = dtype
    if dtype == "bfloat16":
        model = setup_model(params)
        predictor = setup_predictor(add_predictor_params(params, "OCVPSeq"))
        for mod in (model, predictor):
            assert mod.compute_dtype == torch.bfloat16
            assert {p.dtype for p in mod.parameters()} == {torch.float32}
        exp = Experiment(tmp_path / "exp")
        exp.save_params(params)
        trainer = DecompTrainer(exp.exp_path, device="cpu")
        trainer.setup_model()
        assert trainer.model.compute_dtype == torch.bfloat16
        return
    with pytest.raises(NotImplementedError, match=f"compute_dtype '{dtype}'.*bfloat16"):
        setup_model(params)
    with pytest.raises(NotImplementedError, match=f"compute_dtype '{dtype}'"):
        setup_predictor(add_predictor_params(params, "OCVPSeq"))
