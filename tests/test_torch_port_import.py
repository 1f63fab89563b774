"""The port's readers of weights it did not write, on the CPU.

* ``.pth`` (the reference's): synthetic state dicts with the reference's
  names and shapes (SAVi, TextOCVP_CustomTF and VanillaTransformer as in
  ``test_torch_import_structure.py``; ExtendedDINOSAUR with a timm ViT whose
  ``pos_embed`` holds a 37 x 37 grid, resampled to the 24 x 24 grid of 336
  px; TextOCVP_T5 with a HuggingFace T5) go through the port's
  ``train/torch_import.py::import_checkpoint`` and through the JAX
  package's importer followed by ``convert.from_jax_params``. The two state
  dicts are equal bit for bit, the resampled ``pos_embed`` apart. Its
  weights are JAX's bit for bit, but the port sums the bicubic resample in
  float64 and rounds once (within 2^-23 of the largest input value of the
  exact result), where XLA sums in float32 in its own order (up to 1.1e-6 of
  the largest input value off the exact result in these cases): the two are
  held within 2e-6 of the largest input value. Each loads strictly into the
  port's model.
* ``.msgpack`` (the JAX package's): the port's decoder against
  ``flax.serialization.msgpack_restore`` on a real JAX checkpoint, its
  refusals, and the decode of a SAVi read through the import CLI against the
  JAX model's.
"""

import torch_cpu_threads  # noqa: F401  (two torch threads a worker)
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization
from test_torch_import_structure import (
    _lin_sd,
    _ln_sd,
    _prefix,
    _rand,
    _sa_sd,
    _tblock_sd,
    _torch_encoder_layer_sd,
    tiny_savi_exp,
)

from textocvp_tpu.core.config import add_predictor_params as jax_add_predictor_params
from textocvp_tpu.core.config import build_exp_params as jax_build_exp_params
from textocvp_tpu.models import setup_model as jax_setup_model
from textocvp_tpu.train.checkpoints import save_checkpoint as jax_save_checkpoint
from textocvp_tpu.train.torch_import import import_checkpoint as jax_import_checkpoint
from textocvp_tpu_torch.cli import import_torch_checkpoint
from textocvp_tpu_torch.convert import from_jax_params
from textocvp_tpu_torch.core.experiment import Experiment
from textocvp_tpu_torch.models.factory import setup_model, setup_predictor
from textocvp_tpu_torch.nn.vit import cubic_resize_weights, interpolate_pos_embed
from textocvp_tpu_torch.train.checkpoints import (
    from_jax_checkpoint,
    load_params,
    msgpack_restore,
)
from textocvp_tpu_torch.train.torch_import import import_checkpoint, load_torch_state_dict

RESAMPLE_TOL = 2e-6  # of the largest input value: XLA's float32 sums of the resample


def save_pth(path, sd, wrap=False):
    """``sd`` (numpy) as a reference ``.pth``: a bare state dict, or with
    ``wrap`` a training checkpoint of a ``DataParallel`` model."""
    tensors = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}
    if wrap:
        tensors = {"model_state_dict": {f"module.{k}": v for k, v in tensors.items()},
                   "optimizer_state_dict": {"state": {}, "param_groups": []}, "epoch": 7}
    torch.save(tensors, path)
    return path


# ------------------------------------------------------- reference state dicts

def savi_sd(rng):
    """The reference SAVi of ``tiny_savi_exp`` (LearnedRandom slots)."""
    sd = {"initializer.slots_mu": _rand(rng, 1, 1, 32),
          "initializer.slots_sigma": _rand(rng, 1, 1, 32)}
    sd.update(_prefix("transition_module", _tblock_sd(rng, 32, 24)))
    sd.update(_prefix("encoder.encoder.0.block.0", {"weight": _rand(rng, 16, 3, 5, 5),
                                                    "bias": _rand(rng, 16)}))
    sd.update(_prefix("encoder.encoder.1.block.0", {"weight": _rand(rng, 16, 16, 5, 5),
                                                    "bias": _rand(rng, 16)}))
    sd["encoder_pos_embedding.projection.weight"] = _rand(rng, 16, 4, 1, 1)
    sd["encoder_pos_embedding.projection.bias"] = _rand(rng, 16)
    sd.update(_prefix("encoder_mlp.0", _ln_sd(rng, 16)))
    sd.update(_prefix("encoder_mlp.1", _lin_sd(rng, 32, 16)))
    sd.update(_prefix("encoder_mlp.3", _lin_sd(rng, 32, 32)))
    sd["decoder_pos_embedding.projection.weight"] = _rand(rng, 32, 4, 1, 1)
    sd["decoder_pos_embedding.projection.bias"] = _rand(rng, 32)
    sd.update(_prefix("decoder.decoder.0.block.0", {"weight": _rand(rng, 16, 32, 5, 5),
                                                    "bias": _rand(rng, 16)}))
    sd.update(_prefix("decoder.decoder.1.block.0", {"weight": _rand(rng, 16, 16, 5, 5),
                                                    "bias": _rand(rng, 16)}))
    sd.update(_prefix("decoder.decoder.2", {"weight": _rand(rng, 4, 16, 3, 3),
                                            "bias": _rand(rng, 4)}))
    sd.update(_prefix("slot_attention", _sa_sd(rng, 32, 32, 24)))
    return sd


VIT_DIM, VIT_SOURCE_GRID, VIT_BLOCKS = 384, 37, 3  # a DINOv2 ViT-S/14 state dict at 518 px


def tiny_dinosaur_exp(build):
    """ExtendedDINOSAUR at 336 px (a 24 x 24 patch grid) over 2 blocks of a
    ViT-S/14, 3 ``Learned`` slots of 16, a 2-layer patch decoder and the
    4-block CNN head."""
    p = build("ExtendedDINOSAUR", "CLIPort")
    mp = p["model"]["model_params"]
    mp.update(num_slots=3, slot_dim=16, mlp_hidden=16, mlp_encoder_dim=32, initializer="Learned")
    mp["encoder"]["encoder_name"] = "vit_small_patch14_dinov2"
    mp["encoder"]["encoder_params"]["encoder_num_blocks"] = 2
    mp["decoder"]["decoder_params"].update(in_dim=16, hidden_dim=32, out_dim=VIT_DIM + 1,
                                           num_layers=2)
    mp["transition_module"] = {"model_name": "TransformerBlock", "num_heads": 2, "mlp_size": 16}
    return p


def timm_vit_sd(rng, d=VIT_DIM, grid=VIT_SOURCE_GRID, blocks=VIT_BLOCKS, patch=14):
    """A timm ``VisionTransformer`` (DINOv2 layout, LayerScale) state dict,
    one block more than the model keeps, and the final norm the model drops."""
    sd = {"patch_embed.proj.weight": _rand(rng, d, 3, patch, patch),
          "patch_embed.proj.bias": _rand(rng, d), "cls_token": _rand(rng, 1, 1, d),
          "pos_embed": _rand(rng, 1, 1 + grid * grid, d)}
    for i in range(blocks):
        pre = f"blocks.{i}"
        for name in ("norm1", "norm2"):
            sd.update(_prefix(f"{pre}.{name}", _ln_sd(rng, d)))
        sd.update(_prefix(f"{pre}.attn.qkv", _lin_sd(rng, 3 * d, d)))
        sd.update(_prefix(f"{pre}.attn.proj", _lin_sd(rng, d, d)))
        sd.update(_prefix(f"{pre}.mlp.fc1", _lin_sd(rng, 4 * d, d)))
        sd.update(_prefix(f"{pre}.mlp.fc2", _lin_sd(rng, d, 4 * d)))
        sd[f"{pre}.ls1.gamma"] = _rand(rng, d)
        sd[f"{pre}.ls2.gamma"] = _rand(rng, d)
    sd.update(_prefix("norm", _ln_sd(rng, d)))
    return sd


def dinosaur_sd(rng, exp_params):
    mp = exp_params["model"]["model_params"]
    dp = mp["decoder"]["decoder_params"]
    s, d, feats = mp["num_slots"], mp["slot_dim"], VIT_DIM
    sd = _prefix("encoder.vit_backbone", timm_vit_sd(rng))
    sd["initializer.slots"] = _rand(rng, 1, s, d)
    sd.update(_prefix("transition_module", _tblock_sd(rng, d, 16)))
    sd.update(_prefix("linear_feat_proj.0", _ln_sd(rng, feats)))
    sd.update(_prefix("linear_feat_proj.1", _lin_sd(rng, mp["mlp_encoder_dim"], feats)))
    sd.update(_prefix("linear_feat_proj.3", _lin_sd(rng, d, mp["mlp_encoder_dim"])))
    sd.update(_prefix("slot_attention", _sa_sd(rng, d, d, mp["mlp_hidden"])))
    sd["decoder.pos_embed"] = _rand(rng, 1, 1, dp["num_patches"], d)
    sd.update(_prefix("decoder.mlp.0", _ln_sd(rng, d)))  # initial_layer_norm
    sd.update(_prefix("decoder.mlp.1", _lin_sd(rng, dp["hidden_dim"], d)))
    sd.update(_prefix("decoder.mlp.3", _lin_sd(rng, dp["out_dim"], dp["hidden_dim"])))
    # the CNN head, an Upsample after each block while the grid grows
    # (decoders.py::cnn_plan: 24 -> 48 -> 96 -> 192 -> 384 px, channels halving)
    chans, seq = [dp["out_dim"] - 1, 32, 16, 8, 4], 0
    for cin, cout in zip(chans[:-1], chans[1:]):
        pre = f"decoder.conv_patch_decoder.{seq}.block"
        sd.update({f"{pre}.0.weight": _rand(rng, cout, cin, 3, 3),
                   f"{pre}.0.bias": _rand(rng, cout),
                   f"{pre}.1.weight": _rand(rng, cout), f"{pre}.1.bias": _rand(rng, cout),
                   f"{pre}.1.running_mean": _rand(rng, cout),
                   f"{pre}.1.running_var": rng.uniform(0.5, 2, cout).astype(np.float32),
                   f"{pre}.1.num_batches_tracked": np.array(12)})
        seq += 2
    sd.update(_prefix(f"decoder.conv_patch_decoder.{seq}", {"weight": _rand(rng, 3, 4, 3, 3),
                                                            "bias": _rand(rng, 3)}))
    return sd


def _adapted_block_sd(rng, d, ff, inner):
    sd = _tblock_sd(rng, d, ff)
    ca = "cross_attention"
    for name in ("ln_cross_att_q", "ln_cross_att_kv", "ln_mlp"):
        sd.update(_prefix(f"{ca}.{name}", _ln_sd(rng, d)))
    for name in ("q", "k", "v"):
        sd.update(_prefix(f"{ca}.cross_attn.{name}", _lin_sd(rng, inner, d, bias=False)))
    sd.update(_prefix(f"{ca}.cross_attn.out_projection", _lin_sd(rng, d, inner)))
    sd.update(_prefix(f"{ca}.mlp.0", _lin_sd(rng, ff, d)))
    sd.update(_prefix(f"{ca}.mlp.2", _lin_sd(rng, d, ff)))
    return sd


def textocvp_exp(name, t5_layers=6):
    """A TextOCVP predictor over ``tiny_savi_exp``: token 32, 2 layers, buffer
    3; CustomTF's text encoder 16 wide with 1 layer over 30 ids, T5's 32 wide
    with ``t5_layers`` layers."""
    params = jax_add_predictor_params(tiny_savi_exp(), name)
    pp = params["predictor"]["predictor_params"]
    pp["predictor_params"].update(token_dim=32, n_heads=2, hidden_dim=48, num_layers=2)
    pp["fusion_params"].update(num_heads=2, head_dim=8, mlp_size=48)
    if name == "TextOCVP_CustomTF":
        pp["text_encoder_params"].update(input_dim=16, num_layers=1, num_heads=2, vocab_size=30)
    else:
        pp["text_encoder_params"] = dict(vocab_size=64, d_model=32, d_kv=8, num_heads=2,
                                         d_ff=40, num_layers=t5_layers)
    params["prediction_params"].update(input_buffer_size=3)
    return params


def hf_t5_sd(rng, cfg):
    d, inner, ff = cfg["d_model"], cfg["d_kv"] * cfg["num_heads"], cfg["d_ff"]
    sd = {"shared.weight": _rand(rng, cfg["vocab_size"], d),
          "encoder.embed_tokens.weight": _rand(rng, cfg["vocab_size"], d),
          "encoder.final_layer_norm.weight": _rand(rng, d)}
    for i in range(cfg["num_layers"]):
        pre = f"encoder.block.{i}.layer"
        sd.update({f"{pre}.0.SelfAttention.{n}.weight": _rand(rng, inner, d) for n in "qkv"})
        sd[f"{pre}.0.SelfAttention.o.weight"] = _rand(rng, d, inner)
        if i == 0:
            sd[f"{pre}.0.SelfAttention.relative_attention_bias.weight"] = _rand(
                rng, 32, cfg["num_heads"])
        sd[f"{pre}.0.layer_norm.weight"] = _rand(rng, d)
        sd[f"{pre}.1.layer_norm.weight"] = _rand(rng, d)
        sd[f"{pre}.1.DenseReluDense.wi.weight"] = _rand(rng, ff, d)
        sd[f"{pre}.1.DenseReluDense.wo.weight"] = _rand(rng, d, ff)
    return sd


def textocvp_sd(rng, exp_params):
    """The reference TextOCVP (``predictor.``-prefixed) of ``textocvp_exp``."""
    name = exp_params["predictor"]["predictor_name"]
    pp = exp_params["predictor"]["predictor_params"]
    d, slot_dim = 32, 32
    sd = {}
    sd.update(_prefix("predictor.mlp_in", _lin_sd(rng, d, slot_dim)))
    sd.update(_prefix("predictor.mlp_out", _lin_sd(rng, slot_dim, d)))
    sd["predictor.pe.pe"] = _rand(rng, 1, 4, 1, d)  # (1, buffer + 1, 1, d)
    for i in range(2):
        sd.update(_prefix(f"predictor.predictor.{i}", _adapted_block_sd(rng, d, 48, 16)))
    if name == "TextOCVP_CustomTF":
        te = "predictor.text_encoder"
        sd[f"{te}.token_embedding.weight"] = _rand(rng, 30, 16)
        sd[f"{te}.position_embedding.weight"] = _rand(rng, 50, 16)
        sd.update(_prefix(f"{te}.layer_norm", _ln_sd(rng, 16)))
        sd.update(_prefix(f"{te}.transformer.layers.0", _torch_encoder_layer_sd(rng, 16, 64)))
        sd.update(_prefix(f"{te}.text_out_projection.0", _ln_sd(rng, 16)))
        sd.update(_prefix(f"{te}.text_out_projection.1", _lin_sd(rng, d, 16)))
    else:
        sd.update(_prefix("predictor.text_encoder", hf_t5_sd(rng, pp["text_encoder_params"])))
    return sd


def vanilla_exp():
    params = jax_add_predictor_params(tiny_savi_exp(), "VanillaTransformer")
    params["predictor"]["predictor_params"].update(token_dim=16, hidden_dim=32, num_layers=2,
                                                   n_heads=2)
    params["prediction_params"].update(input_buffer_size=3)
    return params


def vanilla_sd(rng):
    """An older layout: no ``predictor.`` prefix."""
    sd = {}
    sd.update(_prefix("mlp_in", _lin_sd(rng, 16, 32)))
    sd.update(_prefix("mlp_out", _lin_sd(rng, 32, 16)))
    for i in range(2):
        sd.update(_prefix(f"transformer_encoders.{i}", _torch_encoder_layer_sd(rng, 16, 32)))
    return sd


CASES = {
    "SAVi": (tiny_savi_exp, lambda rng, p: savi_sd(rng), "decomp", "savi"),
    "ExtendedDINOSAUR": (lambda: tiny_dinosaur_exp(jax_build_exp_params), dinosaur_sd, "decomp",
                         "dinosaur"),
    "TextOCVP_T5": (lambda: textocvp_exp("TextOCVP_T5"), textocvp_sd, "predictor", "predictor"),
    "TextOCVP_CustomTF": (lambda: textocvp_exp("TextOCVP_CustomTF"), textocvp_sd, "predictor",
                          "predictor"),
    "VanillaTransformer": (vanilla_exp, lambda rng, p: vanilla_sd(rng), "predictor",
                           "predictor"),
}


@pytest.mark.parametrize("wrap", [False, True], ids=["bare", "wrapped"])
@pytest.mark.parametrize("name", list(CASES))
def test_pth_import_equals_the_jax_import_and_loads_strictly(tmp_path, name, wrap):
    make_params, make_sd, kind, jax_kind = CASES[name]
    params = make_params()
    path = save_pth(tmp_path / f"{name}.pth", make_sd(np.random.default_rng(5), params), wrap)
    ours = import_checkpoint(path, params, kind)
    ref_state = jax_import_checkpoint(str(path), params, kind)
    ref = from_jax_params(jax_kind, ref_state["params"], batch_stats=ref_state["batch_stats"])
    assert list(ours) == list(ref)
    for key in ref:
        assert ours[key].dtype == ref[key].dtype, key
        if key.endswith("image_encoder.pos_embed"):
            scale = np.abs(make_sd(np.random.default_rng(5), params)[
                "encoder.vit_backbone.pos_embed"]).max()
            assert ours[key].shape == (1, 1 + 24 * 24, VIT_DIM)
            assert (ours[key] - ref[key]).abs().max() <= RESAMPLE_TOL * scale, key
        else:
            assert torch.equal(ours[key], ref[key]), key
    module = (setup_model if kind == "decomp" else setup_predictor)(params)
    module.load_state_dict(ours)  # strict


def test_the_state_dict_reader_strips_module_and_takes_model_state_dict(tmp_path, rng):
    sd = vanilla_sd(rng)
    bare = load_torch_state_dict(save_pth(tmp_path / "a.pth", sd))
    wrapped = load_torch_state_dict(save_pth(tmp_path / "b.pth", sd, wrap=True))
    assert list(bare) == list(wrapped) == list(sd)
    for k in sd:
        np.testing.assert_array_equal(wrapped[k], sd[k])


def test_the_gru_fold_matches_torch_gru_cell(tmp_path, rng):
    """The reference's ``torch.nn.GRUCell`` and the port's GRU leaves, its two
    r and z biases folded into ``bias_ih`` (``bias_hh`` = [0; 0; b_hn] as the
    kernel takes it), give the same update."""
    sd = savi_sd(rng)
    model = setup_model(tiny_savi_exp())
    model.load_state_dict(import_checkpoint(save_pth(tmp_path / "s.pth", sd), tiny_savi_exp(),
                                            "decomp"))
    gru = model.slot_attention.gru
    assert not torch.equal(torch.from_numpy(sd["slot_attention.gru.bias_ih"]), gru.bias_ih)
    ref = torch.nn.GRUCell(32, 32)
    ref.load_state_dict({k: torch.from_numpy(sd[f"slot_attention.gru.{k}"])
                         for k in ("weight_ih", "weight_hh", "bias_ih", "bias_hh")})
    ours = torch.nn.GRUCell(32, 32)
    ours.load_state_dict({"weight_ih": gru.weight_ih, "bias_ih": gru.bias_ih,
                          "weight_hh": gru.weight_hh, "bias_hh": gru.bias_hh()})
    x, h = (torch.from_numpy(_rand(rng, 6, 32)) for _ in range(2))
    with torch.no_grad():
        torch.testing.assert_close(ours(x, h), ref(x, h), rtol=1e-5, atol=1e-5)


def test_a_t5_of_another_depth_imports_where_the_jax_importer_cannot(tmp_path, rng):
    """The JAX importer reads T5-small's 6 layers whatever the config says; the
    port reads the config's."""
    params = textocvp_exp("TextOCVP_T5", t5_layers=2)
    path = save_pth(tmp_path / "t5.pth", textocvp_sd(rng, params))
    setup_predictor(params).load_state_dict(import_checkpoint(path, params, "predictor"))
    with pytest.raises(KeyError, match="encoder.block.2"):
        jax_import_checkpoint(str(path), params, "predictor")


# ------------------------------------------------------------ pos-embed resample

@pytest.mark.parametrize("grids", [(37, 24), (24, 37), (16, 24), (24, 16), (5, 3)])
def test_interpolate_pos_embed_matches_jax_image_resize(rng, grids):
    from jax._src.image.scale import _fill_keys_cubic_kernel, compute_weight_mat

    old, new = grids
    np.testing.assert_array_equal(
        cubic_resize_weights(old, new),
        np.asarray(compute_weight_mat(old, new, new / old, 0.0, _fill_keys_cubic_kernel, True)))
    pos = _rand(rng, 1, 1 + old * old, 64)
    ours = interpolate_pos_embed(pos, new)
    ref = jax.image.resize(jnp.asarray(pos[:, 1:].reshape(1, old, old, 64)),
                           (1, new, new, 64), method="bicubic")
    assert ours.shape == (1, 1 + new * new, 64) and ours.dtype == np.float32
    np.testing.assert_array_equal(ours[:, :1], pos[:, :1])
    err = np.abs(ours[:, 1:] - np.asarray(ref).reshape(1, -1, 64)).max()
    assert err <= RESAMPLE_TOL * np.abs(pos).max(), err
    w = cubic_resize_weights(old, new).astype(np.float64)
    exact = np.einsum("hwd,hy,wx->yxd", pos[0, 1:].reshape(old, old, 64).astype(np.float64), w, w)
    assert np.abs(ours[0, 1:] - exact.reshape(-1, 64)).max() <= 2.0 ** -23 * np.abs(pos).max()
    # F.interpolate's bicubic (a = -0.75, no antialias) is another resample
    grid = torch.from_numpy(pos[:, 1:].reshape(1, old, old, 64)).permute(0, 3, 1, 2)
    other = torch.nn.functional.interpolate(grid, size=(new, new), mode="bicubic",
                                            align_corners=False)
    assert np.abs(other.permute(0, 2, 3, 1).reshape(1, -1, 64).numpy()
                  - np.asarray(ref).reshape(1, -1, 64)).max() > 1e-3
    assert interpolate_pos_embed(pos, old) is pos


# --------------------------------------------------------------------- .msgpack

def jax_savi(rng):
    """A tiny JAX SAVi's params (the init plus noise) and one video."""
    params = tiny_savi_exp()
    model = jax_setup_model(params)
    video = jnp.asarray(rng.uniform(0, 1, (1, 2, 32, 32, 3)).astype(np.float32))
    variables = model.init({"params": jax.random.PRNGKey(0), "slots": jax.random.PRNGKey(1)},
                           video)
    p = jax.tree_util.tree_map(
        lambda x: np.asarray(x) + 0.05 * rng.standard_normal(np.shape(x)).astype(np.float32),
        jax.device_get(variables["params"]))
    return params, model, p, video


def test_msgpack_reader_equals_flax_on_a_jax_checkpoint(tmp_path, rng):
    _, _, params, _ = jax_savi(rng)
    state = {"params": params, "batch_stats": {}, "opt_state": optax.adam(1e-4).init(params),
             "epoch": 3, "step": 17}
    path = jax_save_checkpoint(tmp_path, "ckpt", state)
    data = path.read_bytes()
    ours, ref = msgpack_restore(data), serialization.msgpack_restore(data)
    ours_leaves, ours_def = jax.tree_util.tree_flatten_with_path(ours)
    ref_leaves, ref_def = jax.tree_util.tree_flatten_with_path(ref)
    assert ours_def == ref_def and len(ours_leaves) == len(ref_leaves) > 50
    for (pa, a), (pb, b) in zip(ours_leaves, ref_leaves):
        assert pa == pb and type(a) is type(b)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    assert ours["epoch"] == 3 and ours["step"] == 17


def test_msgpack_reader_reads_every_type_flax_writes():
    """Every msgpack type at each of its widths, and numpy arrays and scalars
    of numpy's own dtypes, against ``flax.serialization.msgpack_restore``."""
    ints = [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**64 - 1,
            -1, -32, -33, -128, -129, -32768, -32769, -2**31, -2**31 - 1, -2**63]
    tree = {
        "ints": {str(i): v for i, v in enumerate(ints)},
        "floats": [0.5, -1e300, float("inf")], "none": None, "flags": [True, False],
        "strs": ["", "x" * 31, "y" * 32, "z" * 255, "w" * 256, "v" * 65536, "ü"],
        "bins": [b"", b"\x00" * 300, b"\x01" * 70000],
        "wide": {f"k{i}": i for i in range(70000)}, "long": list(range(20)),
        "arrays": {str(i): np.arange(n, dtype=dt).reshape(shape) for i, (n, dt, shape) in
                   enumerate([(6, np.float32, (2, 3)), (0, np.float32, (0, 4)),
                              (5, np.int64, (5,)), (300, np.uint8, (300,)),
                              (1, np.float64, ()), (4, np.int8, (2, 2)),
                              (70000, np.float16, (70000,)), (2, np.bool_, (2,))])},
        "scalars": [np.float32(2.5), np.int32(-7)],
    }
    data = serialization.msgpack_serialize(tree)
    ours, ref = msgpack_restore(data), serialization.msgpack_restore(data)
    ours_leaves, ours_def = jax.tree_util.tree_flatten(ours)
    ref_leaves, ref_def = jax.tree_util.tree_flatten(ref)
    assert ours_def == ref_def
    for a, b in zip(ours_leaves, ref_leaves):
        assert type(a) is type(b) and getattr(a, "dtype", None) == getattr(b, "dtype", None)
        np.testing.assert_array_equal(a, b)


def test_msgpack_reader_refuses_what_it_does_not_read(tmp_path):
    import msgpack

    cases = {
        "complex.msgpack": serialization.msgpack_serialize({"x": 1 + 2j}),
        "chunked.msgpack": msgpack.packb({"params": {"w": {
            "__msgpack_chunked_array__": True, "shape": {"0": 2}, "chunks": {"0": 1}}}}),
        "cut.msgpack": serialization.msgpack_serialize({"w": np.ones(8, np.float32)})[:-3],
        "bf16.msgpack": serialization.msgpack_serialize({"w": jnp.ones(2, jnp.bfloat16)}),
    }
    messages = {"complex.msgpack": "ext type 2", "chunked.msgpack": "chunked",
                "cut.msgpack": "truncated", "bf16.msgpack": "bfloat16"}
    for name, blob in cases.items():
        path = tmp_path / name
        path.write_bytes(blob)
        with pytest.raises(ValueError, match=messages[name]) as err:
            from_jax_checkpoint(path, "savi")
        assert name in str(err.value)
    with pytest.raises(FileNotFoundError):
        from_jax_checkpoint(tmp_path / "absent.msgpack", "savi")


def test_a_jax_checkpoint_imported_by_the_cli_decodes_as_the_jax_model(tmp_path, rng):
    params, model, p, video = jax_savi(rng)
    path = jax_save_checkpoint(tmp_path, "jax_savi", {"params": p, "epoch": 1, "step": 2})
    exp = Experiment(tmp_path / "exp")
    exp.save_params(params)
    out = import_torch_checkpoint.main(["-d", str(exp.exp_path), "--kind", "decomp",
                                        "--jax_ckpt", str(path)])
    assert out == exp.checkpoint_path("jax_savi")
    state = torch.load(out, weights_only=True)
    assert set(state) == {"params", "opt_state", "epoch", "step"} and state["epoch"] == 0
    ours = setup_model(params)
    ours.load_state_dict(load_params(out))
    slots = rng.standard_normal((2, 4, 32)).astype(np.float32)
    ref = model.apply({"params": p}, jnp.asarray(slots), method=model.decode)["recons_imgs"]
    with torch.no_grad():
        got = ours.decode(torch.from_numpy(slots))["recons_imgs"]
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-5)
    # a checkpoint of another model is refused before anything is written
    other = Experiment(tmp_path / "other")
    other.save_params(tiny_dinosaur_exp(jax_build_exp_params))
    with pytest.raises(KeyError, match="patch_decoder"):
        import_torch_checkpoint.main(["-d", str(other.exp_path), "--kind", "decomp",
                                      "--jax_ckpt", str(path), "--output_name", "x"])
    assert not other.checkpoint_path("x").exists()


def test_the_cli_imports_a_pth_into_a_predictor_experiment(tmp_path, rng):
    params = vanilla_exp()
    exp = Experiment(tmp_path / "exp" / "predictors" / "vanilla")
    exp.save_params(params)
    pth = save_pth(tmp_path / "Vanilla_CATER.pth", vanilla_sd(rng), wrap=True)
    out = import_torch_checkpoint.main(["-d", str(exp.exp_path), "--kind", "predictor",
                                        "--torch_ckpt", str(pth), "--output_name", "imported"])
    assert out == exp.checkpoint_path("imported")
    want = import_checkpoint(pth, params, "predictor")
    got = load_params(out)
    assert list(got) == list(want) and all(torch.equal(got[k], want[k]) for k in want)
    with pytest.raises(SystemExit):
        import_torch_checkpoint.main(["-d", str(exp.exp_path), "--kind", "predictor",
                                      "--torch_ckpt", str(pth), "--jax_ckpt", "x.msgpack"])
