"""The four other predictors of the PyTorch port (VanillaTransformer, OCVPSeq,
OCVPPar, TextOCVP_CustomTF with its transformer text encoder) against the
JAX package on the CPU, at a small size: slots 4 x 32, token width 32, two
layers of 4 heads, MLP 64; the custom text encoder of width 32 over the
CATER_Easy vocabulary; a buffer of 4 frames and 3 predictions.

Weights: the JAX init plus noise, carried by ``from_jax_params`` with
``strict=True``. Tolerances: rtol 1e-4 / atol 1e-5 for one pass; the
rollout feeds each prediction back as input, so float32 rounding differences
compound over the steps and its tolerance is rtol 1e-3 / atol 1e-4. Also
here: the factory, the ``Synthetic`` set, the checks that keep a CustomTF
predictor's embedding lookups in range, and the service's text plumbing.
The 04 step, 05 and the CLIs of these predictors are in
``test_torch_port_train_predictors.py``.
"""

import os
import warnings

os.environ.setdefault("HF_HUB_OFFLINE", "1")
os.environ.setdefault("TRANSFORMERS_OFFLINE", "1")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
from test_torch_port_predictor import _perturb  # noqa: E402

from textocvp_tpu.core.config import add_predictor_params as jax_add_predictor_params  # noqa: E402
from textocvp_tpu.core.config import build_exp_params as jax_build_exp_params  # noqa: E402
from textocvp_tpu.data.loader import load_data as jax_load_data  # noqa: E402
from textocvp_tpu.data.synthetic import SyntheticBalls as JaxSyntheticBalls  # noqa: E402
from textocvp_tpu.models import setup_predictor as jax_setup_predictor  # noqa: E402
from textocvp_tpu.models.factory import PREDICTORS as JAX_PREDICTORS  # noqa: E402
from textocvp_tpu.nn import blocks as jax_blocks  # noqa: E402
from textocvp_tpu.nn.text_encoders import TransformerTextEncoder as JaxTextEncoder  # noqa: E402
from textocvp_tpu_torch.convert import convert_tree, from_jax_params  # noqa: E402
from textocvp_tpu_torch.core.config import add_predictor_params, build_exp_params  # noqa: E402
from textocvp_tpu_torch.data.loader import EpochLoader, load_data  # noqa: E402
from textocvp_tpu_torch.data.synthetic import SyntheticBalls  # noqa: E402
from textocvp_tpu_torch.data.tokenizers import CustomTokenizer, HashFallbackT5Tokenizer  # noqa: E402
from textocvp_tpu_torch.data.vocabularies import CATER_EASY_VOCAB  # noqa: E402
from textocvp_tpu_torch.models import setup_predictor  # noqa: E402
from textocvp_tpu_torch.models.factory import PREDICTORS  # noqa: E402
from textocvp_tpu_torch.nn import blocks  # noqa: E402
from textocvp_tpu_torch.nn.text_encoders import TransformerTextEncoder  # noqa: E402

RTOL, ATOL = 1e-4, 1e-5
B, S, D, L, NUM_PREDS = 2, 4, 32, 4, 3
OTHERS = ["VanillaTransformer", "OCVPSeq", "OCVPPar", "TextOCVP_CustomTF"]
CAPTIONS = ["the cone is sliding to (1, -2)", "the snitch is rotating"]
TEXT_ENCODER_TINY = dict(input_dim=32, num_layers=2, num_heads=4, vocab_size=50)


def tiny_params(build, add, name, num_context=1, base=None):
    """A tiny experiment of predictor ``name`` (over ``base``, by default the
    SAVi CATER_Easy config) with S x D slots."""
    p = add(base if base is not None else build("SAVi", "CATER_Easy"), name)
    p["model"]["model_params"].update(num_slots=S, slot_dim=D)
    pp = p["predictor"]["predictor_params"]
    if name == "TextOCVP_CustomTF":
        pp["predictor_params"].update(token_dim=32, n_heads=4, hidden_dim=64, num_layers=2)
        pp["fusion_params"].update(num_heads=2, head_dim=16, mlp_size=64)
        pp["text_encoder_params"] = dict(TEXT_ENCODER_TINY)
    else:
        pp.update(token_dim=32, hidden_dim=64, num_layers=2, n_heads=4)
    p["prediction_params"].update(num_context=num_context, num_preds=NUM_PREDS,
                                  input_buffer_size=L)
    return p


def captions(texts=CAPTIONS):
    """CustomTokenizer ids (CATER_Easy vocabulary) and lengths of ``texts``."""
    tok = CustomTokenizer(CATER_EASY_VOCAB)(texts)
    return tok["caption_tokens"], tok["caption_lengths"]


def jax_text(ids, lengths):
    return {"caption_tokens": jnp.asarray(ids), "caption_lengths": jnp.asarray(lengths)}


def torch_text(ids, lengths):
    return {"caption_tokens": torch.from_numpy(ids), "caption_lengths": torch.from_numpy(lengths)}


def jax_predictor(name, num_context, seed):
    """(JAX wrapper, perturbed params) of the tiny predictor ``name``."""
    rng = np.random.default_rng(seed)
    jw = jax_setup_predictor(tiny_params(jax_build_exp_params, jax_add_predictor_params, name,
                                         num_context))
    ids, lengths = captions()
    variables = jw.init({"params": jax.random.PRNGKey(seed)}, jnp.zeros((1, num_context, S, D)),
                        **{k: v[:1] for k, v in jax_text(ids, lengths).items()})
    return jw, _perturb(jax.device_get(variables["params"]), rng)


def port_predictor(name, num_context, params):
    tw = setup_predictor(tiny_params(build_exp_params, add_predictor_params, name,
                                     num_context)).eval()
    tw.load_state_dict(from_jax_params("predictor", params), strict=True)
    return tw


# ------------------------------------------------------------------ blocks


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
@pytest.mark.parametrize("activation", ["relu", "gelu"])
@pytest.mark.parametrize("norm_first", [True, False], ids=["prenorm", "postnorm"])
def test_torch_style_encoder_layer_matches_jax(norm_first, activation, masked):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 6, 32)).astype(np.float32)
    mask = None
    if masked:  # (B, Q, K): the second row's last two keys are padding
        keep = np.ones((2, 6), bool)
        keep[1, 4:] = False
        mask = np.broadcast_to(keep[:, None, :], (2, 6, 6)).copy()
    jl = jax_blocks.TorchStyleEncoderLayer(d_model=32, nhead=4, dim_feedforward=64,
                                           activation=activation, norm_first=norm_first)
    jmask = None if mask is None else jnp.asarray(mask)
    params = jl.init(jax.random.PRNGKey(0), jnp.asarray(x), mask=jmask)
    params = {"params": _perturb(jax.device_get(params["params"]), rng)}
    ref = jl.apply(params, jnp.asarray(x), mask=jmask)
    tl = blocks.TorchStyleEncoderLayer(32, 4, 64, activation=activation, norm_first=norm_first)
    tl.load_state_dict(convert_tree(params["params"]), strict=True)
    with torch.no_grad():
        out = tl(torch.from_numpy(x), None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)


def test_gelu_is_flax_s_tanh_approximation():
    x = torch.linspace(-4, 4, 101)
    ref = np.asarray(jax.nn.gelu(jnp.asarray(x.numpy())))
    layer = blocks.TorchStyleEncoderLayer(4, 1, 4, activation="gelu")
    with torch.no_grad():
        layer.linear1.weight.copy_(torch.eye(4))
        layer.linear1.bias.zero_()
        layer.linear2.weight.copy_(torch.eye(4))
        layer.linear2.bias.zero_()
        out = layer.feed_forward(x.reshape(-1, 1).expand(-1, 4))[:, 0]
    # two float32 evaluations of one formula: within 1e-6; the erf form is
    # more than 1e-4 away over this range
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-6)
    assert (torch.nn.functional.gelu(x) - out).abs().max() > 1e-4


@pytest.mark.parametrize("offset", list(range(L + 1)))
def test_slot_positional_encoding_matches_jax(offset):
    x = np.random.default_rng(offset).standard_normal((2, L, S, 32)).astype(np.float32)
    jpe = jax_blocks.SlotPositionalEncoding(d_model=32, max_len=L)
    ref = jpe.apply({}, jnp.asarray(x), offset=offset)
    tpe = blocks.SlotPositionalEncoding(32, max_len=L)
    assert not dict(tpe.state_dict()) and not list(tpe.parameters())
    np.testing.assert_allclose(tpe(torch.from_numpy(x), offset).numpy(), np.asarray(ref),
                               rtol=RTOL, atol=ATOL)
    if offset == 0:  # the JAX default (no offset) is offset 0
        np.testing.assert_allclose(tpe(torch.from_numpy(x)).numpy(),
                                   np.asarray(jpe.apply({}, jnp.asarray(x))), rtol=0, atol=0)


def test_biased_self_attention_matches_jax_and_the_default_stays_bias_free():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 5, 32)).astype(np.float32)
    mask = np.ones((2, 5, 5), bool)
    mask[0, :, 3:] = False
    jm = jax_blocks.MultiHeadSelfAttention(emb_dim=32, num_heads=4, use_bias=True)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    params = {"params": _perturb(jax.device_get(params["params"]), rng)}
    ref = jm.apply(params, jnp.asarray(x), mask=jnp.asarray(mask))
    tm = blocks.MultiHeadSelfAttention(32, 4, use_bias=True)
    tm.load_state_dict(convert_tree(params["params"]), strict=True)
    with torch.no_grad():
        out = tm(torch.from_numpy(x), torch.from_numpy(mask))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)
    assert sorted(blocks.MultiHeadSelfAttention(32, 4).state_dict()) == [
        "k.weight", "out.weight", "q.weight", "v.weight"]


# ------------------------------------------------------------ text encoder


@pytest.mark.parametrize("texts", [CAPTIONS, ["the cone is rotating", "the snitch is sliding",
                                              "the cone is picked up and placed to (-1, 1)"]],
                         ids=["two", "three"])
def test_text_encoder_matches_jax_on_ragged_captions(texts):
    rng = np.random.default_rng(len(texts))
    ids, lengths = captions(texts)
    assert len(set(lengths.tolist())) > 1 and (ids == CATER_EASY_VOCAB["[PAD]"]).any()
    je = JaxTextEncoder(output_dim=48, **TEXT_ENCODER_TINY)
    params = je.init(jax.random.PRNGKey(0), jnp.asarray(ids), jnp.asarray(lengths))
    params = {"params": _perturb(jax.device_get(params["params"]), rng)}
    ref = je.apply(params, jnp.asarray(ids), jnp.asarray(lengths))
    te = TransformerTextEncoder(output_dim=48, **TEXT_ENCODER_TINY)
    te.load_state_dict(convert_tree(params["params"]), strict=True)
    with torch.no_grad():
        out = te(torch.from_numpy(ids), torch.from_numpy(lengths))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)
    assert te.ln_in.eps == 1e-8 and te.ln_out.eps == 1e-6


@pytest.mark.parametrize("case", ["t5_ids", "too_long"])
def test_out_of_range_ids_raise_before_any_lookup(case, monkeypatch):
    """flax's Embed gives NaN here; the port raises ValueError first."""
    te = TransformerTextEncoder(output_dim=32, **TEXT_ENCODER_TINY)
    if case == "t5_ids":
        tok = HashFallbackT5Tokenizer()(CAPTIONS)
        ids, lengths = tok["caption_tokens"], tok["caption_lengths"]
        match = "vocab_size=50.*'tokenizer'"
    else:
        ids = np.full((1, 51), 3, np.int32)
        lengths = np.array([51], np.int32)
        match = "context_length=50"

    def no_lookup(*args, **kwargs):
        raise AssertionError("embedding looked up")

    monkeypatch.setattr(torch.nn.functional, "embedding", no_lookup)
    with pytest.raises(ValueError, match=match):
        te(torch.from_numpy(ids), torch.from_numpy(lengths))
    # the JAX package gives NaN with no error (ROADMAP.md §3)
    je = JaxTextEncoder(output_dim=32, **TEXT_ENCODER_TINY)
    params = je.init(jax.random.PRNGKey(0), jnp.ones((1, 4), jnp.int32), jnp.asarray([4]))
    assert np.isnan(np.asarray(je.apply(params, jnp.asarray(ids), jnp.asarray(lengths)))).any()


def test_a_t5_batch_into_a_custom_tf_predictor_raises():
    tw = setup_predictor(tiny_params(build_exp_params, add_predictor_params,
                                     "TextOCVP_CustomTF"))
    tok = HashFallbackT5Tokenizer()(CAPTIONS)
    with torch.no_grad(), pytest.raises(ValueError, match="vocab_size"):
        tw(torch.zeros(B, 1, S, D), **{k: torch.from_numpy(v) for k, v in tok.items()})


# --------------------------------------------------------------- factory


def test_the_factory_has_the_jax_predictors_and_their_configs():
    assert PREDICTORS == JAX_PREDICTORS
    def no_tpu(params):  # the JAX package's TPU runtime knobs
        return {k: v for k, v in params.items() if k != "tpu"}

    for name in PREDICTORS:
        full = add_predictor_params(build_exp_params("SAVi", "CATER_Easy"), name)
        assert full == no_tpu(jax_add_predictor_params(jax_build_exp_params("SAVi", "CATER_Easy"),
                                                       name))
        setup_predictor(full)  # every published config builds
    for name in ("CATER_Hard", "Synthetic"):
        assert build_exp_params("SAVi", name) == no_tpu(jax_build_exp_params("SAVi", name))


# -------------------------------------------------------------- predictors


def _window(rng, num_context):
    """A full buffer of L frames whose first L - num_context are padding."""
    return rng.standard_normal((B, L, S, D)).astype(np.float32), L - num_context


@pytest.mark.parametrize("num_context", [1, 2])
@pytest.mark.parametrize("name", OTHERS)
def test_one_step_matches_jax(name, num_context):
    """One call of the predictor on a buffer with L - c padding frames, with
    the mask and PE offset the rollout hands it."""
    rng = np.random.default_rng(40 + num_context)
    jw, params = jax_predictor(name, num_context, 1)
    tw = port_predictor(name, num_context, params)
    buf, pad = _window(rng, num_context)
    valid = np.arange(L) >= pad
    ids, lengths = captions()

    def jax_step(mdl, buf):
        p = mdl.predictor
        if name == "TextOCVP_CustomTF":
            kv = p.precompute_text_kv(p.encode_text(**jax_text(ids, lengths)))
            return p(buf, text_kv=kv, self_mask=jnp.asarray(np.repeat(valid, S))[None, None])
        if name == "VanillaTransformer":
            return p(buf, self_mask=jnp.asarray(np.repeat(valid, S))[None, None], pe_offset=pad)
        return p(buf, time_mask=jnp.asarray(valid)[None, None], pe_offset=pad)

    ref = jw.apply({"params": params}, jnp.asarray(buf), method=jax_step)
    p = tw.predictor
    with torch.no_grad():
        if name == "TextOCVP_CustomTF":
            kv = p.precompute_text_kv(p.encode_text(**torch_text(ids, lengths)))
            out = p(torch.from_numpy(buf), kv,
                    self_mask=torch.from_numpy(np.repeat(valid, S))[None, None])
        elif name == "VanillaTransformer":
            out = p(torch.from_numpy(buf), torch.from_numpy(np.repeat(valid, S))[None, None],
                    pe_offset=pad)
        else:
            out = p(torch.from_numpy(buf), torch.from_numpy(valid)[None, None], pe_offset=pad)
    assert out.shape == (B, S, D)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("num_context", [1, 2])
@pytest.mark.parametrize("name", OTHERS)
def test_rollout_matches_jax(name, num_context):
    """The whole rollout against the JAX ``PredictorWrapper``; every predictor
    is handed the caption, which the unconditioned ones ignore."""
    rng = np.random.default_rng(20 + num_context)
    history = rng.standard_normal((B, num_context, S, D)).astype(np.float32)
    ids, lengths = captions()
    jw, params = jax_predictor(name, num_context, 2)
    ref = jw.apply({"params": params}, jnp.asarray(history), **jax_text(ids, lengths))
    tw = port_predictor(name, num_context, params)
    with torch.no_grad():
        out = tw(torch.from_numpy(history), **torch_text(ids, lengths))
    assert out.shape == (B, NUM_PREDS, S, D)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("num_context", [1, 2])
@pytest.mark.parametrize("name", OTHERS)
def test_static_rollout_matches_a_dynamic_window(name, num_context):
    """The masked ring buffer against a sliding window of only the valid
    frames (at most L), in the port: each step's window is as long as the
    frames it has, with no mask and no PE offset."""
    torch.manual_seed(num_context)
    tw = setup_predictor(tiny_params(build_exp_params, add_predictor_params, name,
                                     num_context)).eval()
    for p in tw.parameters():  # away from the init, as a trained predictor is
        p.data.add_(0.05 * torch.randn_like(p))
    hist = torch.randn(B, num_context, S, D)
    ids, lengths = captions()
    text = torch_text(ids, lengths)
    preds = 5
    with torch.no_grad():
        out = tw(hist, num_preds=preds, **text)
        p = tw.predictor
        kv = (p.precompute_text_kv(p.encode_text(**text))
              if name == "TextOCVP_CustomTF" else None)
        window, manual = list(hist.unbind(1)), []
        for _ in range(preds):
            x = torch.stack(window, dim=1)
            cur = p(x, kv) if kv is not None else p(x)
            manual.append(cur)
            window = (window + [cur])[-L:]
    assert out.shape == (B, preds, S, D)
    torch.testing.assert_close(out, torch.stack(manual, dim=1), rtol=3e-5, atol=3e-5)


@pytest.mark.parametrize("size", ["tiny", "full_width"])
@pytest.mark.parametrize("name", OTHERS)
def test_trainable_parameters_are_the_jax_leaves(name, size):
    """Every JAX leaf trains in these four predictors, CustomTF's text
    encoder too: the same count of numbers in every top-level module."""
    if size == "tiny":
        jp = tiny_params(jax_build_exp_params, jax_add_predictor_params, name)
        tp = tiny_params(build_exp_params, add_predictor_params, name)
    else:
        jp = jax_add_predictor_params(jax_build_exp_params("SAVi", "CATER_Easy"), name)
        tp = add_predictor_params(build_exp_params("SAVi", "CATER_Easy"), name)
    mp = jp["model"]["model_params"]
    ids, lengths = captions()
    shapes = jax.eval_shape(lambda: jax_setup_predictor(jp).init(
        {"params": jax.random.PRNGKey(3)}, jnp.zeros((1, 1, mp["num_slots"], mp["slot_dim"])),
        **jax_text(ids[:1], lengths[:1])))
    ref = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(shapes["params"]["predictor"])[0]:
        ref[path[0].key] = ref.get(path[0].key, 0) + int(np.prod(leaf.shape))
    model = setup_predictor(tp)
    ours = {}
    for pname, p in model.predictor.named_parameters():
        parts = pname.split(".")
        # flax names the i-th layer "layer_<i>" / block "block_<i>", the port's
        # ModuleLists "layers.<i>" / "blocks.<i>"
        top = f"{parts[0][:-1]}_{parts[1]}" if parts[0] in ("layers", "blocks") else parts[0]
        assert p.requires_grad, pname
        ours[top] = ours.get(top, 0) + p.numel()
    assert ours == ref
    if name == "TextOCVP_CustomTF":
        assert ref["text_encoder"] > 0


def test_the_t5_stays_frozen_and_the_custom_encoder_trains():
    t5 = setup_predictor(add_predictor_params(build_exp_params("SAVi", "CATER_Easy"),
                                              "TextOCVP_T5"))
    custom = setup_predictor(tiny_params(build_exp_params, add_predictor_params,
                                         "TextOCVP_CustomTF"))
    assert not any(p.requires_grad for p in t5.predictor.text_encoder.parameters())
    assert all(p.requires_grad for p in custom.predictor.text_encoder.parameters())
    ids, lengths = captions()
    emb = custom.predictor.encode_text(**torch_text(ids, lengths))
    assert emb.requires_grad
    with pytest.raises(KeyError, match="caption_lengths"):
        custom.predictor.encode_text(torch.from_numpy(ids))


# ------------------------------------------------------------------- data


@pytest.mark.parametrize("uint8", [False, True], ids=["float32", "uint8"])
@pytest.mark.parametrize("split", ["train", "test"])
def test_synthetic_items_equal_jax_bit_for_bit(split, uint8):
    kw = dict(num_seqs=5, num_frames=4, img_size=(16, 16), total_frames=9,
              uint8_output=uint8)
    ours, ref = SyntheticBalls(split=split, **kw), JaxSyntheticBalls(split=split, **kw)
    assert len(ours) == len(ref) == 5 and ours.vocabulary == ref.vocabulary
    for epoch in range(2):  # the clip start does not move with the epoch
        for idx in range(5):
            (fo, co), (fr, cr) = ours[idx], ref[idx]
            assert co == cr and fo.dtype == fr.dtype
            np.testing.assert_array_equal(fo, fr)


def test_load_data_reads_synthetic_with_its_custom_tokenizer():
    p = tiny_params(build_exp_params, add_predictor_params, "OCVPSeq",
                    base=build_exp_params("SAVi", "Synthetic"))
    p["dataset"].update(num_train_seqs=6, num_eval_seqs=3, img_size=[16, 16], total_frames=9,
                        num_frames=4)
    for split, n in (("train", 6), ("valid", 3)):
        ours, ref = load_data(p, split), jax_load_data(p, split)
        assert len(ours) == len(ref) == n and isinstance(ours.tokenizer, CustomTokenizer)
        videos, info = next(iter(EpochLoader(ours, batch_size=3)))
        ref_info = ref.tokenizer(info["caption"])
        assert videos.shape == (3, 4, 16, 16, 3) and info["attn_masks"] is None
        for key in ("caption_tokens", "caption_lengths"):
            np.testing.assert_array_equal(info[key], ref_info[key], err_msg=key)
        assert info["caption_tokens"].max() < 16  # SYNTHETIC_VOCAB
        np.testing.assert_array_equal(videos[0], ref[0][0])


# ---------------------------------------------------------------- service


def test_service_text_plumbing(tmp_path, monkeypatch):
    """An experiment's tokenizer comes from its dataset config: a closed
    vocabulary refuses a word outside it (ValueError), warms up with a word
    of its own, and hands the predictor ``caption_lengths``; an
    unconditioned predictor's frames do not depend on the caption."""
    from textocvp_tpu_torch.core.experiment import Experiment
    from textocvp_tpu_torch.models.factory import random_init_
    from textocvp_tpu_torch.serve import PredictionService
    from test_torch_port_train_savi import tiny_savi_params

    res = 16
    decomp = tiny_savi_params(build_exp_params)
    decomp["model"]["model_params"]["initializer"] = "Learned"  # no noise between requests
    decomp["dataset"]["tokenizer"] = "CustomTokenizer"
    parent = Experiment(tmp_path / "exp")
    parent.save_params(decomp)
    parent.models_dir.mkdir(parents=True)
    from textocvp_tpu_torch.models import setup_model
    torch.save(random_init_(setup_model(decomp), torch.Generator().manual_seed(0)).state_dict(),
               parent.checkpoint_path("c"))
    frames = np.random.default_rng(0).uniform(0, 1, (B, 1, res, res, 3)).astype(np.float32)
    outs = {}
    for name in ("TextOCVP_CustomTF", "OCVPSeq"):
        pp = tiny_params(build_exp_params, add_predictor_params, name, base=decomp)
        pred = Experiment(parent.exp_path / "predictors" / name)
        pred.save_params(pp)
        pred.models_dir.mkdir(parents=True)
        torch.save(random_init_(setup_predictor(pp), torch.Generator().manual_seed(1))
                   .state_dict(), pred.checkpoint_path("c"))
        svc = PredictionService(parent.exp_path, name, "c", "c", batch_size=B, max_tokens=16,
                                device="cpu")
        assert isinstance(svc.tokenizer, CustomTokenizer)
        seen = []
        forward = type(svc.predictor).forward

        def spy(self, *args, **kwargs):
            seen.append(sorted(k for k in kwargs if k.startswith(("caption", "attn"))))
            return forward(self, *args, **kwargs)

        monkeypatch.setattr(type(svc.predictor), "forward", spy)
        svc.warmup()  # "the": the word of lowest id
        assert svc._warmup_caption() == "the"
        with pytest.raises(ValueError, match="out-of-vocabulary word: 'warmup'"):
            svc.predict(frames, ["warmup", "the cone"])
        outs[name] = [svc.predict(frames, list(c)) for c in
                      (CAPTIONS, ["the snitch is sliding", "the cone is rotating"])]
        assert seen[0] == ["caption_lengths", "caption_tokens"]
        monkeypatch.undo()
    np.testing.assert_array_equal(*outs["OCVPSeq"])
    assert not np.array_equal(*outs["TextOCVP_CustomTF"])


def test_jax_service_and_port_tokenize_a_custom_experiment_alike(tmp_path):
    from textocvp_tpu.serve.pipeline import _serving_tokenizer
    from textocvp_tpu_torch.serve.pipeline import serving_tokenizer

    for dataset in ("CATER_Easy", "CATER_Hard", "Synthetic"):
        p = build_exp_params("SAVi", dataset)
        p["dataset"]["tokenizer"] = "CustomTokenizer"
        text = ["the"] if dataset == "Synthetic" else CAPTIONS
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            ours, ref = serving_tokenizer(p)(text), _serving_tokenizer(p)(text)
        for key in ("caption_tokens", "caption_lengths"):
            np.testing.assert_array_equal(ours[key], ref[key])
