"""Host-side modules of the PyTorch port against the JAX package's: config
registry, experiment store, video wire formats and tokenizers. These must give
the same dicts, the same floats bit for bit, and the same token ids."""

import json

import numpy as np
import pytest
import torch

from textocvp_tpu.core import config as jax_config
from textocvp_tpu.data import tokenizers as jax_tokenizers
from textocvp_tpu.data import wire as jax_wire
from textocvp_tpu.data.vocabularies import CATER_EASY_VOCAB as JAX_CATER_EASY_VOCAB
from textocvp_tpu_torch.core import config
from textocvp_tpu_torch.core.experiment import Experiment
from textocvp_tpu_torch.data import tokenizers, wire
from textocvp_tpu_torch.data.vocabularies import CATER_EASY_VOCAB

CAPTIONS = ["The cone is sliding to (1, -2).", "the snitch is picked up and placed to (-3, 3)",
            "first quadrant"]


@pytest.mark.parametrize("kind,name", [("models", "SAVi"), ("datasets", "CATER_Easy"),
                                       ("predictors", "TextOCVP_T5")])
def test_config_copies_match(kind, name):
    assert config.get_config(kind, name) == jax_config.get_config(kind, name)


def test_exp_params_match_without_tpu_knobs():
    ours = config.add_predictor_params(config.build_exp_params("SAVi", "CATER_Easy"),
                                       "TextOCVP_T5")
    ref = jax_config.add_predictor_params(jax_config.build_exp_params("SAVi", "CATER_Easy"),
                                          "TextOCVP_T5")
    ref.pop("tpu")
    assert ours == ref
    assert ours["prediction_params"]["num_context"] == 1
    assert ours["prediction_params"]["input_buffer_size"] == 10


def test_unknown_config_raises():
    with pytest.raises(ValueError, match="Available"):
        config.get_config("predictors", "SlotFormer")  # a predictor neither package has


def test_experiment_round_trip(tmp_path):
    exp = Experiment(tmp_path / "e")
    params = config.build_exp_params("SAVi", "CATER_Easy")
    exp.save_params(params)
    assert json.loads((tmp_path / "e" / "experiment_params.json").read_text()) == params
    assert Experiment(tmp_path / "e").params == params
    assert exp.checkpoint_path("c") == tmp_path / "e" / "models" / "c.pt"
    assert exp.checkpoint_path("c.pt") == exp.checkpoint_path("c")
    with pytest.raises(FileNotFoundError):
        Experiment(tmp_path / "missing").params


def test_as_float_video_is_bit_identical_on_both_wires():
    x = np.arange(256, dtype=np.uint8).reshape(1, 1, 16, 16, 1)
    ref = jax_wire.as_float_video(x)
    np.testing.assert_array_equal(wire.as_float_video(x), ref)
    np.testing.assert_array_equal(wire.as_float_video(torch.from_numpy(x)).numpy(), ref)
    assert wire.INV255 == jax_wire.INV255
    f = np.ones((2,), np.float32)
    assert wire.as_float_video(f) is f


def test_to_uint8_frames_clips_before_rounding():
    x = np.array([-0.5, 0.0, 0.5, 1.0, 1.5, 2.0], np.float32)
    np.testing.assert_array_equal(wire.to_uint8_frames(x), [0, 0, 128, 255, 255, 255])
    inside = np.linspace(0, 1, 1001, dtype=np.float32)
    np.testing.assert_array_equal(wire.to_uint8_frames(inside), jax_wire.to_uint8_frames(inside))


def test_hash_tokenizer_gives_the_jax_ids():
    ours = tokenizers.HashFallbackT5Tokenizer()(CAPTIONS)
    ref = jax_tokenizers.HashFallbackT5Tokenizer()(CAPTIONS)
    for key in ("caption_tokens", "caption_lengths", "attn_masks"):
        np.testing.assert_array_equal(ours[key], ref[key])
    assert tokenizers.HashFallbackT5Tokenizer.is_fallback


def test_custom_tokenizer_gives_the_jax_ids():
    assert CATER_EASY_VOCAB == JAX_CATER_EASY_VOCAB
    captions = ["the cone is sliding to ( 1 , -2 ) .", "the snitch is rotating"]
    ours = tokenizers.get_tokenizer("CustomTokenizer", CATER_EASY_VOCAB)(captions)
    ref = jax_tokenizers.get_tokenizer("CustomTokenizer", JAX_CATER_EASY_VOCAB)(captions)
    np.testing.assert_array_equal(ours["caption_tokens"], ref["caption_tokens"])
    np.testing.assert_array_equal(ours["caption_lengths"], ref["caption_lengths"])
    with pytest.raises(KeyError):
        tokenizers.get_tokenizer("CustomTokenizer", CATER_EASY_VOCAB)(["a purple cube"])


def test_t5_gate_falls_back_to_the_hash_tokenizer(monkeypatch):
    def unavailable(*args, **kwargs):
        raise OSError("no local t5-small files")

    monkeypatch.setattr(tokenizers.T5TokenizerWrapper, "__init__", unavailable)
    with pytest.warns(UserWarning, match="HASH tokenizer"):
        tok = tokenizers.get_tokenizer("T5")
    assert isinstance(tok, tokenizers.HashFallbackT5Tokenizer)
    with pytest.raises(NameError):
        tokenizers.get_tokenizer("BPE")
