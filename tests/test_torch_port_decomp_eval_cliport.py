"""The port's 03 evaluate-decomposition protocol on the CPU on a tiny
ExtendedDINOSAUR (2 ViT-S/14 blocks at 42 px, the MLP patch decoder and its
BatchNorm CNN head) over a CLIPort color cache: its ``results.json`` against
the JAX ``DecompEvaluator``'s, and a ragged batch's rows. As
``test_torch_port_decomp_eval.py``, with the CNN head's BatchNorm statistics
moved off 0 and 1; three test episodes of 4 frames in batches of 2."""

import torch_cpu_threads  # noqa: F401  (two torch threads a worker)
import pytest
from test_torch_port_cliport import IMG, tiny_cliport_params, write_cliport
from test_torch_port_decomp_eval import check_against_jax, check_ragged_rows, write_experiment

from textocvp_tpu.core.config import add_predictor_params as jax_add_predictor_params
from textocvp_tpu.core.config import build_exp_params as jax_build_exp_params

CLIP_FRAMES, EPISODES = 4, 3


@pytest.fixture(scope="module")
def dinosaur_exp(tmp_path_factory):
    root = tmp_path_factory.mktemp("decomp_dinosaur")
    params, _ = tiny_cliport_params(jax_build_exp_params, jax_add_predictor_params,
                                    write_cliport(root / "CLIPort"))
    params["dataset"]["num_frames"] = CLIP_FRAMES
    return write_experiment(root / "exp", params, "dinosaur", IMG, 52)


def test_results_match_the_jax_decomp_evaluator(dinosaur_exp, monkeypatch):
    check_against_jax(dinosaur_exp, monkeypatch, CLIP_FRAMES, EPISODES)


def test_a_ragged_batch_equals_the_full_batchs_rows(dinosaur_exp):
    check_ragged_rows(dinosaur_exp)
