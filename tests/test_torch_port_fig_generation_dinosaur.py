"""The port's 06a figure generator on a tiny ExtendedDINOSAUR (2 ViT-S/14
blocks at 42 px, the MLP patch decoder and its BatchNorm CNN head) over a
CLIPort color cache, against the JAX package's, on the CPU: as
``test_torch_port_fig_generation.py`` does on SAVi (its patch alphas through
``process_objs_masks_dinosaur`` at 96 px), and a features-only decoder's
figures without the reconstructions."""

import torch_cpu_threads  # noqa: F401  (two torch threads a worker)
import json
import os

os.environ.setdefault("HF_HUB_OFFLINE", "1")
os.environ.setdefault("TRANSFORMERS_OFFLINE", "1")

import pytest  # noqa: E402
import torch  # noqa: E402
from test_torch_port_cliport import IMG, tiny_cliport_params, write_cliport  # noqa: E402
from test_torch_port_decomp_eval import write_experiment  # noqa: E402
from test_torch_port_fig_generation import check_06a, tree  # noqa: E402

from textocvp_tpu.core.config import add_predictor_params as jax_add_predictor_params  # noqa: E402
from textocvp_tpu.core.config import build_exp_params as jax_build_exp_params  # noqa: E402
from textocvp_tpu_torch.core.experiment import Experiment  # noqa: E402
from textocvp_tpu_torch.train.fig_generation import DecompFigGenerator  # noqa: E402

CLIP_FRAMES = 3


@pytest.fixture(scope="module")
def dinosaur_exp(tmp_path_factory):
    root = tmp_path_factory.mktemp("figs_dinosaur")
    params, _ = tiny_cliport_params(jax_build_exp_params, jax_add_predictor_params,
                                    write_cliport(root / "CLIPort"))
    params["dataset"]["num_frames"] = CLIP_FRAMES
    return write_experiment(root / "exp", params, "dinosaur", IMG, 63)


def test_06a_matches_the_jax_generator_on_extended_dinosaur(dinosaur_exp, monkeypatch,
                                                           tmp_path):
    check_06a(dinosaur_exp, monkeypatch, tmp_path)


def test_06a_draws_a_features_only_decoder_without_its_recons(dinosaur_exp, tmp_path):
    exp = Experiment(tmp_path / "features")
    exp.models_dir.mkdir(parents=True)
    state = torch.load(dinosaur_exp / "models" / "ckpt.pt")
    torch.save({k: v for k, v in state.items() if not k.startswith("patch_decoder.cnn")},
               exp.checkpoint_path("ckpt"))  # no CNN head without images
    params = json.loads((dinosaur_exp / "experiment_params.json").read_text())
    params["model"]["model_params"]["decoder"]["decoder_params"]["reconstruct_images"] = False
    exp.save_params(params)
    gen = DecompFigGenerator(exp.exp_path, "ckpt", num_seqs=1, device="cpu")
    gen.load_data()
    gen.load_model()
    assert {f for _, f in tree(gen.generate_figs())} == {"objects.png", "masks.png",
                                                          "segmentation.png"}
