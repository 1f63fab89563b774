"""The 04 CLI and its 05 CLI on the checkpoint for two of the port's other
predictors on the CPU: OCVPSeq over the CATER fixture, TextOCVP_CustomTF
over the ``Synthetic`` set with its CustomTokenizer, through the tiny SAVi
the 02 CLI trains (``test_torch_port_train_predictor.py::_decomp_experiment``):
finite losses, the checkpoints, finite metrics."""

import torch_cpu_threads  # noqa: F401  (two torch threads a worker)
import json
import os

os.environ.setdefault("HF_HUB_OFFLINE", "1")
os.environ.setdefault("TRANSFORMERS_OFFLINE", "1")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
from test_torch_port_predictors import tiny_params  # noqa: E402
from test_torch_port_train_predictor import _decomp_experiment  # noqa: E402
from test_torch_port_train_predictors import B, P, RES  # noqa: E402
from test_torch_port_train_predictors_eval import CUSTOM  # noqa: E402

from textocvp_tpu_torch.cli import evaluate_predictor, train_predictor  # noqa: E402
from textocvp_tpu_torch.core.config import add_predictor_params, build_exp_params  # noqa: E402
from textocvp_tpu_torch.core.experiment import Experiment  # noqa: E402


@pytest.fixture(scope="module")
def decomp_exp(tmp_path_factory):
    return _decomp_experiment(tmp_path_factory.mktemp("preds_cli"))


@pytest.mark.parametrize("name", CUSTOM)
def test_04_cli_trains_and_05_evaluates_its_checkpoint(decomp_exp, name, capsys):
    """04 and 05 of OCVPSeq over the CATER fixture, of TextOCVP_CustomTF over
    the Synthetic set with its CustomTokenizer, through the tiny SAVi."""
    p = tiny_params(build_exp_params, add_predictor_params, name, base=decomp_exp.params)
    if name == "TextOCVP_CustomTF":
        p["dataset"] = {**build_exp_params("SAVi", "Synthetic")["dataset"], "img_size": [RES, RES],
                        "num_train_seqs": 6, "num_eval_seqs": 3, "total_frames": 8}
    p["training"].update({"num_epochs": 1, "batch_size": B, "save_frequency": 1,
                          "log_frequency": 1, "lr": 1e-3, "warmup_steps": 2})
    pred = Experiment(decomp_exp.exp_path / "predictors" / name)
    pred.save_params(p)
    trainer = train_predictor.main(["-d", str(decomp_exp.exp_path), "--name_pred_exp", name,
                                    "--decomp_ckpt", "checkpoint_epoch_final", "--device", "cpu"])
    out = capsys.readouterr().out
    losses = [float(line.split("loss=")[1]) for line in out.splitlines() if "loss=" in line]
    steps = 4 if name == "OCVPSeq" else 3  # 7 CATER videos or 6 Synthetic ones, batches of 2
    assert len(losses) == steps and np.isfinite(losses).all()
    assert trainer.optimizer.count == steps
    assert {q.name for q in pred.models_dir.iterdir()} == {
        "checkpoint_last_saved.pt", "checkpoint_epoch_1.pt", "checkpoint_epoch_final.pt"}
    evaluate_predictor.main(["-d", str(decomp_exp.exp_path), "--name_pred_exp", name,
                             "--decomp_ckpt", "checkpoint_epoch_final", "--pred_ckpt",
                             "checkpoint_epoch_final", "--num_seed", "1", "--num_preds",
                             str(P), "--batch_size", "2", "--device", "cpu"])
    res = pred.exp_path / "results" / f"eval_pred_checkpoint_epoch_final_NumSeed=1_NumPreds={P}"
    results = json.load(open(res / "results.json"))
    for m in ("psnr", "ssim", "lpips"):
        assert len(results[m]["framewise"]) == P
        assert np.isfinite(results[m]["framewise"] + [results[m]["mean"]]).all(), m
