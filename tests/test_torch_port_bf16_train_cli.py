"""A bf16 experiment through the 02 and 04 CLIs and 05 on the CPU: the tiny
SAVi and TextOCVP_T5 of ``test_torch_port_train_predictor.py`` with
``"tpu": {"compute_dtype": "bfloat16"}``.

* 02 then 04 write checkpoints of float32 parameters and float32 Adam state
  (the models compute in bf16; nothing else is bf16);
* a run resumed from ``checkpoint_last_saved`` ends where an uninterrupted
  run of as many epochs ends, bit for bit;
* the emergency checkpoint of a failed bf16 step holds float32 state and
  resumes;
* 05 evaluates the bf16 04 checkpoint in bf16, with finite metrics.
"""

import torch_cpu_threads  # noqa: F401  (two torch threads a worker)
import json

import numpy as np
import pytest
import torch
from test_torch_port_train_predictor import P, _decomp_experiment, _predictor_experiment

from textocvp_tpu_torch.cli import evaluate_predictor, train_decomp, train_predictor
from textocvp_tpu_torch.core.experiment import Experiment
from textocvp_tpu_torch.train.evaluator import PredictorEvaluator
from textocvp_tpu_torch.train.trainer import DecompTrainer

BF16 = {"compute_dtype": "bfloat16"}


def _bf16(exp: Experiment, **training) -> Experiment:
    params = exp.params
    params["tpu"] = dict(BF16)
    params["training"].update(training)
    exp.save_params(params)
    return exp


def _float32_state(path) -> dict:
    state = torch.load(path, weights_only=True)
    assert set(state) == {"params", "opt_state", "epoch", "step"}
    tensors = list(state["params"].values()) + [
        t for t in torch.utils._pytree.tree_leaves(state["opt_state"])
        if isinstance(t, torch.Tensor) and t.is_floating_point()]
    assert tensors and all(t.dtype == torch.float32 for t in tensors if t.is_floating_point())
    return state


@pytest.fixture(scope="module")
def bf16_decomp(tmp_path_factory):
    """The tiny SAVi trained by the 02 CLI: one epoch in float32, then one more
    in bf16, resumed from the float32 checkpoint."""
    root = tmp_path_factory.mktemp("bf16_cli")
    exp = _decomp_experiment(root)  # a float32 epoch first: the fixture's data and layout
    _bf16(exp, num_epochs=2)
    train_decomp.main(["-d", str(exp.exp_path), "--checkpoint", "checkpoint_last_saved",
                       "--resume_training", "--device", "cpu"])
    return exp


def test_02_in_bf16_writes_float32_checkpoints_and_resumes_where_it_stopped(tmp_path, capsys):
    exp = _decomp_experiment(tmp_path / "a")
    _bf16(exp, num_epochs=1)
    capsys.readouterr()
    first = train_decomp.main(["-d", str(exp.exp_path), "--device", "cpu"])
    out = capsys.readouterr().out
    losses = [float(line.split("loss=")[1]) for line in out.splitlines() if "loss=" in line]
    assert losses and np.isfinite(losses).all()
    assert next(first.model.parameters()).dtype == torch.float32
    assert first.model.image_decoder.compute_dtype == torch.bfloat16
    _float32_state(exp.checkpoint_path("checkpoint_epoch_final"))
    _bf16(exp, num_epochs=2)
    resumed = train_decomp.main(["-d", str(exp.exp_path), "--checkpoint",
                                 "checkpoint_last_saved", "--resume_training", "--device", "cpu"])
    assert resumed.start_epoch == 1 and resumed.optimizer.count == 2 * first.optimizer.count
    straight_exp = _bf16(_decomp_experiment(tmp_path / "b"), num_epochs=2)
    straight = train_decomp.main(["-d", str(straight_exp.exp_path), "--device", "cpu"])
    for (name, a), b in zip(resumed.model.state_dict().items(),
                            straight.model.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=name)


def test_emergency_checkpoint_of_a_bf16_step_is_float32_and_resumes(tmp_path, monkeypatch):
    exp = _bf16(_decomp_experiment(tmp_path), num_epochs=1)
    tr = DecompTrainer(exp.exp_path, device="cpu")
    tr.load_data()
    tr.setup_model()
    step, calls = DecompTrainer.train_step, []

    def failing(self, videos, noise=None, **text):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("boom")
        return step(self, videos, noise, **text)

    monkeypatch.setattr(DecompTrainer, "train_step", failing)
    with pytest.raises(RuntimeError, match="boom"):
        tr.training_loop()
    state = _float32_state(exp.checkpoint_path("emergency_checkpoint_epoch_0"))
    assert state["opt_state"]["count"] == 1
    monkeypatch.setattr(DecompTrainer, "train_step", step)
    resumed = train_decomp.main(["-d", str(exp.exp_path), "--checkpoint",
                                 "emergency_checkpoint_epoch_0", "--resume_training",
                                 "--device", "cpu"])
    assert resumed.optimizer.count > 1


def test_04_in_bf16_trains_resumes_and_05_evaluates_it_in_bf16(bf16_decomp, capsys):
    pred = _bf16(_predictor_experiment(bf16_decomp, "bf16"))
    argv = ["-d", str(bf16_decomp.exp_path), "--name_pred_exp", "bf16", "--decomp_ckpt",
            "checkpoint_epoch_final", "--device", "cpu"]
    first = train_predictor.main(argv)
    assert first.decomp_model.compute_dtype == first.model.compute_dtype == torch.bfloat16
    _float32_state(pred.checkpoint_path("checkpoint_epoch_final"))
    _bf16(pred, num_epochs=2)
    resumed = train_predictor.main(argv + ["--checkpoint", "checkpoint_last_saved",
                                           "--resume_training"])
    assert resumed.start_epoch == 1 and resumed.optimizer.count == 2 * first.optimizer.count
    _float32_state(pred.checkpoint_path("checkpoint_epoch_final"))
    evaluate_predictor.main(["-d", str(bf16_decomp.exp_path), "--name_pred_exp", "bf16",
                             "--decomp_ckpt", "checkpoint_epoch_final", "--pred_ckpt",
                             "checkpoint_epoch_final", "--num_seed", "1", "--num_preds",
                             str(P), "--batch_size", "2", "--device", "cpu"])
    res = pred.exp_path / "results" / f"eval_pred_checkpoint_epoch_final_NumSeed=1_NumPreds={P}"
    results = json.load(open(res / "results.json"))
    for m in ("psnr", "ssim", "lpips"):
        assert len(results[m]["framewise"]) == P
        assert np.isfinite(results[m]["framewise"] + [results[m]["mean"]]).all(), m
    ev = PredictorEvaluator(bf16_decomp.exp_path, "bf16", "checkpoint_epoch_final",
                            "checkpoint_epoch_final", device="cpu")
    ev.load_models()
    assert ev.model.compute_dtype == torch.bfloat16  # what the 05 CLI ran
