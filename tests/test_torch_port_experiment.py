"""The port's 01 CLIs against the JAX package's, on the CPU: the
``experiment_params.json`` each writes for every model x dataset pair and
every predictor (the JAX package's ``tpu`` block apart, a set of knobs the
port does not have), the directories, the refusals, ``--name``, and a user
config under ``TEXTOCVP_CONFIGS``."""

import torch_cpu_threads  # noqa: F401  (two torch threads a worker)
import json

import pytest

from textocvp_tpu.cli import create_experiment as jax_create_experiment
from textocvp_tpu.cli import create_predictor_experiment as jax_create_predictor_experiment
from textocvp_tpu.core import config as jax_config
from textocvp_tpu_torch.cli import create_experiment, create_predictor_experiment
from textocvp_tpu_torch.core.config import (
    add_predictor_params,
    build_exp_params,
    get_available_configs,
    get_config,
)
from textocvp_tpu_torch.core.experiment import Experiment

MODELS = ["ExtendedDINOSAUR", "SAVi"]
DATASETS = ["CATER_Easy", "CATER_Hard", "CLIPort", "Synthetic"]
PREDICTORS = ["OCVPPar", "OCVPSeq", "TextOCVP_CustomTF", "TextOCVP_T5", "VanillaTransformer"]


def params_of(path):
    return json.loads((path / "experiment_params.json").read_text())


def without_tpu(params):
    return {k: v for k, v in params.items() if k != "tpu"}


def test_the_registry_lists_the_jax_packages_configs():
    assert get_available_configs("models") == MODELS
    assert get_available_configs("datasets") == DATASETS
    assert get_available_configs("predictors") == PREDICTORS
    for kind in ("models", "datasets", "predictors"):
        assert get_available_configs(kind) == jax_config.get_available_configs(kind)
    with pytest.raises(ValueError, match=r"Unknown models config 'SAVI'\. Available: "):
        get_config("models", "SAVI")
    with pytest.raises(ValueError, match="unknown config kind"):
        get_available_configs("optimizers")


@pytest.mark.parametrize("dataset", DATASETS)
@pytest.mark.parametrize("model", MODELS)
def test_create_experiment_writes_the_jax_params(tmp_path, model, dataset):
    args = ["--model_name", model, "--dataset_name", dataset]
    ours = create_experiment.main(["-d", str(tmp_path / "ours"), *args])
    jax_create_experiment.main(["-d", str(tmp_path / "jax"), *args])
    assert ours.exp_path == tmp_path / "ours"
    assert params_of(ours.exp_path) == without_tpu(params_of(tmp_path / "jax"))
    assert params_of(ours.exp_path) == build_exp_params(model, dataset)
    for sub in ("models", "plots", "tboard_logs"):
        assert (ours.exp_path / sub).is_dir() and not any((ours.exp_path / sub).iterdir())
    # the CLI's lines in the experiment's logs.txt, as the JAX CLI writes them
    logged = [line.split("    ", 1)[1] for line in
              (ours.exp_path / "logs.txt").read_text().splitlines()]
    jax_logged = [line.split("    ", 1)[1] for line in
                  (tmp_path / "jax" / "logs.txt").read_text().splitlines()]
    assert logged == [f"INFO: Created experiment at {ours.exp_path}",
                      f"INFO:   model: {model}  dataset: {dataset}"]
    assert [line.replace(str(tmp_path / "jax"), str(ours.exp_path))
            for line in jax_logged] == logged


@pytest.mark.parametrize("predictor", PREDICTORS)
def test_create_predictor_experiment_writes_the_jax_params(tmp_path, predictor):
    for name, cli in (("ours", create_experiment), ("jax", jax_create_experiment)):
        cli.main(["-d", str(tmp_path / name), "--model_name", "SAVi",
                  "--dataset_name", "CATER_Easy"])
        (tmp_path / name / "models" / "SAVi_CATER.pt").write_bytes(b"")
    args = ["--name_pred_exp", "pred", "--predictor_name", predictor]
    ours = create_predictor_experiment.main(["-d", str(tmp_path / "ours"), *args])
    jax_create_predictor_experiment.main(["-d", str(tmp_path / "jax"), *args])
    assert ours.exp_path == tmp_path / "ours" / "predictors" / "pred"
    assert ours.parent.exp_path == tmp_path / "ours"
    want = without_tpu(params_of(tmp_path / "jax" / "predictors" / "pred"))
    assert params_of(ours.exp_path) == want
    assert want == add_predictor_params(build_exp_params("SAVi", "CATER_Easy"), predictor)
    assert all((ours.exp_path / sub).is_dir() for sub in ("models", "plots", "tboard_logs"))


def test_the_refusals(tmp_path):
    exp = tmp_path / "exp"
    create_experiment.main(["-d", str(exp), "--model_name", "SAVi", "--dataset_name", "CLIPort"])
    with pytest.raises(FileExistsError, match="already exists"):
        create_experiment.main(["-d", str(exp), "--model_name", "SAVi",
                                "--dataset_name", "CLIPort"])
    args = ["--name", "p", "--predictor_name", "TextOCVP_T5"]
    with pytest.raises(FileNotFoundError, match="Parent experiment not found"):
        create_predictor_experiment.main(["-d", str(tmp_path / "none"), *args])
    with pytest.raises(FileNotFoundError, match="no trained checkpoints"):
        create_predictor_experiment.main(["-d", str(exp), *args])
    assert not (exp / "predictors").exists()
    made = create_predictor_experiment.main(["-d", str(exp), *args, "--skip_ckpt_check"])
    assert made.exp_path == exp / "predictors" / "p"
    with pytest.raises(FileExistsError, match="already exists"):
        create_predictor_experiment.main(["-d", str(exp), *args, "--skip_ckpt_check"])
    # the JAX package refuses the same
    with pytest.raises(FileNotFoundError, match="no trained checkpoints"):
        jax_create_predictor_experiment.main(["-d", str(exp), "--name", "q",
                                              "--predictor_name", "TextOCVP_T5"])
    with pytest.raises(SystemExit):  # argparse lists the choices
        create_experiment.main(["-d", str(tmp_path / "x"), "--model_name", "SAVI",
                                "--dataset_name", "CLIPort"])
    with pytest.raises(FileNotFoundError, match="experiment_params.json"):
        Experiment(tmp_path / "none").params


def test_name_and_the_experiments_root(tmp_path, monkeypatch):
    made = create_experiment.main(["-d", str(tmp_path), "--name", "TextOCVP_CATER",
                                   "--model_name", "SAVi", "--dataset_name", "CATER_Easy"])
    assert made.exp_path == tmp_path / "TextOCVP_CATER"
    assert made.params == params_of(tmp_path / "TextOCVP_CATER")
    monkeypatch.setenv("TEXTOCVP_EXPERIMENTS", str(tmp_path / "root"))
    monkeypatch.chdir(tmp_path)
    made = create_experiment.main(["-d", "relative", "--model_name", "ExtendedDINOSAUR",
                                   "--dataset_name", "CLIPort"])
    assert made.exp_path == tmp_path / "root" / "relative"


def test_a_user_config_under_textocvp_configs(tmp_path, monkeypatch):
    user = tmp_path / "configs"
    (user / "datasets").mkdir(parents=True)
    mine = {**get_config("datasets", "CATER_Easy"), "dataset_name": "CATER_Easy",
            "root": "/data/CATER", "num_frames": 6}
    (user / "datasets" / "CATER_Mine.json").write_text(json.dumps(mine))
    # a user file of a shipped name takes its place
    (user / "datasets" / "CLIPort.json").write_text(json.dumps({"dataset_name": "CLIPort",
                                                                "num_frames": 4}))
    monkeypatch.setenv("TEXTOCVP_CONFIGS", str(user))
    monkeypatch.setitem(jax_config.CONFIG["paths"], "configs_path", str(user))
    assert get_available_configs("datasets") == sorted(DATASETS + ["CATER_Mine"])
    assert get_available_configs("models") == MODELS
    for name in ("CATER_Mine", "CLIPort"):
        args = ["--name", name, "--model_name", "SAVi", "--dataset_name", name]
        ours = create_experiment.main(["-d", str(tmp_path / "ours"), *args])
        jax_create_experiment.main(["-d", str(tmp_path / "jax"), *args])
        assert params_of(ours.exp_path) == without_tpu(params_of(tmp_path / "jax" / name))
    assert params_of(tmp_path / "ours" / "CATER_Mine")["dataset"]["num_frames"] == 6
    assert params_of(tmp_path / "ours" / "CLIPort")["dataset"] == {
        "dataset_name": "CLIPort", "shuffle_train": True, "shuffle_eval": False, "num_frames": 4}
