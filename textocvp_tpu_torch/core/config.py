"""
Config registry of the PyTorch port: JSON configs shipped under
``textocvp_tpu_torch/configs/{datasets,models,predictors}`` merged over
``DEFAULTS`` into an ``experiment_params.json`` dict.

The port keeps its own copy of the registry and of the configs it serves,
the JAX package's files unchanged (models SAVi and ExtendedDINOSAUR;
datasets CATER_Easy, CATER_Hard, CLIPort and Synthetic; predictors
VanillaTransformer, OCVPSeq, OCVPPar, TextOCVP_CustomTF and TextOCVP_T5),
so it runs where the JAX package cannot be imported. The layout of the materialized dict is
the JAX package's, so one ``experiment_params.json`` drives both packages.

A directory named by ``TEXTOCVP_CONFIGS`` is searched first: a JSON file under
its ``datasets/``, ``models/`` or ``predictors/`` registers a new option, or
takes the place of a shipped one of the same name.
"""

from __future__ import annotations

import copy
import json
import os
from pathlib import Path

_PKG_CONFIG_DIR = Path(__file__).resolve().parent.parent / "configs"

# Machine-level settings, the JAX package's CONFIG keys the port reads:
# the data loader's workers (TEXTOCVP_NUM_WORKERS, default 8).
CONFIG = {
    "random_seed": 14,
    "num_workers": int(os.environ.get("TEXTOCVP_NUM_WORKERS", "8")),
}

# Training/prediction defaults, the same keys and values as the JAX package's
# DEFAULTS minus its TPU runtime knobs.
DEFAULTS = {
    "dataset": {
        "dataset_name": "",
        "shuffle_train": True,
        "shuffle_eval": False,
    },
    "model": {
        "model_name": "",
        "model_params": {},
    },
    "predictor": {
        "predictor_name": "",
        "predictor_params": {},
    },
    "loss": [
        {"type": "mse", "weight": 1},
    ],
    "predictor_loss": [
        {"type": "pred_img_mse", "weight": 1},
        {"type": "pred_slot_mse", "weight": 1},
    ],
    "training": {
        "num_epochs": 1000,
        "save_frequency": 25,
        "log_frequency": 100,
        "image_log_frequency": 300,
        "batch_size": 64,
        "lr": 1e-4,
        "scheduler": "cosine_annealing",
        "scheduler_steps": 1e6,
        "lr_warmup": True,
        "warmup_steps": 2000,
        "gradient_clipping": True,
        "clipping_max_value": 0.05,
    },
    "prediction_params": {
        "num_context": 1,
        "num_preds": 9,
        "teacher_force": False,
        "input_buffer_size": 10,
    },
}

_KINDS = ("datasets", "models", "predictors")


def _config_dirs(kind: str) -> list[Path]:
    """The directories searched for configs of ``kind``, the user's
    (``$TEXTOCVP_CONFIGS/<kind>``) first."""
    if kind not in _KINDS:
        raise ValueError(f"unknown config kind {kind!r}; use one of {_KINDS}")
    dirs = []
    user = os.environ.get("TEXTOCVP_CONFIGS")
    if user and (Path(user) / kind).is_dir():
        dirs.append(Path(user) / kind)
    if (_PKG_CONFIG_DIR / kind) not in dirs:
        dirs.append(_PKG_CONFIG_DIR / kind)
    return dirs


def get_available_configs(kind: str) -> list[str]:
    """Names of every registered config of ``kind``, sorted."""
    return sorted({p.stem for d in _config_dirs(kind) for p in d.glob("*.json")})


def get_config(kind: str, name: str) -> dict:
    """Load one registered JSON config by kind and name."""
    for d in _config_dirs(kind):
        path = d / f"{name}.json"
        if path.is_file():
            with open(path) as f:
                return json.load(f)
    raise ValueError(f"Unknown {kind} config {name!r}. Available: {get_available_configs(kind)}")


def build_exp_params(model_name: str, dataset_name: str) -> dict:
    """DEFAULTS + a registered model config + a registered dataset config."""
    params = copy.deepcopy(DEFAULTS)
    params["dataset"] = {**params["dataset"], **get_config("datasets", dataset_name)}
    params["model"]["model_name"] = model_name
    params["model"]["model_params"] = get_config("models", model_name)
    if model_name == "ExtendedDINOSAUR":
        # dual loss: DINO-feature MSE + image MSE
        params["loss"] = [
            {"type": "pred_feature_mse", "weight": 1},
            {"type": "mse", "weight": 1},
        ]
    return params


def add_predictor_params(exp_params: dict, predictor_name: str) -> dict:
    """Merge a registered predictor config into a decomposition experiment's params."""
    params = copy.deepcopy(exp_params)
    params["predictor"] = get_config("predictors", predictor_name)
    params.setdefault("predictor_loss", copy.deepcopy(DEFAULTS["predictor_loss"]))
    params.setdefault("prediction_params", copy.deepcopy(DEFAULTS["prediction_params"]))
    return params
