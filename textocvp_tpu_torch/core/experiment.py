"""
Experiment directory (counterpart of ``textocvp_tpu/core/experiment.py``):

    <exp>/experiment_params.json       full config
    <exp>/models/<name>.pt             checkpoints (train/checkpoints.py)
    <exp>/plots/                       figures
    <exp>/tboard_logs/                 training logs
    <exp>/results/<run>/results.json   metric outputs
    <exp>/predictors/<pname>/...       nested predictor experiment, same layout

:meth:`Experiment.create` and :meth:`Experiment.create_predictor` make the
directories the 01 CLIs make. The JAX package's ``logs.txt`` (its
``core/logger.py``) is not written: the port's logger is not ported yet.
"""

from __future__ import annotations

import json
import os
from pathlib import Path

from textocvp_tpu_torch.core.config import add_predictor_params, build_exp_params

SUBDIRS = ("models", "plots", "tboard_logs")


class Experiment:
    PARAMS_FILE = "experiment_params.json"

    def __init__(self, exp_path: str | os.PathLike):
        self.exp_path = Path(exp_path)
        self._params: dict | None = None

    @classmethod
    def create(cls, exp_path: str | os.PathLike, model_name: str,
               dataset_name: str) -> "Experiment":
        """A new decomposition experiment at ``exp_path``, its params
        materialized from the registered model and dataset configs. Refuses
        an existing experiment."""
        exp = cls(exp_path)
        if exp.params_path.exists():
            raise FileExistsError(f"Experiment already exists at {exp.exp_path}")
        params = build_exp_params(model_name, dataset_name)
        exp._make_dirs()
        exp.save_params(params)
        return exp

    @classmethod
    def create_predictor(cls, parent_path: str | os.PathLike, name: str, predictor_name: str,
                         require_parent_ckpt: bool = True) -> "Experiment":
        """A new predictor experiment ``<parent>/predictors/<name>``, its params
        the parent's with the registered predictor config merged in. Refuses a
        parent without params, or (with ``require_parent_ckpt``) without a file
        in its ``models/``, and an existing predictor experiment."""
        parent = cls(parent_path)
        if not parent.params_path.exists():
            raise FileNotFoundError(f"Parent experiment not found at {parent.exp_path}")
        if require_parent_ckpt and not any(parent.models_dir.glob("*")):
            raise FileNotFoundError(
                f"Parent experiment {parent.exp_path} has no trained checkpoints in models/")
        exp = cls(parent.exp_path / "predictors" / name)
        if exp.params_path.exists():
            raise FileExistsError(f"Predictor experiment already exists at {exp.exp_path}")
        params = add_predictor_params(parent.params, predictor_name)
        exp._make_dirs()
        exp.save_params(params)
        return exp

    def _make_dirs(self):
        for sub in SUBDIRS:
            (self.exp_path / sub).mkdir(parents=True, exist_ok=True)

    @property
    def params_path(self) -> Path:
        return self.exp_path / self.PARAMS_FILE

    @property
    def params(self) -> dict:
        if self._params is None:
            if not self.params_path.is_file():
                raise FileNotFoundError(f"no {self.PARAMS_FILE} in {self.exp_path}")
            with open(self.params_path) as f:
                self._params = json.load(f)
        return self._params

    def save_params(self, params: dict) -> None:
        self.exp_path.mkdir(parents=True, exist_ok=True)
        self._params = params
        with open(self.params_path, "w") as f:
            json.dump(params, f, indent=4)

    @property
    def models_dir(self) -> Path:
        return self.exp_path / "models"

    def checkpoint_path(self, name: str) -> Path:
        """``models/<name>.pt``; ``name`` may carry the suffix already."""
        name = str(name)
        return self.models_dir / (name if name.endswith(".pt") else f"{name}.pt")

    @property
    def plots_dir(self) -> Path:
        d = self.exp_path / "plots"
        d.mkdir(parents=True, exist_ok=True)
        return d

    @property
    def parent(self) -> "Experiment | None":
        """The decomposition experiment of a nested predictor experiment
        (``<exp>/predictors/<name>``), else None."""
        if self.exp_path.parent.name == "predictors":
            return Experiment(self.exp_path.parent.parent)
        return None

    def results_dir(self, run_name: str) -> Path:
        d = self.exp_path / "results" / run_name
        d.mkdir(parents=True, exist_ok=True)
        return d

    def save_results(self, run_name: str, results: dict) -> Path:
        """Write ``results/<run>/results.json``; keys of an earlier file that
        ``results`` does not carry are kept."""
        results_file = self.results_dir(run_name) / "results.json"
        merged = dict(results)
        if results_file.exists():
            with open(results_file) as f:
                for k, v in json.load(f).items():
                    merged.setdefault(k, v)
        with open(results_file, "w") as f:
            json.dump(merged, f, indent=2)
        return results_file
