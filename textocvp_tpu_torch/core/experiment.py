"""
Experiment directory, trimmed to what the service reads:

    <exp>/experiment_params.json       full config
    <exp>/models/<name>.pt             torch state dicts
    <exp>/predictors/<pname>/...       nested predictor experiment, same layout
"""

from __future__ import annotations

import json
import os
from pathlib import Path


class Experiment:
    PARAMS_FILE = "experiment_params.json"

    def __init__(self, exp_path: str | os.PathLike):
        self.exp_path = Path(exp_path)
        self._params: dict | None = None

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
