"""
Checkpoint I/O of the port (counterpart of the JAX package's
``textocvp_tpu/train/checkpoints.py``).

A training checkpoint is one ``torch.save`` file in the experiment's
``models/`` directory (``Experiment.checkpoint_path``) holding ``{"params":
<the model's state dict>, "opt_state": <Adam.state_dict()>, "epoch": E,
"step": S}``, written to a unique temporary file and moved into place with
``os.replace``. Names follow the JAX package's cadence, with ``.pt`` in place
of ``.msgpack``:

* ``checkpoint_last_saved.pt``   every epoch
* ``checkpoint_epoch_<E>.pt``    every ``save_frequency`` epochs
* ``checkpoint_epoch_final.pt``  at the end of training
* ``emergency_checkpoint_epoch_<E>.pt`` on an exception or an interrupt

The JAX package's background writer (``tpu.async_checkpoint``) is not
ported: the port writes in the training loop's thread.

Readers of model weights (the 04 trainer's frozen decomposition model, the
05 evaluator, the service) go through :func:`load_params`, which takes a
training checkpoint or a bare state dict.
"""

from __future__ import annotations

import os
import pickle
from pathlib import Path

import torch


def _to_cpu(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


def save_checkpoint(path, state: dict) -> Path:
    """Write one checkpoint (tensors moved to the CPU) atomically; returns its path."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    # a unique temporary name: two savers must not truncate each other's file
    tmp = path.with_name(f"{path.name}.tmp.{os.getpid()}")
    torch.save(_to_cpu(state), tmp)
    os.replace(tmp, path)
    return path


def load_checkpoint(path) -> dict:
    """Read a checkpoint onto the CPU; raises, naming the file, if it is
    missing or torch cannot read it."""
    path = Path(path)
    if not path.is_file():
        raise FileNotFoundError(f"Checkpoint {path} not found")
    try:
        return torch.load(path, map_location="cpu", weights_only=True)
    except (pickle.UnpicklingError, RuntimeError, EOFError) as e:
        raise ValueError(f"Checkpoint {path} is not a torch file of tensors: {e}") from e


def _is_state_dict(obj) -> bool:
    return (isinstance(obj, dict) and bool(obj)
            and all(isinstance(k, str) and isinstance(v, torch.Tensor) for k, v in obj.items()))


def load_params(path) -> dict:
    """A module's state dict from ``path``: ``state["params"]`` of a training
    checkpoint, or the file itself when it is a bare state dict. Raises,
    naming the file, when it is neither."""
    state = load_checkpoint(path)
    if isinstance(state, dict) and _is_state_dict(state.get("params")):
        return state["params"]
    if _is_state_dict(state):
        return state
    keys = list(state)[:8] if isinstance(state, dict) else type(state).__name__
    raise ValueError(f"Checkpoint {path} holds neither a training checkpoint "
                     f"({{'params': <state dict>, ...}}) nor a state dict: {keys}")
