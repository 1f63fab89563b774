"""
Process-group bring-up of the port (counterpart of the JAX package's
``textocvp_tpu/parallel/distributed.py``).

The JAX package runs one controller per host over many devices; the port
runs one process per GPU, as PyTorch does. A run joins a process group when
its environment says so, either torchrun's (``MASTER_ADDR``, ``MASTER_PORT``,
``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``) or the JAX
package's (``TEXTOCVP_COORDINATOR=host:port``, ``TEXTOCVP_NUM_PROCESSES``,
``TEXTOCVP_PROCESS_ID``; one host unless ``LOCAL_RANK`` and
``LOCAL_WORLD_SIZE`` say otherwise)::

    torchrun --nproc_per_node 8 -m textocvp_tpu_torch.cli.train_decomp -d EXP

Without that environment nothing changes: no process group is made and
:func:`get_runtime_mesh` gives a mesh of one process that runs no
collective.

The backend follows from where the ranks live: ``nccl`` when each rank has a
GPU of its own, ``gloo`` on the CPU, and ``gloo`` when several ranks share
one GPU (NCCL refuses two ranks on one device). Under gloo the collectives
of ``parallel/mesh.py`` pass CUDA tensors through host copies. Every
collective times out after :data:`TIMEOUT_S` seconds, so that a rank that
skips one fails with an error instead of hanging.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

TIMEOUT_S = 120
_STATE = {"initialized": False, "backend": None, "device": None}


def _env_int(name: str, default: Optional[int] = None) -> Optional[int]:
    raw = os.environ.get(name)
    return default if raw in (None, "") else int(raw)


def launch_env() -> Optional[dict]:
    """The process group's coordinates from the environment, or None when
    this is a single-process run: ``init_method``, ``world``, ``rank``,
    ``local_rank``, ``local_world``."""
    coord = os.environ.get("TEXTOCVP_COORDINATOR")
    if coord:
        init = f"tcp://{coord}"
        world = _env_int("TEXTOCVP_NUM_PROCESSES", default=1)
        rank = _env_int("TEXTOCVP_PROCESS_ID", default=0)
    elif os.environ.get("MASTER_ADDR") and os.environ.get("WORLD_SIZE"):
        init, world, rank = "env://", _env_int("WORLD_SIZE"), _env_int("RANK", default=0)
    else:
        return None
    return {"init_method": init, "world": world, "rank": rank,
            "local_rank": _env_int("LOCAL_RANK", default=rank),
            "local_world": _env_int("LOCAL_WORLD_SIZE", default=world)}


def pick_backend(local_world: int) -> str:
    """``nccl`` when every local rank has a GPU of its own, else ``gloo``."""
    if torch.cuda.is_available() and local_world <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def maybe_initialize_distributed() -> bool:
    """Join the process group that the environment names. Returns True iff
    this process is (now or already) in one. Idempotent: the CLIs and the
    trainers all call it, and only the first call initializes. Sets this
    rank's GPU (``torch.cuda.set_device(local_rank)``, modulo the count when
    ranks share a GPU) before the group is made; on ranks other than 0 it
    turns ``logs.txt`` writes off (``Logger.file_writes_enabled``), since
    the experiment directory is shared."""
    if _STATE["initialized"] or dist.is_initialized():
        _STATE["initialized"] = True
        return True
    env = launch_env()
    if env is None:
        return False
    backend = pick_backend(env["local_world"])
    device = torch.device("cpu")
    if torch.cuda.is_available():
        device = torch.device("cuda", env["local_rank"] % torch.cuda.device_count())
        torch.cuda.set_device(device)
    timeout = datetime.timedelta(seconds=TIMEOUT_S)
    dist.init_process_group(backend, init_method=env["init_method"], world_size=env["world"],
                            rank=env["rank"], timeout=timeout)
    _STATE.update(initialized=True, backend=backend, device=device,
                  local_world=env["local_world"], timeout=timeout)
    if env["rank"] != 0:
        from textocvp_tpu_torch.core.logger import Logger

        Logger.file_writes_enabled = False
    return True


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def is_process_zero() -> bool:
    """True on the one process that writes the experiment's side outputs
    (checkpoints, TensorBoard events, results.json, figures, logs.txt); every
    single-process run."""
    return not is_initialized() or dist.get_rank() == 0


def destroy():
    """Leave the process group (tests and the card's checks make several)."""
    if is_initialized():
        dist.destroy_process_group()
    _STATE.update(initialized=False, backend=None, device=None)


def runtime_device(device) -> torch.device:
    """``device`` as this rank uses it: a bare ``cuda`` becomes this rank's GPU."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None and _STATE["device"] is not None \
            and _STATE["device"].type == "cuda":
        return _STATE["device"]
    return device


def get_runtime_mesh(tpu_params: Optional[dict] = None, device="cpu"):
    """The trainers' and evaluators' mesh from ``tpu.mesh_axes`` (default
    ``{"data": -1, "model": 1}``) over the process group; a mesh of one
    process without groups when there is none."""
    from textocvp_tpu_torch.parallel.mesh import Mesh

    axes = dict((tpu_params or {}).get("mesh_axes") or {"data": -1, "model": 1})
    return Mesh(data=int(axes.get("data", -1)), model=int(axes.get("model", 1)),
                device=runtime_device(device))


def loader_process_kwargs(mesh) -> dict:
    """``EpochLoader`` keywords for the mesh's batch split: each data index
    loads its contiguous rows of every global batch (the ranks of one model
    group load the same rows), a ragged global batch padded to the data
    axis. No keywords on a mesh whose data axis is 1 (every rank loads the
    whole batch, as one process does)."""
    if mesh is None or mesh.data <= 1:
        return {}
    return {"process_index": mesh.data_index, "process_count": mesh.data,
            "pad_to_multiple": mesh.data}
