"""
The ``(data, model)`` mesh of the port (counterpart of the JAX package's
``textocvp_tpu/parallel/mesh.py``), over ``torch.distributed``: one process
per GPU, explicit collectives.

* ``data``: the batch splits over it, each data index its contiguous rows;
  gradients are averaged over the data group once a step.
* ``model``: the predictors' large matmuls, and ExtendedDINOSAUR's, shard
  over it, Megatron's pattern (``parallel/partitioning.py``).

Rank ``r`` sits at data index ``r // model`` and model index ``r % model``:
the ranks of a model group are consecutive, so that tensor parallelism stays
inside a node's NVLink (``model`` must divide the ranks a node holds). The
JAX package's ``dcn`` axis (``get_hybrid_mesh``, the hosts) folds into
``data`` through this order: the nodes are consecutive blocks of ranks, and
the data axis runs across them.

A mesh made without a process group (a single-process run) is of one rank
and has no groups; its collectives return their input unchanged and run no
communication, so every single-process path is the same as without a mesh.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from textocvp_tpu_torch.parallel import distributed as _dist


class Mesh:
    """A ``(data, model)`` mesh over the process group.

    ``data=-1`` takes ``world // model``; a ``data * model`` that is not the
    world size raises. Fields: ``world``, ``rank``, ``data``, ``model``,
    ``data_index``, ``model_index``, ``data_group`` (the ranks of this
    model index), ``model_group`` (the ranks of this data index),
    ``world_group``, ``device``, ``backend`` (None without a process group).
    Every rank makes every group, in the same order."""

    def __init__(self, data: int = -1, model: int = 1, device="cpu"):
        distributed = _dist.is_initialized()
        world = dist.get_world_size() if distributed else 1
        rank = dist.get_rank() if distributed else 0
        if model < 1:
            raise ValueError(f"model={model} must be >= 1")
        if data == -1:
            if world % model:
                raise ValueError(f"{world} processes not divisible by model={model}")
            data = world // model
        if data * model != world:
            raise ValueError(f"mesh {data}x{model} != {world} processes")
        local_world = _dist._STATE.get("local_world") or world
        if local_world % model:
            raise ValueError(f"model={model} does not divide the {local_world} ranks of a node: "
                             "a model group must stay inside one node")
        self.world, self.rank, self.data, self.model = world, rank, data, model
        self.data_index, self.model_index = rank // model, rank % model
        self.device = torch.device(device)
        self.distributed = distributed
        self.backend = dist.get_backend() if distributed else None
        self.data_group = self.model_group = self.world_group = None
        if distributed:
            self.world_group = dist.group.WORLD
            timeout = _dist._STATE.get("timeout")
            for j in range(model):
                group = dist.new_group(list(range(j, world, model)), timeout=timeout)
                if j == self.model_index:
                    self.data_group = group
            for k in range(data):
                group = dist.new_group(list(range(k * model, (k + 1) * model)), timeout=timeout)
                if k == self.data_index:
                    self.model_group = group

    def __repr__(self):
        return (f"Mesh(data={self.data}, model={self.model}, rank={self.rank}, "
                f"backend={self.backend}, device={self.device})")

    @property
    def tensor_parallel(self) -> bool:
        return self.model_group is not None and self.model > 1


# ------------------------------------------------------------------ collectives


def _staged(t: torch.Tensor, group) -> bool:
    """Whether ``t`` passes through a host copy: a CUDA tensor on a gloo group."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def all_reduce(t: torch.Tensor, group=None, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """Sum ``t`` over ``group`` in place (or reduce it by ``op``,
    ``dist.ReduceOp.MAX``) and return it; ``t`` itself without a group (a
    single-process mesh)."""
    if group is None:
        return t
    if _staged(t, group):
        host = t.detach().cpu()
        dist.all_reduce(host, op=op, group=group)
        t.copy_(host)
        return t
    dist.all_reduce(t, op=op, group=group)
    return t


def all_gather_rows(t: torch.Tensor, group=None) -> torch.Tensor:
    """The equal-sized tensors of ``group``'s ranks concatenated along the
    first axis, in group-rank order (data index order for a data group)."""
    if group is None:
        return t
    src = t.detach().cpu() if _staged(t, group) else t.contiguous()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts).to(t.device)


def broadcast_object(obj, src: int = 0, group=None):
    """``obj`` of rank ``src`` (a global rank) on every rank of ``group``,
    pickled; ``obj`` itself without a process group."""
    if not _dist.is_initialized():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src, group=group)
    return box[0]


def barrier():
    """Every rank waits for the others (after a write that they will read);
    nothing without a process group."""
    if _dist.is_initialized():
        dist.barrier()


class AllReduceSum(torch.autograd.Function):
    """A differentiable sum over a group: every rank's output depends on every
    rank's input, so the gradient is summed over the group too (BatchNorm's
    global statistics under data parallelism)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x.clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad.clone(), ctx.group), None


# ---------------------------------------------------------------- batch helpers


def _is_array(x) -> bool:
    return isinstance(x, (np.ndarray, torch.Tensor)) and x.ndim >= 1


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not (tree and isinstance(tree[0], str)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _leaves(tree):
    out = []
    _tree_map(lambda x: out.append(x), tree)
    return out


def shard_batch(batch, mesh: Mesh):
    """This data index's contiguous rows of every array leaf of a global
    batch; other leaves (captions) pass through. A batch whose rows do not
    divide the data axis raises: pad it first (:func:`pad_batch`)."""

    def take(x):
        if not _is_array(x):
            return x
        if x.shape[0] % mesh.data:
            raise ValueError(f"batch of {x.shape[0]} rows does not divide data={mesh.data}")
        per = x.shape[0] // mesh.data
        return x[mesh.data_index * per:(mesh.data_index + 1) * per]

    return _tree_map(take, batch)


def global_tokens(info: dict, tokenizer, mesh: Mesh) -> dict:
    """``info`` with this data index's rows of the global batch's tokens: the
    captions gathered over the data group and tokenized together, so that
    they pad to the global batch's longest, as one process pads them (the
    fusion attends the padding). ``info`` itself on a data axis of 1."""
    if mesh.data_group is None or mesh.data == 1 or tokenizer is None:
        return info
    parts = [None] * mesh.data
    dist.all_gather_object(parts, list(info["caption"]), group=mesh.data_group)
    tokens = tokenizer([c for part in parts for c in part])
    return {**info, **shard_batch({k: v for k, v in tokens.items() if v is not None}, mesh)}


def pad_batch_to_multiple(batch_size: int, mesh: Mesh) -> int:
    """Smallest batch size >= ``batch_size`` that the data axis divides."""
    d = mesh.data
    return ((batch_size + d - 1) // d) * d


def pad_batch(batch, mesh: Mesh):
    """Every array leaf's rows padded to the data multiple by repeating the
    last row; returns ``(padded_batch, original_batch_size)``: the caller cuts
    per-sample outputs back to it."""
    leaves = [x for x in _leaves(batch) if _is_array(x)]
    if not leaves:
        return batch, 0
    b = leaves[0].shape[0]
    target = pad_batch_to_multiple(b, mesh)
    if target == b:
        return batch, b
    reps = np.concatenate([np.arange(b), np.full(target - b, b - 1)])

    def pad(x):
        if _is_array(x) and x.shape[0] == b:
            return x[torch.from_numpy(reps).to(x.device)] if isinstance(x, torch.Tensor) \
                else np.asarray(x)[reps]
        return x

    return _tree_map(pad, batch), b
