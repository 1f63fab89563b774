"""
Tensor parallelism of the predictors over the mesh's ``model`` axis
(counterpart of the JAX package's ``textocvp_tpu/parallel/partitioning.py``,
its predictor half), Megatron's pattern:

* attention ``q``/``k``/``v`` under ``attn``, ``cross_attn`` and
  ``self_attn``: the output (head) dim, this rank's group of heads
  (:class:`ColumnParallelLinear`, bias sliced with it);
* attention ``out`` / ``o`` under those names: the input dim
  (:class:`RowParallelLinear`, the bias added once after the sum);
* the feed-forward pairs, ``mlp.layers.0`` / ``linear1`` / ``wi`` (the JAX
  ``Dense_0``) by columns and ``mlp.layers.1`` / ``linear2`` / ``wo``
  (``Dense_1``) by rows.

The names are the JAX package's ``_spec_for_path`` rules read through
``convert.py``'s name mapping; OCVPPar's ``self_attn_obj`` /
``self_attn_time`` are not among them and stay replicated, as there. A layer
whose heads (or hidden width) the model axis does not divide stays
replicated, as ``shard_predictor_params`` keeps such leaves. Everything else
(LayerNorms, embeddings, the row layers' biases, positional encodings,
``mlp_in`` / ``mlp_out``) is replicated. T5's shared relative-position bias
keeps this rank's head columns: layer 0 computes the bias of the local heads
and hands it down.

The JAX package lets XLA insert the collectives; here they are two
``torch.autograd.Function``s. :class:`ColumnEntry` is the identity forward and
sums the input gradient over the model group backward (each rank holds the
part of it that its heads give). :class:`RowExit` sums the partial outputs
forward and is the identity backward: every model rank already holds the same
upstream gradient, and ``torch.distributed.nn.functional.all_reduce`` would
sum it again, ``model`` times too large. With the entry's sum, replicated
leaves get the same gradient on every model rank.

Checkpoints keep one layout for any mesh: :func:`gather_state_dict` gathers
every sharded leaf back to its full shape, and a checkpoint is loaded into
the whole module before :func:`shard_predictor_` slices it.

The decomposition half (``decomp_tp_enabled``, ``shard_decomp_variables``:
the ViT blocks and the patch decoder's MLP) is not ported: under ``model >
1`` the decomposition model is replicated, which changes no result.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from textocvp_tpu_torch.parallel.mesh import all_gather_rows, all_reduce

ATTENTION_PARENTS = ("attn", "cross_attn", "self_attn")


class ColumnEntry(torch.autograd.Function):
    """Identity forward; the input gradient summed over the model group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad.clone(), ctx.group), None


class RowExit(torch.autograd.Function):
    """The partial outputs summed over the model group forward; identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def _shard_param(p: torch.Tensor, dim: int, index: int, size: int) -> nn.Parameter:
    """This rank's contiguous slice of ``p`` along ``dim``, marked ``tp_shard
    = (dim, index, size)``."""
    per = p.shape[dim] // size
    part = nn.Parameter(p.detach().narrow(dim, index * per, per).clone(),
                        requires_grad=p.requires_grad)
    part.tp_shard = (dim, index, size)
    return part


class ColumnParallelLinear(nn.Module):
    """This rank's output rows of a ``nn.Linear`` (and of its bias), behind a
    :class:`ColumnEntry`. Its state-dict keys are the Linear's."""

    def __init__(self, linear: nn.Linear, index: int, size: int, group):
        super().__init__()
        self.group = group
        self.weight = _shard_param(linear.weight, 0, index, size)
        self.bias = None if linear.bias is None else _shard_param(linear.bias, 0, index, size)

    def forward(self, x):
        return F.linear(ColumnEntry.apply(x, self.group), self.weight, self.bias)


class RowParallelLinear(nn.Module):
    """This rank's input columns of a ``nn.Linear``; the partial products summed
    by :class:`RowExit`, then the (replicated) bias added once."""

    def __init__(self, linear: nn.Linear, index: int, size: int, group):
        super().__init__()
        self.group = group
        self.weight = _shard_param(linear.weight, 1, index, size)
        self.bias = linear.bias

    def forward(self, x):
        y = RowExit.apply(F.linear(x, self.weight), self.group)
        return y if self.bias is None else y + self.bias


def _split_pair(owner: nn.Module, col: str, row: str, index: int, size: int, group):
    setattr(owner, col, ColumnParallelLinear(getattr(owner, col), index, size, group))
    setattr(owner, row, RowParallelLinear(getattr(owner, row), index, size, group))


def shard_predictor_(module: nn.Module, mesh) -> list:
    """Shard a loaded predictor (or its ``PredictorWrapper``) in place over
    ``mesh``'s model axis and return the names of the sharded parameters; a
    mesh whose model axis is 1 changes nothing."""
    from textocvp_tpu_torch.nn.blocks import (
        MLP,
        MultiHeadCrossAttention,
        MultiHeadSelfAttention,
    )
    from textocvp_tpu_torch.nn.t5 import T5EncoderLayer, T5SelfAttention

    if not mesh.tensor_parallel:
        return []
    m, r, g = mesh.model, mesh.model_index, mesh.model_group
    for name, mod in list(module.named_modules()):
        attr = name.rsplit(".", 1)[-1]
        if isinstance(mod, (MultiHeadSelfAttention, MultiHeadCrossAttention, T5SelfAttention)):
            if attr not in ATTENTION_PARENTS or mod.num_heads % m:
                continue
            out = "o" if isinstance(mod, T5SelfAttention) else "out"
            for col in ("q", "k", "v"):
                setattr(mod, col, ColumnParallelLinear(getattr(mod, col), r, m, g))
            setattr(mod, out, RowParallelLinear(getattr(mod, out), r, m, g))
            mod.num_heads //= m
            bias = getattr(mod, "relative_attention_bias", None)
            if bias is not None:
                bias.weight = _shard_param(bias.weight, 1, r, m)
                bias.embedding_dim = bias.weight.shape[1]
        elif isinstance(mod, MLP) and attr == "mlp" and len(mod.layers) == 2:
            if mod.layers[0].out_features % m == 0:
                _split_pair(mod.layers, "0", "1", r, m, g)
        elif isinstance(mod, T5EncoderLayer):
            if mod.wi.out_features % m == 0:
                _split_pair(mod, "wi", "wo", r, m, g)
        elif isinstance(getattr(mod, "linear1", None), nn.Linear) \
                and isinstance(getattr(mod, "linear2", None), nn.Linear):
            if mod.linear1.out_features % m == 0:
                _split_pair(mod, "linear1", "linear2", r, m, g)
    return sharded_names(module)


def sharded_names(module: nn.Module) -> list:
    """Names of the parameters that hold a shard (``tp_shard``)."""
    return [n for n, p in module.named_parameters() if getattr(p, "tp_shard", None)]


def gather_full(t: torch.Tensor, shard, group) -> torch.Tensor:
    """A sharded leaf's full tensor from the model group's slices (``shard`` =
    ``(dim, index, size)``), in model-rank order."""
    dim = shard[0]
    if dim == 0:
        return all_gather_rows(t.detach(), group)
    return all_gather_rows(t.detach().transpose(0, dim).contiguous(), group).transpose(0, dim)


def slice_full(t: torch.Tensor, shard) -> torch.Tensor:
    """This rank's slice of a full tensor, as :func:`_shard_param` takes it."""
    dim, index, size = shard
    per = t.shape[dim] // size
    return t.narrow(dim, index * per, per)


def gather_state_dict(module: nn.Module, group) -> dict:
    """``module.state_dict()`` with every sharded parameter gathered to its
    full shape: the layout of a checkpoint written without a mesh. Every rank
    of the model group calls it (a collective)."""
    state = module.state_dict()
    for name, p in module.named_parameters():
        shard = getattr(p, "tp_shard", None)
        if shard:
            state[name] = gather_full(p, shard, group)
    return state
