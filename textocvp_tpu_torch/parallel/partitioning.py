"""
Tensor parallelism over the mesh's ``model`` axis (counterpart of the JAX
package's ``textocvp_tpu/parallel/partitioning.py``), Megatron's pattern.

The predictors (:func:`shard_predictor_`):

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

The decomposition model (:func:`shard_decomp_`, the JAX
``shard_decomp_variables``, gated by :func:`decomp_tp_enabled`: a ViT
encoder, i.e. ExtendedDINOSAUR; SAVi stays replicated). Its modules are
listed, not found by a walk of names:

* every ViT block: ``qkv`` and ``fc1`` by columns, ``proj`` and ``fc2`` by
  rows. ``qkv`` keeps timm's fused ``[q; k; v]`` output layout, so a rank
  takes its head group of q, of k and of v: three row ranges of the
  ``(3d, d)`` weight (``tp_shard``'s ``groups`` 3). The block's attention
  then runs at ``num_heads / model`` heads a rank;
* the patch decoder's ``mlps``: ``mlp_i`` by columns for even ``i`` and by
  rows for odd ``i``, each pair of a ReLU apart; an even last layer stays
  whole (its output would have to be gathered), which no config has;
* the transition ``TransformerBlock``'s ``attn`` and ``mlp``, as a
  predictor's.

The one departure from the JAX set: ``slot_attention.mlp`` (the JAX
``slot_attention/mlp/Dense_{0,1}``, which ``_spec_for_path`` shards) stays
whole. The slot-attention kernel (``csrc/slot_attention.cu``) computes that
MLP inside its one launch from the whole weights; where a weight lies
changes no result. The LayerNorms, the patch embedding, the CNN head and its
BatchNorm are replicated, as there.

The JAX package lets XLA insert the collectives; here they are two
``torch.autograd.Function``s. :class:`ColumnEntry` is the identity forward and
sums the input gradient over the model group backward (each rank holds the
part of it that its heads give). :class:`RowExit` sums the partial outputs
forward and is the identity backward: every model rank already holds the same
upstream gradient, and ``torch.distributed.nn.functional.all_reduce`` would
sum it again, ``model`` times too large.

Both layers compute in the compute dtype of the layer they replace
(``nn/precision.py``, flax's ``promote_dtype``). In bfloat16 a row layer's
partial products are float32 sums of the bf16 operands' exact products
(:class:`RowPartial`: on the card one bf16 tensor-core GEMM that writes
float32), all-reduced in float32 and rounded to bf16 once, then the bias
added in bf16: the order in which XLA computes a bf16 dot whose contraction
the JAX mesh shards (a float32 all-reduce of the partial dots, then the
convert). Summing bf16 partials would round twice. The input gradient's sum
runs in float32 too, rounded once to the gradient's dtype. With the entry's sum, replicated
leaves get the same gradient on every model rank. The opt-in int8 of a row
layer (``ops/dense_int8.py``, its ``row_group``) takes the whole weight's
per-row scales and sums the integer partial products.

Checkpoints keep one layout for any mesh: :func:`gather_state_dict` gathers
every sharded leaf back to its full shape, and a checkpoint is loaded into
the whole module before :func:`shard_predictor_` or :func:`shard_decomp_`
slices it. The emergency checkpoint under tensor parallelism cannot gather
(a failed rank may never join the collective): every rank writes its own
slices and their ``tp_shard``, and :func:`join_slices` puts a leaf back
together from a set of such files (``train/checkpoints.py``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from textocvp_tpu_torch.nn.precision import compute_dtype
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
        return all_reduce(grad.to(torch.float32, copy=True), ctx.group).to(grad.dtype), None


class RowExit(torch.autograd.Function):
    """The partial outputs summed over the model group forward; identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def _dot32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` of bf16 values, their exact products summed in float32 and
    not rounded: on the card a bf16 GEMM that writes float32 (cuBLAS on the
    tensor cores), elsewhere a float32 GEMM of the same values."""
    if a.is_cuda:
        return torch.mm(a.to(torch.bfloat16), b.to(torch.bfloat16), out_dtype=torch.float32)
    return a.float() @ b.float()


class RowPartial(torch.autograd.Function):
    """A bf16 row layer's partial product: bf16 ``x`` (..., K) times the bf16
    weight ``w`` (N, K) transposed, as float32 (:func:`_dot32`). Backward
    the same for each operand's gradient, rounded once to bf16: the gradient
    arrives through the bf16 rounding of the summed output, so its float32
    values are bf16 ones."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _dot32(x.reshape(-1, x.shape[-1]), w.t()).reshape(*x.shape[:-1], w.shape[0])

    @staticmethod
    def backward(ctx, grad):
        x, w = ctx.saved_tensors
        g = grad.reshape(-1, grad.shape[-1])
        return (_dot32(g, w).reshape(x.shape).to(x.dtype),
                _dot32(g.t(), x.reshape(-1, x.shape[-1])).to(w.dtype))


def _shard_param(p: torch.Tensor, dim: int, index: int, size: int,
                 groups: int = 1) -> nn.Parameter:
    """This rank's slice of ``p`` along ``dim``, marked ``tp_shard = (dim,
    index, size, groups)``: the ``index``-th of ``size`` contiguous parts,
    or with ``groups`` > 1 that part of each of ``dim``'s ``groups`` equal
    blocks (a fused ``[q; k; v]``), the blocks' parts in order."""
    part = nn.Parameter(slice_full(p.detach(), (dim, index, size, groups)).clone(),
                        requires_grad=p.requires_grad)
    part.tp_shard = (dim, index, size, groups)
    return part


class ColumnParallelLinear(nn.Module):
    """This rank's output rows of a ``nn.Linear`` (and of its bias; with
    ``groups``, of each of its ``groups`` blocks), behind a
    :class:`ColumnEntry`. Its state-dict keys are the Linear's."""

    def __init__(self, linear: nn.Linear, index: int, size: int, group, groups: int = 1):
        super().__init__()
        self.group = group
        self.compute_dtype = compute_dtype(linear)
        self.weight = _shard_param(linear.weight, 0, index, size, groups)
        self.bias = (None if linear.bias is None
                     else _shard_param(linear.bias, 0, index, size, groups))

    def forward(self, x):
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(ColumnEntry.apply(x, self.group).to(dt), self.weight.to(dt), bias)


class RowParallelLinear(nn.Module):
    """This rank's input columns of a ``nn.Linear``; the partial products summed
    by :class:`RowExit`, then the (replicated) bias added once. ``row_group``
    tells the int8 path (``ops/dense_int8.py``) that its weight and input are
    shards."""

    def __init__(self, linear: nn.Linear, index: int, size: int, group):
        super().__init__()
        self.group = self.row_group = group
        self.compute_dtype = compute_dtype(linear)
        self.weight = _shard_param(linear.weight, 1, index, size)
        self.bias = linear.bias

    def forward(self, x):
        dt = self.compute_dtype
        if dt == torch.float32:
            partial = F.linear(x.float(), self.weight)
        else:  # float32 partials of the bf16 operands, rounded once after the sum
            partial = RowPartial.apply(x.to(dt), self.weight.to(dt))
        y = RowExit.apply(partial, self.group).to(dt)
        return y if self.bias is None else y + self.bias.to(dt)


def _split_pair(owner: nn.Module, col: str, row: str, index: int, size: int, group):
    setattr(owner, col, ColumnParallelLinear(getattr(owner, col), index, size, group))
    setattr(owner, row, RowParallelLinear(getattr(owner, row), index, size, group))


def _shard_attention(mod, out: str, m: int, r: int, g):
    """``q``/``k``/``v`` by columns, ``out`` by rows, ``num_heads`` the local
    count; nothing when ``m`` does not divide the heads."""
    if mod.num_heads % m:
        return
    for col in ("q", "k", "v"):
        setattr(mod, col, ColumnParallelLinear(getattr(mod, col), r, m, g))
    setattr(mod, out, RowParallelLinear(getattr(mod, out), r, m, g))
    mod.num_heads //= m


def _shard_mlp(mlp, m: int, r: int, g):
    """A two-layer ``MLP``'s pair, when ``m`` divides its hidden width."""
    if mlp.layers[0].out_features % m == 0:
        _split_pair(mlp.layers, "0", "1", r, m, g)


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
            _shard_attention(mod, "o" if isinstance(mod, T5SelfAttention) else "out", m, r, g)
            bias = getattr(mod, "relative_attention_bias", None)
            if bias is not None:
                bias.weight = _shard_param(bias.weight, 1, r, m)
                bias.embedding_dim = bias.weight.shape[1]
        elif isinstance(mod, MLP) and attr == "mlp" and len(mod.layers) == 2:
            _shard_mlp(mod, m, r, g)
        elif isinstance(mod, T5EncoderLayer):
            if mod.wi.out_features % m == 0:
                _split_pair(mod, "wi", "wo", r, m, g)
        elif isinstance(getattr(mod, "linear1", None), nn.Linear) \
                and isinstance(getattr(mod, "linear2", None), nn.Linear):
            if mod.linear1.out_features % m == 0:
                _split_pair(mod, "linear1", "linear2", r, m, g)
    return sharded_names(module)


def decomp_tp_enabled(exp_params: dict) -> bool:
    """Whether the decomposition model shards under ``model > 1``: its
    encoder's name holds "vit" (ExtendedDINOSAUR), the JAX package's rule.
    SAVi's 128-wide layers would pay an all-reduce a recurrence step for
    nothing, so it stays replicated."""
    enc = (exp_params.get("model", {}).get("model_params", {}).get("encoder", {})) or {}
    return "vit" in str(enc.get("encoder_name", "")).lower()


def shard_decomp_(model: nn.Module, mesh) -> list:
    """Shard a loaded ExtendedDINOSAUR in place over ``mesh``'s model axis
    (the modules the module docstring lists; ``slot_attention`` whole) and
    return the names of the sharded parameters; a mesh whose model axis is 1
    changes nothing. Callers gate it with :func:`decomp_tp_enabled`."""
    from textocvp_tpu_torch.nn.blocks import TransformerBlock

    if not mesh.tensor_parallel:
        return []
    m, r, g = mesh.model, mesh.model_index, mesh.model_group
    for block in model.image_encoder.blocks:
        if block.num_heads % m == 0:
            block.qkv = ColumnParallelLinear(block.qkv, r, m, g, groups=3)
            block.proj = RowParallelLinear(block.proj, r, m, g)
            block.num_heads //= m
        if block.fc1.out_features % m == 0:
            _split_pair(block, "fc1", "fc2", r, m, g)
    mlps = model.patch_decoder.mlps
    for i in range(0, len(mlps) - 1, 2):
        if mlps[i].out_features % m == 0:
            _split_pair(mlps, str(i), str(i + 1), r, m, g)
    if isinstance(model.transition, TransformerBlock):
        _shard_attention(model.transition.attn, "out", m, r, g)
        _shard_mlp(model.transition.mlp, m, r, g)
    return sharded_names(model)


def sharded_names(module: nn.Module) -> list:
    """Names of the parameters that hold a shard (``tp_shard``)."""
    return [n for n, p in module.named_parameters() if getattr(p, "tp_shard", None)]


def gather_full(t: torch.Tensor, shard, group) -> torch.Tensor:
    """A sharded leaf's full tensor from the model group's slices (``shard`` =
    ``(dim, index, size, groups)``), in model-rank order within each of the
    ``groups`` blocks."""
    dim, _, size, groups = shard
    parts = all_gather_rows(t.detach().transpose(0, dim).contiguous(), group)
    rest = parts.shape[1:]
    parts = parts.reshape(size, groups, -1, *rest).transpose(0, 1).reshape(-1, *rest)
    return parts.transpose(0, dim)


def slice_full(t: torch.Tensor, shard) -> torch.Tensor:
    """This rank's slice of a full tensor, as :func:`_shard_param` takes it."""
    dim, index, size, groups = shard
    block = t.shape[dim] // groups
    per = block // size
    return torch.cat([t.narrow(dim, j * block + index * per, per) for j in range(groups)], dim)


def join_slices(parts, shard) -> torch.Tensor:
    """The full tensor from every model rank's slice (``parts`` in model-rank
    order), the inverse of :func:`slice_full` and what :func:`gather_full`
    gathers, with no collective: within each of the ``groups`` blocks of
    ``dim`` the ranks' parts in order."""
    dim, _, size, groups = shard
    if len(parts) != size:
        raise ValueError(f"{len(parts)} slices of a leaf sharded {size} ways")
    blocks = [t.chunk(groups, dim) for t in parts]
    return torch.cat([blocks[j][g] for g in range(groups) for j in range(size)], dim)


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
