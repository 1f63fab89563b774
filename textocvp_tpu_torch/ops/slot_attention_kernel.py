"""
Slot-attention refinement: the CUDA kernel of ``csrc/slot_attention.cu`` and
its plain PyTorch version.

The kernel replaces the JAX package's Pallas TPU kernel
(``textocvp_tpu/ops/pallas/slot_attention_kernel.py::_slot_attention_kernel``);
the plain version is the counterpart of its XLA twin ``_xla_iterations``. The
source file says what bounds the kernel on an H100 and how its design answers:
one launch a call, a grid of thread-block clusters with one cluster a batch
element, every iteration inside the launch, the CTAs of a cluster splitting
the locations in the attention and the weights' rows in the update and
meeting through distributed shared memory.

* :func:`slot_attention_iterations` dispatches on the tensor's device: a CPU
  tensor runs :func:`slot_attention_plain` (plain autograd), a CUDA tensor
  goes through :class:`SlotAttentionFunction`, whose forward launches the
  kernel through :func:`slot_attention_cuda` or raises. There is no
  fallback: a failed build, a cluster the card cannot place, or a launch
  error raises. Where no gradient is recorded the call is the op
  ``torch.ops.textocvp_torch.slot_attention`` (``torch.library.custom_op``:
  the plain version for a CPU tensor, the kernel for a CUDA one), which
  ``torch.export`` records as one node.
* The kernel is compiled with ``nvcc`` for ``sm_90a`` into a shared library
  with a plain C interface (:mod:`textocvp_tpu_torch.ops.build`, at first use)
  and bound through ``ctypes``.
* The gradient is the JAX package's: its ``_fused`` custom VJP runs the
  Pallas forward and, in ``_fused_bwd``, ``jax.vjp`` through the XLA twin
  ``_xla_iterations``, recomputing the forward. :class:`SlotAttentionFunction`
  does the same with :func:`slot_attention_plain` under autograd: the kernel
  has no backward of its own.

``params`` is the dict of :meth:`SlotAttention.iteration_params`: LayerNorm
weights and biases (eps 1e-3), ``q_w`` (D, D), the GRU weights in
``torch.nn.GRUCell``'s layout (gate order r, z, n; ``gru_b_hh`` is [0; 0;
b_hn], the JAX GRU having no recurrent r and z bias) and the MLP weights, all
in torch's (out, in) layout.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from textocvp_tpu_torch.ops import build
from textocvp_tpu_torch.ops.grad_guard import needs_grad

LN_EPS = 1e-3

_PARAM_ORDER = ("norm_slot_w", "norm_slot_b", "q_w", "q_b",
                "gru_w_ih", "gru_b_ih", "gru_w_hh", "gru_b_hh",
                "norm_mlp_w", "norm_mlp_b", "mlp_w0", "mlp_b0", "mlp_w1", "mlp_b1")


def slot_attention_plain(k, v, slots, params: dict, num_iters: int, scale: float,
                         eps: float = 1e-8):
    """k, v (B, N, D); slots (B, S, D) -> (slots, attn (B, S, N)), attn being
    the last iteration's attention after +eps and before the renorm."""
    p = params
    d = slots.shape[-1]
    attn_out = None
    for _ in range(num_iters):
        prev = slots
        q = F.linear(F.layer_norm(slots, (d,), p["norm_slot_w"], p["norm_slot_b"], LN_EPS),
                     p["q_w"], p["q_b"])
        dots = torch.einsum("bsd,bnd->bsn", q, k) * scale
        attn = torch.softmax(dots, dim=1) + eps  # slots compete for each location
        attn_out = attn
        updates = torch.einsum("bsn,bnd->bsd", attn / attn.sum(-1, keepdim=True), v)
        i_r, i_z, i_n = F.linear(updates, p["gru_w_ih"], p["gru_b_ih"]).chunk(3, -1)
        h_r, h_z, h_n = F.linear(prev, p["gru_w_hh"], p["gru_b_hh"]).chunk(3, -1)
        r = torch.sigmoid(i_r + h_r)
        z = torch.sigmoid(i_z + h_z)
        n = torch.tanh(i_n + r * h_n)
        slots = (1.0 - z) * n + z * prev
        h = F.relu(F.linear(
            F.layer_norm(slots, (d,), p["norm_mlp_w"], p["norm_mlp_b"], LN_EPS),
            p["mlp_w0"], p["mlp_b0"]))
        slots = slots + F.linear(h, p["mlp_w1"], p["mlp_b1"])
    return slots, attn_out


# ----------------------------------------------------------------------------- build

_lib = None


def bind(lib):
    """Set the argument types of the C interface on a library built from
    ``csrc/slot_attention.cu``; returns it."""
    lib.sa_forward.argtypes = ([ctypes.c_void_p] * 19 + [ctypes.c_int] * 5
                               + [ctypes.c_float] * 2 + [ctypes.c_void_p])
    lib.sa_forward.restype = ctypes.c_int
    for fn in (lib.sa_width, lib.sa_max_slots, lib.sa_cluster_size):
        fn.argtypes = []
        fn.restype = ctypes.c_int
    lib.sa_active_clusters.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.sa_active_clusters.restype = ctypes.c_int
    lib.sa_error_string.argtypes = [ctypes.c_int]
    lib.sa_error_string.restype = ctypes.c_char_p
    return lib


def load_library():
    """The kernel's shared library (built by :mod:`ops.build` at first use), bound."""
    global _lib
    if _lib is None:
        _lib = bind(build.load_library("slot_attention"))
    return _lib


# ---------------------------------------------------------------------------- launch


def _check(k, v, slots, params, num_iters, lib, out=None):
    if not k.is_cuda:
        raise ValueError(f"k must lie on a CUDA device, got {k.device}")
    tensors = {"k": k, "v": v, "slots": slots, **{n: params[n] for n in _PARAM_ORDER}}
    if out is not None:
        tensors["out"] = out
    for name, t in tensors.items():
        if t.device != k.device:
            raise ValueError(f"{name} must lie on {k.device} with k, got {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if k.dim() != 3 or v.shape != k.shape or slots.dim() != 3:
        raise ValueError(f"want k, v (B, N, D) and slots (B, S, D); got "
                         f"{tuple(k.shape)}, {tuple(v.shape)}, {tuple(slots.shape)}")
    b, _, d = k.shape
    s = slots.shape[1]
    if slots.shape[0] != b or slots.shape[2] != d:
        raise ValueError(f"slots {tuple(slots.shape)} do not match k {tuple(k.shape)}")
    if out is not None and out.shape != slots.shape:
        raise ValueError(f"out {tuple(out.shape)} does not match slots {tuple(slots.shape)}")
    if d != lib.sa_width():
        raise ValueError(f"the kernel takes D = {lib.sa_width()}, got {d}")
    if not 1 <= s <= lib.sa_max_slots():
        raise ValueError(f"the kernel takes 1..{lib.sa_max_slots()} slots, got {s}")
    h = params["mlp_w0"].shape[0]
    if h % 4:
        raise ValueError(f"MLP hidden width {h} must be a multiple of 4")
    want = {"norm_slot_w": (d,), "norm_slot_b": (d,), "q_w": (d, d), "q_b": (d,),
            "gru_w_ih": (3 * d, d), "gru_b_ih": (3 * d,), "gru_w_hh": (3 * d, d),
            "gru_b_hh": (3 * d,), "norm_mlp_w": (d,), "norm_mlp_b": (d,),
            "mlp_w0": (h, d), "mlp_b0": (h,), "mlp_w1": (d, h), "mlp_b1": (d,)}
    for name, shape in want.items():
        if tuple(params[name].shape) != shape:
            raise ValueError(f"{name} has shape {tuple(params[name].shape)}, want {shape}")
    if num_iters < 1:
        raise ValueError(f"num_iters must be >= 1, got {num_iters}")


def launch(lib, k, v, slots, params: dict, num_iters: int, scale: float, eps: float, out, attn):
    """One call of ``sa_forward`` of a bound library on the current stream,
    into ``out`` and ``attn``, with no checks and no count; raises on a
    launch error. :func:`slot_attention_cuda` is the checked entry point."""
    b, n, _ = k.shape
    ptrs = [t.data_ptr() for t in (k, v, slots, out, attn)]
    ptrs += [params[name].data_ptr() for name in _PARAM_ORDER]
    stream = torch.cuda.current_stream(k.device).cuda_stream
    with torch.cuda.device(k.device):
        err = lib.sa_forward(*ptrs, b, n, slots.shape[1], params["mlp_w0"].shape[0], num_iters,
                             float(scale), float(eps), stream)
    if err != 0:
        raise RuntimeError(f"slot-attention kernel launch failed: cudaError {err} "
                           f"({lib.sa_error_string(err).decode()})")


def slot_attention_cuda(k, v, slots, params: dict, num_iters: int, scale: float,
                        eps: float = 1e-8, out=None):
    """Launch the CUDA kernel on the current stream; raises on what it does not
    take. The refined slots go to ``out`` (a new tensor if None), which may be
    ``slots`` itself. No autograd: :func:`slot_attention_iterations` records
    the gradient through :class:`SlotAttentionFunction`."""
    lib = load_library()
    _check(k, v, slots, params, num_iters, lib, out)
    b, n, _ = k.shape
    out = torch.empty_like(slots) if out is None else out
    attn = torch.empty((b, slots.shape[1], n), device=k.device, dtype=torch.float32)
    launch(lib, k, v, slots, params, num_iters, scale, eps, out, attn)
    slot_attention_cuda.launches += 1
    return out, attn


slot_attention_cuda.launches = 0


class SlotAttentionFunction(torch.autograd.Function):
    """The refinement with a gradient: the counterpart of the JAX package's
    ``_fused`` / ``_fused_fwd`` / ``_fused_bwd``.

    ``apply(k, v, slots, num_iters, scale, eps, forward, *params)`` with the
    14 parameter tensors in ``_PARAM_ORDER``. ``forward(k, v, slots, params,
    num_iters, scale, eps)`` computes (slots, attn) without autograd: the
    kernel's :func:`slot_attention_cuda` on the card (the tests pass
    :func:`slot_attention_plain`). The backward re-runs
    :func:`slot_attention_plain` under autograd from the saved inputs and
    returns the gradients of k, v, slots and every parameter that needs one,
    for whichever of the two outputs has a cotangent."""

    @staticmethod
    def forward(ctx, k, v, slots, num_iters, scale, eps, forward, *params):
        out, attn = forward(k, v, slots, dict(zip(_PARAM_ORDER, params)), num_iters, scale, eps)
        ctx.save_for_backward(k, v, slots, *params)
        ctx.config = (num_iters, scale, eps)
        ctx.set_materialize_grads(False)
        return out, attn

    @staticmethod
    def backward(ctx, g_slots, g_attn):
        inputs = ctx.saved_tensors
        # needs_input_grad follows apply's arguments: k, v, slots, the three
        # numbers and the forward, then the parameters
        needs = ctx.needs_input_grad[:3] + ctx.needs_input_grad[7:]
        grads = [None] * len(inputs)
        pairs = [(g, i) for i, g in enumerate((g_slots, g_attn)) if g is not None]
        wanted = [i for i, need in enumerate(needs) if need]
        if pairs and wanted:
            with torch.enable_grad():
                leaves = [t.detach().requires_grad_(need) for t, need in zip(inputs, needs)]
                k, v, slots, *params = leaves
                outs = slot_attention_plain(k, v, slots, dict(zip(_PARAM_ORDER, params)),
                                            *ctx.config)
                found = torch.autograd.grad([outs[i] for _, i in pairs],
                                            [leaves[i] for i in wanted],
                                            [g for g, _ in pairs], allow_unused=True)
            for i, g in zip(wanted, found):
                grads[i] = g
        return (*grads[:3], None, None, None, None, *grads[3:])


@torch.library.custom_op("textocvp_torch::slot_attention", mutates_args=())
def slot_attention_op(k: torch.Tensor, v: torch.Tensor, slots: torch.Tensor,
                      params: list[torch.Tensor], num_iters: int, scale: float,
                      eps: float) -> tuple[torch.Tensor, torch.Tensor]:
    """The refinement as one op, ``params`` in ``_PARAM_ORDER``: the plain
    version for a CPU tensor, the kernel (:func:`slot_attention_cuda`) for a
    CUDA tensor."""
    p = dict(zip(_PARAM_ORDER, params))
    if k.device.type == "cpu":
        return slot_attention_plain(k, v, slots, p, num_iters, scale, eps)
    return slot_attention_cuda(k, v, slots, p, num_iters, scale, eps)


@slot_attention_op.register_fake
def _(k, v, slots, params, num_iters, scale, eps):
    return (torch.empty_like(slots),
            slots.new_empty((slots.shape[0], slots.shape[1], k.shape[1])))


def slot_attention_iterations(k, v, slots, params: dict, num_iters: int, scale: float,
                              eps: float = 1e-8):
    """The plain version for CPU tensors; for CUDA tensors the kernel, through
    :class:`SlotAttentionFunction` so that autograd records its gradient.
    Where no gradient is recorded, :func:`slot_attention_op`."""
    tensors = [params[name] for name in _PARAM_ORDER]
    if not needs_grad(k, v, slots, *tensors):
        return slot_attention_op(k, v, slots, tensors, num_iters, scale, eps)
    if k.device.type == "cpu":
        return slot_attention_plain(k, v, slots, params, num_iters, scale, eps)
    return SlotAttentionFunction.apply(k, v, slots, num_iters, scale, eps, slot_attention_cuda,
                                       *(params[name] for name in _PARAM_ORDER))
