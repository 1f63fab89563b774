"""
Slot Attention: iterative inverted cross-attention with GRU slot refinement.

Per iteration:
    slots_prev = slots
    q = W_q LN(slots) + b
    attn = softmax(q k^T * dim_feats^-0.5, over slots) + eps
    updates = (attn / attn.sum(over locations)) v
    slots = GRU(updates, slots_prev)
    slots = slots + MLP(LN(slots))

The inputs are layer-normed and projected to K/V once per frame
(:meth:`SlotAttention.project_inputs`). :meth:`SlotAttention.iterate` runs the
refinement through :func:`slot_attention_kernel.slot_attention_iterations`,
which launches the CUDA kernel for a CUDA tensor and runs the plain PyTorch
version for a CPU tensor. There is no switch between the two.

In bfloat16 (``tpu.compute_dtype``) the LayerNorm and the K/V projection run
in bf16, and the refinement follows the JAX package's Pallas arm
(``textocvp_tpu/ops/pallas/slot_attention_kernel.py:148-154, 230-232``),
whose port the kernel is: k, v and the slots cast to float32, the float32
refinement with the float32 parameters, then the slots and the attention
cast back to the slots' dtype. The JAX package's XLA arm, which runs the
refinement itself in bf16, differs from it by about as much as bf16 differs
from float32.
"""

from __future__ import annotations

import torch
from torch import nn

from textocvp_tpu_torch.nn.blocks import MLP
from textocvp_tpu_torch.nn.precision import LayerNorm, Linear
from textocvp_tpu_torch.ops.slot_attention_kernel import slot_attention_iterations


class GRUCell(nn.Module):
    """The flax GRU cell's parameters in ``torch.nn.GRUCell``'s layout (gate
    order r, z, n): ``weight_ih`` (3D, D) with ``bias_ih`` (3D,), and
    ``weight_hh`` (3D, D) with a bias on the n gate only, ``bias_hn`` (D,).
    The JAX package's GRU has no bias on the recurrent r and z projections,
    so neither has the port: a ``torch.nn.GRUCell`` would train two more
    (D,) biases, each moving with the input bias beside it.
    :meth:`SlotAttention.iteration_params` hands the kernel ``b_hh = [0; 0;
    b_hn]``."""

    def __init__(self, input_size: int, hidden_size: int):
        super().__init__()
        lim = hidden_size ** -0.5  # torch.nn.GRUCell's draw
        self.weight_ih = nn.Parameter(torch.empty(3 * hidden_size, input_size).uniform_(-lim, lim))
        self.bias_ih = nn.Parameter(torch.empty(3 * hidden_size).uniform_(-lim, lim))
        self.weight_hh = nn.Parameter(torch.empty(3 * hidden_size, hidden_size).uniform_(-lim, lim))
        self.bias_hn = nn.Parameter(torch.empty(hidden_size).uniform_(-lim, lim))

    def bias_hh(self):
        """[0; 0; b_hn], the recurrent bias in ``torch.nn.GRUCell``'s layout."""
        zeros = self.bias_hn.new_zeros(2 * self.bias_hn.shape[0])
        return torch.cat([zeros, self.bias_hn])


class SlotAttention(nn.Module):
    def __init__(self, dim_feats: int, dim_slots: int, num_slots: int,
                 mlp_hidden: int = 128, epsilon: float = 1e-8):
        super().__init__()
        self.dim_feats = dim_feats
        self.num_slots = num_slots
        self.epsilon = epsilon
        self.norm_input = LayerNorm(dim_feats, eps=1e-3)
        self.norm_slot = LayerNorm(dim_slots, eps=1e-3)
        self.norm_mlp = LayerNorm(dim_slots, eps=1e-3)
        self.to_q = Linear(dim_slots, dim_slots)
        self.to_k = Linear(dim_feats, dim_slots)
        self.to_v = Linear(dim_feats, dim_slots)
        self.gru = GRUCell(dim_slots, dim_slots)
        self.mlp = MLP(dim_slots, [mlp_hidden, dim_slots])

    def project_inputs(self, inputs):
        """LayerNorm the encoder features and project them to K and V."""
        inputs = self.norm_input(inputs)
        return self.to_k(inputs), self.to_v(inputs)

    def iteration_params(self) -> dict:
        """The refinement's weights in the layout the kernel and the plain version take."""
        return {
            "norm_slot_w": self.norm_slot.weight, "norm_slot_b": self.norm_slot.bias,
            "q_w": self.to_q.weight, "q_b": self.to_q.bias,
            "gru_w_ih": self.gru.weight_ih, "gru_b_ih": self.gru.bias_ih,
            "gru_w_hh": self.gru.weight_hh, "gru_b_hh": self.gru.bias_hh(),
            "norm_mlp_w": self.norm_mlp.weight, "norm_mlp_b": self.norm_mlp.bias,
            "mlp_w0": self.mlp.layers[0].weight, "mlp_b0": self.mlp.layers[0].bias,
            "mlp_w1": self.mlp.layers[1].weight, "mlp_b1": self.mlp.layers[1].bias,
        }

    def iterate(self, k, v, slots, num_iters: int):
        """``num_iters`` refinements of slots (B, S, D) against k, v (B, N, D).
        Returns (slots, attn): attn is the last iteration's (B, S, N) attention
        after +eps and before the renorm over locations (the object masks).
        Float32 inside whatever the inputs' dtype; both outputs in the slots'."""
        dtype = slots.dtype
        slots, attn = slot_attention_iterations(
            k.float().contiguous(), v.float().contiguous(), slots.float().contiguous(),
            self.iteration_params(), num_iters,
            scale=self.dim_feats ** -0.5, eps=self.epsilon)
        return slots.to(dtype), attn.to(dtype)
