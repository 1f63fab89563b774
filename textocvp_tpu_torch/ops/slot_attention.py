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
"""

from __future__ import annotations

from torch import nn

from textocvp_tpu_torch.nn.blocks import MLP
from textocvp_tpu_torch.ops.slot_attention_kernel import slot_attention_iterations


class SlotAttention(nn.Module):
    def __init__(self, dim_feats: int, dim_slots: int, num_slots: int,
                 mlp_hidden: int = 128, epsilon: float = 1e-8):
        super().__init__()
        self.dim_feats = dim_feats
        self.num_slots = num_slots
        self.epsilon = epsilon
        self.norm_input = nn.LayerNorm(dim_feats, eps=1e-3)
        self.norm_slot = nn.LayerNorm(dim_slots, eps=1e-3)
        self.norm_mlp = nn.LayerNorm(dim_slots, eps=1e-3)
        self.to_q = nn.Linear(dim_slots, dim_slots)
        self.to_k = nn.Linear(dim_feats, dim_slots)
        self.to_v = nn.Linear(dim_feats, dim_slots)
        # gate order r, z, n; b_hr and b_hz are zero for weights from the JAX
        # package, whose GRU has no bias on those two recurrent projections
        self.gru = nn.GRUCell(dim_slots, dim_slots)
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
            "gru_w_hh": self.gru.weight_hh, "gru_b_hh": self.gru.bias_hh,
            "norm_mlp_w": self.norm_mlp.weight, "norm_mlp_b": self.norm_mlp.bias,
            "mlp_w0": self.mlp.layers[0].weight, "mlp_b0": self.mlp.layers[0].bias,
            "mlp_w1": self.mlp.layers[1].weight, "mlp_b1": self.mlp.layers[1].bias,
        }

    def iterate(self, k, v, slots, num_iters: int):
        """``num_iters`` refinements of slots (B, S, D) against k, v (B, N, D).
        Returns (slots, attn): attn is the last iteration's (B, S, N) attention
        after +eps and before the renorm over locations (the object masks)."""
        return slot_attention_iterations(
            k.contiguous(), v.contiguous(), slots.contiguous(), self.iteration_params(),
            num_iters,
            scale=self.dim_feats ** -0.5, eps=self.epsilon)
