"""The bfloat16 parity rule of the port's CPU tests (``tests/test_torch_port_bf16*.py``).

bf16 cannot be held to float32's tolerances: the JAX package's own bf16
output differs from its float32 output by up to a few percent of the largest
value. Each output is held to that measured distance. With
``e(a, b) = max|a - b| / max|JAX float32|``:

* e(port bf16, JAX bf16) <= 2 e(JAX bf16, JAX float32) + 2**-8;
* e(port bf16, JAX float32) <= 1.5 e(JAX bf16, JAX float32) + 2**-8;
* the port's output is bfloat16;
* it lies more than 1e-4 (of the largest value) from the port's own float32
  output, so the bf16 path was really taken.

A gradient adds its measured spread to both bounds (``check_bf16``'s
``spread``): the port's own bf16 gradient's move under an input change below
one bf16 step.

2**-8 is one bf16 step at the largest value.
"""

import numpy as np
import torch

STEP = 2.0 ** -8


def as_f32(x) -> np.ndarray:
    """A torch tensor or a (JAX or numpy) array of any float dtype as float32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x).astype(np.float32)


def e(a, b, ref) -> float:
    """max|a - b| over max|ref|."""
    a, b, ref = as_f32(a), as_f32(b), as_f32(ref)
    return float(np.abs(a - b).max() / np.abs(ref).max())


def check_bf16(port_bf16, port_f32, jax_bf16, jax_f32, what: str = "",
               dtype_checked: bool = True, scale=None, spread: float = 0.0) -> dict:
    """Assert the rule above for one output; returns its distances. Outputs
    that are not the port's bf16 tensors by contract (metrics, the service's
    uint8 reply, the float32 gradients Adam reads) pass
    ``dtype_checked=False``. ``scale`` replaces max|JAX float32| as the
    yardstick for an output that is 0 in exact arithmetic (a gradient leaf
    of rounding noise on every side, held against the largest leaf's
    scale); such an output need not lie apart from the port's float32.
    ``spread`` (a gradient's) is how far the port's own bf16 output moves
    when its input moves by less than one bf16 step (e over the same
    yardstick): a step's gradient passes kinks (ReLU, the loss's clip) where
    such a move flips a mask and a whole term with it, and two bf16
    computations that round in other orders differ by that much; it is added
    to both bounds."""
    if dtype_checked:
        assert isinstance(port_bf16, torch.Tensor) and port_bf16.dtype == torch.bfloat16, (
            what, getattr(port_bf16, "dtype", type(port_bf16)))
    pb = as_f32(port_bf16)
    assert pb.shape == as_f32(jax_f32).shape, (what, pb.shape, as_f32(jax_f32).shape)
    assert np.isfinite(pb).all(), what
    ref = jax_f32 if scale is None else np.full((1,), scale, np.float32)
    base = e(jax_bf16, jax_f32, ref)
    d = {"jax_bf16_vs_f32": base, "port_vs_jax_bf16": e(pb, jax_bf16, ref),
         "port_vs_jax_f32": e(pb, jax_f32, ref), "port_vs_port_f32": e(pb, port_f32, pb)}
    d["spread"] = spread
    assert d["port_vs_jax_bf16"] <= 2 * base + spread + STEP, (what, d)
    assert d["port_vs_jax_f32"] <= 1.5 * base + spread + STEP, (what, d)
    if scale is None:
        assert d["port_vs_port_f32"] > 1e-4, (what, d)
    return d
