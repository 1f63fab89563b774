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
               dtype_checked: bool = True) -> dict:
    """Assert the rule above for one output; returns its distances. Outputs
    that are not the port's bf16 tensors by contract (metrics, the service's
    uint8 reply) pass ``dtype_checked=False``."""
    if dtype_checked:
        assert isinstance(port_bf16, torch.Tensor) and port_bf16.dtype == torch.bfloat16, (
            what, getattr(port_bf16, "dtype", type(port_bf16)))
    pb = as_f32(port_bf16)
    assert pb.shape == as_f32(jax_f32).shape, (what, pb.shape, as_f32(jax_f32).shape)
    assert np.isfinite(pb).all(), what
    base = e(jax_bf16, jax_f32, jax_f32)
    d = {"jax_bf16_vs_f32": base, "port_vs_jax_bf16": e(pb, jax_bf16, jax_f32),
         "port_vs_jax_f32": e(pb, jax_f32, jax_f32), "port_vs_port_f32": e(pb, port_f32, pb)}
    assert d["port_vs_jax_bf16"] <= 2 * base + STEP, (what, d)
    assert d["port_vs_jax_f32"] <= 1.5 * base + STEP, (what, d)
    assert d["port_vs_port_f32"] > 1e-4, (what, d)
    return d
