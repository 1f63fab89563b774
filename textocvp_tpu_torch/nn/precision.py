"""
The compute dtype of the port's modules (``tpu.compute_dtype``), as the JAX
package's flax modules take their ``dtype``: parameters stay float32 (state
dicts, checkpoints and the importers do not change), matmuls and convs run
in the compute dtype, and the normalisations take their statistics in
float32 and return the compute dtype.

:func:`set_compute_dtype` gives every submodule of a model its dtype
(``models/factory.py`` does so from the experiment's params); a module reads
it with :func:`compute_dtype` (float32 where none was set). The layers below
are torch's with flax's ``promote_dtype`` at the call: the input, the weight
and the bias cast to the compute dtype. They use explicit casts, not
``torch.autocast``, which keeps ``layer_norm`` and ``softmax`` outputs in
float32 where flax rounds them to bfloat16. In float32 each is exactly the
torch layer it extends.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def compute_dtype(module: nn.Module) -> torch.dtype:
    """The compute dtype :func:`set_compute_dtype` gave ``module``, float32 by default."""
    return getattr(module, "compute_dtype", torch.float32)


def set_compute_dtype(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Give ``module`` and every submodule the compute dtype ``dtype``."""
    if dtype not in COMPUTE_DTYPES.values():
        raise ValueError(f"compute dtype {dtype}: the port computes in "
                         f"{sorted(COMPUTE_DTYPES)}")
    for mod in module.modules():
        mod.compute_dtype = dtype
    return module


def _cast(t, dtype):
    return None if t is None else t.to(dtype)


class Linear(nn.Linear):
    """``nn.Linear`` in the compute dtype: flax's ``Dense(dtype=...)``."""

    def forward(self, x):
        dt = compute_dtype(self)
        return F.linear(x.to(dt), self.weight.to(dt), _cast(self.bias, dt))


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` in the compute dtype: flax's ``Conv(dtype=...)``."""

    def forward(self, x):
        dt = compute_dtype(self)
        return self._conv_forward(x.to(dt), self.weight.to(dt), _cast(self.bias, dt))


class ConvTranspose2d(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` in the compute dtype: flax's ``ConvTranspose(dtype=...)``."""

    def forward(self, x):
        dt = compute_dtype(self)
        return F.conv_transpose2d(x.to(dt), self.weight.to(dt), _cast(self.bias, dt),
                                  self.stride, self.padding, self.output_padding, self.groups,
                                  self.dilation)


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` whose statistics and affine run in float32 and whose
    output is in the compute dtype: flax's ``LayerNorm(dtype=...)``."""

    def forward(self, x):
        dt = compute_dtype(self)
        if dt == torch.float32 and x.dtype == torch.float32:
            return super().forward(x)
        return F.layer_norm(x.float(), self.normalized_shape, self.weight, self.bias,
                            self.eps).to(dt)
