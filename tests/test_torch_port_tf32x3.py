"""The arithmetic of the port's tensor-core kernels (``csrc/tf32x3.cuh``),
emulated on the CPU.

The conv5 and ViT-attention kernels compute float32-accurate products as
"3xTF32": each float32 operand x splits into ``big`` = x rounded to TF32
(10 mantissa bits, nearest, ties away from zero: ``cvt.rna.tf32.f32``) and
``small`` = x - big, and a product a * b becomes a_small * b_big + a_big *
b_small + a_big * b_big, each a TF32 tensor-core product accumulated in
float32. Here:

* the emulation of ``cvt.rna.tf32.f32`` against an independent rounding
  written with Python floats, on ties, negatives, zeros, subnormals and
  values near the float32 maximum;
* that the split is exact and what the tensor core reads of it (``small``
  truncated to TF32, as the kernels pass it, or rounded) leaves at most
  2^-21 |x| out;
* conv5 through ``conv5_plain``'s own 25-tap loop with each tap's product
  emulated as 3xTF32, within 1e-5 of ``conv5_plain``; the attention with
  both products emulated, within 2e-6 of ``vit_attention_plain``; and the
  same with one TF32 product (no split), which misses the limits that
  ``chip_smoke.py`` holds the kernels to (1e-4 for conv5, 2e-5 for the ViT
  attention). That is why the kernels take three products.

The emulation sums in float32 with round-to-nearest; the tensor cores'
float32 accumulation does not round so, and the kernels on the card land
further from the plain versions (within their limits; ``chip_smoke.py`` and
``tests/test_torch_port_gpu.py`` measure that).
"""

import math

import numpy as np
import pytest
import torch

from textocvp_tpu_torch.ops import conv5 as c5
from textocvp_tpu_torch.ops import vit_attention as va

CONV5_LIMIT, VIT_LIMIT = 1e-4, 2e-5  # the kernels' limits against the plain versions
_MATMUL = torch.matmul  # the real product, whatever a test patches in conv5_plain


def rna_tf32(x):
    """``cvt.rna.tf32.f32`` of float32 values: round to 10 mantissa bits,
    nearest, ties away from zero; the low 13 bits come out zero."""
    bits = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def trunc_tf32(x):
    """The TF32 value a tensor core reads from a float32 register: its top 19 bits."""
    bits = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return (bits & np.uint32(0xFFFFE000)).view(np.float32)


def _rna_reference(v: float) -> float:
    """v rounded to 11 significant bits, ties away from zero, with float32's
    exponent range (subnormal spacing 2^-136 in TF32, overflow to inf)."""
    if v == 0 or not math.isfinite(v):
        return v
    _, e = math.frexp(abs(v))  # |v| = m 2^e, m in [0.5, 1)
    step = 2.0 ** (max(e, -125) - 11)
    out = math.copysign(math.floor(abs(v) / step + 0.5) * step, v)
    return out if abs(out) < 2.0 ** 128 else math.copysign(math.inf, v)


def _f32(bits: int) -> float:
    return float(np.array([bits], np.uint32).view(np.float32)[0])


EDGE_VALUES = {
    "one": 1.0,
    "tie_rounds_away": 1 + 2.0 ** -11,              # halfway to 1 + 2^-10: not to even
    "below_tie": 1 + 2.0 ** -11 - 2.0 ** -23,
    "above_tie": 1 + 2.0 ** -11 + 2.0 ** -23,
    "negative_tie": -(1 + 2.0 ** -11),
    "negative_below_tie": -(1 + 2.0 ** -11 - 2.0 ** -23),
    "carry_into_exponent": 2 - 2.0 ** -23,          # rounds up to 2
    "zero": 0.0,
    "negative_zero": -0.0,
    "smallest_subnormal": 2.0 ** -149,              # rounds to 0
    "subnormal_tie": 2.0 ** -137,                   # halfway to 2^-136
    "largest_subnormal": _f32(0x007FFFFF),          # rounds up to the smallest normal
    "smallest_normal": 2.0 ** -126,
    "largest_tf32": _f32(0x7F7FE000),
    "below_max_tie": _f32(0x7F7FEFFF),              # rounds down to the largest TF32
    "float32_max": _f32(0x7F7FFFFF),                # past the largest TF32 + half a step: inf
    "negative_float32_max": -_f32(0x7F7FFFFF),
    "infinity": math.inf,
}


@pytest.mark.parametrize("name", sorted(EDGE_VALUES))
def test_rna_emulation_on_edge_values(name):
    v = EDGE_VALUES[name]
    got = float(rna_tf32(np.array([v], np.float32))[0])
    want = _rna_reference(float(np.float32(v)))
    assert got == want or (math.isnan(got) and math.isnan(want)), (got, want)
    assert math.copysign(1, got) == math.copysign(1, want)
    assert int(rna_tf32(np.array([v], np.float32)).view(np.uint32)[0]) & 0x1FFF == 0


def test_rna_emulation_on_random_values():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(20000) * 10.0 ** rng.uniform(-30, 30, 20000)).astype(np.float32)
    got = rna_tf32(x)
    want = np.array([_rna_reference(float(v)) for v in x], np.float32)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_split_is_exact_and_what_the_tensor_core_reads_is_within_2_to_the_minus_21():
    rng = np.random.default_rng(1)
    x = (rng.standard_normal(100000) * 10.0 ** rng.uniform(-20, 20, 100000)).astype(np.float32)
    big = rna_tf32(x)
    small = x - big
    np.testing.assert_array_equal(big.astype(np.float64) + small.astype(np.float64),
                                  x.astype(np.float64))
    for read in (trunc_tf32(small), rna_tf32(small)):
        left = np.abs(x.astype(np.float64) - big - read.astype(np.float64))
        assert (left <= 2.0 ** -21 * np.abs(x.astype(np.float64))).all()


def _split(t, small_rounding):
    big = torch.from_numpy(rna_tf32(t.numpy()))
    small = t - big
    read = trunc_tf32 if small_rounding == "truncated" else rna_tf32
    return big, torch.from_numpy(read(small.numpy()))


def _matmul_3xtf32(small_rounding):
    """a @ b as three TF32 products (exact in float32) summed in float32."""
    def mm(a, b):
        ab, as_ = _split(a.contiguous(), small_rounding)
        bb, bs = _split(b.contiguous(), small_rounding)
        return _MATMUL(as_, bb) + _MATMUL(ab, bs) + _MATMUL(ab, bb)
    return mm


def _matmul_1xtf32(a, b):
    return _MATMUL(torch.from_numpy(rna_tf32(a.contiguous().numpy())),
                   torch.from_numpy(rna_tf32(b.contiguous().numpy())))


def _conv5_inputs(n=2, h=16, w=16, c=64, seed=0):
    """Drawn as the conv5 tests and ``chip_smoke.py`` draw them."""
    rng = np.random.default_rng(seed)
    x = (0.5 * rng.standard_normal((n, h, w, c))).astype(np.float32)
    wt = (rng.standard_normal((5, 5, c, c)) / np.sqrt(25 * c)).astype(np.float32)
    b = (0.1 * rng.standard_normal((c,))).astype(np.float32)
    return torch.from_numpy(x), torch.from_numpy(wt), torch.from_numpy(b)


def _conv5_through_plain(monkeypatch, matmul, x, w, b):
    """``conv5_plain`` with each tap's product replaced by ``matmul``."""
    with monkeypatch.context() as m:
        m.setattr(c5.torch, "matmul", matmul)
        with torch.no_grad():
            return c5.conv5_plain(x, w, b)


@pytest.fixture(scope="module")
def conv5_case():
    x, w, b = _conv5_inputs()
    with torch.no_grad():
        return x, w, b, c5.conv5_plain(x, w, b)


@pytest.mark.parametrize("small_rounding", ["truncated", "rna"])
def test_3xtf32_conv5_is_within_1e_5_of_plain(monkeypatch, conv5_case, small_rounding):
    x, w, b, ref = conv5_case
    out = _conv5_through_plain(monkeypatch, _matmul_3xtf32(small_rounding), x, w, b)
    err = (out - ref).abs().max().item()
    assert err <= 1e-5, err


def test_1xtf32_conv5_misses_the_chip_limit(monkeypatch, conv5_case):
    x, w, b, ref = conv5_case
    err = (_conv5_through_plain(monkeypatch, _matmul_1xtf32, x, w, b) - ref).abs().max().item()
    assert err > CONV5_LIMIT, err


def _attention(q, k, v, scale, matmul):
    """vit_attention_plain's arithmetic with both products through ``matmul``."""
    s = matmul(q, k.transpose(-1, -2)) * scale
    return matmul(torch.softmax(s, dim=-1), v)


@pytest.fixture(scope="module")
def attention_case():
    rng = np.random.default_rng(2)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 2, 577, 64)).astype(np.float32))
               for _ in range(3))
    return q, k, v, va.vit_attention_plain(q, k, v, 64 ** -0.5)


@pytest.mark.parametrize("small_rounding", ["truncated", "rna"])
def test_3xtf32_attention_is_within_2e_6_of_plain(attention_case, small_rounding):
    q, k, v, ref = attention_case
    out = _attention(q, k, v, 64 ** -0.5, _matmul_3xtf32(small_rounding))
    err = (out - ref).abs().max().item()
    assert err <= 2e-6, err


def test_1xtf32_attention_misses_the_chip_limit(attention_case):
    q, k, v, ref = attention_case
    err = (_attention(q, k, v, 64 ** -0.5, _matmul_1xtf32) - ref).abs().max().item()
    assert err > VIT_LIMIT, err
