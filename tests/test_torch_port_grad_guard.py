"""The refusal of gradients that the port's forward-only CUDA kernels would
drop (``ops/grad_guard.py``), on the CPU.

``refuse_grad`` looks only at the autograd state, so it is tested here on CPU
tensors. The CUDA wrappers of slot attention and conv5 are shown to call it
before they launch, with the device check and the library stubbed (there is
no card or ``nvcc`` here); the launches themselves are refused on the card by
the ``gpu`` tests of ``tests/test_torch_port_gpu.py``. The CPU paths keep
their autograd: they run the plain versions.
"""

import pytest
import torch

from textocvp_tpu_torch.models.factory import random_init_
from textocvp_tpu_torch.nn.decoders import ConvDecoder
from textocvp_tpu_torch.ops import conv5 as c5
from textocvp_tpu_torch.ops import slot_attention_kernel as sak
from textocvp_tpu_torch.ops.grad_guard import refuse_grad
from textocvp_tpu_torch.ops.slot_attention import SlotAttention


def _tensors():
    return [torch.zeros(3), torch.ones(2, 2), torch.full((4,), 2.0)]


@pytest.mark.parametrize("which", [0, 1, 2])
def test_refuses_when_any_input_requires_grad(which):
    ts = _tensors()
    ts[which].requires_grad_()
    with pytest.raises(RuntimeError, match=f"op: the CUDA kernel has no backward, and tensor "
                                           f"{which} "):
        refuse_grad("op", *ts)


@pytest.mark.parametrize("mode", ["no_grad", "inference_mode", "set_grad_enabled_false"])
def test_passes_when_grad_is_off(mode):
    ts = _tensors()
    for t in ts:
        t.requires_grad_()
    ctx = {"no_grad": torch.no_grad, "inference_mode": torch.inference_mode,
           "set_grad_enabled_false": lambda: torch.set_grad_enabled(False)}[mode]
    with ctx():
        refuse_grad("op", *ts)


def test_passes_when_nothing_requires_grad():
    assert torch.is_grad_enabled()
    refuse_grad("op", *_tensors())
    refuse_grad("op")


def test_passes_for_a_detached_view_of_a_tensor_that_requires_grad():
    t = torch.ones(3, requires_grad=True)
    refuse_grad("op", t.detach(), t.detach()[1:])


class _NoLaunch:
    """Stands in for a built library; launching through it fails the test."""
    sa_width = staticmethod(lambda: 32)
    sa_max_slots = staticmethod(lambda: 12)

    def __getattr__(self, name):
        raise AssertionError(f"{name} reached: the launch was not refused")


def test_slot_attention_wrapper_refuses_before_launching(monkeypatch):
    monkeypatch.setattr(sak, "load_library", lambda: _NoLaunch())
    monkeypatch.setattr(sak, "_check", lambda *a, **kw: None)
    mod = random_init_(SlotAttention(32, 32, 4, 64), torch.Generator().manual_seed(0))
    k = torch.randn(2, 10, 32)
    before = sak.slot_attention_cuda.launches
    with pytest.raises(RuntimeError, match="slot attention: the CUDA kernel has no backward"):
        sak.slot_attention_cuda(k, k, torch.randn(2, 4, 32), mod.iteration_params(), 1, 0.1)
    assert sak.slot_attention_cuda.launches == before


def test_conv5_wrapper_refuses_before_launching(monkeypatch):
    monkeypatch.setattr(c5, "load_library", lambda: _NoLaunch())
    monkeypatch.setattr(c5, "_check", lambda *a, **kw: None)
    x = torch.randn(1, 4, 4, 64, requires_grad=True)
    before = c5.conv5_cuda.launches
    with pytest.raises(RuntimeError, match="conv5: the CUDA kernel has no backward"):
        c5.conv5_cuda(x, torch.randn(5, 5, 64, 64), torch.randn(64))
    assert c5.conv5_cuda.launches == before


def test_cpu_slot_attention_keeps_its_gradient():
    mod = random_init_(SlotAttention(32, 32, 4, 64), torch.Generator().manual_seed(1))
    gen = torch.Generator().manual_seed(2)
    k, v = torch.randn(2, 10, 32, generator=gen), torch.randn(2, 10, 32, generator=gen)
    out, _ = mod.iterate(k, v, torch.randn(2, 4, 32, generator=gen), 2)
    out.square().sum().backward()
    assert mod.to_q.weight.grad is not None and mod.to_q.weight.grad.abs().sum() > 0


def test_cpu_conv5_keeps_its_gradient():
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(1, 6, 6, 8, generator=gen, requires_grad=True)
    c5.conv5(x, torch.randn(5, 5, 8, 8, generator=gen), torch.randn(8, generator=gen)).sum().backward()
    assert x.grad is not None and x.grad.abs().sum() > 0


@pytest.mark.parametrize("frozen_first", [False, True])
def test_cpu_conv_decoder_tail_keeps_its_weight_gradients(frozen_first):
    """The tail's HWIO weights keep their autograd history under grad, so each
    tail conv gets the gradient ``F.conv2d`` gives it, also when the first
    block, and so the tail's input, requires no grad."""
    dec = random_init_(ConvDecoder(16, [8, 8, 8]), torch.Generator().manual_seed(4))
    dec.blocks[0].requires_grad_(not frozen_first)
    x = torch.randn(2, 16, 7, 7, generator=torch.Generator().manual_seed(5))
    dec(x).square().sum().backward()
    got = [b.conv.weight.grad.clone() for b in dec.blocks[1:]] + [dec.blocks[-1].conv.bias.grad]
    dec.zero_grad()
    y = x
    for block in dec.blocks:
        y = block(y)
    dec.final_conv(y).square().sum().backward()
    want = [b.conv.weight.grad for b in dec.blocks[1:]] + [dec.blocks[-1].conv.bias.grad]
    for g, w in zip(got, want):
        assert g.abs().sum() > 0
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-5)
