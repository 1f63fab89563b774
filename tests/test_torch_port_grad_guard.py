"""The refusal of gradients that the port's forward-only CUDA kernel would
drop (``ops/grad_guard.py``), and the gradients of the two kernels that have
a backward, on the CPU.

``refuse_grad`` looks only at the autograd state, so it is tested here on CPU
tensors. The CUDA wrapper of the ViT attention is shown to call it before it
launches, with the device check and the library stubbed (there is no card or
``nvcc`` here); on the card the ``gpu`` tests of
``tests/test_torch_port_gpu.py`` show the refusal and, for slot attention
and conv5, the gradients. Slot attention and conv5 record their gradients
through ``torch.autograd.Function``s, run here with their plain forwards.
The CPU paths keep their autograd: they run the plain versions.
"""

import torch_cpu_threads  # noqa: F401  (two torch threads a worker)
import pytest
import torch

from textocvp_tpu_torch.models.factory import random_init_
from textocvp_tpu_torch.nn.decoders import ConvDecoder
from textocvp_tpu_torch.ops import conv5 as c5
from textocvp_tpu_torch.ops import slot_attention_kernel as sak
from textocvp_tpu_torch.ops import vit_attention as va
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
    va_head_dim = staticmethod(lambda: 64)

    def __getattr__(self, name):
        raise AssertionError(f"{name} reached: the launch was not refused")


def test_vit_attention_wrapper_refuses_before_launching(monkeypatch):
    monkeypatch.setattr(va, "load_library", lambda: _NoLaunch())
    monkeypatch.setattr(va, "_check", lambda *a, **kw: None)
    q = torch.randn(1, 2, 5, 64, requires_grad=True)
    before = va.vit_attention_cuda.launches
    with pytest.raises(RuntimeError, match="ViT attention: the CUDA kernel has no backward"):
        va.vit_attention_cuda(q, q.detach(), q.detach(), 0.125)
    assert va.vit_attention_cuda.launches == before


def test_slot_attention_function_gradient_flows_like_the_plain_version():
    """What a CUDA tensor runs, with the plain forward in the kernel's place:
    every parameter of the refinement and k, v, slots get the plain
    version's gradients."""
    mod = random_init_(SlotAttention(32, 32, 4, 64), torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(6)
    k, v, s = (torch.randn(shape, generator=gen).requires_grad_()
               for shape in ((2, 10, 32), (2, 10, 32), (2, 4, 32)))
    p = mod.iteration_params()
    out, attn = sak.SlotAttentionFunction.apply(k, v, s, 2, 0.1, 1e-8, sak.slot_attention_plain,
                                                *(p[n] for n in sak._PARAM_ORDER))
    leaves = [k, v, s, *mod.parameters()]
    got = torch.autograd.grad(out.square().sum() + attn.sum(), leaves, allow_unused=True)
    ref_out, ref_attn = sak.slot_attention_plain(k, v, s, mod.iteration_params(), 2, 0.1)
    want = torch.autograd.grad(ref_out.square().sum() + ref_attn.sum(), leaves, allow_unused=True)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_conv5_function_gradient_flows_like_the_plain_version():
    gen = torch.Generator().manual_seed(7)
    x, w, b = (torch.randn(shape, generator=gen).requires_grad_()
               for shape in ((2, 6, 7, 8), (5, 5, 8, 8), (8,)))
    y = c5.Conv5Function.apply(x, w, b, True, c5.conv5_plain, c5.conv5_plain)
    got = torch.autograd.grad(y.square().sum(), (x, w, b))
    want = torch.autograd.grad(c5.conv5_plain(x, w, b).square().sum(), (x, w, b))
    for g, r in zip(got, want):
        torch.testing.assert_close(g, r, rtol=1e-5, atol=1e-4)


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
