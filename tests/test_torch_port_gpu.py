"""Tests of the port that need the card: the CUDA slot-attention kernel
against its plain version, and the SAVi seed encode on the card against the
CPU. Marked ``gpu``; without a CUDA device each one skips (decided in the
``cuda`` fixture, so every worker collects the same tests).

    python -m pytest -m gpu tests/

Tolerance: 1e-4 absolute for the kernel against the plain version (float32
on both, sums in other orders; slots are of order 1, attention weights lie in
[0, 1]). TF32 is off for the plain version's matmuls.
"""

import numpy as np
import pytest
import torch

from textocvp_tpu_torch.models.factory import random_init_
from textocvp_tpu_torch.ops import slot_attention_kernel as sak
from textocvp_tpu_torch.ops.slot_attention import SlotAttention

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _case(b, n, s, h, seed=0):
    gen = torch.Generator().manual_seed(seed)
    mod = random_init_(SlotAttention(128, 128, s, h), gen).cuda()
    params = {k: p.detach() for k, p in mod.iteration_params().items()}
    k = torch.randn((b, n, 128), generator=gen).cuda()
    v = torch.randn((b, n, 128), generator=gen).cuda()
    slots = torch.randn((b, s, 128), generator=gen).cuda()
    return k, v, slots, params


@pytest.mark.parametrize("b,n,s,h", [(8, 4096, 8, 256), (2, 576, 10, 256), (3, 300, 1, 64),
                                     (1, 129, 12, 128)])
@pytest.mark.parametrize("iters", [1, 3])
def test_kernel_matches_plain(cuda, b, n, s, h, iters):
    k, v, slots, params = _case(b, n, s, h)
    before = sak.slot_attention_cuda.launches
    out, attn = sak.slot_attention_cuda(k, v, slots, params, iters, 128 ** -0.5)
    ref, ref_attn = sak.slot_attention_plain(k, v, slots, params, iters, 128 ** -0.5)
    torch.cuda.synchronize()
    assert sak.slot_attention_cuda.launches == before + 1
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-4)
    torch.testing.assert_close(attn, ref_attn, rtol=0, atol=1e-4)


def test_module_dispatches_cuda_tensors_to_the_kernel(cuda):
    k, v, slots, _ = _case(2, 256, 8, 256)
    mod = random_init_(SlotAttention(128, 128, 8, 256), torch.Generator().manual_seed(1)).cuda()
    before = sak.slot_attention_cuda.launches
    with torch.no_grad():
        out, _ = mod.iterate(k, v, slots, 2)
        ref, _ = sak.slot_attention_plain(k, v, slots, mod.iteration_params(), 2, 128 ** -0.5)
    assert sak.slot_attention_cuda.launches == before + 1
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-4)


@pytest.mark.parametrize("bad", ["width", "slots", "dtype", "strided", "device"])
def test_kernel_refuses_what_it_does_not_take(cuda, bad):
    k, v, slots, params = _case(2, 256, 8, 256)
    if bad == "width":
        k, v, slots = k[..., :64].contiguous(), v[..., :64].contiguous(), slots[..., :64].contiguous()
    elif bad == "slots":
        slots = torch.randn((2, 13, 128), device="cuda")
    elif bad == "dtype":
        k = k.double()
    elif bad == "strided":
        k = k.transpose(0, 1).contiguous().transpose(0, 1)
    else:
        slots = slots.cpu()
    with pytest.raises((ValueError, TypeError)):
        sak.slot_attention_cuda(k, v, slots, params, 1, 0.1)


def test_savi_seed_encode_on_the_card_matches_the_cpu(cuda):
    from textocvp_tpu_torch.core.config import build_exp_params
    from textocvp_tpu_torch.models import setup_model

    p = build_exp_params("SAVi", "CATER_Easy")
    mp = p["model"]["model_params"]
    mp["encoder"]["encoder_params"].update(num_channels=[8, 8], resolution=[16, 16])
    mp["decoder"]["decoder_params"].update(num_channels=[8, 8], resolution=[16, 16])
    model = random_init_(setup_model(p), torch.Generator().manual_seed(2)).eval()
    gen = torch.Generator().manual_seed(3)
    video = torch.rand((2, 3, 16, 16, 3), generator=gen)
    init = model.slot_initializer(2, gen)
    with torch.no_grad():
        ref = model.decompose(video, initial_slots=init)
        out = model.cuda().decompose(video.cuda(), initial_slots=init.cuda())
    scale = max(1.0, ref["slot_history"].abs().max().item())
    np.testing.assert_allclose(out["slot_history"].cpu().numpy(), ref["slot_history"].numpy(),
                               rtol=0, atol=1e-4 * scale)
    np.testing.assert_allclose(out["attn_masks"].cpu().numpy(), ref["attn_masks"].numpy(),
                               rtol=0, atol=1e-4)
