"""Tests of the port that need the card: the CUDA slot-attention, ViT
attention and decoder-tail conv5 kernels against their plain versions (the
last two at shapes on and across the edges of their tiles), the tensor-core
instructions in the built conv5 and ViT-attention libraries, the SAVi and
ExtendedDINOSAUR seed encodes and the SAVi decode on the card against the
CPU; the gradients of the slot-attention and conv5 Functions against
autograd through the plain versions on the card (conv5's input gradient
alone behind frozen weights too), a SAVi train step that leaves no parameter
without a gradient, a predictor train step through the frozen SAVi that
gives every trainable predictor parameter one and the SAVi and T5 none, an
ExtendedDINOSAUR train step that trains all but the frozen ViT, the CNN
head's BatchNorm block in training mode against the CPU, the ViT
attention's refusal of grad, the four other predictors' rollouts on the card
against the CPU, the 03 step on the card against the CPU, a CustomTF predictor's refusal of ids past its
vocabulary before the lookup, the host image library's build on the card's
machine, remat steps against plain ones (gradients within 1e-6 of the
largest leaf), the PNG route into a 05 batch, the three kernels at the 06
paths' batch-1 shapes, figures and GIFs of card tensors, and two requests
coalesced by the dynamic batcher against a direct predict; the mesh's
collectives on CUDA tensors in a group of one rank over NCCL and over gloo
(host copies), and BatchNorm at world size 1 bit for bit; the int8 conv
kernel against its plain version (exact) at the int8 decode's shapes and
across its tiles, its refusals, the int8 dense on the card against the CPU
(exact), a full-width int8 SAVi decode on the card against the CPU (in
quanta, as ``test_torch_port_quant.py``), and a quantized CATER service's
artifact answering like the live service; the ViT attention at 6 heads a
rank (ViT-B under ``model=2``), and a row shard's int8 dense taking the
whole weight's scales; the ResNet SAVi and the BatchNorm upsampling decoder
on the card against the CPU, GroupNorm on the card against the CPU, and a
ResNet SAVi train step that reaches every parameter; the bf16 variants of
conv5 and the ViT attention against their plain versions run in float32 on
the same bf16 inputs (within 2**-8 of the largest value) across their
tiles, their refusals of grad and CPU tensors, and float32 calls still
launching the float32 variants; the wgmma designs of the bf16 ViT attention
(n = 1 to 577 across its 64-key tiles and 128-query CTAs) and of the int8
conv (exact across its channel tiles, Cin 64 / 128 / 768 by Cout 64 / 128 /
1024, k 3 and 5, ReLU on and off, frames smaller than a halo and wider than
a TMA box), as more inputs of the kernels' tests; the wgmma design of the
bf16 conv5 (frames wider than its halo's room, tile counts off the grid,
rows ending inside a tile; HGMMA and no HMMA in its SASS; its plan the one
the CPU tiling test walks). Marked ``gpu``;
without a CUDA device each one skips (decided in the ``cuda`` fixture, so
every worker collects the same tests).

    python -m pytest -m gpu tests/

Tolerances: 1e-4 absolute for the slot-attention kernel against its plain
version (float32 on both, sums in other orders; slots are of order 1,
attention weights lie in [0, 1]); 2e-5 absolute and relative for the ViT
attention kernel, the JAX package's own flash-vs-XLA tolerance; 1e-4
absolute for conv5 against its plain version (float32, 1600-term sums in
other orders, outputs of order 1). Gradients: each as max abs error over
the reference's max |value|, 1e-4 (conv5's input gradient is the kernel
itself on the 3xTF32 tensor cores, its weight gradient float32 products over
every pixel). TF32 is off for the plain versions' matmuls.
"""

import copy

import numpy as np
import pytest
import torch

from textocvp_tpu_torch.models.factory import random_init_
from textocvp_tpu_torch.ops import conv5 as c5
from textocvp_tpu_torch.ops import slot_attention_kernel as sak
from textocvp_tpu_torch.ops import vit_attention as va
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


# (2, 5, 3, 64): fewer locations than CTAs in a cluster, so some own none;
# (64, 4096, 8, 256): the CATER eval batch
@pytest.mark.parametrize("b,n,s,h", [(8, 4096, 8, 256), (2, 576, 10, 256), (2, 576, 10, 512),
                                     (3, 300, 1, 64), (1, 129, 12, 128), (2, 5, 3, 64),
                                     (64, 4096, 8, 256)])
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


def test_kernel_writes_slots_in_place(cuda):
    """``out`` may be ``slots``: every CTA reads its slots before any is written."""
    k, v, slots, params = _case(4, 1000, 8, 256)
    ref, ref_attn = sak.slot_attention_plain(k, v, slots, params, 3, 128 ** -0.5)
    out, attn = sak.slot_attention_cuda(k, v, slots, params, 3, 128 ** -0.5, out=slots)
    torch.cuda.synchronize()
    assert out.data_ptr() == slots.data_ptr()
    torch.testing.assert_close(slots, ref, rtol=0, atol=1e-4)
    torch.testing.assert_close(attn, ref_attn, rtol=0, atol=1e-4)


def test_kernel_raises_on_a_launch_it_cannot_make(cuda):
    """An MLP too wide for the shared memory is refused by the launch, and the
    wrapper raises: nothing runs in its place."""
    k, v, slots, params = _case(1, 16, 12, 4096)
    before = sak.slot_attention_cuda.launches
    with pytest.raises(RuntimeError, match="cudaError"):
        sak.slot_attention_cuda(k, v, slots, params, 1, 128 ** -0.5)
    assert sak.slot_attention_cuda.launches == before


def _rel_err(got, want):
    return ((got - want).abs().max() / want.abs().max()).item()


def _grads_close(got, want):
    """Each gradient within 1e-4 of its reference's max |value|, that scale
    floored at a thousandth of the largest reference's (the query bias and
    the slot LayerNorm's bias have a gradient of exactly 0, rounding noise
    on both sides)."""
    top = max(w.abs().max().item() for w in want)
    for i, (g, w) in enumerate(zip(got, want)):
        err = (g - w).abs().max().item()
        assert err <= 1e-4 * max(w.abs().max().item(), 1e-3 * top), (i, err)


def test_slot_attention_grad_flows_and_matches_plain(cuda):
    """Under grad the module goes through the Function: one kernel launch a
    call, the gradients of k, v, slots and every refinement parameter those
    of autograd through the plain version; under no_grad and inference_mode
    it launches as before."""
    k, v, slots, _ = _case(2, 256, 8, 256)
    mod = random_init_(SlotAttention(128, 128, 8, 256), torch.Generator().manual_seed(1)).cuda()
    k, v, slots = (t.requires_grad_() for t in (k, v, slots))
    before = sak.slot_attention_cuda.launches
    out, attn = mod.iterate(k, v, slots, 2)
    assert sak.slot_attention_cuda.launches == before + 1
    leaves = [k, v, slots, *(p for n, p in mod.named_parameters()
                             if not n.startswith(("norm_input", "to_k", "to_v")))]
    got = torch.autograd.grad(out.square().sum() + attn.square().sum(), leaves)
    ref, ref_attn = sak.slot_attention_plain(k, v, slots, mod.iteration_params(), 2, 128 ** -0.5)
    want = torch.autograd.grad(ref.square().sum() + ref_attn.square().sum(), leaves)
    assert sak.slot_attention_cuda.launches == before + 1  # the backward recomputes, plain
    _grads_close(got, want)
    with torch.no_grad():
        out, _ = mod.iterate(k, v, slots, 2)
    with torch.inference_mode():
        out2, _ = mod.iterate(k, v, slots, 2)
    assert sak.slot_attention_cuda.launches == before + 3
    torch.testing.assert_close(out, out2, rtol=0, atol=0)


def test_conv5_grad_flows_and_matches_plain(cuda):
    x, wt, b = _conv5_case(2, 8, 8)
    x, wt, b = (t.requires_grad_() for t in (x, wt, b))
    before = c5.conv5_cuda.launches, c5.conv5_input_grad_cuda.launches
    y = c5.conv5(x, wt, b)
    got = torch.autograd.grad(y.square().sum(), (x, wt, b))
    assert (c5.conv5_cuda.launches, c5.conv5_input_grad_cuda.launches) == (
        before[0] + 2, before[1] + 1)
    want = torch.autograd.grad(c5.conv5_plain(x, wt, b).square().sum(), (x, wt, b))
    for g, w in zip(got, want):
        assert _rel_err(g, w) <= 1e-4
    with torch.no_grad():
        out = c5.conv5(x, wt, b)
    with torch.inference_mode():
        out2 = c5.conv5(x, wt, b)
    torch.testing.assert_close(out, out2, rtol=0, atol=0)


def test_conv_decoder_trains_its_tail_behind_a_frozen_first_block(cuda):
    """The tail's input requires no grad, its weights do: the tail convs get
    their weight gradients (those of the CPU's plain version), and no input
    gradient is launched."""
    from textocvp_tpu_torch.nn.decoders import ConvDecoder

    dec = random_init_(ConvDecoder(32, [64, 64, 64]), torch.Generator().manual_seed(4))
    dec.blocks[0].requires_grad_(False)
    x = torch.randn(2, 32, 16, 16, generator=torch.Generator().manual_seed(5))
    dec(x).square().sum().backward()
    want = [p.grad.clone() for b in dec.blocks[1:] for p in b.parameters()]
    dec.zero_grad()
    dec = dec.cuda()
    before = c5.conv5_cuda.launches, c5.conv5_input_grad_cuda.launches
    dec(x.cuda()).square().sum().backward()
    # the first tail conv's input needs no gradient: one input-gradient launch
    assert (c5.conv5_cuda.launches, c5.conv5_input_grad_cuda.launches) == (
        before[0] + 3, before[1] + 1)
    got = [p.grad for b in dec.blocks[1:] for p in b.parameters()]
    for g, w in zip(got, want):
        assert _rel_err(g.cpu(), w) <= 1e-4


def test_vit_attention_refuses_grad_and_runs_without_it(cuda):
    q, k, v = _qkv(2, 4, 100)
    before = va.vit_attention_cuda.launches
    with pytest.raises(RuntimeError, match="ViT attention: the CUDA kernel has no backward"):
        va.vit_attention(q.clone().requires_grad_(), k, v, 0.125)
    assert va.vit_attention_cuda.launches == before
    with torch.no_grad():
        out = va.vit_attention(q.clone().requires_grad_(), k, v, 0.125)
    assert va.vit_attention_cuda.launches == before + 1
    torch.testing.assert_close(out, va.vit_attention_plain(q, k, v, 0.125), rtol=2e-5, atol=2e-5)


# conv5's gradients across the kernel's 16 x 64 tile: H and W on, under and
# over its edges
@pytest.mark.parametrize("n,h,w", [(2, 16, 64), (2, 15, 63), (2, 17, 65), (1, 33, 129),
                                   (3, 5, 7), (1, 1, 1)])
@pytest.mark.parametrize("relu", [True, False])
def test_conv5_function_gradients_across_tile_edges(cuda, n, h, w, relu):
    x, wt, b = _conv5_case(n, h, w)
    g = torch.randn((n, 64, h, w), generator=torch.Generator().manual_seed(h * w)).cuda()
    g = g.permute(0, 2, 3, 1)  # strided, as it comes back through the final conv
    x, wt, b = (t.requires_grad_() for t in (x, wt, b))
    y = c5.conv5(x, wt, b, relu)
    got = torch.autograd.grad(y, (x, wt, b), g)
    # the reference takes the ReLU's mask from the kernel's output: where the
    # two forwards straddle 0 within their error, the masks differ, and the
    # gradients with them by a whole term of g
    gm = torch.where(y.detach() > 0, g, 0.0) if relu else g
    want = torch.autograd.grad(c5.conv5_plain(x, wt, b, relu=False), (x, wt, b), gm)
    for gg, ww, what in zip(got, want, "xwb"):
        assert _rel_err(gg, ww) <= 1e-4, what


@pytest.mark.parametrize("b,n,s,h,iters", [(2, 5, 3, 64, 3), (1, 7, 8, 256, 1),
                                           (64, 4096, 8, 256, 3), (64, 4096, 8, 256, 1),
                                           (8, 576, 10, 512, 3), (8, 576, 10, 512, 1)])
def test_slot_attention_function_gradients(cuda, b, n, s, h, iters):
    """N < 8 (CTAs of a cluster that own no location), the CATER train shape,
    B=64, N=4096, and the CLIPort 02 microbatch, B=8, N=576, S=10, MLP 512."""
    k, v, slots, params = _case(b, n, s, h)
    leaves = [t.requires_grad_() for t in (k, v, slots, *params.values())]
    k, v, slots = leaves[:3]
    p = dict(zip(params, leaves[3:]))
    gen = torch.Generator().manual_seed(b + n)
    gs = torch.randn((b, s, 128), generator=gen).cuda()
    ga = torch.randn((b, s, n), generator=gen).cuda()
    out, attn = sak.slot_attention_iterations(k, v, slots, p, iters, 128 ** -0.5)
    got = torch.autograd.grad([out, attn], leaves, [gs, ga])
    ref, ref_attn = sak.slot_attention_plain(k, v, slots, p, iters, 128 ** -0.5)
    want = torch.autograd.grad([ref, ref_attn], leaves, [gs, ga])
    _grads_close(got, want)


def test_savi_train_step_on_the_card_leaves_no_parameter_without_a_gradient(cuda, tmp_path):
    """One DecompTrainer step at full width, B=2, T=3: every parameter gets a
    finite gradient and moves; 3 slot-attention calls (one a frame), 3 conv5
    forward and 3 input-gradient launches."""
    from textocvp_tpu_torch.core.config import build_exp_params
    from textocvp_tpu_torch.core.experiment import Experiment
    from textocvp_tpu_torch.train.trainer import DecompTrainer

    p = build_exp_params("SAVi", "CATER_Easy")
    p["training"].update(batch_size=2, lr_warmup=False)
    Experiment(tmp_path).save_params(p)
    tr = DecompTrainer(tmp_path)
    tr.setup_model()
    before = {n: t.detach().clone() for n, t in tr.model.named_parameters()}
    video = torch.rand((2, 3, 64, 64, 3), generator=torch.Generator().manual_seed(6)).cuda()
    counts = (sak.slot_attention_cuda.launches, c5.conv5_cuda.launches,
              c5.conv5_input_grad_cuda.launches)
    values = tr.train_step(video)
    torch.cuda.synchronize()
    assert (sak.slot_attention_cuda.launches - counts[0], c5.conv5_cuda.launches - counts[1],
            c5.conv5_input_grad_cuda.launches - counts[2]) == (3, 6, 3)
    assert np.isfinite(float(values["_total"]))
    for name, t in tr.model.named_parameters():
        assert t.grad is not None and bool(torch.isfinite(t.grad).all()), name
        if name not in ("slot_attention.to_q.bias", "slot_attention.norm_slot.bias"):
            assert t.grad.abs().max() > 0, name  # those two: exactly 0 (softmax over slots)
        assert not torch.equal(t.detach(), before[name]) or t.grad.abs().max() == 0, name


def test_predictor_train_step_on_the_card_reaches_the_predictor_and_nothing_frozen(cuda,
                                                                                   tmp_path):
    """One PredictorTrainer step at full width (CATER SAVi + TextOCVP_T5), B=2,
    c=1, p=9: every trainable predictor parameter gets a finite gradient, no
    SAVi or T5 parameter gets one; 10 slot-attention calls (the frozen encode
    of 10 frames), 3 conv5 forward and 3 input-gradient launches, no conv5
    weight gradient."""
    from textocvp_tpu_torch.core.config import add_predictor_params, build_exp_params
    from textocvp_tpu_torch.core.experiment import Experiment
    from textocvp_tpu_torch.models import setup_model
    from textocvp_tpu_torch.train.predictor_trainer import PredictorTrainer

    p = build_exp_params("SAVi", "CATER_Easy")
    parent = Experiment(tmp_path / "exp")
    parent.save_params(p)
    parent.models_dir.mkdir(parents=True)
    torch.save(random_init_(setup_model(p), torch.Generator().manual_seed(1)).state_dict(),
               parent.checkpoint_path("savi"))
    pp = add_predictor_params(p, "TextOCVP_T5")
    pp["training"].update(batch_size=2, lr_warmup=False)
    Experiment(parent.exp_path / "predictors" / "t5").save_params(pp)
    tr = PredictorTrainer(parent.exp_path / "predictors" / "t5", "savi")
    tr.setup_model()
    gen = torch.Generator().manual_seed(6)
    video = torch.rand((2, 10, 64, 64, 3), generator=gen).cuda()
    text = {"caption_tokens": torch.randint(2, 32000, (2, 12), generator=gen).cuda(),
            "attn_masks": torch.ones((2, 12), dtype=torch.long).cuda()}
    counts = (sak.slot_attention_cuda.launches, c5.conv5_cuda.launches,
              c5.conv5_input_grad_cuda.launches, c5.conv5_weight_grad.calls)
    values = tr.train_step(video, **text)
    torch.cuda.synchronize()
    assert (sak.slot_attention_cuda.launches - counts[0], c5.conv5_cuda.launches - counts[1],
            c5.conv5_input_grad_cuda.launches - counts[2],
            c5.conv5_weight_grad.calls - counts[3]) == (10, 6, 3, 0)
    assert np.isfinite(float(values["_total"]))
    trainable = 0
    for name, t in tr.model.named_parameters():
        if name.startswith("predictor.text_encoder."):
            assert not t.requires_grad and t.grad is None, name
        else:
            assert t.grad is not None and bool(torch.isfinite(t.grad).all()), name
            trainable += 1
    assert trainable == len(tr.optimizer.params)
    assert all(t.grad is None and not t.requires_grad for t in tr.decomp_model.parameters())


OTHER_PREDICTORS = ("VanillaTransformer", "OCVPSeq", "OCVPPar", "TextOCVP_CustomTF")


def _tiny_predictor(name):
    """Predictor ``name`` at a small width over 4 slots of 32, buffer 4, its
    weights drawn from a seed, in ``eval()``."""
    from textocvp_tpu_torch.core.config import add_predictor_params, build_exp_params
    from textocvp_tpu_torch.models import setup_predictor

    p = add_predictor_params(build_exp_params("SAVi", "CATER_Easy"), name)
    p["model"]["model_params"].update(num_slots=4, slot_dim=32)
    pp = p["predictor"]["predictor_params"]
    if name == "TextOCVP_CustomTF":
        pp["predictor_params"].update(token_dim=32, n_heads=4, hidden_dim=64, num_layers=2)
        pp["fusion_params"].update(num_heads=2, head_dim=16, mlp_size=64)
        pp["text_encoder_params"].update(input_dim=32)
    else:
        pp.update(token_dim=32, hidden_dim=64)
    p["prediction_params"].update(num_context=2, num_preds=5, input_buffer_size=4)
    return random_init_(setup_predictor(p), torch.Generator().manual_seed(2)).eval()


@pytest.mark.parametrize("name", OTHER_PREDICTORS)
def test_other_predictors_roll_out_on_the_card_as_on_the_cpu(cuda, name):
    """A 5-step rollout over a buffer of 4 (its padding masked, then sliding)
    on the card and on the CPU, the same weights, slots and CustomTokenizer
    captions: within 1e-5 of each step's largest slot."""
    from textocvp_tpu_torch.data.tokenizers import CustomTokenizer
    from textocvp_tpu_torch.data.vocabularies import CATER_EASY_VOCAB

    pred = _tiny_predictor(name)
    hist = torch.randn((2, 2, 4, 32), generator=torch.Generator().manual_seed(3))
    tok = CustomTokenizer(CATER_EASY_VOCAB)(["the cone is rotating", "the snitch is sliding"])
    text = {k: torch.from_numpy(tok[k]) for k in ("caption_tokens", "caption_lengths")}
    with torch.no_grad():
        ref = pred(hist, **text)
        out = copy.deepcopy(pred).to(cuda)(hist.to(cuda), **{k: v.to(cuda)
                                                              for k, v in text.items()}).cpu()
    err = (out - ref).abs().amax(dim=(0, 2, 3)) / ref.abs().amax(dim=(0, 2, 3))
    assert out.shape == (2, 5, 4, 32) and err.max() <= 1e-5, err


def test_custom_tf_refuses_out_of_range_ids_on_the_card_before_any_lookup(cuda):
    """T5 ids into a CustomTF predictor on the card raise ValueError, not a
    device-side assert: the process goes on to a good call."""
    pred = _tiny_predictor("TextOCVP_CustomTF").to(cuda)
    hist = torch.randn((2, 2, 4, 32), device=cuda)
    lengths = torch.tensor([5, 3], device=cuda)
    with torch.no_grad():
        with pytest.raises(ValueError, match="vocab_size"):
            pred(hist, caption_tokens=torch.full((2, 5), 32000, device=cuda),
                 caption_lengths=lengths)
        out = pred(hist, caption_tokens=torch.full((2, 5), 3, device=cuda),
                   caption_lengths=lengths)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out).all())


def test_conv5_input_gradient_behind_frozen_weights_matches_plain(cuda):
    """Conv5Function with weights that need no gradient, at a CATER request's
    N=1216: one forward and one input-gradient launch, no weight gradient,
    and the input gradient of autograd through ``conv5_plain`` (both with the
    ReLU mask of the kernel's output; in chunks of 304 frames)."""
    x, wt, b = _conv5_case(1216, 64, 64)
    x.requires_grad_()
    g = torch.randn(x.shape, generator=torch.Generator().manual_seed(3)).cuda()
    before = (c5.conv5_cuda.launches, c5.conv5_input_grad_cuda.launches,
              c5.conv5_weight_grad.calls)
    y = c5.conv5(x, wt, b)
    (got,) = torch.autograd.grad(y, x, g)
    assert (c5.conv5_cuda.launches - before[0], c5.conv5_input_grad_cuda.launches - before[1],
            c5.conv5_weight_grad.calls - before[2]) == (2, 1, 0)
    gm = torch.where(y.detach() > 0, g, 0.0)
    want = torch.empty_like(got)
    for i in range(0, x.shape[0], 304):
        xi = x[i:i + 304].detach().requires_grad_()
        (want[i:i + 304],) = torch.autograd.grad(c5.conv5_plain(xi, wt, b, relu=False), xi,
                                                  gm[i:i + 304])
    assert _rel_err(got, want) <= 1e-4


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


def _qkv(b, h, n, dh=64, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn((b, h, n, dh), generator=gen).cuda() for _ in range(3)]


@pytest.mark.parametrize("b,h,n", [(8, 12, 577), (64, 12, 577), (2, 4, 150), (1, 1, 1), (3, 2, 64),
                                   (2, 3, 63), (2, 3, 65), (1, 2, 128), (1, 2, 129)])
def test_vit_attention_kernel_matches_plain(cuda, b, h, n):
    q, k, v = _qkv(b, h, n)
    before = va.vit_attention_cuda.launches
    out = va.vit_attention_cuda(q, k, v, 64 ** -0.5)
    ref = va.vit_attention_plain(q, k, v, 64 ** -0.5)
    torch.cuda.synchronize()
    assert va.vit_attention_cuda.launches == before + 1
    torch.testing.assert_close(out, ref, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("bad", ["dtype", "head_dim", "strided", "device"])
def test_vit_attention_kernel_refuses_what_it_does_not_take(cuda, bad):
    q, k, v = _qkv(2, 4, 100)
    if bad == "dtype":
        k = k.double()
    elif bad == "head_dim":
        q, k, v = _qkv(2, 4, 100, dh=32)
    elif bad == "strided":
        q = q.transpose(1, 2).contiguous().transpose(1, 2)
    else:
        v = v.cpu()
    with pytest.raises((ValueError, TypeError)):
        va.vit_attention_cuda(q, k, v, 0.125)


def test_vit_launches_the_kernel_once_per_block(cuda):
    from textocvp_tpu_torch.nn.vit import ViTEncoder

    vit = random_init_(ViTEncoder(img_size=56, patch_size=14, embed_dim=128, depth=3,
                                  num_heads=2, layerscale_init=0.1),
                       torch.Generator().manual_seed(4)).eval()
    frames = torch.rand((2, 56, 56, 3), generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        ref = vit(frames)
        before = va.vit_attention_cuda.launches
        out = vit.cuda()(frames.cuda())
        torch.cuda.synchronize()
    assert va.vit_attention_cuda.launches == before + 3
    torch.testing.assert_close(out.cpu(), ref, rtol=1e-4, atol=1e-4)


def test_dinosaur_seed_encode_on_the_card_matches_the_cpu(cuda):
    from textocvp_tpu_torch.core.config import build_exp_params
    from textocvp_tpu_torch.models import setup_model

    p = build_exp_params("ExtendedDINOSAUR", "CLIPort")
    mp = p["model"]["model_params"]
    mp.update(img_size=56)
    mp["encoder"]["encoder_params"]["encoder_num_blocks"] = 2
    mp["decoder"]["decoder_params"].update(num_patches=16, hidden_dim=64, num_layers_cnn=2)
    model = random_init_(setup_model(p), torch.Generator().manual_seed(6)).eval()
    gen = torch.Generator().manual_seed(7)
    video = torch.rand((2, 2, 56, 56, 3), generator=gen)
    init = model.slot_initializer(2, gen)
    with torch.no_grad():
        ref = model.decompose(video, initial_slots=init)
        out = model.cuda().decompose(video.cuda(), initial_slots=init.cuda())
    scale = max(1.0, ref["slot_history"].abs().max().item())
    np.testing.assert_allclose(out["slot_history"].cpu().numpy(), ref["slot_history"].numpy(),
                               rtol=0, atol=1e-4 * scale)
    np.testing.assert_allclose(out["attn_masks"].cpu().numpy(), ref["attn_masks"].numpy(),
                               rtol=0, atol=1e-4)


def _conv5_case(n, h, w, c=64, seed=0):
    gen = torch.Generator().manual_seed(seed)
    x = 0.5 * torch.randn((n, h, w, c), generator=gen)
    wt = torch.randn((5, 5, c, c), generator=gen) / (25 * c) ** 0.5
    b = 0.1 * torch.randn((c,), generator=gen)
    return x.cuda(), wt.cuda(), b.cuda()


# the kernel's tile is 16 rows x 64 columns: H and W on, one under and one
# over its edges
@pytest.mark.parametrize("n,h,w", [(2, 64, 64), (3, 17, 70), (1, 1, 1), (4, 5, 130), (70, 16, 16),
                                   (2, 15, 63), (2, 17, 65), (1, 16, 64), (1, 33, 129),
                                   (3, 31, 127)])
@pytest.mark.parametrize("relu", [True, False])
def test_conv5_kernel_matches_plain(cuda, n, h, w, relu):
    x, wt, b = _conv5_case(n, h, w)
    before = c5.conv5_cuda.launches
    out = c5.conv5_cuda(x, wt, b, relu)
    ref = c5.conv5_plain(x, wt, b, relu)
    torch.cuda.synchronize()
    assert c5.conv5_cuda.launches == before + 1
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-4)


@pytest.mark.parametrize("bad", ["dtype", "channels", "layout", "device", "weight_shape"])
def test_conv5_kernel_refuses_what_it_does_not_take(cuda, bad):
    x, wt, b = _conv5_case(2, 8, 8)
    if bad == "dtype":
        x = x.double()
    elif bad == "channels":
        x, wt, b = _conv5_case(2, 8, 8, c=32)
    elif bad == "layout":  # an NCHW tensor's NHWC view is not contiguous
        x = x.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    elif bad == "device":
        b = b.cpu()
    else:
        wt = wt.permute(3, 2, 0, 1).contiguous()
    before = c5.conv5_cuda.launches
    with pytest.raises((ValueError, TypeError)):
        c5.conv5_cuda(x, wt, b)
    assert c5.conv5_cuda.launches == before


@pytest.mark.parametrize("stem", ["conv5", "vit_attention", "conv_int8"])
def test_kernel_runs_on_the_tensor_cores(cuda, stem):
    from textocvp_tpu_torch.ops import build

    build.load_library(stem)
    assert build.tensor_core_instructions(stem) > 0, build.ptxas_report(stem)


def test_savi_decode_on_the_card_matches_the_cpu_with_one_launch_per_tail_conv(cuda):
    from textocvp_tpu_torch.core.config import build_exp_params
    from textocvp_tpu_torch.models import setup_model

    p = build_exp_params("SAVi", "CATER_Easy")  # decoder tail 64 -> 64 at 64 x 64
    model = random_init_(setup_model(p), torch.Generator().manual_seed(8)).eval()
    slots = torch.randn((3, 8, 128), generator=torch.Generator().manual_seed(9))
    with torch.no_grad():
        ref = model.decode(slots)["recons_imgs"]
        before = c5.conv5_cuda.launches
        out = model.cuda().decode(slots.cuda())["recons_imgs"]
        torch.cuda.synchronize()
    assert c5.conv5_cuda.launches == before + 3
    torch.testing.assert_close(out.cpu(), ref, rtol=0, atol=1e-4)


def test_03_step_on_the_card_matches_the_cpu(cuda, tmp_path):
    """The 03 step (every frame decomposed, every frame decoded, the metrics)
    of a full-width SAVi on an imported-style bare state dict, B=1, T=3: one
    slot-attention call a frame, three conv5 launches, PSNR within 1e-3 dB,
    SSIM and LPIPS within 1e-4 of the CPU's."""
    from textocvp_tpu_torch.core.config import build_exp_params
    from textocvp_tpu_torch.core.experiment import Experiment
    from textocvp_tpu_torch.models import setup_model
    from textocvp_tpu_torch.train.evaluator import DecompEvaluator

    exp = Experiment(tmp_path / "exp")
    exp.save_params(build_exp_params("SAVi", "CATER_Easy"))
    exp.models_dir.mkdir()
    model = random_init_(setup_model(exp.params), torch.Generator().manual_seed(10))
    torch.save(model.state_dict(), exp.checkpoint_path("SAVi_CATER"))
    videos = np.random.default_rng(11).uniform(0, 1, (1, 3, 64, 64, 3)).astype(np.float32)
    vals = {}
    for dev in ("cpu", "cuda"):
        ev = DecompEvaluator(exp.exp_path, "SAVi_CATER", device=dev)
        ev.load_model()
        init = ev.model.slot_initializer(1, torch.Generator().manual_seed(12))
        before = (sak.slot_attention_cuda.launches, c5.conv5_cuda.launches)
        vals[dev] = {m: v.cpu() for m, v in ev.eval_step(videos, initial_slots=init).items()}
        torch.cuda.synchronize()
        launched = (sak.slot_attention_cuda.launches - before[0],
                    c5.conv5_cuda.launches - before[1])
        assert launched == ((0, 0) if dev == "cpu" else (3, 3))
    for m, tol in (("psnr", 1e-3), ("ssim", 1e-4), ("lpips", 1e-4)):
        assert vals["cuda"][m].shape == (1, 3)
        torch.testing.assert_close(vals["cuda"][m], vals["cpu"][m], rtol=0, atol=tol)


def test_batchnorm_conv_block_in_training_mode_on_the_card_matches_the_cpu(cuda):
    """A CNN-head block (3x3 conv, flax's BatchNorm, ReLU) in ``train()``: the
    output, the running statistics after the call and the input and weight
    gradients on the card against the CPU (1e-5 relative to each tensor's
    largest value; the gradients with the card's ReLU mask on both)."""
    from textocvp_tpu_torch.nn.blocks import ConvBlock

    gen = torch.Generator().manual_seed(9)
    block = random_init_(ConvBlock(32, 16, 3, batch_norm=True), gen).train()
    with torch.no_grad():
        block.bn.running_mean.normal_(0, 0.3, generator=gen)
        block.bn.running_var.uniform_(0.5, 2.0, generator=gen)
    x = (1.0 + torch.randn((6, 32, 24, 24), generator=gen)).requires_grad_()
    g = torch.randn((6, 16, 24, 24), generator=gen)
    card = copy.deepcopy(block).cuda()
    xc = x.detach().cuda().requires_grad_()
    out = card(xc)
    (gx,) = torch.autograd.grad(out, xc, g.cuda())
    mask = out.detach().cpu() > 0
    pre = block.bn(block.conv(x))
    ref = torch.where(mask, pre, 0.0)
    (rx,) = torch.autograd.grad(ref, x, g)
    for got, want in ((out.detach().cpu(), ref.detach()), (gx.cpu(), rx),
                      (card.bn.running_mean.cpu(), block.bn.running_mean),
                      (card.bn.running_var.cpu(), block.bn.running_var)):
        assert _rel_err(got, want) <= 1e-5
    assert int(card.bn.num_batches_tracked) == int(block.bn.num_batches_tracked) == 1


def test_dinosaur_train_step_on_the_card_trains_all_but_the_vit(cuda, tmp_path):
    """One DecompTrainer step of ExtendedDINOSAUR on the card (DINOv2 ViT-B/14
    at 112 px, 2 ViT blocks, full-width slots, decoder and CNN head), B=2,
    T=3: every trainable parameter gets a finite gradient, the ViT none and
    stays bit for bit; one slot-attention call a frame and one ViT-attention
    launch a block, the running statistics moved."""
    from textocvp_tpu_torch.core.config import build_exp_params
    from textocvp_tpu_torch.core.experiment import Experiment
    from textocvp_tpu_torch.train.trainer import DecompTrainer

    p = build_exp_params("ExtendedDINOSAUR", "CLIPort")
    mp = p["model"]["model_params"]
    mp["img_size"] = 112
    mp["encoder"]["encoder_params"]["encoder_num_blocks"] = 2
    mp["decoder"]["decoder_params"]["num_patches"] = 64
    p["training"].update(batch_size=2, lr_warmup=False, accum_steps=1)
    Experiment(tmp_path).save_params(p)
    tr = DecompTrainer(tmp_path)
    tr.setup_model()
    vit = {k: v.clone() for k, v in tr.model.image_encoder.state_dict().items()}
    stats = tr.model.patch_decoder.cnns[0].bn.running_mean.clone()
    video = torch.rand((2, 3, 112, 112, 3), generator=torch.Generator().manual_seed(6)).cuda()
    counts = (sak.slot_attention_cuda.launches, va.vit_attention_cuda.launches)
    values = tr.train_step(video)
    torch.cuda.synchronize()
    assert (sak.slot_attention_cuda.launches - counts[0],
            va.vit_attention_cuda.launches - counts[1]) == (3, 2)
    assert set(values) == {"pred_feature_mse", "mse", "_total"}
    assert np.isfinite(float(values["_total"]))
    for name, t in tr.model.named_parameters():
        if name.startswith("image_encoder."):
            assert not t.requires_grad and t.grad is None, name
        else:
            assert t.grad is not None and bool(torch.isfinite(t.grad).all()), name
    for k, v in tr.model.image_encoder.state_dict().items():
        assert torch.equal(v, vit[k]), k
    assert not torch.equal(tr.model.patch_decoder.cnns[0].bn.running_mean, stats)


def test_imgio_builds_on_this_machine_and_is_exact(cuda, tmp_path):
    """The host image library builds here against zlib; its resize equals ``resize_bilinear_plain`` at the CATER and
    CLIPort shapes, and PNGs of the stdlib writer decode back to their
    frames."""
    from textocvp_tpu_torch import native
    from textocvp_tpu_torch.native.png import encode_png

    assert native.build().is_file()
    assert native.host_io()["imgio_with_zlib"] is True
    rng = np.random.default_rng(0)
    for (h, w), (oh, ow) in (((240, 320), (64, 64)), ((480, 640), (336, 336))):
        frame = rng.integers(0, 256, (h, w, 3), np.uint8)
        np.testing.assert_array_equal(native.resize_bilinear_rgb(frame, oh, ow),
                                      native.resize_bilinear_plain(frame, oh, ow))
        for color_type, arr in ((2, frame), (6, np.concatenate([frame, frame[..., :1]], -1))):
            np.testing.assert_array_equal(native.decode_png_rgb(encode_png(arr, color_type)),
                                          frame)


def _remat_grads(tmp_path, params, video, noise, frozen=None):
    """The gradients of one DecompTrainer backward on the card without and
    with ``tpu.remat``, and the buffers after it."""
    from textocvp_tpu_torch.core.experiment import Experiment
    from textocvp_tpu_torch.train.trainer import DecompTrainer

    out = {}
    for knob in (False, True):
        Experiment(tmp_path / str(knob)).save_params({**params, "tpu": {"remat": knob}})
        tr = DecompTrainer(tmp_path / str(knob))
        tr.setup_model()
        tr.backward(video, noise)
        out[knob] = ({n: p.grad.clone() for n, p in tr.model.named_parameters()
                      if p.grad is not None},
                     {n: b.clone() for n, b in tr.model.named_buffers()})
    (g0, b0), (g1, b1) = out[False], out[True]
    assert g0.keys() == g1.keys() and g0
    top = max(g.abs().max().item() for g in g0.values())
    for name, g in g0.items():
        assert (g1[name] - g).abs().max().item() <= 1e-6 * top, name
    for name, b in b0.items():
        torch.testing.assert_close(b1[name], b, rtol=1e-6, atol=1e-7, msg=name)
    return b0


@pytest.mark.parametrize("model", ["SAVi", "ExtendedDINOSAUR"])
def test_a_remat_step_on_the_card_matches_the_plain_step(cuda, tmp_path, model):
    """One 02 backward on the card (SAVi at full width, B=2, T=3;
    ExtendedDINOSAUR at 112 px with 2 ViT blocks, two microbatches) with
    ``tpu.remat``: every gradient within 1e-6 of the largest leaf of the
    step without it, and the BatchNorm statistics moved as without it."""
    from textocvp_tpu_torch.core.config import build_exp_params

    p = build_exp_params(model, "CATER_Easy" if model == "SAVi" else "CLIPort")
    mp = p["model"]["model_params"]
    res = 64
    if model == "ExtendedDINOSAUR":
        res = mp["img_size"] = 112
        mp["encoder"]["encoder_params"]["encoder_num_blocks"] = 2
        mp["decoder"]["decoder_params"]["num_patches"] = 64
    p["training"].update(batch_size=2, lr_warmup=False, accum_steps=2 if res == 112 else 1)
    gen = torch.Generator().manual_seed(7)
    video = torch.rand((2, 3, res, res, 3), generator=gen).cuda()
    noise = torch.randn((2, mp["num_slots"], mp["slot_dim"]), generator=gen)
    buffers = _remat_grads(tmp_path, p, video, noise)
    if model == "ExtendedDINOSAUR":
        tracked = [b for n, b in buffers.items() if n.endswith("num_batches_tracked")]
        assert tracked and all(int(b) == 2 for b in tracked)


def test_the_png_route_feeds_a_05_batch_on_the_card(cuda, tmp_path):
    """CATER frame directories of 320 x 240 PNGs resized to 64 x 64 into a
    05 batch at full width (B=2, p=3) on the card: the same metrics as the
    ``.npy`` cache of the same PNGs."""
    import json

    from textocvp_tpu_torch.cli import make_npy_cache
    from textocvp_tpu_torch.core.config import add_predictor_params, build_exp_params
    from textocvp_tpu_torch.core.experiment import Experiment
    from textocvp_tpu_torch.models import setup_model, setup_predictor
    from textocvp_tpu_torch.native.png import encode_png
    from textocvp_tpu_torch.train.evaluator import PredictorEvaluator

    rng = np.random.default_rng(8)
    mode = tmp_path / "png" / "easy"
    ann = {}
    for i in range(2):
        (mode / f"v{i}").mkdir(parents=True)
        for t in range(5):
            frame = rng.integers(0, 256, (240, 320, 3), np.uint8)
            (mode / f"v{i}" / f"{t:03d}.png").write_bytes(encode_png(frame, 2))
        ann[str(i)] = {"video": f"v{i}", "caption": "the cone is rotating"}
    (mode / "test_explicit.json").write_text(json.dumps(ann))
    make_npy_cache.main(["--root", str(tmp_path / "png"), "--split", "test", "--img-size",
                         "64x64", "--out", str(tmp_path / "npy")])
    params = build_exp_params("SAVi", "CATER_Easy")
    gen = torch.Generator().manual_seed(9)
    model = random_init_(setup_model(params), gen)
    pred_params = add_predictor_params(params, "TextOCVP_T5")
    predictor = random_init_(setup_predictor(pred_params), gen)
    metrics = {}
    for route in ("png", "npy"):
        for q in (params, pred_params):
            q["dataset"]["root"] = str(tmp_path / route)
        exp = Experiment(tmp_path / f"exp_{route}")
        exp.save_params(params)
        pred = Experiment(exp.exp_path / "predictors" / "p")
        pred.save_params(pred_params)
        for e in (exp, pred):
            e.models_dir.mkdir(parents=True, exist_ok=True)
        torch.save(model.state_dict(), exp.checkpoint_path("m"))
        torch.save(predictor.state_dict(), pred.checkpoint_path("m"))
        ev = PredictorEvaluator(exp.exp_path, "p", "m", "m", num_seed=1, num_preds=3,
                                batch_size=2)
        ev.load_data()
        ev.load_models()
        videos, info = next(iter(ev.test_loader))
        assert videos.shape == (2, 4, 64, 64, 3)
        metrics[route] = {k: v.cpu() for k, v in ev.eval_step(videos, info).items()}
    for k, v in metrics["png"].items():
        assert bool(torch.isfinite(v).all()) and torch.equal(v, metrics["npy"][k]), k


# the batch-1 shapes of the 06 paths: one sequence's seed encode (CATER N=4096,
# S=8; CLIPort N=576, S=10) and its decodes (conv5 over the 8 seed maps, the
# 64 maps of 06a's 8 frames, the 152 predicted maps at p=19), and the ViT on
# one frame
@pytest.mark.parametrize("n,s,h", [(4096, 8, 256), (576, 10, 512)])
@pytest.mark.parametrize("iters", [1, 3])
def test_slot_attention_at_batch_1_matches_plain(cuda, n, s, h, iters):
    k, v, slots, params = _case(1, n, s, h, seed=3)
    out, attn = sak.slot_attention_cuda(k, v, slots, params, iters, 128 ** -0.5)
    ref, ref_attn = sak.slot_attention_plain(k, v, slots, params, iters, 128 ** -0.5)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-4)
    torch.testing.assert_close(attn, ref_attn, rtol=0, atol=1e-4)


@pytest.mark.parametrize("n", [8, 64, 152])
def test_conv5_at_the_06_map_counts_matches_plain(cuda, n):
    x, wt, b = _conv5_case(n, 64, 64, seed=3)
    out = c5.conv5_cuda(x, wt, b)
    ref = c5.conv5_plain(x, wt, b)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-4)


def test_vit_attention_at_batch_1_matches_plain(cuda):
    q, k, v = _qkv(1, 12, 577, seed=3)
    out = va.vit_attention_cuda(q, k, v, 64 ** -0.5)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, va.vit_attention_plain(q, k, v, 64 ** -0.5), rtol=2e-5,
                               atol=2e-5)


def test_figures_and_gifs_take_card_tensors(cuda, tmp_path):
    """A figure and a GIF of tensors on the card equal those of the same
    tensors on the CPU, read back from their files."""
    from PIL import Image

    from textocvp_tpu_torch import viz

    x = torch.rand((4, 16, 16, 3), device="cuda", generator=torch.Generator("cuda").manual_seed(0))

    def frames(path):
        with Image.open(path) as img:
            out = []
            for i in range(getattr(img, "n_frames", 1)):
                img.seek(i)
                out.append(np.asarray(img.convert("RGB")))
        return np.stack(out)

    for d, a in (("card", x), ("cpu", x.cpu())):
        viz.visualize_recons(a, a.flip(0), savepath=tmp_path / f"{d}.png")
        viz.make_gif(a, tmp_path / f"{d}.gif", n_seed=1)
    for ext, n in (("png", 1), ("gif", 4)):
        card, cpu = frames(tmp_path / f"card.{ext}"), frames(tmp_path / f"cpu.{ext}")
        assert len(card) == n
        np.testing.assert_array_equal(card, cpu)


def test_coalesced_requests_equal_a_direct_predict_on_the_card(cuda, tmp_path):
    """Two one-row requests through the dynamic batcher equal a direct two-row
    predict at the same generator state, bit for bit, on a full-width CATER
    service (batch 8, ``LearnedRandom`` slots, random weights)."""
    import threading
    import time

    from textocvp_tpu_torch.core.config import add_predictor_params, build_exp_params
    from textocvp_tpu_torch.core.experiment import Experiment
    from textocvp_tpu_torch.models import setup_model, setup_predictor
    from textocvp_tpu_torch.serve import DynamicBatcher, PredictionService

    params = build_exp_params("SAVi", "CATER_Easy")
    params["model"]["model_params"]["initializer"] = "LearnedRandom"
    pred_params = add_predictor_params(params, "TextOCVP_T5")
    gen = torch.Generator().manual_seed(6)
    exp, pred = Experiment(tmp_path / "exp"), Experiment(tmp_path / "exp" / "predictors" / "p")
    for e, p, module in ((exp, params, random_init_(setup_model(params), gen)),
                         (pred, pred_params, random_init_(setup_predictor(pred_params), gen))):
        e.save_params(p)
        e.models_dir.mkdir(parents=True, exist_ok=True)
        torch.save(module.state_dict(), e.checkpoint_path("m"))
    service = PredictionService(exp.exp_path, "p", "m", "m", batch_size=8)
    frames = np.random.default_rng(7).random((2, 1, 64, 64, 3), np.float32)
    captions = ["the cone is rotating", "the snitch is sliding to (2, 2)"]
    state = service.generator.get_state()
    ref = service.predict(frames, captions)
    batcher = DynamicBatcher(service, max_wait_ms=2000.0)
    try:
        service.generator.set_state(state)
        out = {}
        threads = [threading.Thread(target=lambda i=i: out.update(
            {i: batcher.predict(frames[i:i + 1], captions[i:i + 1])})) for i in range(2)]
        threads[0].start()
        time.sleep(0.1)  # request 0 enqueues first
        threads[1].start()
        for t in threads:
            t.join(timeout=120)
        assert batcher._dispatches == 1
        np.testing.assert_array_equal(np.concatenate([out[0], out[1]]), ref)
    finally:
        batcher.close()


def _int8_case(n, h, w, k, cin, cout, seed=0):
    g = torch.Generator().manual_seed(seed)
    x_q = torch.randint(-127, 128, (n, h, w, cin), generator=g, dtype=torch.int8)
    w_q = torch.randint(-127, 128, (k, k, cin, cout), generator=g, dtype=torch.int8)
    a_scale = torch.tensor(0.013)
    w_scale = torch.rand(cout, generator=g) * 1e-3
    bias = torch.randn(cout, generator=g)
    return x_q, w_q, a_scale, w_scale, bias


# SAVi's tail at a request's and a 05 batch's first maps, the CNN head's first
# layer, and frames across the kernel's tiles and the frame's border; then the
# wgmma design's edges: 3 frames of 11 x 13 (11 x (13 + k - 1) padded
# positions, off the 256-position tile) at every Cin / Cout pairing of the
# paths' widths (64-channel output tiles for Cout 64, 128 for 128 and 1024;
# the weights resident at 64 -> 64 and 128 -> 64, streamed otherwise), frames
# smaller than a tile's halo, a frame one pixel wide, and frames wider than a
# TMA box (strips of 257 - k columns, their halos read from the neighbour strip)
@pytest.mark.parametrize("n,h,w,k,cin,cout", [
    (3, 64, 64, 5, 64, 64), (2, 24, 24, 3, 768, 1024), (1, 48, 48, 3, 1024, 512),
    (2, 17, 70, 5, 64, 64), (1, 1, 1, 3, 64, 64), (5, 3, 130, 3, 128, 192)]
    + [(3, 11, 13, k, cin, cout) for cin in (64, 128, 768) for cout in (64, 128, 1024)
       for k in (3, 5)]
    + [(2, 1, 3, 5, 64, 64), (3, 2, 2, 3, 128, 128), (4, 4, 5, 5, 64, 1024), (2, 9, 1, 3, 768, 64),
       (1, 3, 300, 3, 64, 128), (2, 2, 520, 5, 64, 64)])
@pytest.mark.parametrize("relu", [True, False])
def test_conv_int8_kernel_matches_plain_exactly(cuda, n, h, w, k, cin, cout, relu):
    from textocvp_tpu_torch.ops import conv_int8 as ci

    args = [t.to(cuda) for t in _int8_case(n, h, w, k, cin, cout)]
    before = ci.conv_int8_cuda.launches
    out = ci.conv_int8(*args, relu=relu)
    torch.cuda.synchronize()
    assert ci.conv_int8_cuda.launches == before + 1
    ref = ci.conv_int8_plain(*args, relu=relu)
    assert torch.equal(out, ref), (out - ref).abs().max().item()


@pytest.mark.parametrize("bad", ["channels_in", "channels_out", "kernel", "dtype", "device"])
def test_conv_int8_kernel_refuses_what_it_does_not_take(cuda, bad):
    from textocvp_tpu_torch.ops import conv_int8 as ci

    x_q, w_q, a_scale, w_scale, bias = (t.to(cuda) for t in _int8_case(1, 8, 8, 3, 64, 64))
    if bad == "channels_in":
        x_q, w_q = x_q[..., :32].contiguous(), w_q[:, :, :32].contiguous()
    elif bad == "channels_out":
        w_q, w_scale, bias = w_q[..., :40].contiguous(), w_scale[:40], bias[:40]
    elif bad == "kernel":
        w_q = torch.zeros((7, 7, 64, 64), dtype=torch.int8, device=cuda)
    elif bad == "dtype":
        x_q = x_q.float()
    else:
        w_q = w_q.cpu()
    before = ci.conv_int8_cuda.launches
    with pytest.raises((ValueError, TypeError)):
        ci.conv_int8_cuda(x_q, w_q, a_scale, w_scale, bias)
    assert ci.conv_int8_cuda.launches == before


@pytest.mark.parametrize("m,k,n", [(10, 128, 769), (1154, 768, 2304), (17, 3072, 768)])
def test_dense_int8_on_the_card_is_the_cpu_product(cuda, m, k, n):
    from textocvp_tpu_torch.ops.dense_int8 import dense_int8

    g = torch.Generator().manual_seed(m)
    x, weight, bias = torch.randn((m, k), generator=g), torch.randn((n, k), generator=g), \
        torch.randn(n, generator=g)
    a_scale = x.abs().max() / 127
    ref = dense_int8(x, weight, bias, a_scale)
    out = dense_int8(x.to(cuda), weight.to(cuda), bias.to(cuda), a_scale.to(cuda))
    assert torch.equal(out.cpu(), ref)


def test_savi_int8_tail_on_the_card_matches_the_cpu(cuda):
    """The full-width SAVi decoder's int8 tail, on the card and on the CPU,
    from the same activations and scales: the three int8 convs exact (the
    kernel against the plain version, the quantizers' IEEE divisions alike on
    both), the final float32 conv within 1e-4 of the largest output. (Whole
    decodes differ more: the float first conv rounds differently on the two
    devices, and an activation within that of a .5 boundary is quantized a
    quantum apart, a difference the tail then carries on; the quant phase of
    ``chip_smoke.py`` measures its effect on the metrics.)"""
    from textocvp_tpu_torch.core.config import build_exp_params
    from textocvp_tpu_torch.models import setup_model
    from textocvp_tpu_torch.models.quant import calibrate_decode_scales
    from textocvp_tpu_torch.ops import conv_int8 as ci

    model = random_init_(setup_model(build_exp_params("SAVi", "CATER_Easy")),
                         torch.Generator().manual_seed(8)).eval()
    slots = torch.randn((3, 8, 128), generator=torch.Generator().manual_seed(9))
    x = torch.rand((6, 64, 64, 64), generator=torch.Generator().manual_seed(10))
    with torch.no_grad():
        scales = calibrate_decode_scales(model, slots)
        ref = model.image_decoder._tail(x, scales)
        before = ci.conv_int8_cuda.launches, c5.conv5_cuda.launches
        out = model.cuda().image_decoder._tail(x.cuda(), scales.cuda()).cpu()
    assert (ci.conv_int8_cuda.launches, c5.conv5_cuda.launches) == (before[0] + 3, before[1])
    assert (out - ref).abs().max() <= 1e-4 * ref.abs().max()


def test_a_quantized_cater_artifact_on_the_card_answers_like_the_live_service(cuda, tmp_path):
    from textocvp_tpu_torch.core.config import add_predictor_params, build_exp_params
    from textocvp_tpu_torch.core.experiment import Experiment
    from textocvp_tpu_torch.models import setup_model, setup_predictor
    from textocvp_tpu_torch.ops import conv_int8 as ci
    from textocvp_tpu_torch.serve import (
        ExportedPredictionService,
        PredictionService,
        export_service,
    )

    params = build_exp_params("SAVi", "CATER_Easy")
    params["tpu"] = {"decode_quant": "int8"}
    pred_params = add_predictor_params(params, "TextOCVP_T5")
    pred_params["prediction_params"]["num_preds"] = 3
    gen = torch.Generator().manual_seed(6)
    exp, pred = Experiment(tmp_path / "exp"), Experiment(tmp_path / "exp" / "predictors" / "p")
    for e, p, module in ((exp, params, random_init_(setup_model(params), gen)),
                         (pred, pred_params, random_init_(setup_predictor(pred_params), gen))):
        e.save_params(p)
        e.models_dir.mkdir(parents=True, exist_ok=True)
        torch.save(module.state_dict(), e.checkpoint_path("m"))
    service = PredictionService(exp.exp_path, "p", "m", "m", batch_size=2)
    service.warmup()
    artifact = ExportedPredictionService(export_service(service, tmp_path / "art"))
    frames = np.random.default_rng(7).random((2, 1, 64, 64, 3), np.float32)
    captions = ["the cone is rotating", "the snitch is sliding to (2, 2)"]
    state = service.generator.get_state()
    ref = service.predict(frames, captions)
    artifact.generator.set_state(state)
    before = sak.slot_attention_cuda.launches, ci.conv_int8_cuda.launches
    out = artifact.predict(frames, captions)
    assert (sak.slot_attention_cuda.launches, ci.conv_int8_cuda.launches) == (
        before[0] + 1, before[1] + 3)
    np.testing.assert_array_equal(out, ref)


# ------------------------------------------------------------------------- the mesh


def _one_rank_group(monkeypatch, backend=None):
    """A process group of one rank: through the ``TEXTOCVP_*`` environment
    (``parallel/distributed.py``, which picks NCCL for one rank on one GPU),
    or with ``backend`` made directly. The caller leaves it (``destroy``)."""
    import socket

    import torch.distributed as dist

    from textocvp_tpu_torch.parallel import distributed as pdist

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    if backend:
        dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}", world_size=1,
                                rank=0)
        return pdist
    for k, v in {"TEXTOCVP_COORDINATOR": f"127.0.0.1:{port}", "TEXTOCVP_NUM_PROCESSES": "1",
                 "TEXTOCVP_PROCESS_ID": "0"}.items():
        monkeypatch.setenv(k, v)
    assert pdist.maybe_initialize_distributed()
    return pdist


def _helpers_at_world1(pdist, device):
    """The mesh of the group, and its collectives on CUDA tensors: each the
    identity at world size 1, the result on the card."""
    from textocvp_tpu_torch.parallel.mesh import (
        AllReduceSum,
        all_gather_rows,
        all_reduce,
        broadcast_object,
    )

    mesh = pdist.get_runtime_mesh({"mesh_axes": {"data": -1, "model": 1}}, "cuda")
    assert (mesh.world, mesh.data, mesh.model) == (1, 1, 1) and mesh.device.type == "cuda"
    x = torch.randn((5, 7), device=device)
    want = x.clone()
    assert all_reduce(x, mesh.data_group) is x
    assert torch.equal(x, want)
    g = all_gather_rows(x, mesh.data_group)
    assert g.device.type == "cuda" and torch.equal(g, want)
    assert broadcast_object({"a": 1}) == {"a": 1}
    y = x.clone().requires_grad_()
    out = AllReduceSum.apply(y, mesh.data_group)
    (grad,) = torch.autograd.grad(out.sum(), y)
    assert out.device.type == "cuda" and torch.equal(grad, torch.ones_like(y))
    return mesh


def test_nccl_group_of_one_rank_runs_the_helpers_on_the_card(cuda, monkeypatch):
    pdist = _one_rank_group(monkeypatch)
    try:
        assert _helpers_at_world1(pdist, cuda).backend == "nccl"
    finally:
        pdist.destroy()


def test_gloo_helpers_stage_cuda_tensors_through_the_host(cuda, monkeypatch):
    """Under gloo the helpers pass CUDA tensors through host copies; BatchNorm's
    global statistics over a group of one equal its own batch's."""
    from textocvp_tpu_torch.nn.blocks import BatchNorm

    pdist = _one_rank_group(monkeypatch, "gloo")
    try:
        mesh = _helpers_at_world1(pdist, cuda)
        assert mesh.backend == "gloo"
        bn = BatchNorm(8).cuda().train()
        x = torch.randn((4, 8, 6, 6), device=cuda)
        want = bn(x)
        bn.data_group = mesh.data_group
        torch.testing.assert_close(bn(x), want, rtol=1e-5, atol=1e-5)
    finally:
        pdist.destroy()


def test_batchnorm_at_world_size_1_is_unchanged_on_the_card(cuda):
    """Without a data group BatchNorm in ``train()`` is ``F.batch_norm`` and
    flax's running-statistics update, bit for bit."""
    import torch.nn.functional as F

    from textocvp_tpu_torch.nn.blocks import BatchNorm, set_batchnorm_group

    gen = torch.Generator().manual_seed(4)
    bn = BatchNorm(16)
    with torch.no_grad():
        bn.weight.uniform_(0.5, 1.5, generator=gen)
        bn.bias.uniform_(-0.5, 0.5, generator=gen)
    bn = bn.cuda().train()
    set_batchnorm_group(bn, None)
    x = torch.randn((6, 16, 12, 12), generator=gen).cuda()
    out = bn(x)
    want = F.batch_norm(x, None, None, bn.weight, bn.bias, True, 0.0, bn.eps)
    mean = x.mean((0, 2, 3))
    var = (x.square().mean((0, 2, 3)) - mean.square()).clamp_(min=0)
    assert torch.equal(out, want)
    assert torch.equal(bn.running_mean, 0.01 * mean)
    assert torch.equal(bn.running_var, 0.99 * torch.ones_like(var) + 0.01 * var)


# ------------------------------------------- ExtendedDINOSAUR under tensor parallelism


@pytest.mark.parametrize("b", [8, 1])
def test_vit_attention_at_6_heads_a_rank_matches_plain(cuda, b):
    """ViT-B/14's attention at ``model=2``: 6 of its 12 heads a rank, 577
    tokens; the kernel against its plain version, and its refusal of grad."""
    q, k, v = _qkv(b, 6, 577, seed=b)
    before = va.vit_attention_cuda.launches
    out = va.vit_attention(q, k, v, 64 ** -0.5)
    torch.cuda.synchronize()
    assert va.vit_attention_cuda.launches == before + 1
    torch.testing.assert_close(out, va.vit_attention_plain(q, k, v, 64 ** -0.5), rtol=2e-5,
                               atol=2e-5)
    with pytest.raises(RuntimeError, match="no backward"):
        va.vit_attention(q.requires_grad_(), k, v, 64 ** -0.5)
    assert va.vit_attention_cuda.launches == before + 1


@pytest.mark.parametrize("backend", ["nccl", "gloo"])
def test_row_shard_int8_takes_the_whole_weights_scales_on_the_card(cuda, monkeypatch, backend):
    """A row shard's int8 dense (``dense_int8(..., row_group)``, the ViT's
    proj / fc2 and the patch decoder's odd layers under ``model=2``): each
    half of fc2's weight (768, 3072) quantized with the whole weight's row
    maxima gives the whole weight's scales and its int8 columns, and the
    halves' integer products summed and dequantized are the whole layer's
    int8 output, bit for bit; through a group of one rank the collective
    path is the whole layer's too."""
    from textocvp_tpu_torch.ops.conv_int8 import dequantize, quantize_activation, quantize_weight
    from textocvp_tpu_torch.ops.dense_int8 import dense_int8, int8_product

    g = torch.Generator().manual_seed(16)
    m, k, n = 577, 3072, 768
    x, w, bias = (torch.randn(s, generator=g).to(cuda) for s in ((m, k), (n, k), (n,)))
    a_scale = (x.abs().max() / 127).reshape(())
    w_q, w_scale = quantize_weight(w, (1,))
    amax = w.abs().amax(1, keepdim=True)  # the max-reduce over the model group
    x_q = quantize_activation(x, a_scale)
    acc = 0
    for half in (slice(0, k // 2), slice(k // 2, k)):
        q, s = quantize_weight(w[:, half], (1,), amax)
        assert torch.equal(s, w_scale) and torch.equal(q, w_q[:, half])
        acc = acc + int8_product(x_q[:, half].contiguous(), q)
    whole = dense_int8(x, w, bias, a_scale)
    assert torch.equal(dequantize(acc, a_scale, w_scale, bias), whole)
    pdist = _one_rank_group(monkeypatch, backend)
    try:
        group = pdist.get_runtime_mesh(None, "cuda").model_group
        assert torch.equal(dense_int8(x, w, bias, a_scale, group), whole)
    finally:
        pdist.destroy()


def _variant_savi(encoder=None, decoder=None):
    """The stock SAVi (8 slots x 128, 64 px) with another encoder or decoder
    params, random weights."""
    from textocvp_tpu_torch.core.config import build_exp_params
    from textocvp_tpu_torch.models import setup_model

    p = build_exp_params("SAVi", "CATER_Easy")
    mp = p["model"]["model_params"]
    if encoder is not None:
        mp["encoder"] = encoder
    mp["decoder"]["decoder_params"].update(decoder or {})
    return random_init_(setup_model(p), torch.Generator().manual_seed(12))


@pytest.mark.parametrize("variant, train", [("resnet", False), ("bn_up", True)])
def test_savi_variants_on_the_card_match_the_cpu(cuda, variant, train):
    """The ResNet SAVi (``eval()``) and the BatchNorm upsampling decoder's
    (``train()``, 8 -> 64 px) ``decompose`` and decode of two frames on the
    card against the CPU, the same initial slots: slots, masks and frames
    within 1e-4 of their largest value; conv5 launched on the card."""
    model = (_variant_savi(encoder={"encoder_name": "ResNet",
                                    "encoder_params": {"resolution": [8, 8], "num_groups": 32}})
             if variant == "resnet" else
             _variant_savi(decoder={"batch_norm": True, "upsample": 2, "resolution": [8, 8]}))
    gen = torch.Generator().manual_seed(13)
    video = torch.rand((1, 2, 64, 64, 3), generator=gen)
    init = model.slot_initializer(1, gen)
    card = copy.deepcopy(model).cuda()
    outs = {}
    before = c5.conv5_cuda.launches
    with torch.no_grad():
        for dev, m in (("cpu", model), ("cuda", card)):
            m.train(train)
            out = m.decompose(video.to(dev), initial_slots=init.to(dev))
            out.update(m.decoded(out["slot_history"]))
            outs[dev] = {k: out[k].cpu() for k in ("slot_history", "masks", "recons_imgs")}
    assert c5.conv5_cuda.launches == before + 3
    for k, ref in outs["cpu"].items():
        assert outs["cuda"][k].shape == ref.shape
        assert _rel_err(outs["cuda"][k], ref) <= 1e-4, k


def test_group_norm_on_the_card_matches_the_cpu(cuda):
    """flax's GroupNorm (``nn/blocks.py::GroupNorm``) on a ResNet stage's
    activations, behind a ReLU (means large against the spread): output and
    input and weight gradients within 1e-5 of their largest value."""
    from textocvp_tpu_torch.nn.blocks import GroupNorm

    gen = torch.Generator().manual_seed(14)
    norm = random_init_(GroupNorm(32, 128), gen)
    x = torch.relu(torch.randn((4, 128, 16, 16), generator=gen) + 1).requires_grad_()
    g = torch.randn((4, 128, 16, 16), generator=gen)
    card = copy.deepcopy(norm).cuda()
    xc = x.detach().cuda().requires_grad_()
    out = card(xc)
    gx, gw = torch.autograd.grad(out, (xc, card.weight), g.cuda())
    ref = norm(x)
    rx, rw = torch.autograd.grad(ref, (x, norm.weight), g)
    for got, want in ((out, ref), (gx, rx), (gw, rw)):
        assert _rel_err(got.detach().cpu(), want.detach()) <= 1e-5


def test_a_resnet_savi_train_step_on_the_card_reaches_every_parameter(cuda, tmp_path):
    """One 02 step of the ResNet SAVi with a BatchNorm upsampling decoder on
    the card, B=2, T=2: every parameter gets a finite gradient, the decoder
    tail's through conv5 (forward and input-gradient launches)."""
    from textocvp_tpu_torch.core.config import build_exp_params
    from textocvp_tpu_torch.core.experiment import Experiment
    from textocvp_tpu_torch.train.trainer import DecompTrainer

    p = build_exp_params("SAVi", "CATER_Easy")
    mp = p["model"]["model_params"]
    mp["encoder"] = {"encoder_name": "ResNet", "encoder_params": {"resolution": [8, 8]}}
    mp["decoder"]["decoder_params"].update(batch_norm=True, upsample=2, resolution=[8, 8])
    p["training"].update(batch_size=2, lr_warmup=False)
    exp = Experiment(tmp_path / "exp")
    exp.save_params(p)
    tr = DecompTrainer(exp.exp_path)
    tr.setup_model()
    gen = torch.Generator().manual_seed(15)
    video = torch.rand((2, 2, 64, 64, 3), generator=gen).cuda()
    before = c5.conv5_input_grad_cuda.launches
    values = tr.train_step(video, noise=torch.randn((2, 8, 128), generator=gen))
    assert c5.conv5_input_grad_cuda.launches == before + 3
    assert bool(torch.isfinite(values["_total"]))
    for name, param in tr.model.named_parameters():
        assert param.grad is not None and bool(torch.isfinite(param.grad).all()), name


# ------------------------------------------------------------------ bfloat16
#
# The bf16 variants round their float32 result once to bf16; each is held
# against its plain version run in float32 on the same bf16 inputs (the
# float32 weights rounded to bf16 as the kernel rounds them), within one bf16
# step at the largest value, 2**-8 of max |plain|: the rounding moves a value
# by half a bf16 step of its own binade at most, and the float32 sums in
# other orders by far less. (Against the bf16 plain version, which rounds its
# own float32 sum, a value where the two sums straddle a rounding edge
# differs by a whole bf16 step of its binade, up to 2 x 2**-8 of the max.)

BF16_STEP = 2.0 ** -8


# and the wgmma design's edges: frames wider than the halo's room (strips of
# 75 and 40 columns), a tile count the persistent grid does not divide (133
# frames of 9 tiles), padded rows that end inside a warpgroup's half, the
# widest single strip
@pytest.mark.parametrize("n,h,w", [(2, 64, 64), (3, 17, 70), (1, 1, 1), (4, 5, 130), (2, 15, 63),
                                   (1, 33, 129), (70, 16, 16), (1, 9, 300), (133, 64, 64),
                                   (2, 20, 30), (1, 2, 520), (3, 7, 79), (2, 6, 80)])
@pytest.mark.parametrize("relu", [True, False])
def test_conv5_bf16_kernel_matches_plain(cuda, n, h, w, relu):
    x, wt, b = _conv5_case(n, h, w)
    x, wb = x.to(torch.bfloat16), wt.to(torch.bfloat16)
    before = (c5.conv5_cuda.launches, c5.conv5_bf16_cuda.launches)
    out = c5.conv5_cuda(x, wt, b, relu)  # float32 weights, rounded to bf16 in the wrapper
    torch.cuda.synchronize()
    assert (c5.conv5_cuda.launches, c5.conv5_bf16_cuda.launches) == (before[0], before[1] + 1)
    assert out.dtype == torch.bfloat16 and out.shape == x.shape
    ref = c5.conv5_plain(x.float(), wb.float(), b, relu)
    err = (out.float() - ref).abs().max().item()
    assert err <= BF16_STEP * ref.abs().max().item(), err
    # the plain version of the contract: the float32 sum rounded once
    torch.testing.assert_close(c5.conv5_plain(x, wt, b, relu), ref.to(torch.bfloat16),
                               rtol=0, atol=0)


def test_conv5_bf16_kernel_runs_on_hgmma_alone(cuda):
    """The bf16 conv5 kernel's products are warpgroup MMAs: HGMMA in its SASS
    and no warp-level HMMA."""
    from textocvp_tpu_torch.ops import build

    build.load_library("conv5")
    ops = [o for f, o in build.tensor_core_by_function("conv5").items()
           if "conv5_bf16_kernel" in f]
    assert len(ops) == 1, build.ptxas_report("conv5")
    assert ops[0]["HGMMA"] > 0 and ops[0]["HMMA"] == 0, ops[0]


@pytest.mark.parametrize("h,w", [(64, 64), (1, 1), (9, 300), (16, 16), (5, 79), (5, 80), (2, 520)])
def test_conv5_bf16_plan_is_the_one_the_cpu_tiling_test_emulates(cuda, h, w):
    """``csrc/conv5.cu::make_bf16_plan`` against the geometry that
    ``test_torch_port_conv5_bf16_tiling.py`` walks on the CPU."""
    threads = torch.get_num_threads()
    from test_torch_port_conv5_bf16_tiling import plan  # sets two CPU threads

    torch.set_num_threads(threads)
    assert c5.bf16_plan(h, w) == plan(h, w)


# and the wgmma design's edges: key tiles of 64, CTAs of 128 queries (two
# warpgroups of 64 rows), the last key tile masked, rows past n never stored,
# over 15 frame-heads, each a grid row of its own
@pytest.mark.parametrize("b,h,n", [(8, 12, 577), (2, 4, 150), (1, 1, 1), (3, 2, 64), (2, 3, 63),
                                   (2, 3, 65), (1, 2, 129)]
                         + [(3, 5, n) for n in (1, 63, 64, 65, 127, 128, 129, 577)])
def test_vit_attention_bf16_kernel_matches_plain(cuda, b, h, n):
    q, k, v = (t.to(torch.bfloat16) for t in _qkv(b, h, n))
    before = (va.vit_attention_cuda.launches, va.vit_attention_bf16_cuda.launches)
    out = va.vit_attention_cuda(q, k, v, 64 ** -0.5)
    torch.cuda.synchronize()
    assert (va.vit_attention_cuda.launches, va.vit_attention_bf16_cuda.launches) == (
        before[0], before[1] + 1)
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    assert bool(torch.isfinite(out).all())
    ref = va.vit_attention_plain(q.float(), k.float(), v.float(), 64 ** -0.5)
    err = (out.float() - ref).abs().max().item()
    assert err <= BF16_STEP * ref.abs().max().item(), err


def test_bf16_wrappers_refuse_grad_and_cpu_tensors(cuda):
    x, wt, b = _conv5_case(2, 8, 8)
    x = x.to(torch.bfloat16)
    q, k, v = (t.to(torch.bfloat16) for t in _qkv(1, 2, 10))
    before = (c5.conv5_bf16_cuda.launches, va.vit_attention_bf16_cuda.launches)
    # the launcher alone, outside conv5()'s Function
    with pytest.raises(RuntimeError, match="no backward"):
        c5.conv5_bf16_cuda(x, wt.requires_grad_(), b)
    with pytest.raises(RuntimeError, match="no backward"):
        c5.conv5_bf16_cuda(x.requires_grad_(), wt.detach(), b)
    with pytest.raises(RuntimeError, match="no backward"):
        va.vit_attention_cuda(q.requires_grad_(), k, v, 0.125)
    with pytest.raises(ValueError, match="CUDA"):
        c5.conv5_bf16_cuda(x.detach().cpu(), wt.detach().cpu(), b.cpu())
    with pytest.raises(ValueError, match="CUDA"):
        va.vit_attention_bf16_cuda(q.detach().cpu(), k.cpu(), v.cpu(), 0.125)
    with pytest.raises(TypeError, match="float32"):
        c5.conv5_bf16_cuda(x.detach(), wt.detach(), b.to(torch.bfloat16))  # the bias is float32
    assert (c5.conv5_bf16_cuda.launches, va.vit_attention_bf16_cuda.launches) == before


@pytest.mark.parametrize("n,h,w,train_w", [(2, 64, 64, True), (3, 17, 70, True),
                                           (4, 16, 16, False)])
def test_conv5_bf16_backward_matches_its_plain_version(cuda, n, h, w, train_w):
    """conv5() on bf16 with grad: the Function's forward and input gradient
    launch the bf16 kernel (the latter counted apart too), the weight
    gradient is 25 bf16 GEMMs; each within its bf16 steps of the plain
    version in float32 on the same bf16 operands and mask (input 1, weight
    2), the bias gradient a float32 sum. (The CPU's Function, the plain
    version of this backward, is held in ``test_torch_port_bf16_train_ops.py``;
    against the card its ReLU mask differs where an output lies within
    rounding of 0.)"""
    x, wt, b = _conv5_case(n, h, w, seed=5)
    x = x.to(torch.bfloat16).requires_grad_()
    wt.requires_grad_(train_w)
    b.requires_grad_(train_w)
    g = torch.randn((n, 64, h, w), device="cuda").to(torch.bfloat16).permute(0, 2, 3, 1)
    leaves = (x, wt, b) if train_w else (x,)
    before = (c5.conv5_bf16_cuda.launches, c5.conv5_bf16_input_grad_cuda.launches,
              c5.conv5_weight_grad.calls)
    y = c5.conv5(x, wt, b)
    got = torch.autograd.grad(y, leaves, g)
    after = (c5.conv5_bf16_cuda.launches, c5.conv5_bf16_input_grad_cuda.launches,
             c5.conv5_weight_grad.calls)
    assert tuple(a - z for a, z in zip(after, before)) == (2, 1, int(train_w))
    assert got[0].dtype == torch.bfloat16
    gm = torch.where(y > 0, g, 0).float()
    w16 = wt.detach().to(torch.bfloat16).float()
    dx = c5.conv5_plain(gm, w16.flip(0, 1).transpose(2, 3), torch.zeros_like(b), relu=False)
    assert (got[0].float() - dx).abs().max() <= BF16_STEP * dx.abs().max()
    if train_w:
        dw = c5.conv5_weight_grad(x.detach().float(), gm)
        assert got[1].dtype == torch.float32
        assert (got[1] - dw).abs().max() <= 2 * BF16_STEP * dw.abs().max()
        torch.testing.assert_close(got[2], gm.sum((0, 1, 2)), rtol=1e-5, atol=1e-5)


def test_float32_calls_still_launch_the_float32_variants(cuda):
    x, wt, b = _conv5_case(2, 8, 8)
    q, k, v = _qkv(1, 2, 10)
    before = {f: f.launches for f in (c5.conv5_cuda, c5.conv5_bf16_cuda, va.vit_attention_cuda,
                                      va.vit_attention_bf16_cuda)}
    with torch.no_grad():
        assert c5.conv5(x, wt, b).dtype == va.vit_attention(q, k, v, 0.125).dtype == torch.float32
    torch.cuda.synchronize()
    assert {f: f.launches - n for f, n in before.items()} == {
        c5.conv5_cuda: 1, c5.conv5_bf16_cuda: 0, va.vit_attention_cuda: 1,
        va.vit_attention_bf16_cuda: 0}
