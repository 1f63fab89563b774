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
coalesced by the dynamic batcher against a direct predict. Marked ``gpu``;
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


@pytest.mark.parametrize("stem", ["conv5", "vit_attention"])
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
