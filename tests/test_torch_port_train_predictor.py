"""The 04 predictor training of the port on the CPU: the TextOCVP_T5 step
through the frozen SAVi against the JAX package, the checkpoint layout that
the 02 and 04 trainers write read back by the 04 trainer, the 05 evaluator
and the service, and the 04 CLI end to end on a tiny experiment.

* Sizes: the tiny SAVi of ``test_torch_port_train_savi.py`` (16 px, 4 slots
  of 32) and a tiny TextOCVP_T5 (token 32, 2 layers, 2 heads, MLP 64, fusion
  2 x 16 and MLP 64; T5 of width 32, 2 layers); c=1, p=3, B=2.
* Same weights (the JAX init plus noise, carried by ``from_jax_params``), the
  same video and captions, and the JAX slot noise handed to the port.
  Float32 on both sides, sums in other orders. Loss rtol 1e-5; each
  trainable gradient leaf within 1e-4 of the leaf's largest |g|, that scale
  floored at a thousandth of the largest |g| of any leaf (a leaf whose
  gradient is 0 in exact arithmetic, such as an attention's key bias, is
  rounding noise on both sides). The JAX T5 leaves' gradient is exactly 0
  (``stop_gradient``); the port's T5 parameters get none.
* Parameters after one and two Adam updates within 1e-7 of optax's, at lr
  1e-5. Adam moves an element by ``lr * m / (sqrt(v) + eps)``; where the
  clipped gradient is within its float32 noise of ``eps`` (1e-8), that
  fraction of lr is the rounding's to choose: at lr 1e-3 such elements
  came out up to 3.2e-6 apart (0.3 % of lr), at 1e-5 that is 3.2e-8.
* ``teacher_force`` x ``input_buffer_size``: a buffer of 2 slides over the
  3 predictions, one of 10 keeps masked padding.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_port_train_savi import _jax_noise, tiny_savi_params, write_cater

from textocvp_tpu.core.config import add_predictor_params as jax_add_predictor_params
from textocvp_tpu.core.config import build_exp_params as jax_build_exp_params
from textocvp_tpu.models import setup_model as jax_setup_model
from textocvp_tpu.models import setup_predictor as jax_setup_predictor
from textocvp_tpu.train.losses import build_loss_fn as jax_build_loss_fn
from textocvp_tpu.train.schedulers import build_optimizer as jax_build_optimizer
from textocvp_tpu_torch.cli import evaluate_predictor, train_decomp, train_predictor
from textocvp_tpu_torch.convert import from_jax_params
from textocvp_tpu_torch.core.config import add_predictor_params, build_exp_params
from textocvp_tpu_torch.core.experiment import Experiment
from textocvp_tpu_torch.models import setup_predictor
from textocvp_tpu_torch.serve import PredictionService
from textocvp_tpu_torch.train.checkpoints import load_params, save_checkpoint
from textocvp_tpu_torch.train.evaluator import PredictorEvaluator
from textocvp_tpu_torch.train.predictor_trainer import PredictorTrainer

B, C, P, RES, S, D, TOKENS = 2, 1, 3, 16, 4, 32, 7
T5_TINY = dict(vocab_size=32128, d_model=32, d_kv=16, num_heads=2, d_ff=64, num_layers=2)
TRAINING = {"lr": 1e-5, "scheduler": "cosine_annealing", "scheduler_steps": 100,
            "lr_warmup": False, "warmup_steps": 0, "gradient_clipping": True,
            "clipping_max_value": 0.05}


def tiny_pred_params(build, add, buffer=10, teacher_force=False):
    p = add(tiny_savi_params(build), "TextOCVP_T5")
    pr = p["predictor"]["predictor_params"]
    pr["predictor_params"].update(token_dim=32, n_heads=2, hidden_dim=64, num_layers=2)
    pr["fusion_params"].update(num_heads=2, head_dim=16, mlp_size=64)
    pr["text_encoder_params"] = dict(T5_TINY)
    p["prediction_params"].update(num_context=C, num_preds=P, input_buffer_size=buffer,
                                  teacher_force=teacher_force)
    return p


def _perturb(tree, rng, scale=0.05):
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x) + scale * rng.standard_normal(np.shape(x)).astype(np.float32),
        tree)


@pytest.fixture(scope="module")
def jax_decomp():
    """JAX weights of the tiny SAVi, a video, captions and two draws of slot
    noise."""
    rng = np.random.default_rng(5)
    video = rng.uniform(0, 1, (B, C + P, RES, RES, 3)).astype(np.float32)
    tokens = rng.integers(2, 32000, (B, TOKENS)).astype(np.int32)
    masks = np.ones((B, TOKENS), np.int32)
    masks[1, 4:] = 0  # a padded caption
    tokens[1, 4:] = 0
    jdecomp = jax_setup_model(tiny_savi_params(jax_build_exp_params))
    mvars = jax.jit(lambda x: jdecomp.init({"params": jax.random.PRNGKey(0),
                                            "slots": jax.random.PRNGKey(1)}, x, decode=True))(
        jnp.asarray(video))
    mparams = _perturb(jax.device_get(mvars["params"]), rng)
    keys = [jax.random.PRNGKey(7), jax.random.PRNGKey(8)]
    noise = [_jax_noise(jdecomp, {"params": mparams}, B, k) for k in keys]
    return {"jdecomp": jdecomp, "mparams": mparams, "video": video, "tokens": tokens,
            "masks": masks, "keys": keys, "noise": noise}


@pytest.fixture(scope="module", params=[2, 10], ids=lambda b: f"buffer{b}")
def jax_case(request, jax_decomp):
    """The tiny SAVi's case with JAX weights of the tiny predictor for one
    buffer size."""
    buffer = request.param
    rng = np.random.default_rng(buffer)
    tokens, masks = jax_decomp["tokens"], jax_decomp["masks"]
    jp = tiny_pred_params(jax_build_exp_params, jax_add_predictor_params, buffer)
    jpred = jax_setup_predictor(jp)
    pvars = jax.jit(lambda s, t, m: jpred.init({"params": jax.random.PRNGKey(3)}, s,
                                               caption_tokens=t, attn_masks=m))(
        jnp.zeros((1, C, S, D)), jnp.asarray(tokens[:1]), jnp.asarray(masks[:1]))
    pparams = _perturb(jax.device_get(pvars["params"]), rng)
    return {**jax_decomp, "buffer": buffer, "jp": jp, "jpred": jpred, "pparams": pparams}


def jax_loss_fn(case, tf):
    """``forward_loss`` of the JAX ``PredictorTrainer`` as a function of the
    predictor's params and the slot key, copied line for line from
    ``textocvp_tpu/train/predictor_trainer.py:219-251`` (no decode chunks)."""
    jdecomp, predictor = case["jdecomp"], case["jpred"]
    loss_fn = jax_build_loss_fn(case["jp"]["predictor_loss"])
    c, p = C, P
    num_slots, slot_dim = S, D
    # the JAX _text_kwargs: the tokenizer's arrays that are not None
    text_kwargs = {key: jnp.asarray(case[name]) for key, name in (
        ("caption_tokens", "tokens"), ("caption_lengths", "lengths"), ("attn_masks", "masks"))
        if case.get(name) is not None}

    def decomp_vars():
        return {"params": case["mparams"]}

    def forward_loss(params, rng):
        videos = jnp.asarray(case["video"])[:, : c + p]
        b = videos.shape[0]
        out = jdecomp.apply(decomp_vars(), videos, decode=False, rngs={"slots": rng})
        slot_history = jax.lax.stop_gradient(out["slot_history"])
        pred_slots = predictor.apply({"params": params}, slot_history, teacher_force=tf,
                                     **text_kwargs)
        dec = jdecomp.apply(decomp_vars(), pred_slots.reshape(b * p, num_slots, slot_dim),
                            method="decode")
        pred_imgs = dec["recons_imgs"]
        target_imgs = videos[:, c: c + p]
        pred_imgs = pred_imgs.reshape(target_imgs.shape)
        tensors = {"pred_slots": pred_slots, "target_slots": slot_history[:, c: c + p],
                   "pred_imgs": pred_imgs, "target_imgs": target_imgs}
        total, values = loss_fn(**tensors)
        return total, values

    return forward_loss


@pytest.fixture(scope="module")
def jax_steps():
    """By (buffer, teacher_force): the jitted ``value_and_grad`` of
    :func:`jax_loss_fn` and its (loss, gradients) at the initial weights and
    the first slot key, shared by the tests."""
    return {}


def jax_step(case, tf, cache, params=None, key=0):
    """(loss, gradients as numpy) of the JAX step."""
    name = (case["buffer"], tf)
    if name not in cache:
        fn = jax.jit(jax.value_and_grad(jax_loss_fn(case, tf), has_aux=True))
        (loss, _), grads = fn(case["pparams"], case["keys"][0])
        cache[name] = fn, (float(loss), jax.device_get(grads))
    fn, first = cache[name]
    if params is None and key == 0:
        return first
    (loss, _), grads = fn(case["pparams"] if params is None else params, case["keys"][key])
    return float(loss), jax.device_get(grads)


def write_pred_experiment(root, case, tf, **training):
    """A parent experiment with the JAX SAVi weights as ``decomp.pt`` (a bare
    state dict) and its predictor experiment with the JAX predictor weights
    as ``init.pt`` (a training checkpoint)."""
    params = tiny_pred_params(build_exp_params, add_predictor_params, case["buffer"], tf)
    params["training"].update({**TRAINING, "batch_size": B, **training})
    parent = Experiment(root / "exp")
    parent.save_params(tiny_savi_params(build_exp_params))
    pred = Experiment(root / "exp" / "predictors" / "tiny")
    pred.save_params(params)
    parent.models_dir.mkdir(parents=True)
    torch.save(from_jax_params("savi", case["mparams"]), parent.checkpoint_path("decomp"))
    save_checkpoint(pred.checkpoint_path("init"),
                    {"params": from_jax_params("predictor", case["pparams"])})
    return pred.exp_path


def port_trainer(root, case, tf, **training):
    tr = PredictorTrainer(write_pred_experiment(root, case, tf, **training), "decomp",
                          checkpoint="init", device="cpu")
    tr.setup_model()
    return tr


def port_batch(case, i=0):
    text = {"caption_tokens": torch.tensor(case["tokens"]),
            "attn_masks": torch.tensor(case["masks"])}
    return torch.tensor(case["video"]), torch.tensor(case["noise"][i]), text


def _assert_grads_match(model, jax_grads):
    want = from_jax_params("predictor", jax_grads)
    named = dict(model.named_parameters())
    assert set(want) == set(named)
    frozen = {n for n in named if n.startswith("predictor.text_encoder.")}
    assert frozen and frozen == {n for n, p in named.items() if not p.requires_grad}
    for name in frozen:  # stop_gradient on the JAX side, no gradient on ours
        assert not want[name].any(), name
        assert named[name].grad is None, name
    floor = 1e-3 * max(g.abs().max().item() for g in want.values())
    for name in set(named) - frozen:
        g = want[name]
        assert named[name].grad is not None, name
        err = (named[name].grad - g).abs().max().item()
        assert err <= 1e-4 * max(g.abs().max().item(), floor), (name, err, g.abs().max().item())


@pytest.mark.parametrize("tf", [False, True], ids=["free", "forced"])
def test_loss_and_every_gradient_match_jax(jax_case, tf, jax_steps, tmp_path):
    loss, grads = jax_step(jax_case, tf, jax_steps)
    tr = port_trainer(tmp_path, jax_case, tf)
    video, noise, text = port_batch(jax_case)
    total, values = tr.forward_loss(video, noise, **text)
    np.testing.assert_allclose(total.item(), loss, rtol=1e-5)
    assert set(values) == {"pred_img_mse", "pred_slot_mse", "_total"}
    total.backward()
    _assert_grads_match(tr.model, grads)


@pytest.mark.parametrize("jax_case", [2], indirect=True, ids=["buffer2"])
def test_two_updates_match_optax_and_leave_the_frozen_weights(jax_case, jax_steps, tmp_path):
    tx, _ = jax_build_optimizer(TRAINING)

    @jax.jit
    def update(grads, opt_state, params):
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state

    params = jax_case["pparams"]
    opt_state = jax.jit(tx.init)(params)
    tr = port_trainer(tmp_path, jax_case, True)
    frozen = {k: v.clone() for k, v in tr.decomp_model.state_dict().items()}
    frozen.update({k: v.clone() for k, v in tr.model.state_dict().items() if "text_encoder" in k})
    for i in range(2):
        loss, grads = jax_step(jax_case, True, jax_steps, None if i == 0 else params, key=i)
        params, opt_state = update(grads, opt_state, params)
        video, noise, text = port_batch(jax_case, i)
        values = tr.train_step(video, noise, **text)
        np.testing.assert_allclose(float(values["_total"]), float(loss), rtol=1e-5)
        want = from_jax_params("predictor", jax.device_get(params))
        for name, p in tr.model.state_dict().items():
            torch.testing.assert_close(p, want[name], rtol=0, atol=1e-7, msg=name)
    assert tr.optimizer.count == 2
    state = {**tr.decomp_model.state_dict(), **tr.model.state_dict()}
    for name, before in frozen.items():
        assert torch.equal(state[name], before), name


@pytest.mark.parametrize("size", ["tiny", "full_width"])
def test_trainable_parameters_are_the_jax_leaves_minus_the_t5(size):
    if size == "tiny":
        jp = tiny_pred_params(jax_build_exp_params, jax_add_predictor_params)
        tp = tiny_pred_params(build_exp_params, add_predictor_params)
    else:
        jp = jax_add_predictor_params(jax_build_exp_params("SAVi", "CATER_Easy"), "TextOCVP_T5")
        tp = add_predictor_params(build_exp_params("SAVi", "CATER_Easy"), "TextOCVP_T5")
    mp = jp["model"]["model_params"]
    shapes = jax.eval_shape(lambda: jax_setup_predictor(jp).init(
        {"params": jax.random.PRNGKey(3)}, jnp.zeros((1, 1, mp["num_slots"], mp["slot_dim"])),
        caption_tokens=jnp.ones((1, 5), jnp.int32), attn_masks=jnp.ones((1, 5), jnp.int32)))
    ref = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(shapes["params"]["predictor"])[0]:
        top = path[0].key
        if top != "text_encoder":
            ref[top] = ref.get(top, 0) + int(np.prod(leaf.shape))
    model = setup_predictor(tp)
    ours = {}
    for name, p in model.predictor.named_parameters():
        parts = name.split(".")
        # flax names the i-th block "block_<i>", the port's ModuleList "blocks.<i>"
        top = f"block_{parts[1]}" if parts[0] == "blocks" else parts[0]
        assert p.requires_grad == (top != "text_encoder"), name
        if p.requires_grad:
            ours[top] = ours.get(top, 0) + p.numel()
    assert ours == ref


@pytest.mark.parametrize("jax_case", [2], indirect=True, ids=["buffer2"])
def test_teacher_forcing_in_the_wrapper_matches_jax(jax_case):
    """The wrapper alone: forced and free rollouts against the JAX wrapper's
    pred_slots; the constructor's ``teacher_force`` is the default of a call,
    and a call overrides it."""
    rng = np.random.default_rng(4)
    hist = rng.standard_normal((B, C + P, S, D)).astype(np.float32)
    tok, mask = jnp.asarray(jax_case["tokens"]), jnp.asarray(jax_case["masks"])
    tp = tiny_pred_params(build_exp_params, add_predictor_params, jax_case["buffer"], True)
    wrapper = setup_predictor(tp).eval()
    wrapper.load_state_dict(from_jax_params("predictor", jax_case["pparams"]))
    assert wrapper.teacher_force
    args = (torch.from_numpy(hist), torch.from_numpy(jax_case["tokens"]),
            torch.from_numpy(jax_case["masks"]))
    outs = {}
    with torch.no_grad():
        for tf in (True, False):
            ref = jax_case["jpred"].apply({"params": jax_case["pparams"]}, jnp.asarray(hist),
                                          teacher_force=tf, caption_tokens=tok, attn_masks=mask)
            outs[tf] = wrapper(*args, teacher_force=tf)
            np.testing.assert_allclose(outs[tf].numpy(), np.asarray(ref), rtol=1e-4, atol=1e-5)
        torch.testing.assert_close(wrapper(*args), outs[True], rtol=0, atol=0)
        # the free rollout reads only the context frames
        torch.testing.assert_close(wrapper(args[0][:, :C], *args[1:], teacher_force=False),
                                   outs[False], rtol=0, atol=0)
        with pytest.raises(ValueError, match="teacher forcing needs 4 frames"):
            wrapper(args[0][:, :C], *args[1:])
    assert not torch.equal(outs[True][:, 1:], outs[False][:, 1:])
    torch.testing.assert_close(outs[True][:, 0], outs[False][:, 0], rtol=0, atol=0)


def test_accumulated_gradient_equals_the_flat_one(jax_case, tmp_path):
    grads = []
    for accum in (1, 2):
        tr = port_trainer(tmp_path / f"a{accum}", jax_case, False, accum_steps=accum)
        video, noise, text = port_batch(jax_case)
        assert np.isfinite(float(tr.backward(video, noise, **text)["_total"]))
        grads.append([p.grad.clone() for p in tr.model.parameters() if p.requires_grad])
    # the same sums split in two: each leaf within 1e-5 of its largest |g|,
    # floored at a thousandth of the largest |g| of any leaf, as above
    floor = 1e-3 * max(g.abs().max().item() for g in grads[0])
    for a, b in zip(*grads):
        assert (a - b).abs().max().item() <= 1e-5 * max(b.abs().max().item(), floor)


# ------------------------------------------------- the CLIs end to end, CPU

def _decomp_experiment(root):
    """The tiny SAVi experiment over a CATER .npy fixture (10-frame videos),
    trained one epoch by the port's 02 CLI: models/checkpoint_epoch_final.pt
    in the training layout."""
    data_root = write_cater(root / "CATER")
    p = tiny_savi_params(build_exp_params)
    p["dataset"].update(root=str(data_root), num_frames=3)
    p["training"].update({"num_epochs": 1, "batch_size": B, "save_frequency": 1,
                          "log_frequency": 1, "lr": 1e-3, "warmup_steps": 2})
    exp = Experiment(root / "exp")
    exp.save_params(p)
    train_decomp.main(["-d", str(exp.exp_path), "--device", "cpu"])
    return exp


def _predictor_experiment(parent, name="tiny", **training):
    p = tiny_pred_params(build_exp_params, add_predictor_params, teacher_force=True)
    p["dataset"] = dict(parent.params["dataset"])
    p["training"].update({"num_epochs": 1, "batch_size": B, "save_frequency": 1,
                          "log_frequency": 1, "lr": 1e-3, "warmup_steps": 2, **training})
    pred = Experiment(parent.exp_path / "predictors" / name)
    pred.save_params(p)
    return pred


@pytest.fixture(scope="module")
def decomp_exp(tmp_path_factory):
    return _decomp_experiment(tmp_path_factory.mktemp("pred_cli"))


def _run_04(exp, name, capsys, *extra):
    trainer = train_predictor.main(["-d", str(exp.exp_path), "--name_pred_exp", name,
                                    "--decomp_ckpt", "checkpoint_epoch_final", "--device",
                                    "cpu", *extra])
    return trainer, capsys.readouterr().out


def test_the_02_checkpoint_layout_loads_everywhere_and_a_stray_file_raises(decomp_exp):
    path = decomp_exp.checkpoint_path("checkpoint_epoch_final")
    state = torch.load(path, weights_only=True)
    assert set(state) == {"params", "opt_state", "epoch", "step"}
    assert load_params(path) is not None and set(load_params(path)) == set(state["params"])
    pred = _predictor_experiment(decomp_exp, "layout")
    pred.models_dir.mkdir(parents=True)
    tr = PredictorTrainer(pred.exp_path, "checkpoint_epoch_final", device="cpu")
    tr.setup_model()
    for name, p in tr.decomp_model.state_dict().items():
        torch.testing.assert_close(p, state["params"][name], rtol=0, atol=0, msg=name)
    # a predictor checkpoint in the training layout too
    save_checkpoint(pred.checkpoint_path("trained"), {
        "params": tr.model.state_dict(), "opt_state": tr.optimizer.state_dict(), "epoch": 1,
        "step": 1})
    ev = PredictorEvaluator(decomp_exp.exp_path, "layout", "checkpoint_epoch_final", "trained",
                            device="cpu")
    ev.load_models()
    svc = PredictionService(decomp_exp.exp_path, "layout", "checkpoint_epoch_final", "trained",
                            device="cpu")
    for module in (ev.model, svc.model):
        for name, p in module.state_dict().items():
            torch.testing.assert_close(p, state["params"][name], rtol=0, atol=0, msg=name)
    for bad in ({"opt_state": {}, "epoch": 0}, [1, 2], {"params": {"w": 3}}):
        torch.save(bad, pred.checkpoint_path("bad"))
        with pytest.raises(ValueError, match="bad.pt holds neither"):
            load_params(pred.checkpoint_path("bad"))
    decomp_exp.checkpoint_path("bad").write_bytes(b"not a torch file")
    with pytest.raises(ValueError, match="bad.pt is not a torch file"):
        PredictorEvaluator(decomp_exp.exp_path, "layout", "bad", "trained",
                           device="cpu").load_models()


def test_cli_trains_resumes_where_it_stopped_and_05_evaluates_its_checkpoint(decomp_exp,
                                                                            capsys):
    pred = _predictor_experiment(decomp_exp)
    first, out = _run_04(decomp_exp, "tiny", capsys)
    assert "Starting predictor training loop" in out and "Epoch 1/1: train=" in out
    losses = [float(line.split("loss=")[1]) for line in out.splitlines() if "loss=" in line]
    assert len(losses) == 4 and np.isfinite(losses).all()  # 7 videos in batches of 2
    assert {p.name for p in pred.models_dir.iterdir()} == {
        "checkpoint_last_saved.pt", "checkpoint_epoch_1.pt", "checkpoint_epoch_final.pt"}
    # 2 valid batches (3 videos) and 4 train batches, one noise draw each
    assert first.global_step == 6 and first.optimizer.count == 4
    assert first.train_set.num_frames == C + P and first.train_set.random_start

    p = pred.params
    p["training"]["num_epochs"] = 2
    pred.save_params(p)
    resumed, out = _run_04(decomp_exp, "tiny", capsys, "--checkpoint", "checkpoint_last_saved",
                           "--resume_training")
    assert "Resuming training from epoch 1" in out
    assert resumed.start_epoch == 1 and resumed.global_step == 12
    assert resumed.optimizer.count == 8

    straight_pred = _predictor_experiment(decomp_exp, "straight", num_epochs=2)
    straight, _ = _run_04(decomp_exp, "straight", capsys)
    assert straight_pred.checkpoint_path("checkpoint_epoch_2").is_file()
    for (name, a), b in zip(resumed.model.state_dict().items(),
                            straight.model.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=name)

    # the 05 CLI on the predictor checkpoint the 04 CLI wrote (the experiment
    # trains with teacher forcing; the evaluation rolls out freely)
    evaluate_predictor.main(["-d", str(decomp_exp.exp_path), "--name_pred_exp", "tiny",
                             "--decomp_ckpt", "checkpoint_epoch_final", "--pred_ckpt",
                             "checkpoint_epoch_final", "--num_seed", "1", "--num_preds",
                             str(P), "--batch_size", "2", "--device", "cpu"])
    res = pred.exp_path / "results" / f"eval_pred_checkpoint_epoch_final_NumSeed=1_NumPreds={P}"
    results = json.load(open(res / "results.json"))
    for m in ("psnr", "ssim", "lpips"):
        assert len(results[m]["framewise"]) == P
        assert np.isfinite(results[m]["framewise"] + [results[m]["mean"]]).all(), m


def test_emergency_checkpoint_on_an_exception(decomp_exp, monkeypatch):
    pred = _predictor_experiment(decomp_exp, "emergency")
    tr = PredictorTrainer(pred.exp_path, "checkpoint_epoch_final", device="cpu")
    tr.load_data()
    tr.setup_model()
    calls = []
    step = PredictorTrainer.train_step

    def failing(self, videos, noise=None, **text):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("boom")
        return step(self, videos, noise, **text)

    monkeypatch.setattr(PredictorTrainer, "train_step", failing)
    with pytest.raises(RuntimeError, match="boom"):
        tr.training_loop()
    assert {p.name for p in pred.models_dir.iterdir()} == {"emergency_checkpoint_epoch_0.pt"}
    state = torch.load(pred.checkpoint_path("emergency_checkpoint_epoch_0"), weights_only=True)
    assert state["epoch"] == 0 and state["opt_state"]["count"] == 1


def test_cli_defaults_to_the_card_and_refuses_cuda_without_one(decomp_exp, monkeypatch):
    _predictor_experiment(decomp_exp, "card")
    argv = ["-d", str(decomp_exp.exp_path), "--name_pred_exp", "card", "--decomp_ckpt",
            "checkpoint_epoch_final"]
    assert train_predictor.train_predictor_args(argv).device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="PredictorTrainer: no CUDA device"):
        train_predictor.main(argv)


def test_trainer_refuses_what_is_not_ported(decomp_exp):
    with pytest.raises(ValueError, match="not a nested predictor experiment"):
        PredictorTrainer(decomp_exp.exp_path, "checkpoint_epoch_final", device="cpu")
    pred = _predictor_experiment(decomp_exp, "ocvp")
    p = pred.params
    p["predictor"]["predictor_name"] = "SlotFormer"  # a predictor neither package has
    pred.save_params(p)
    with pytest.raises(NameError, match="is not ported; the port has"):
        PredictorTrainer(pred.exp_path, "checkpoint_epoch_final", device="cpu")
