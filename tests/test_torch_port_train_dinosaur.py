"""ExtendedDINOSAUR training in the port on the CPU (the CLIPort chain): the
BatchNorm of the CNN head in training mode against flax, the 02 step against
the JAX ``DecompTrainer``'s, the freeze of the ViT, the validation epoch's
running statistics, the 04 step through the frozen model against the JAX
``PredictorTrainer``'s, and the 02 -> 04 -> 05 CLIs end to end.

* Sizes: img 42, patch 14 (a 3 x 3 grid), 2 ViT-S blocks, 3 slots of 16,
  ``LearnedRandom`` slots, the MLP patch decoder (hidden 32, 2 layers) and a
  4-block CNN head growing 3 -> 48 before the bilinear resize to 42, as
  24 -> 384 -> 336 at full width; B=2, T=3. The predictor is the tiny
  TextOCVP_T5 of ``test_torch_port_cliport.py``, c=1, p=3.
* Same weights (the JAX init plus noise; BatchNorm statistics off 0 and 1)
  carried by ``from_jax_params("dinosaur", ..., batch_stats=...)``, the same
  video, and the JAX slot noise handed to the port: under accumulation the
  JAX step draws each microbatch's noise from its own key, and the port
  takes them concatenated. The JAX step is a line-for-line copy of
  ``textocvp_tpu/train/trainer.py:253-330`` (no remat, no decode chunks).
* Float32 on both sides, sums in other orders. Loss rtol 1e-5; each
  trainable gradient leaf within 1e-4 of its largest |g|, that scale floored
  at a thousandth of the largest |g| of any leaf (a leaf whose gradient is 0
  in exact arithmetic is rounding noise on both sides); BatchNorm outputs
  and running statistics within 1e-5 (rtol and atol). The ViT stays bit for
  bit.
* Adam: the port's, applied to the JAX gradients, gives optax's parameters
  within 1e-7 after one and two updates at lr 1e-5. On the port's own
  gradients, Adam's division by |g| + eps turns the rounding of an element
  whose clipped gradient is of the order of eps (1e-8) into a move of up to
  lr either way: there every element is held within 2 lr, and at most
  0.1 % of them more than lr / 100 apart.
* The CNN head's conv biases sit before a BatchNorm in training mode,
  whose batch mean takes away any shift common to a channel: their
  gradient is 0 in exact arithmetic, and the BatchNorm backward's
  cancellation leaves rounding noise on each side. Those leaves are held
  to that: |g| within 1e-5 of the largest |g| on both sides.
"""

import torch_cpu_threads  # noqa: F401  (two torch threads a worker)
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_port_cliport import _perturb, _perturb_stats, tiny_cliport_params, write_cliport
from test_torch_port_train_savi import _jax_noise

from textocvp_tpu.core.config import add_predictor_params as jax_add_predictor_params
from textocvp_tpu.core.config import build_exp_params as jax_build_exp_params
from textocvp_tpu.models import setup_model as jax_setup_model
from textocvp_tpu.models import setup_predictor as jax_setup_predictor
from textocvp_tpu.nn.blocks import ConvBlock as JaxConvBlock
from textocvp_tpu.train.losses import build_loss_fn as jax_build_loss_fn
from textocvp_tpu.train.schedulers import build_optimizer as jax_build_optimizer
from textocvp_tpu.train.trainer import freeze_labels
from textocvp_tpu_torch.cli import evaluate_predictor, train_decomp, train_predictor
from textocvp_tpu_torch.convert import convert_batch_stats, convert_tree, from_jax_params
from textocvp_tpu_torch.core.config import add_predictor_params, build_exp_params
from textocvp_tpu_torch.core.experiment import Experiment
from textocvp_tpu_torch.models import setup_model
from textocvp_tpu_torch.nn.blocks import ConvBlock
from textocvp_tpu_torch.train.checkpoints import save_checkpoint
from textocvp_tpu_torch.train.predictor_trainer import PredictorTrainer
from textocvp_tpu_torch.train.trainer import DecompTrainer

B, T, IMG, S, D, P = 2, 3, 42, 3, 16, 3
TRAINING = {"lr": 1e-5, "scheduler": "cosine_annealing", "scheduler_steps": 100,
            "lr_warmup": False, "warmup_steps": 0, "gradient_clipping": True,
            "clipping_max_value": 0.05}


def tiny_params(build, add, data_root="unused"):
    """The tiny CLIPort experiment with ``LearnedRandom`` slots."""
    p, pp = tiny_cliport_params(build, add, data_root)
    for q in (p, pp):
        q["model"]["model_params"]["initializer"] = "LearnedRandom"
    return p, pp


def _bn_buffers(module):
    return {k: v.clone() for k, v in module.state_dict().items() if "running" in k}


def _assert_buffers_match(module, batch_stats):
    want = convert_batch_stats(batch_stats)
    got = module.state_dict()
    for name, w in want.items():
        if "running" in name:
            torch.testing.assert_close(got[name], w, rtol=1e-5, atol=1e-5, msg=name)


# ------------------------------------------------------------ BatchNorm, train


def test_conv_block_batchnorm_in_training_mode_matches_flax():
    """Output and ``batch_stats`` after one and after two calls; 72 values a
    channel, so torch's unbiased variance (x 72/71) or momentum 0.1 would
    show; then ``eval()`` normalizes with the moved statistics."""
    rng = np.random.default_rng(1)
    xs = [(2.0 + 1.5 * rng.standard_normal((2, 6, 6, 5))).astype(np.float32) for _ in range(2)]
    jblock = JaxConvBlock(out_channels=7, kernel_size=3, batch_norm=True)
    variables = jblock.init(jax.random.PRNGKey(0), jnp.asarray(xs[0]))
    params = _perturb(jax.device_get(variables["params"]), rng)
    stats = _perturb_stats(jax.device_get(variables["batch_stats"]), rng)
    tblock = ConvBlock(5, 7, 3, batch_norm=True).train()
    tblock.load_state_dict({**convert_tree(params), **convert_batch_stats(stats)})
    for x in xs:
        ref, mut = jblock.apply({"params": params, "batch_stats": stats}, jnp.asarray(x),
                                train=True, mutable=["batch_stats"])
        stats = jax.device_get(mut["batch_stats"])
        out = tblock(torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2))))
        np.testing.assert_allclose(out.detach().permute(0, 2, 3, 1).numpy(), np.asarray(ref),
                                   rtol=1e-5, atol=1e-5)
        _assert_buffers_match(tblock, stats)
    assert int(tblock.bn.num_batches_tracked) == 2
    ref = jblock.apply({"params": params, "batch_stats": stats}, jnp.asarray(xs[0]))
    with torch.no_grad():
        out = tblock.eval()(torch.from_numpy(np.ascontiguousarray(xs[0].transpose(0, 3, 1, 2))))
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


# ---------------------------------------------------------------- the 02 step


def jax_train_step(jmodel, loss_fn, tx, accum):
    """The JAX ``DecompTrainer``'s ``forward``, ``micro_grads`` and
    ``train_step`` for ExtendedDINOSAUR, copied line for line (no remat, no
    decode chunks, no mesh); returns the gradients too."""

    def loss_tensors(out, videos):
        return {
            "preds_feats": jnp.clip(out["recons_feats"], 0, 1),
            "targets_feats": jnp.clip(out["encoded_img_feats"], 0, 1),
            "pred_imgs": jnp.clip(out["recons_imgs"], 0, 1),
            "target_imgs": jnp.clip(videos, 0, 1),
        }

    def forward(params, batch_stats, videos, rng, train: bool):
        variables = {"params": params, "batch_stats": batch_stats}
        if train:
            out, mut = jmodel.apply(variables, videos, train=True, rngs={"slots": rng},
                                    mutable=["batch_stats"])
            return out, mut.get("batch_stats")
        out = jmodel.apply(variables, videos, train=False, rngs={"slots": rng})
        return out, batch_stats

    def micro_grads(params, batch_stats, videos, rng):
        def loss_of(p):
            out, new_bs = forward(p, batch_stats, videos, rng, train=True)
            total, values = loss_fn(**loss_tensors(out, videos))
            return total, (values, new_bs)

        (_, (values, new_bs)), grads = jax.value_and_grad(loss_of, has_aux=True)(params)
        return grads, values, new_bs

    @jax.jit
    def train_step(params, batch_stats, opt_state, videos, rng):
        if accum == 1:
            grads, values, new_bs = micro_grads(params, batch_stats, videos, rng)
        else:
            mb = videos.shape[0] // accum
            vr = videos.reshape(accum, mb, *videos.shape[1:])
            keys = jax.random.split(rng, accum)

            def body(carry, xs):
                bs, g_acc = carry
                v, r = xs
                g, vals, bs = micro_grads(params, bs, v, r)
                g_acc = jax.tree_util.tree_map(jnp.add, g_acc, g)
                return (bs, g_acc), vals

            zeros = jax.tree_util.tree_map(jnp.zeros_like, params)
            (new_bs, g_sum), vals_stack = jax.lax.scan(body, (batch_stats, zeros), (vr, keys))
            grads = jax.tree_util.tree_map(lambda g: g / accum, g_sum)
            values = jax.tree_util.tree_map(lambda v: jnp.mean(v, axis=0), vals_stack)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, new_bs, opt_state, values, grads

    def noise(params, rng):
        """The slot noise of every microbatch, concatenated (B, S, D)."""
        keys = [rng] if accum == 1 else list(jax.random.split(rng, accum))
        return np.concatenate([_jax_noise(jmodel, {"params": params}, B // accum, k)
                               for k in keys])

    return train_step, noise


@pytest.fixture(scope="module")
def jax_model():
    rng = np.random.default_rng(5)
    video = rng.uniform(0, 1, (B, T, IMG, IMG, 3)).astype(np.float32)
    jp, jpp = tiny_params(jax_build_exp_params, jax_add_predictor_params)
    jmodel = jax_setup_model(jp)
    variables = jax.jit(lambda x: jmodel.init({"params": jax.random.PRNGKey(0),
                                               "slots": jax.random.PRNGKey(1)}, x,
                                              decode=True))(jnp.asarray(video[:1, :1]))
    params = _perturb(jax.device_get(variables["params"]), rng)
    stats = _perturb_stats(jax.device_get(variables["batch_stats"]), rng)
    return {"jmodel": jmodel, "jp": jp, "jpp": jpp, "params": params, "stats": stats,
            "video": video}


def _experiment(root, params, **training):
    params = {**params, "training": {**params["training"], **training}}
    exp = Experiment(root)
    exp.save_params(params)
    return exp.exp_path


def port_decomp_trainer(root, case, accum):
    tp, _ = tiny_params(build_exp_params, add_predictor_params)
    tr = DecompTrainer(_experiment(root, tp, **TRAINING, batch_size=B, accum_steps=accum),
                       device="cpu")
    tr.setup_model()
    tr.model.load_state_dict(from_jax_params("dinosaur", case["params"],
                                             batch_stats=case["stats"]))
    return tr


# conv biases before a BatchNorm in training mode: a gradient of 0 in exact arithmetic
ZERO_GRAD = {f"patch_decoder.cnns.{i}.conv.bias" for i in range(4)}


def _assert_grads_match(named, want, frozen_prefix, zero=frozenset()):
    frozen = {n for n in named if n.startswith(frozen_prefix)}
    assert frozen and frozen == {n for n, p in named.items() if not p.requires_grad}
    for name in frozen:  # stop_gradient on the JAX side, no gradient on ours
        assert not want[name].any(), name
        assert named[name].grad is None, name
    top = max(g.abs().max().item() for g in want.values())
    for name in zero:
        for g in (want[name], named[name].grad):
            assert g.abs().max().item() <= 1e-5 * top, (name, g.abs().max().item(), top)
    floor = 1e-3 * top
    for name in set(named) - frozen - zero:
        g = want[name]
        assert named[name].grad is not None, name
        err = (named[name].grad - g).abs().max().item()
        assert err <= 1e-4 * max(g.abs().max().item(), floor), (name, err, g.abs().max().item())


@pytest.mark.parametrize("accum", [1, 2])
def test_two_02_steps_match_jax_loss_gradients_statistics_and_optax(jax_model, accum, tmp_path):
    """Each step: the loss, every trainable gradient leaf (the ViT's: 0 on
    the JAX side, none on ours), the running statistics after it (threaded
    through the microbatches in order); then the port's Adam applies the
    JAX gradients and the parameters are optax's within 1e-7; the ViT bit
    for bit. A second trainer steps on its own gradients: every element
    within 2 lr of optax's, and at most 0.1 % more than lr / 100 apart."""
    case = jax_model
    jmodel = case["jmodel"]
    tx, _ = jax_build_optimizer(TRAINING, freeze_mask=freeze_labels(case["params"],
                                                                    ("image_encoder",)))
    train_step, noise_of = jax_train_step(jmodel, jax_build_loss_fn(case["jp"]["loss"]), tx,
                                          accum)
    params, stats, opt_state = case["params"], case["stats"], tx.init(case["params"])
    tr = port_decomp_trainer(tmp_path / "a", case, accum)
    own = port_decomp_trainer(tmp_path / "b", case, accum)
    vit = {k: v.clone() for k, v in tr.model.image_encoder.state_dict().items()}
    video = torch.from_numpy(case["video"])
    for i in range(2):
        key = jax.random.PRNGKey(7 + i)
        noise = torch.from_numpy(noise_of(params, key))
        params, stats, opt_state, values, grads = train_step(
            params, stats, opt_state, jnp.asarray(case["video"]), key)
        params, stats, grads = jax.device_get((params, stats, grads))
        got = tr.backward(video, noise)
        assert set(got) == {"pred_feature_mse", "mse", "_total"}
        for name in got:
            np.testing.assert_allclose(float(got[name]), float(values[name]), rtol=1e-5,
                                       err_msg=name)
        want_grads = from_jax_params("dinosaur", grads)
        named = dict(tr.model.named_parameters())
        _assert_grads_match(named, want_grads, "image_encoder.", ZERO_GRAD)
        _assert_buffers_match(tr.model, stats)
        for name, p in named.items():
            if p.requires_grad:
                p.grad = want_grads[name].clone()
        tr.optimizer.step()
        own.train_step(video, noise)
        want = from_jax_params("dinosaur", params)
        for name, p in tr.model.named_parameters():
            torch.testing.assert_close(p.detach(), want[name], rtol=0, atol=1e-7, msg=name)
    assert tr.optimizer.count == own.optimizer.count == 2
    for name, v in tr.model.image_encoder.state_dict().items():
        assert torch.equal(v, vit[name]), name
        assert torch.equal(own.model.image_encoder.state_dict()[name], v), name
    # on its own gradients, an element whose clipped gradient is within its
    # rounding of Adam's eps moves by up to lr either way
    lr = TRAINING["lr"]
    diffs = torch.cat([(p.detach() - want[n]).abs().flatten()
                       for n, p in own.model.named_parameters()])
    assert diffs.max() <= 2 * lr and (diffs > lr / 100).float().mean() <= 1e-3, (
        diffs.max(), (diffs > lr / 100).sum())
    _assert_buffers_match(own.model, stats)


@pytest.mark.parametrize("size", ["tiny", "full_width"])
def test_trainable_parameters_are_the_jax_train_leaves(size):
    """Module by module, the numbers that require grad are those of JAX's
    ``"train"`` labels, and those that do not are its ``"freeze"`` ones (the
    ViT)."""
    if size == "tiny":
        jp, tp = (tiny_params(b, a)[0] for b, a in ((jax_build_exp_params,
                                                      jax_add_predictor_params),
                                                     (build_exp_params, add_predictor_params)))
    else:
        jp = jax_build_exp_params("ExtendedDINOSAUR", "CLIPort")
        tp = build_exp_params("ExtendedDINOSAUR", "CLIPort")
    img = jp["model"]["model_params"]["img_size"]
    shapes = jax.eval_shape(
        lambda: jax_setup_model(jp).init({"params": jax.random.PRNGKey(0),
                                          "slots": jax.random.PRNGKey(1)},
                                         jnp.zeros((1, 1, img, img, 3)), decode=True))["params"]
    labels = freeze_labels(shapes, ("image_encoder",))
    ref = {"train": {}, "freeze": {}}
    for (path, x), label in zip(jax.tree_util.tree_leaves_with_path(shapes),
                                jax.tree_util.tree_leaves(labels)):
        top = path[0].key
        ref[label][top] = ref[label].get(top, 0) + int(np.prod(x.shape))
    ours = {"train": {}, "freeze": {}}
    for name, p in setup_model(tp).named_parameters():
        label, top = ("train" if p.requires_grad else "freeze"), name.split(".")[0]
        ours[label][top] = ours[label].get(top, 0) + p.numel()
    assert ours == ref and set(ref["freeze"]) == {"image_encoder"}


def test_valid_epoch_leaves_the_running_statistics_and_train_mode(jax_model, tmp_path):
    data_root = write_cliport(tmp_path / "CLIPort")
    tp, _ = tiny_params(build_exp_params, add_predictor_params, data_root)
    tr = DecompTrainer(_experiment(tmp_path / "exp", tp, batch_size=B), device="cpu")
    tr.load_data()
    tr.setup_model()
    tr.model.load_state_dict(from_jax_params("dinosaur", jax_model["params"],
                                             batch_stats=jax_model["stats"]))
    before = _bn_buffers(tr.model)
    assert np.isfinite(tr.valid_epoch(0))
    assert tr.model.training
    for name, v in _bn_buffers(tr.model).items():
        assert torch.equal(v, before[name]), name
    tr.train_step(tr.to_device(next(iter(tr.train_loader))[0]))
    assert not torch.equal(tr.model.patch_decoder.cnns[0].bn.running_mean,
                           before["patch_decoder.cnns.0.bn.running_mean"])


# ------------------------------------------------------------- the 04 step


def test_04_loss_and_every_gradient_match_jax_through_the_frozen_dinosaur(jax_model, tmp_path):
    """The JAX ``PredictorTrainer.forward_loss`` (``textocvp_tpu/train/
    predictor_trainer.py:219-251``, the frozen model's ``batch_stats`` in its
    variables) against the port's, on unclipped images decoded through the
    BatchNorm head in ``eval()``."""
    case = jax_model
    jdecomp = case["jmodel"]
    rng = np.random.default_rng(8)
    video = rng.uniform(0, 1, (B, 1 + P, IMG, IMG, 3)).astype(np.float32)
    tokens = rng.integers(2, 32000, (B, 6)).astype(np.int32)
    masks = np.ones((B, 6), np.int32)
    masks[1, 4:] = tokens[1, 4:] = 0
    jpred = jax_setup_predictor(case["jpp"])
    pvars = jax.jit(lambda s, t, m: jpred.init({"params": jax.random.PRNGKey(3)}, s,
                                               caption_tokens=t, attn_masks=m))(
        jnp.zeros((1, 1, S, D)), jnp.asarray(tokens[:1]), jnp.asarray(masks[:1]))
    pparams = _perturb(jax.device_get(pvars["params"]), rng)
    loss_fn = jax_build_loss_fn(case["jpp"]["predictor_loss"])
    text_kwargs = {"caption_tokens": jnp.asarray(tokens), "attn_masks": jnp.asarray(masks)}
    key = jax.random.PRNGKey(11)

    def decomp_vars():
        return {"params": case["params"], "batch_stats": case["stats"]}

    def forward_loss(params, rng):
        c, p = 1, P
        videos = jnp.asarray(video)[:, : c + p]
        b = videos.shape[0]
        out = jdecomp.apply(decomp_vars(), videos, decode=False, rngs={"slots": rng})
        slot_history = jax.lax.stop_gradient(out["slot_history"])
        pred_slots = jpred.apply({"params": params}, slot_history, teacher_force=False,
                                 **text_kwargs)
        dec = jdecomp.apply(decomp_vars(), pred_slots.reshape(b * p, S, D), method="decode")
        pred_imgs = dec["recons_imgs"]
        target_imgs = videos[:, c: c + p]
        pred_imgs = pred_imgs.reshape(target_imgs.shape)
        tensors = {"pred_slots": pred_slots, "target_slots": slot_history[:, c: c + p],
                   "pred_imgs": pred_imgs, "target_imgs": target_imgs}
        return loss_fn(**tensors)

    (loss, _), grads = jax.jit(jax.value_and_grad(forward_loss, has_aux=True))(pparams, key)

    tp, tpp = tiny_params(build_exp_params, add_predictor_params)
    parent = Experiment(tmp_path / "exp")
    parent.save_params(tp)
    parent.models_dir.mkdir(parents=True)
    torch.save(from_jax_params("dinosaur", case["params"], batch_stats=case["stats"]),
               parent.checkpoint_path("decomp"))
    pred = Experiment(parent.exp_path / "predictors" / "tiny")
    pred.save_params({**tpp, "training": {**tpp["training"], **TRAINING, "batch_size": B}})
    save_checkpoint(pred.checkpoint_path("init"),
                    {"params": from_jax_params("predictor", pparams)})
    tr = PredictorTrainer(pred.exp_path, "decomp", checkpoint="init", device="cpu")
    tr.setup_model()
    assert not tr.decomp_model.training
    before = _bn_buffers(tr.decomp_model)
    noise = _jax_noise(jdecomp, {"params": case["params"]}, B, key)
    total, values = tr.forward_loss(torch.from_numpy(video), torch.from_numpy(noise),
                                    caption_tokens=torch.from_numpy(tokens).long(),
                                    attn_masks=torch.from_numpy(masks).long())
    np.testing.assert_allclose(total.item(), float(loss), rtol=1e-5)
    total.backward()
    _assert_grads_match(dict(tr.model.named_parameters()),
                        from_jax_params("predictor", jax.device_get(grads)),
                        "predictor.text_encoder.")
    assert all(p.grad is None for p in tr.decomp_model.parameters())
    for name, v in _bn_buffers(tr.decomp_model).items():
        assert torch.equal(v, before[name]), name


# ------------------------------------------------------ the CLIs end to end


@pytest.fixture(scope="module")
def chain_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("dino_chain")
    return root, write_cliport(root / "CLIPort")


def _chain_experiment(root, data_root, name="exp", **training):
    tp, _ = tiny_params(build_exp_params, add_predictor_params, data_root)
    tp["dataset"]["num_frames"] = T
    return _experiment(root / name, tp, **{"num_epochs": 1, "batch_size": B,
                                           "save_frequency": 1, "log_frequency": 1,
                                           "lr": 1e-3, "warmup_steps": 2, "accum_steps": 2,
                                           **training})


def test_02_04_05_chain_on_the_cpu_with_resume(chain_root, capsys):
    """The 02 CLI (ExtendedDINOSAUR, accumulation 2), its resume equal to an
    uninterrupted run, the 04 CLI (TextOCVP_T5) on its final checkpoint and
    its resume, then the 05 CLI on the 04 checkpoint."""
    root, data_root = chain_root
    exp = _chain_experiment(root, data_root)
    first = train_decomp.main(["-d", str(exp), "--device", "cpu"])
    out = capsys.readouterr().out
    losses = [float(line.split("loss=")[1]) for line in out.splitlines() if "loss=" in line]
    assert len(losses) == 2 and np.isfinite(losses).all()  # 3 episodes in batches of 2
    assert first.global_step == 4 and first.optimizer.count == 2  # 2 valid + 2 train batches
    state = torch.load(Experiment(exp).checkpoint_path("checkpoint_epoch_final"),
                       weights_only=True)
    vit = {k: v for k, v in state["params"].items() if k.startswith("image_encoder.")}
    assert vit and "patch_decoder.cnns.3.bn.running_var" in state["params"]
    assert len(state["opt_state"]["mu"]) == len(first.optimizer.params) < len(
        list(first.model.parameters()))

    p = Experiment(exp).params
    p["training"]["num_epochs"] = 2
    Experiment(exp).save_params(p)
    resumed = train_decomp.main(["-d", str(exp), "--checkpoint", "checkpoint_last_saved",
                                 "--resume_training", "--device", "cpu"])
    assert "Resuming training from epoch 1" in capsys.readouterr().out
    assert resumed.start_epoch == 1 and resumed.global_step == 8
    straight = train_decomp.main(["-d", str(_chain_experiment(root, data_root, "straight",
                                                              num_epochs=2)),
                                  "--device", "cpu"])
    for (name, a), b in zip(resumed.model.state_dict().items(),
                            straight.model.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=name)  # BN buffers too
    for name, v in vit.items():
        assert torch.equal(resumed.model.state_dict()[name], v), name

    _, tpp = tiny_params(build_exp_params, add_predictor_params, data_root)
    tpp["training"].update(num_epochs=1, batch_size=B, save_frequency=1, log_frequency=1,
                           lr=1e-3, warmup_steps=2)
    pred = Experiment(exp / "predictors" / "tiny")
    pred.save_params(tpp)
    argv = ["-d", str(exp), "--name_pred_exp", "tiny", "--decomp_ckpt",
            "checkpoint_epoch_final", "--device", "cpu"]
    trainer = train_predictor.main(argv)
    assert trainer.train_set.num_frames == 1 + P and not trainer.decomp_model.training
    assert trainer.global_step == 4 and trainer.optimizer.count == 2
    tpp["training"]["num_epochs"] = 2
    pred.save_params(tpp)
    resumed = train_predictor.main(argv + ["--checkpoint", "checkpoint_last_saved",
                                           "--resume_training"])
    assert resumed.start_epoch == 1 and resumed.optimizer.count == 4

    evaluate_predictor.main(["-d", str(exp), "--name_pred_exp", "tiny", "--decomp_ckpt",
                             "checkpoint_epoch_final", "--pred_ckpt", "checkpoint_epoch_final",
                             "--num_seed", "1", "--num_preds", str(P), "--batch_size", "2",
                             "--device", "cpu"])
    res = pred.exp_path / "results" / f"eval_pred_checkpoint_epoch_final_NumSeed=1_NumPreds={P}"
    results = __import__("json").loads((res / "results.json").read_text())
    for m in ("psnr", "ssim", "lpips"):
        assert len(results[m]["framewise"]) == P
        assert np.isfinite(results[m]["framewise"] + [results[m]["mean"]]).all(), m


def test_02_emergency_checkpoint_on_an_exception(chain_root, monkeypatch):
    root, data_root = chain_root
    exp = _chain_experiment(root, data_root, "emergency")
    tr = DecompTrainer(exp, device="cpu")
    tr.load_data()
    tr.setup_model()
    calls = []
    step = DecompTrainer.train_step

    def failing(self, videos, noise=None):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("boom")
        return step(self, videos, noise)

    monkeypatch.setattr(DecompTrainer, "train_step", failing)
    with pytest.raises(RuntimeError, match="boom"):
        tr.training_loop()
    models = Experiment(exp).models_dir
    assert {p.name for p in models.iterdir()} == {"emergency_checkpoint_epoch_0.pt"}
    state = torch.load(models / "emergency_checkpoint_epoch_0.pt", weights_only=True)
    assert state["epoch"] == 0 and state["opt_state"]["count"] == 1
    assert "image_encoder.blocks.0.qkv.weight" in state["params"]
