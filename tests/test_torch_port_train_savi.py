"""The 02 decomposition training of the port on the CPU: SAVi's loss and
gradients against the JAX package, the train split and its loader against
the JAX package's, and the trainer and its CLI end to end on a tiny
experiment.

* Same weights (the JAX init plus noise, carried by ``from_jax_params``),
  the same video, and the JAX slot noise handed to the port's ``forward``
  (``noise=``), so the gradients of ``slots_mu`` and ``slots_sigma`` are
  compared too. T=3 runs both ``num_iterations_first`` and
  ``num_iterations``. Loss rtol 1e-5; every gradient leaf, converted from
  the JAX tree of gradients by ``from_jax_params``, within 1e-4 of the
  leaf's largest value (float32 on both sides, sums in other orders;
  measured about 1.4e-5 at most). ``to_q.bias`` and ``norm_slot.bias`` have
  a gradient of exactly 0, since the softmax over slots does not see a shift
  common to every slot, and both sides give rounding noise of order 1e-10
  there: their limit is 1e-4 of a thousandth of the largest gradient of any
  leaf. The loss after one Adam update on each side: rtol 1e-5.
* The trainable parameters are the JAX leaves: the same count of numbers in
  total and in every top-level module.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from textocvp_tpu.core.config import build_exp_params as jax_build_exp_params
from textocvp_tpu.data.datasets import CATER as JaxCATER
from textocvp_tpu.data.datasets import _random_start as jax_random_start
from textocvp_tpu.data.loader import DataLoader as JaxDataLoader
from textocvp_tpu.models import setup_model as jax_setup_model
from textocvp_tpu.train.losses import build_loss_fn as jax_build_loss_fn
from textocvp_tpu.train.schedulers import build_optimizer as jax_build_optimizer
from textocvp_tpu.train.trainer import accum_steps_of as jax_accum_steps_of
from textocvp_tpu.train.trainer import ragged_accum as jax_ragged_accum
from textocvp_tpu_torch.cli.train_decomp import main as train_main
from textocvp_tpu_torch.convert import from_jax_params
from textocvp_tpu_torch.core.config import build_exp_params
from textocvp_tpu_torch.core.experiment import Experiment
from textocvp_tpu_torch.data.datasets import CATER, _random_start
from textocvp_tpu_torch.data.loader import EpochLoader
from textocvp_tpu_torch.models import setup_model
from textocvp_tpu_torch.ops.slot_attention import SlotAttention
from textocvp_tpu_torch.train import trainer as trainer_mod
from textocvp_tpu_torch.train.losses import build_loss_fn
from textocvp_tpu_torch.train.schedulers import build_optimizer
from textocvp_tpu_torch.train.trainer import DecompTrainer, accum_steps_of, ragged_accum

B, T, RES = 2, 3, 16
LOSS = [{"type": "mse", "weight": 1}]
TRAINING = {"lr": 1e-3, "scheduler": "cosine_annealing", "scheduler_steps": 100,
            "lr_warmup": False, "warmup_steps": 0, "gradient_clipping": True,
            "clipping_max_value": 0.05}


def tiny_savi_params(build):
    p = build("SAVi", "CATER_Easy")
    mp = p["model"]["model_params"]
    mp.update(num_slots=4, slot_dim=32, mlp_hidden=64, mlp_encoder_dim=32)
    mp["encoder"]["encoder_params"].update(num_channels=[8, 8], resolution=[RES, RES])
    mp["decoder"]["decoder_params"].update(num_channels=[8, 8], resolution=[RES, RES])
    mp["transition_module"] = {"model_name": "TransformerBlock", "num_heads": 2, "mlp_size": 64}
    p["dataset"]["img_size"] = [RES, RES]
    return p


def _jax_noise(jmodel, variables, batch, key):
    """The slot initializer's ``jax.random.normal`` draw under ``key``, as
    ``decompose`` makes it (the initializer's own scope and rng stream)."""
    drawn = []
    normal = jax.random.normal

    def record(*args, **kwargs):
        drawn.append(normal(*args, **kwargs))
        return drawn[-1]

    jax.random.normal = record
    try:
        jmodel.apply(variables, batch, method=lambda m, b: m.slot_initializer(batch_size=b),
                     rngs={"slots": key})
    finally:
        jax.random.normal = normal
    assert len(drawn) == 1
    return np.asarray(drawn[0])


@pytest.fixture(scope="module")
def step_case():
    """One JAX training step: loss and gradients, then the loss after the
    optimizer's update, each with its own slot noise."""
    rng = np.random.default_rng(5)
    video = rng.uniform(0, 1, (B, T, RES, RES, 3)).astype(np.float32)
    jmodel = jax_setup_model(tiny_savi_params(jax_build_exp_params))
    init = jax.jit(lambda x: jmodel.init({"params": jax.random.PRNGKey(0),
                                          "slots": jax.random.PRNGKey(1)}, x, decode=True))(
        jnp.asarray(video))
    params = jax.tree_util.tree_map(
        lambda x: np.asarray(x) + 0.05 * rng.standard_normal(np.shape(x)).astype(np.float32),
        jax.device_get(init["params"]))
    keys = [jax.random.PRNGKey(7), jax.random.PRNGKey(8)]
    noise = [_jax_noise(jmodel, {"params": params}, B, k) for k in keys]
    loss_fn = jax_build_loss_fn(LOSS)

    def loss_of(p, key):
        out = jmodel.apply({"params": p}, jnp.asarray(video), rngs={"slots": key})
        return loss_fn(pred_imgs=jnp.clip(out["recons_imgs"], 0, 1),
                       target_imgs=jnp.clip(jnp.asarray(video), 0, 1))[0]

    loss1, grads = jax.jit(jax.value_and_grad(loss_of))(params, keys[0])
    tx, _ = jax_build_optimizer(TRAINING)
    updates, _ = tx.update(grads, tx.init(params), params)
    loss2 = jax.jit(loss_of)(optax.apply_updates(params, updates), keys[1])
    return {"video": video, "params": params, "noise": noise, "loss1": float(loss1),
            "grads": jax.device_get(grads), "loss2": float(loss2)}


def _port_loss(model, video, noise):
    out = model(torch.from_numpy(video), noise=torch.from_numpy(noise))
    return build_loss_fn(LOSS)(pred_imgs=out["recons_imgs"].clamp(0, 1),
                               target_imgs=torch.from_numpy(video).clamp(0, 1))[0]


def test_loss_and_every_gradient_match_jax_then_the_loss_after_an_update(step_case):
    model = setup_model(tiny_savi_params(build_exp_params))
    model.load_state_dict(from_jax_params("savi", step_case["params"]))
    loss = _port_loss(model, step_case["video"], step_case["noise"][0])
    np.testing.assert_allclose(float(loss), step_case["loss1"], rtol=1e-5)
    loss.backward()
    want = from_jax_params("savi", step_case["grads"])
    named = dict(model.named_parameters())
    assert set(want) == set(named)
    floor = 1e-3 * max(g.abs().max().item() for g in want.values())
    for name, g in want.items():
        assert named[name].grad is not None, name
        err = (named[name].grad - g).abs().max().item()
        assert err <= 1e-4 * max(g.abs().max().item(), floor), (name, err, g.abs().max().item())
    opt, _ = build_optimizer(TRAINING, model.parameters())
    opt.step()
    with torch.no_grad():
        loss2 = _port_loss(model, step_case["video"], step_case["noise"][1])
    np.testing.assert_allclose(float(loss2), step_case["loss2"], rtol=1e-5)
    assert abs(step_case["loss2"] - step_case["loss1"]) > 1e-5  # the update moved it


def test_forward_returns_the_jax_decompose_dict(step_case):
    model = setup_model(tiny_savi_params(build_exp_params)).eval()
    model.load_state_dict(from_jax_params("savi", step_case["params"]))
    jmodel = jax_setup_model(tiny_savi_params(jax_build_exp_params))
    ref = jmodel.apply({"params": step_case["params"]}, jnp.asarray(step_case["video"]),
                       rngs={"slots": jax.random.PRNGKey(7)})
    with torch.no_grad():
        out = model(torch.from_numpy(step_case["video"]),
                    noise=torch.from_numpy(step_case["noise"][0]))
    assert set(out) == set(ref)
    for key in ref:
        assert tuple(out[key].shape) == ref[key].shape, key
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]), rtol=1e-4, atol=2e-5,
                                   err_msg=key)
    with torch.no_grad():
        assert set(model(torch.from_numpy(step_case["video"]), noise=torch.from_numpy(
            step_case["noise"][0]), decode=False)) == {"slot_history", "attn_masks"}


@pytest.mark.parametrize("size", ["tiny", "full_width"])
def test_trainable_parameters_are_the_jax_leaves(size):
    if size == "tiny":
        jp, tp = tiny_savi_params(jax_build_exp_params), tiny_savi_params(build_exp_params)
    else:
        jp, tp = jax_build_exp_params("SAVi", "CATER_Easy"), build_exp_params("SAVi", "CATER_Easy")
    res = jp["model"]["model_params"]["encoder"]["encoder_params"]["resolution"]
    shapes = jax.eval_shape(
        lambda: jax_setup_model(jp).init({"params": jax.random.PRNGKey(0),
                                          "slots": jax.random.PRNGKey(1)},
                                         jnp.zeros((1, 1, *res, 3)), decode=True))["params"]
    model = setup_model(tp)
    ours = {}
    for name, p in model.named_parameters():
        assert p.requires_grad, name
        ours[name.split(".")[0]] = ours.get(name.split(".")[0], 0) + p.numel()
    ref = {k: sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(v))
           for k, v in shapes.items()}
    assert ours == ref


def test_gru_has_no_recurrent_r_and_z_bias():
    mod = SlotAttention(16, 16, 3, 32)
    assert {n for n, _ in mod.gru.named_parameters()} == {"weight_ih", "bias_ih", "weight_hh",
                                                          "bias_hn"}
    b_hh = mod.iteration_params()["gru_b_hh"]
    assert b_hh.shape == (48,) and not b_hh[:32].any()
    torch.testing.assert_close(b_hh[32:], mod.gru.bias_hn, rtol=0, atol=0)
    (g,) = torch.autograd.grad(b_hh.sum(), mod.gru.bias_hn)
    torch.testing.assert_close(g, torch.ones(16), rtol=0, atol=0)


def test_learned_random_init_takes_the_noise():
    model = setup_model(tiny_savi_params(build_exp_params))
    init = model.slot_initializer
    noise = torch.randn((3, 4, 32), generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(init(3, noise=noise), init.slots_mu + init.slots_sigma * noise,
                               rtol=0, atol=0)
    with pytest.raises(ValueError, match="noise of shape"):
        init(2, noise=noise)


@pytest.mark.parametrize("seed", [14, 0, 123])
def test_random_start_matches_jax(seed):
    for epoch in range(4):
        for idx in range(6):
            for n in (1, 3, 14):
                assert _random_start(seed, epoch, idx, n) == jax_random_start(seed, epoch, idx, n)


def write_cater(root, splits=(("train", 7), ("test", 3)), frames=10, res=RES, seed=14):
    """<root>/easy/video_<i>.npy uint8 and <split>_explicit.json for each split."""
    rng = np.random.default_rng(seed)
    mode = root / "easy"
    mode.mkdir(parents=True, exist_ok=True)
    start = 0
    for split, count in splits:
        ann = {}
        for j in range(count):
            i = start + j
            video = rng.integers(0, 256, (frames, res, res, 3), dtype=np.uint8)
            video[:, 0, 0, 0] = np.arange(frames)  # each frame names itself
            np.save(mode / f"video_{i:04d}.npy", video)
            ann[str(j)] = {"video": f"video_{i:04d}.npy", "caption": f"the cone is rotating {j}"}
        with open(mode / f"{split}_explicit.json", "w") as f:
            json.dump(ann, f)
        start += count
    return root


def test_train_split_items_and_loader_order_match_jax(tmp_path):
    root = write_cater(tmp_path / "CATER")
    kw = dict(root=str(root), mode="easy", split="train", num_frames=4, img_size=(RES, RES),
              random_start=True)
    ours, ref = CATER(**kw), JaxCATER(**kw)
    for drop_last in (False, True):
        loader = EpochLoader(ours, batch_size=3, shuffle=True, drop_last=drop_last)
        jloader = JaxDataLoader(ref, batch_size=3, shuffle=True, drop_last=drop_last,
                                num_workers=0)
        assert len(loader) == len(jloader) == (2 if drop_last else 3)
        starts = set()
        for _ in range(3):  # three epochs
            got, want = list(loader), list(jloader)
            assert len(got) == len(want)
            for (vo, io), (vr, ir) in zip(got, want):
                np.testing.assert_array_equal(vo, vr)
                assert io["caption"] == ir["caption"]
                starts.update(vo[:, 0, 0, 0, 0].round(4).tolist())
        assert len(starts) > 1  # the clips do start at different frames
    test = CATER(**{**kw, "split": "test"})
    assert test[0][0].shape == (4, RES, RES, 3)  # the valid split starts at frame 1
    np.testing.assert_allclose(test[0][0][:, 0, 0, 0] * 255, [1, 2, 3, 4], atol=1e-4)


def test_accumulation_helpers_match_jax():
    for bs in (4, 6, 8):
        for accum in (1, 2, 4):
            tp = {"batch_size": bs, "accum_steps": accum}
            if bs % accum:
                with pytest.raises(ValueError):
                    accum_steps_of(tp)
                continue
            assert accum_steps_of(tp) == jax_accum_steps_of(tp)
            for n in range(1, bs + 1):
                assert ragged_accum(n, accum, bs) == jax_ragged_accum(n, accum, bs)


def _experiment(root, **training):
    data_root = write_cater(root / "CATER")
    p = tiny_savi_params(build_exp_params)
    p["dataset"].update(root=str(data_root), num_frames=T)
    p["training"].update({"num_epochs": 1, "batch_size": B, "save_frequency": 1,
                          "log_frequency": 1, "lr": 1e-3, "warmup_steps": 2, **training})
    exp = Experiment(root / "exp")
    exp.save_params(p)
    return exp.exp_path


def test_trainer_refuses_cuda_without_a_card_and_unported_models(tmp_path, monkeypatch):
    exp = _experiment(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DecompTrainer(exp)
    p = Experiment(exp).params
    p["model"]["model_name"] = "SlotFormer"  # a model neither package has
    Experiment(exp).save_params(p)
    with pytest.raises(NameError, match="is not ported; the port has"):
        DecompTrainer(exp, device="cpu")


def test_accumulated_gradient_equals_the_flat_one(tmp_path):
    exp = _experiment(tmp_path)
    grads = []
    for accum in (1, 2):
        p = Experiment(exp).params
        p["training"]["accum_steps"] = accum
        Experiment(exp).save_params(p)
        tr = DecompTrainer(exp, device="cpu")
        tr.setup_model()
        video = torch.rand((B, T, RES, RES, 3), generator=torch.Generator().manual_seed(3))
        noise = torch.randn((B, 4, 32), generator=torch.Generator().manual_seed(4))
        values = tr.backward(video, noise)
        assert np.isfinite(float(values["_total"]))
        grads.append([p.grad.clone() for p in tr.model.parameters()])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-7)


def test_cli_trains_writes_checkpoints_and_resumes_where_it_stopped(tmp_path, capsys):
    exp = _experiment(tmp_path)
    first = train_main(["-d", str(exp), "--device", "cpu"])
    out = capsys.readouterr().out
    losses = [float(line.split("loss=")[1]) for line in out.splitlines() if "loss=" in line]
    assert len(losses) == 4 and np.isfinite(losses).all()  # 7 videos in batches of 2
    assert "Epoch 1/1: train=" in out
    models = Experiment(exp).models_dir
    assert {p.name for p in models.iterdir()} == {
        "checkpoint_last_saved.pt", "checkpoint_epoch_1.pt", "checkpoint_epoch_final.pt"}
    assert (exp / "model_architecture.txt").is_file()
    # 2 valid batches (3 videos) and 4 train batches, one noise draw each
    assert first.global_step == 6 and first.optimizer.count == 4

    p = Experiment(exp).params
    p["training"]["num_epochs"] = 2
    Experiment(exp).save_params(p)
    resumed = train_main(["-d", str(exp), "--checkpoint", "checkpoint_last_saved",
                          "--resume_training", "--device", "cpu"])
    assert "Resuming training from epoch 1" in capsys.readouterr().out
    assert resumed.start_epoch == 1 and resumed.global_step == 12
    assert resumed.optimizer.count == 8

    straight_root = tmp_path / "straight"
    straight_root.mkdir()
    straight_exp = _experiment(straight_root, num_epochs=2)
    straight = train_main(["-d", str(straight_exp), "--device", "cpu"])
    for (name, a), b in zip(resumed.model.state_dict().items(),
                            straight.model.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=name)


def test_emergency_checkpoint_on_an_exception(tmp_path, monkeypatch):
    exp = _experiment(tmp_path)
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


def test_noise_stream_is_a_function_of_the_step():
    a = torch.randn(5, generator=trainer_mod.noise_generator(3))
    torch.testing.assert_close(a, torch.randn(5, generator=trainer_mod.noise_generator(3)),
                               rtol=0, atol=0)
    assert not torch.equal(a, torch.randn(5, generator=trainer_mod.noise_generator(4)))
