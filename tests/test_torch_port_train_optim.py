"""The port's training arithmetic on the CPU against the JAX package: the
learning-rate schedule, the clipped Adam update, the losses; and the
checkpoint files.

Tolerances: schedule values rtol 1e-6 (the JAX schedule computes in float32,
the port in float64); the optimizer's parameters after five updates rtol
1e-7 (both float32, the same formulas, one update order; atol 1e-9 for
values near 0); losses rtol 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from textocvp_tpu.train.losses import build_loss_fn as jax_build_loss_fn
from textocvp_tpu.train.schedulers import build_lr_schedule as jax_build_lr_schedule
from textocvp_tpu.train.schedulers import build_optimizer as jax_build_optimizer
from textocvp_tpu_torch.core.experiment import Experiment
from textocvp_tpu_torch.train import checkpoints
from textocvp_tpu_torch.train.losses import LOSS_DICT, build_loss_fn
from textocvp_tpu_torch.train.schedulers import Adam, build_lr_schedule, build_optimizer

TRAINING = {"lr": 1e-4, "scheduler": "cosine_annealing", "scheduler_steps": 1e6,
            "lr_warmup": True, "warmup_steps": 2000, "gradient_clipping": True,
            "clipping_max_value": 0.05}

SCHEDULES = {
    "cosine_warmup": {},
    "cosine_no_warmup": {"lr_warmup": False},
    "cosine_short": {"warmup_steps": 3, "scheduler_steps": 10},
    "constant_warmup": {"scheduler": "constant", "warmup_steps": 5},
    "exponential": {"scheduler": "exponential", "lr_warmup": False, "scheduler_steps": 7,
                    "lr_factor": 0.5},
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedule_matches_jax(name):
    tp = {**TRAINING, **SCHEDULES[name]}
    ours, ref = build_lr_schedule(tp), jax_build_lr_schedule(tp)
    ws = tp["warmup_steps"]
    for count in (0, 1, 2, ws - 1, ws, ws + 1, ws + 2, ws + 10, 3 * ws, 10 ** 6 + 5000, 2 * 10 ** 6):
        want = float(ref(jnp.asarray(count)))
        np.testing.assert_allclose(ours(count), want, rtol=1e-6, atol=1e-12,
                                   err_msg=f"{name} at count {count}")
    if tp.get("lr_warmup") and ws:
        assert ours(0) == 0.0  # the first update runs at lr 0


def test_unknown_scheduler_raises():
    with pytest.raises(NameError, match="Unknown scheduler"):
        build_lr_schedule({**TRAINING, "scheduler": "step"})


def _grads(scale, seed=3):
    rng = np.random.default_rng(seed)
    shapes = [(4, 3), (3,), (2, 2, 5), (1,)]
    g = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    norm = np.sqrt(sum(float(np.sum(x.astype(np.float64) ** 2)) for x in g))
    return [(x * np.float32(scale / norm)).astype(np.float32) for x in g]


# the global norm of the gradients against the clip's 0.05
@pytest.mark.parametrize("regime,scale", [("below", 0.02), ("at", 0.05), ("above", 0.4),
                                          ("off", 0.4)])
def test_five_optimizer_steps_match_optax(regime, scale):
    tp = {**TRAINING, "warmup_steps": 2, "scheduler_steps": 20, "lr": 1e-2,
          "gradient_clipping": regime != "off"}
    rng = np.random.default_rng(7)
    params = [rng.standard_normal(g.shape).astype(np.float32) for g in _grads(1.0)]
    tx, _ = jax_build_optimizer(tp)
    jp = [jnp.asarray(p) for p in params]
    state = tx.init(jp)
    tparams = [torch.from_numpy(p.copy()) for p in params]
    opt, _ = build_optimizer(tp, tparams)
    for step in range(5):
        grads = _grads(scale, seed=10 + step)
        updates, state = tx.update([jnp.asarray(g) for g in grads], state, jp)
        jp = optax.apply_updates(jp, updates)
        for p, g in zip(tparams, grads):
            p.grad = torch.from_numpy(g)
        info = opt.step()
        # "at": the norm is 0.05 up to rounding, so the clip's side is optax's
        want = regime != "off" and not float(optax.global_norm(grads)) < tp["clipping_max_value"]
        assert info["clipped"] == want and (regime != "above" or want), info
        for p, r in zip(tparams, jp):
            np.testing.assert_allclose(p.numpy(), np.asarray(r), rtol=1e-7, atol=1e-9,
                                       err_msg=f"{regime} step {step}")
    assert opt.count == 5
    adam = next(s for s in state if hasattr(s, "mu"))
    for m, r in zip(opt.mu, adam.mu):
        np.testing.assert_allclose(m.numpy(), np.asarray(r), rtol=1e-6, atol=1e-12)


def test_optimizer_state_round_trip_continues_the_run():
    tp = {**TRAINING, "warmup_steps": 1, "lr": 1e-2}
    p0 = [torch.randn(3, 2, generator=torch.Generator().manual_seed(1))]

    def run(steps, opt=None, params=None):
        params = params or [p.clone() for p in p0]
        opt = opt or build_optimizer(tp, params)[0]
        for _ in range(steps):
            params[0].grad = torch.full((3, 2), 0.01 * (1 + opt.count))
            opt.step()
        return params, opt

    straight, _ = run(4)
    half, opt = run(2)
    resumed = [half[0].clone()]
    opt2 = build_optimizer(tp, resumed)[0]
    opt2.load_state_dict(opt.state_dict())
    run(2, opt2, resumed)
    torch.testing.assert_close(resumed[0], straight[0], rtol=0, atol=0)
    with pytest.raises(ValueError, match="parameters"):
        build_optimizer(tp, [torch.zeros(1), torch.zeros(1)])[0].load_state_dict(opt.state_dict())


def test_parameter_without_gradient_counts_as_zero():
    p = [torch.ones(2), torch.ones(3)]
    opt = Adam(p, lambda c: 0.1)
    p[0].grad = torch.ones(2)
    opt.step()
    torch.testing.assert_close(p[1], torch.ones(3), rtol=0, atol=0)
    assert p[0][0] < 1


@pytest.mark.parametrize("specs", [
    [{"type": "mse", "weight": 1}],
    [{"type": "pred_feature_mse", "weight": 1}, {"type": "mse", "weight": 1}],
    [{"type": "pred_img_mse", "weight": 1}, {"type": "pred_slot_mse", "weight": 0.5}],
])
def test_losses_match_jax(specs):
    rng = np.random.default_rng(5)
    tensors = {k: rng.uniform(-0.2, 1.2, (2, 3, 4, 4, 3)).astype(np.float32)
               for k in ("pred_imgs", "target_imgs", "preds_feats", "targets_feats",
                         "pred_slots", "target_slots")}
    total, values = build_loss_fn(specs)(**{k: torch.from_numpy(v) for k, v in tensors.items()})
    jtotal, jvalues = jax_build_loss_fn(specs)(**{k: jnp.asarray(v) for k, v in tensors.items()})
    np.testing.assert_allclose(float(total), float(jtotal), rtol=1e-6)
    assert set(values) == set(jvalues)
    for k in values:
        np.testing.assert_allclose(float(values[k]), float(jvalues[k]), rtol=1e-6, err_msg=k)
    assert set(LOSS_DICT) == {"mse", "pred_img_mse", "pred_slot_mse", "pred_feature_mse"}


def test_unknown_loss_raises():
    with pytest.raises(NameError, match="Unknown loss"):
        build_loss_fn([{"type": "l1"}])


def test_checkpoint_round_trip_is_atomic_and_on_the_cpu(tmp_path):
    state = {"params": {"w": torch.arange(6.0).view(2, 3)},
             "opt_state": {"count": 3, "mu": [torch.ones(2)], "nu": [torch.zeros(2)]},
             "epoch": 4, "step": 17}
    exp = Experiment(tmp_path)
    path = checkpoints.save_checkpoint(exp.checkpoint_path("checkpoint_epoch_4"), state)
    assert path == tmp_path / "models" / "checkpoint_epoch_4.pt"
    assert sorted(p.name for p in path.parent.iterdir()) == ["checkpoint_epoch_4.pt"]
    back = checkpoints.load_checkpoint(exp.checkpoint_path("checkpoint_epoch_4.pt"))
    assert back["epoch"] == 4 and back["step"] == 17 and back["opt_state"]["count"] == 3
    torch.testing.assert_close(back["params"]["w"], state["params"]["w"], rtol=0, atol=0)


def test_missing_checkpoint_raises_naming_the_path(tmp_path):
    with pytest.raises(FileNotFoundError, match="nope.pt"):
        checkpoints.load_checkpoint(Experiment(tmp_path).checkpoint_path("nope"))
