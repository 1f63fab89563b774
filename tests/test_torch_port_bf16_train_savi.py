"""The 02 step of SAVi in ``tpu.compute_dtype: "bfloat16"`` on the CPU,
against the JAX package's bf16 and float32 steps, and the trainer's
``tpu.remat`` and ``accum_steps`` in bf16.

* The JAX side: the tiny SAVi of ``test_torch_port_train_savi.py`` with
  ``"tpu": {"compute_dtype": ..., "use_pallas": true}`` under
  ``pltpu.force_tpu_interpret_mode()`` (the Pallas slot attention, whose
  port the kernel is, and its float32 recompute in the backward), its loss
  and gradients by ``jax.value_and_grad`` and two optax updates, all under
  ``jax.jit``; the same weights (the JAX init plus noise, carried by
  ``from_jax_params``), video and slot noise (drawn on the JAX side).
* The rule is ``tests/torch_bf16.py``'s, leaf by leaf on the gradients Adam
  reads (float32 on both sides: the casts' backward), and on the loss. Each
  leaf adds its spread: how far the port's bf16 gradient moves when the
  video moves by 2**-10 of itself, below one bf16 step (at this tiny random
  model, whose reconstructions lie mostly outside [0, 1], the step's
  gradient runs through few pixels, and such a move flips ReLU masks that
  move a leaf by up to a fifth of its largest value: the distance between
  any two bf16 steps that round in other orders). The loss's clip takes
  the port's bf16 decisions on every side (``clip_codes``). A leaf whose
  gradient is 0 in exact arithmetic (``to_q.bias`` and ``norm_slot.bias``:
  the softmax over slots does not see a shift common to every slot) is held
  with the largest leaf's scale.
* After two updates (the first at lr 0, as the 02 defaults' warmup makes
  it, the second at lr 1e-3) the parameters lie within 2 lr of JAX's bf16
  ones (Adam moves an element by about lr a step whatever its gradient's
  size); the loss falls on one batch.
* ``tpu.remat`` and ``accum_steps`` 2 in bf16: every leaf within
  2 e(bf16, float32) + 2**-8 of the plain bf16 step's, e over the float32
  step's largest value (remat sums the decode's weight gradient region by
  region, each region's rounded to bf16 once; the microbatches round
  theirs).
"""

import torch_cpu_threads  # noqa: F401  (two torch threads a worker)
import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from test_torch_port_train_savi import LOSS, STEP_TAIL, _jax_noise, tiny_savi_params
from torch_bf16 import STEP, check_bf16, e

from textocvp_tpu.core.config import build_exp_params as jax_build_exp_params
from textocvp_tpu.models import setup_model as jax_setup_model
from textocvp_tpu.train.losses import build_loss_fn as jax_build_loss_fn
from textocvp_tpu.train.schedulers import build_optimizer as jax_build_optimizer
from textocvp_tpu_torch.convert import from_jax_params
from textocvp_tpu_torch.core.config import build_exp_params
from textocvp_tpu_torch.core.experiment import Experiment
from textocvp_tpu_torch.models import setup_model
from textocvp_tpu_torch.train.losses import build_loss_fn, clip01
from textocvp_tpu_torch.train.schedulers import build_optimizer
from textocvp_tpu_torch.train.trainer import DecompTrainer

B, T, RES = 2, 3, 16
SEED = 5
DTYPES = ("bfloat16", "float32")
TRAINING = {"lr": 1e-3, "scheduler": "cosine_annealing", "scheduler_steps": 100,
            "lr_warmup": False, "warmup_steps": 0, "gradient_clipping": True,
            "clipping_max_value": 0.05}
# the two updates: the 02 defaults' warmup, whose first update runs at lr 0
# (optax's count), then lr: each side moves an element by at most about lr
SIGN_STEPS, SIGN_LR = 8, 1e-4  # the loss on one batch, warmup off
UPDATES = {**TRAINING, "lr_warmup": True, "warmup_steps": 1}
ZERO_GRAD = ("slot_attention.to_q.bias", "slot_attention.norm_slot.bias")


def with_dtype(params: dict, dtype: str, jax_side: bool) -> dict:
    params = copy.deepcopy(params)
    params["tpu"] = {"compute_dtype": dtype, **({"use_pallas": True} if jax_side else {})}
    return params


NUDGE = 1 + 2.0 ** -10  # an input change below one bf16 step (2**-8)


def check_leaves(port16: dict, port32: dict, jax16: dict, jax32: dict, nudged16: dict,
                 zero=()) -> dict:
    """The bf16 rule on every gradient leaf, each with its spread: its
    distance to ``nudged16``, the port's bf16 gradients of the same step on
    the input times NUDGE (``zero``: with the largest leaf's scale). Returns
    each leaf's distances."""
    assert set(port16) == set(port32) == set(jax16) == set(jax32) == set(nudged16)
    top = max(float(np.abs(np.asarray(g)).max()) for g in jax32.values())
    out = {}
    for name in jax32:
        scale = top if name in zero else float(np.abs(np.asarray(jax32[name])).max())
        out[name] = check_bf16(port16[name], port32[name], jax16[name], jax32[name], name,
                               dtype_checked=False, scale=top if name in zero else None,
                               spread=e(nudged16[name], port16[name], np.float32(scale)))
    return out


def clip_codes(x) -> np.ndarray:
    """The [0, 1] clip's gradient weight of each value of ``x``, doubled:
    2 inside, 1 at a bound (``clip01``, ``jnp.clip``), 0 outside."""
    x = torch.as_tensor(x)
    return (2 * ((x > 0) & (x < 1)) + ((x == 0) | (x == 1))).to(torch.uint8).numpy()


def port_model(case, dtype):
    model = setup_model(with_dtype(tiny_savi_params(build_exp_params, STEP_TAIL), dtype, False))
    model.load_state_dict(from_jax_params("savi", case["params"]))
    return model


def port_loss(model, video, noise, codes=None):
    """The 02 loss; with ``codes`` (``clip_codes``) the clip's gradient
    weights are those, the values the clip's."""
    x = model(torch.from_numpy(video), noise=torch.from_numpy(np.asarray(noise)))["recons_imgs"]
    if codes is None:
        pred = clip01(x)
    else:
        w = torch.from_numpy(codes).to(x.dtype) / 2
        pred = w * x + (1 - w) * clip01(x.detach())
    return build_loss_fn(LOSS)(pred_imgs=pred, target_imgs=clip01(torch.from_numpy(video)))[0]


@pytest.fixture(scope="module")
def jax_case():
    """Per dtype: the JAX loss and gradients of the first step (the loss's
    clip weighted as the port's bf16 step clips: ``clip_codes``), and the
    parameters after two optax updates, each step with its own noise."""
    rng = np.random.default_rng(SEED)
    video = rng.uniform(0, 1, (B, T, RES, RES, 3)).astype(np.float32)
    loss_fn = jax_build_loss_fn(LOSS)
    keys = [jax.random.PRNGKey(7), jax.random.PRNGKey(8)]
    out, case = {}, None
    for dt in DTYPES:
        jmodel = jax_setup_model(with_dtype(tiny_savi_params(jax_build_exp_params, STEP_TAIL), dt, True))
        with pltpu.force_tpu_interpret_mode():
            if case is None:
                init = jax.jit(lambda x: jmodel.init({"params": jax.random.PRNGKey(0),
                                                      "slots": jax.random.PRNGKey(1)}, x,
                                                     decode=True))(jnp.asarray(video))
                params0 = jax.tree_util.tree_map(
                    lambda x: np.asarray(x) + 0.05 * rng.standard_normal(np.shape(x)).astype(
                        np.float32), jax.device_get(init["params"]))
                noise = [_jax_noise(jmodel, {"params": params0}, B, k) for k in keys]
                case = {"video": video, "params": params0, "noise": noise}
                with torch.no_grad():
                    recons = port_model(case, "bfloat16")(
                        torch.from_numpy(video), noise=torch.from_numpy(noise[0]))["recons_imgs"]
                case["codes"] = clip_codes(recons.float())

            def loss_of(p, key, codes):
                """The loss, its clip weighted by ``codes`` (3: its own)."""
                x = jmodel.apply({"params": p}, jnp.asarray(video), rngs={"slots": key})[
                    "recons_imgs"]
                own = jnp.clip(x, 0, 1)
                w = (codes / 2).astype(x.dtype)
                pred = jnp.where(codes == 3, own, w * x + (1 - w) * jax.lax.stop_gradient(own))
                return loss_fn(pred_imgs=pred, target_imgs=jnp.clip(jnp.asarray(video), 0, 1))[0]

            tx, _ = jax_build_optimizer(UPDATES)

            @jax.jit
            def step(p, opt, key, codes):
                loss, grads = jax.value_and_grad(loss_of)(p, key, codes)
                updates, opt = tx.update(grads, opt, p)
                return optax.apply_updates(p, updates), opt, loss, grads

            # the first update runs at lr 0: p1 is the start, its moments the
            # replayed gradients'
            p1, opt, loss, grads = step(case["params"], tx.init(case["params"]), keys[0],
                                        case["codes"])
            p2, _, _, _ = step(p1, opt, keys[1], np.full_like(case["codes"], 3))
        out[dt] = {"loss": float(loss), "grads": jax.device_get(grads),
                   "params2": jax.device_get(p2)}
    return {**case, **out}


def test_the_02_step_matches_jax_bf16_loss_and_every_gradient_leaf(jax_case):
    losses, grads = {}, {}
    for dt, nudge in (("bfloat16", 1), ("float32", 1), ("nudged", NUDGE)):
        model = port_model(jax_case, "bfloat16" if dt == "nudged" else dt)
        loss = port_loss(model, jax_case["video"] * np.float32(nudge), jax_case["noise"][0],
                         jax_case["codes"])
        assert loss.dtype == torch.float32  # the losses compute in float32
        loss.backward()
        losses[dt] = loss.detach()
        grads[dt] = {n: p.grad for n, p in model.named_parameters()}
        assert all(g is not None and g.dtype == torch.float32 for g in grads[dt].values())
    check_bf16(losses["bfloat16"], losses["float32"], np.float32(jax_case["bfloat16"]["loss"]),
               np.float32(jax_case["float32"]["loss"]), "loss", dtype_checked=False)
    jax16, jax32 = (from_jax_params("savi", jax_case[dt]["grads"]) for dt in DTYPES)
    check_leaves(grads["bfloat16"], grads["float32"], jax16, jax32, grads["nudged"], ZERO_GRAD)


def test_two_bf16_updates_stay_within_2_lr_of_jax_and_the_loss_falls(jax_case, tmp_path):
    model = port_model(jax_case, "bfloat16")
    opt, _ = build_optimizer(UPDATES, model.parameters())
    for i in range(2):
        opt.zero_grad()
        port_loss(model, jax_case["video"], jax_case["noise"][i]).backward()
        opt.step()
    want = from_jax_params("savi", jax_case["bfloat16"]["params2"])
    for name, p in model.named_parameters():
        assert p.dtype == torch.float32
        assert (p.detach() - want[name]).abs().max() <= 2 * TRAINING["lr"], name
    # the trainer, on one batch and one noise draw
    params = with_dtype(tiny_savi_params(build_exp_params, STEP_TAIL), "bfloat16", False)
    params["training"].update(TRAINING, batch_size=B, lr=SIGN_LR)
    Experiment(tmp_path).save_params(params)
    tr = DecompTrainer(tmp_path, device="cpu")
    tr.setup_model()
    video = torch.from_numpy(jax_case["video"])
    noise = torch.from_numpy(np.asarray(jax_case["noise"][0]))
    losses = [float(tr.train_step(video, noise)["_total"]) for _ in range(SIGN_STEPS)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses


def _trainer_grads(root, dtype, **options):
    params = with_dtype(tiny_savi_params(build_exp_params, STEP_TAIL), dtype, False)
    params["training"].update(TRAINING, batch_size=B, accum_steps=options.pop("accum", 1))
    params["tpu"].update(options)
    Experiment(root).save_params(params)
    tr = DecompTrainer(root, device="cpu")
    tr.setup_model()
    g = torch.Generator().manual_seed(3)
    tr.backward(torch.rand((B, T, RES, RES, 3), generator=g), torch.randn((B, 4, 32), generator=g))
    return {n: p.grad.clone() for n, p in tr.model.named_parameters()}


@pytest.mark.parametrize("option", [{"remat": True}, {"accum": 2}], ids=["remat", "accum2"])
def test_remat_and_accumulation_in_bf16_match_the_plain_bf16_step(option, tmp_path):
    plain16 = _trainer_grads(tmp_path / "p16", "bfloat16")
    plain32 = _trainer_grads(tmp_path / "p32", "float32")
    got = _trainer_grads(tmp_path / "opt", "bfloat16", **option)
    top = max(g.abs().max().item() for g in plain32.values())
    for name, g in got.items():
        scale = top if name in ZERO_GRAD else plain32[name].abs().max().item()
        base = e(plain16[name], plain32[name], np.float32(scale))
        assert e(g, plain16[name], np.float32(scale)) <= 2 * base + STEP, (name, option)
