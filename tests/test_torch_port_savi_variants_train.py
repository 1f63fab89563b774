"""One 02 training step of the SAVi variants of
``test_torch_port_savi_variants.py`` (the ResNet encoder; BatchNorm and
downsampling encoder, BatchNorm and upsampling decoder) against the JAX
package's step on the CPU.

The JAX side is ``DecompTrainer``'s forward with ``train=True`` (BatchNorm
on the batch's statistics, ``batch_stats`` mutable), its ``mse`` on clipped
frames, ``value_and_grad``; the port's model in ``train()`` with the JAX
slot noise. Loss rtol 1e-5; every gradient leaf within ``GRAD_LIMIT`` of its
largest value, that scale floored at a thousandth of the largest gradient of
any leaf. The conv biases before a training-mode BatchNorm, ``to_q.bias``
and ``norm_slot.bias`` have a gradient of 0 in exact arithmetic, rounding
noise on both sides: they are held to 1e-4 of the largest gradient of any
leaf (ROADMAP.md's traps). The running statistics after the step rtol 1e-5,
atol 1e-6. Under ``tpu.remat`` the port's step gives the
same gradients (1e-5 of the largest, the limit ``chip_smoke.py`` holds the
02 step's remat to) and moves the statistics once.

``GRAD_LIMIT`` is 1e-4 of a leaf's largest value, as the stock SAVi's 02
parity, but 3e-4 for ``bn_up``: a training-mode BatchNorm after each
decoder-tail conv takes away the conv's common offset, and with it most of
its value, so the float32 rounding of ``conv5_plain``'s 25 accumulated taps
(the CPU path of the tail) weighs more. Measured against the step in float64:
the port 1.07e-4 of the worst leaf's largest value, JAX (XLA's conv) 1.4e-5;
with ``F.conv2d`` in place of ``conv5_plain`` the port is at 3.6e-5.

The ResNet's 33 ReLUs see a million pre-activations a step, and the two
packages' float32 sums put a few of them on the other side of 0 (ROADMAP.md's
ReLU-mask trap): each such element sends its whole gradient elsewhere, and a
single one moved a GroupNorm bias's gradient by 2e-2 of its largest value.
So the JAX step replays the port's masks of the encoder's ReLUs (``jax.nn``'s
``relu`` replaced, in the JAX encoder's module only, by a ``where`` on the
port's mask), as the card-against-CPU parities of ``chip_smoke.py`` replay
the card's; the port runs on its own.
"""

import torch_cpu_threads  # noqa: F401  (two torch threads a worker)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_savi_variants import VARIANTS, jax_variables, variant_params
from test_torch_port_train_savi import LOSS, _jax_noise

from textocvp_tpu.core.config import build_exp_params as jax_build_exp_params
from textocvp_tpu.nn import encoders as jax_encoders
from textocvp_tpu.models import setup_model as jax_setup_model
from textocvp_tpu.train.losses import build_loss_fn as jax_build_loss_fn
from textocvp_tpu_torch.convert import convert_batch_stats, from_jax_params
from textocvp_tpu_torch.core.config import build_exp_params
from textocvp_tpu_torch.core.experiment import Experiment
from textocvp_tpu_torch.models import setup_model
from textocvp_tpu_torch.nn import encoders as port_encoders
from textocvp_tpu_torch.train.losses import build_loss_fn
from textocvp_tpu_torch.train.trainer import DecompTrainer

B, T, RES = 2, 3, 16
GRAD_LIMIT = {"resnet": 1e-4, "bn_up": 3e-4}


class _WithRelu:
    """``module``'s attributes, but ``relu``."""

    def __init__(self, module, relu):
        self._module, self.relu = module, relu

    def __getattr__(self, name):
        return getattr(self._module, name)


def _encoder_masks(variables, video) -> list:
    """The port's masks (pre-activation > 0) of its ResNet's ReLUs, in call
    order, NHWC, on the frames of ``video`` with the JAX weights."""
    import torch.nn.functional as F

    model = setup_model(variant_params(build_exp_params, "resnet"))
    model.load_state_dict(from_jax_params("savi", variables["params"]))
    masks = []

    def relu(x):
        masks.append((x > 0).permute(0, 2, 3, 1).numpy())
        return F.relu(x)

    frames = torch.from_numpy(video.reshape(-1, *video.shape[2:]))
    encoders_f = port_encoders.F
    port_encoders.F = _WithRelu(F, relu)
    try:
        with torch.no_grad():
            model.image_encoder(frames.permute(0, 3, 1, 2))
    finally:
        port_encoders.F = encoders_f
    return masks


@pytest.fixture(scope="module", params=VARIANTS)
def step_case(request):
    variant = request.param
    rng = np.random.default_rng(8)
    video = rng.uniform(0, 1, (B, T, RES, RES, 3)).astype(np.float32)
    jmodel = jax_setup_model(variant_params(jax_build_exp_params, variant))
    variables = jax_variables(jmodel, video, rng)
    key = jax.random.PRNGKey(9)
    noise = _jax_noise(jmodel, variables, B, key)
    loss_fn = jax_build_loss_fn(LOSS)
    stats = variables.get("batch_stats")

    def loss_of(p):
        if stats is None:
            out, moved = jmodel.apply({"params": p}, jnp.asarray(video), train=True,
                                      rngs={"slots": key}), None
        else:
            out, mut = jmodel.apply({"params": p, "batch_stats": stats}, jnp.asarray(video),
                                    train=True, rngs={"slots": key}, mutable=["batch_stats"])
            moved = mut["batch_stats"]
        total = loss_fn(pred_imgs=jnp.clip(out["recons_imgs"], 0, 1),
                        target_imgs=jnp.clip(jnp.asarray(video), 0, 1))[0]
        return total, moved

    jax_nn = jax_encoders.nn
    if variant == "resnet":  # the port's masks, in the order the encoder calls relu
        masks = iter(_encoder_masks(variables, video))
        jax_encoders.nn = _WithRelu(jax_nn, lambda x: jnp.where(next(masks), x, 0))
    try:
        (loss, moved), grads = jax.jit(jax.value_and_grad(loss_of, has_aux=True))(
            variables["params"])
    finally:
        jax_encoders.nn = jax_nn
    return {"variant": variant, "variables": variables, "video": video, "noise": noise,
            "loss": float(loss), "grads": jax.device_get(grads),
            "moved": None if moved is None else jax.device_get(moved)}


def _port_model(case):
    model = setup_model(variant_params(build_exp_params, case["variant"])).train()
    model.load_state_dict(from_jax_params("savi", case["variables"]["params"],
                                          batch_stats=case["variables"].get("batch_stats")))
    return model


def _port_loss(model, case):
    video = torch.from_numpy(case["video"])
    out = model(video, noise=torch.from_numpy(case["noise"]))
    return build_loss_fn(LOSS)(pred_imgs=out["recons_imgs"].clamp(0, 1),
                               target_imgs=video.clamp(0, 1))[0]


def test_02_step_matches_jax(step_case):
    model = _port_model(step_case)
    loss = _port_loss(model, step_case)
    np.testing.assert_allclose(float(loss), step_case["loss"], rtol=1e-5)
    loss.backward()
    want = from_jax_params("savi", step_case["grads"])
    named = dict(model.named_parameters())
    assert set(want) == set(named)
    largest = max(g.abs().max().item() for g in want.values())
    modules = dict(model.named_modules())
    for name, g in want.items():
        err = (named[name].grad - g).abs().max().item()
        owner = name.rsplit(".", 2)[0]
        if name.endswith(("to_q.bias", "norm_slot.bias")) or (
                name.endswith("conv.bias") and getattr(modules[owner], "bn", None) is not None):
            assert err <= 1e-4 * largest, (name, err)  # exactly 0 in exact arithmetic
        else:
            scale = max(g.abs().max().item(), 1e-3 * largest)
            assert err <= GRAD_LIMIT[step_case["variant"]] * scale, (name, err)
    if step_case["moved"] is not None:
        state = model.state_dict()
        for key, value in convert_batch_stats(step_case["moved"]).items():
            if not key.endswith("num_batches_tracked"):
                np.testing.assert_allclose(state[key].numpy(), value.numpy(), rtol=1e-5,
                                           atol=1e-6, err_msg=key)


def test_remat_step_equals_the_plain_step(step_case, tmp_path):
    """``tpu.remat``: the decode of a BatchNorm decoder is one region (its
    statistics span every frame), so the gradients are the plain step's."""
    exp = Experiment(tmp_path / "exp")
    params = variant_params(build_exp_params, step_case["variant"])
    params["tpu"] = {"remat": True}
    exp.save_params(params)
    tr = DecompTrainer(exp.exp_path, device="cpu")
    tr.model.load_state_dict(_port_model(step_case).state_dict())
    tr.model.train()
    total, _ = tr.forward_loss(torch.from_numpy(step_case["video"]),
                               torch.from_numpy(step_case["noise"]))
    total.backward()
    plain = _port_model(step_case)
    _port_loss(plain, step_case).backward()
    grads = {n: p.grad for n, p in plain.named_parameters()}
    largest = max(g.abs().max().item() for g in grads.values())
    for name, p in tr.model.named_parameters():
        assert (p.grad - grads[name]).abs().max().item() <= 1e-5 * largest, name
    for name, buf in plain.named_buffers():  # the statistics moved once, in the forward
        torch.testing.assert_close(dict(tr.model.named_buffers())[name], buf, rtol=1e-6,
                                   atol=1e-7, msg=name)
