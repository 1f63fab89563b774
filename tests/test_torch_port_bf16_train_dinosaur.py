"""The 02 step of ExtendedDINOSAUR in ``tpu.compute_dtype: "bfloat16"`` on the
CPU, against the JAX package's bf16 and float32 steps: the loss, every
gradient leaf, the CNN head's BatchNorm running statistics, and the frozen
ViT.

* Sizes and weights: the tiny ExtendedDINOSAUR of
  ``test_torch_port_train_dinosaur.py`` (img 42, a 3 x 3 grid of patches, 2
  ViT-S blocks, 3 ``LearnedRandom`` slots of 16, the MLP patch decoder and a
  4-block CNN head with BatchNorm in training mode), B=2, T=3; the JAX init
  plus noise and BatchNorm statistics off 0 and 1, carried by
  ``from_jax_params``; the slot noise drawn on the JAX side.
* The JAX side: ``"tpu": {"compute_dtype": ..., "use_pallas": true}`` under
  ``pltpu.force_tpu_interpret_mode()`` (the ViT's XLA arm, which rounds the
  probabilities to bf16 before P V as the flash arm and the port's kernel
  do; the ViT is frozen, out of the gradient), the 02 loss of
  the JAX ``DecompTrainer`` (``pred_feature_mse`` + ``mse`` on clipped
  inputs), one ``jax.value_and_grad`` under ``jax.jit`` with the
  statistics mutable.
* The rule is ``tests/torch_bf16.py``'s, with each leaf's spread (the port's
  bf16 gradient's move under a 2**-10 change of the video,
  ``test_torch_port_bf16_train_savi.py``); both clips of the loss take the
  port's bf16 decisions on every side. The CNN head's conv biases sit before
  a training-mode BatchNorm, so their gradient is 0 in exact arithmetic:
  they are held with the largest leaf's scale. The running statistics'
  moves in the step (float32 buffers, the statistics taken in float32 of
  bf16 activations, as flax takes them) are held to the same rule. The ViT stays frozen:
  no gradient, bit for bit after an update.
"""

import torch_cpu_threads  # noqa: F401  (two torch threads a worker)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from test_torch_port_bf16_train_savi import NUDGE, check_leaves, clip_codes, with_dtype
from test_torch_port_cliport import _perturb, _perturb_stats
from test_torch_port_train_dinosaur import ZERO_GRAD, tiny_params
from test_torch_port_train_savi import _jax_noise
from torch_bf16 import check_bf16

from textocvp_tpu.core.config import add_predictor_params as jax_add_predictor_params
from textocvp_tpu.core.config import build_exp_params as jax_build_exp_params
from textocvp_tpu.models import setup_model as jax_setup_model
from textocvp_tpu.train.losses import build_loss_fn as jax_build_loss_fn
from textocvp_tpu_torch.convert import convert_batch_stats, from_jax_params
from textocvp_tpu_torch.core.config import add_predictor_params, build_exp_params
from textocvp_tpu_torch.models import setup_model
from textocvp_tpu_torch.train.losses import build_loss_fn, clip01
from textocvp_tpu_torch.train.schedulers import build_optimizer

B, T, IMG = 2, 3, 42
DTYPES = ("bfloat16", "float32")
CLIPPED = (("preds_feats", "recons_feats"), ("pred_imgs", "recons_imgs"))


def _codes_clip(x, codes, clip, stop):
    """x's [0, 1] clip with the gradient weights ``codes`` / 2."""
    w = codes / 2
    return w * x + (1 - w) * stop(clip(x))


def port_loss(model, video, noise, codes):
    out = model(video, noise=noise)
    loss_fn = build_loss_fn(tiny_params(build_exp_params, add_predictor_params)[0]["loss"])
    tensors = {"target_imgs": clip01(video), "targets_feats": clip01(out["encoded_img_feats"])}
    for key, src in CLIPPED:
        x = out[src]
        tensors[key] = _codes_clip(x, torch.from_numpy(codes[key]).to(x.dtype), clip01,
                                   torch.Tensor.detach)
    return loss_fn(**tensors)


def port_model(case, dtype):
    tp, _ = tiny_params(build_exp_params, add_predictor_params)
    model = setup_model(with_dtype(tp, dtype, False)).train()
    model.load_state_dict(from_jax_params("dinosaur", case["params"], batch_stats=case["stats"]))
    return model


@pytest.fixture(scope="module")
def jax_case():
    rng = np.random.default_rng(5)
    video = rng.uniform(0, 1, (B, T, IMG, IMG, 3)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    out, case = {}, None
    for dt in DTYPES:
        jp, _ = tiny_params(jax_build_exp_params, jax_add_predictor_params)
        jmodel = jax_setup_model(with_dtype(jp, dt, True))
        loss_fn = jax_build_loss_fn(jp["loss"])
        with pltpu.force_tpu_interpret_mode():
            if case is None:
                variables = jax.jit(lambda x: jmodel.init(
                    {"params": jax.random.PRNGKey(0), "slots": jax.random.PRNGKey(1)}, x,
                    decode=True))(jnp.asarray(video[:1, :1]))
                case = {"video": video,
                        "params": _perturb(jax.device_get(variables["params"]), rng),
                        "stats": _perturb_stats(jax.device_get(variables["batch_stats"]), rng)}
                case["noise"] = _jax_noise(jmodel, {"params": case["params"]}, B, key)
                with torch.no_grad():
                    o = port_model(case, "bfloat16")(torch.from_numpy(video),
                                                     noise=torch.from_numpy(case["noise"]))
                case["codes"] = {k: clip_codes(o[src].float()) for k, src in CLIPPED}

            def loss_of(p, codes):
                o, mut = jmodel.apply({"params": p, "batch_stats": case["stats"]},
                                      jnp.asarray(video), train=True, rngs={"slots": key},
                                      mutable=["batch_stats"])
                tensors = {"target_imgs": jnp.clip(jnp.asarray(video), 0, 1),
                           "targets_feats": jnp.clip(o["encoded_img_feats"], 0, 1)}
                for k, src in CLIPPED:
                    x = o[src]
                    tensors[k] = _codes_clip(x, codes[k].astype(x.dtype),
                                             lambda y: jnp.clip(y, 0, 1), jax.lax.stop_gradient)
                total, values = loss_fn(**tensors)
                return total, (values, mut["batch_stats"])

            (_, (values, stats)), grads = jax.jit(jax.value_and_grad(loss_of, has_aux=True))(
                case["params"], {k: jnp.asarray(c) for k, c in case["codes"].items()})
        out[dt] = jax.device_get({"values": values, "grads": grads, "stats": stats})
    return {**case, **out}


def test_the_02_step_matches_jax_bf16_loss_leaves_and_statistics(jax_case, tmp_path):
    values, grads, buffers = {}, {}, {}
    video = torch.from_numpy(jax_case["video"])
    noise = torch.from_numpy(jax_case["noise"])
    for run, nudge in (("bfloat16", 1), ("float32", 1), ("nudged", NUDGE)):
        model = port_model(jax_case, "bfloat16" if run == "nudged" else run)
        vit = {k: v.clone() for k, v in model.image_encoder.state_dict().items()}
        total, values[run] = port_loss(model, video * nudge, noise, jax_case["codes"])
        total.backward()
        named = dict(model.named_parameters())
        assert all(named[n].grad is None for n in named if n.startswith("image_encoder."))
        grads[run] = {n: p.grad for n, p in named.items() if p.requires_grad}
        buffers[run] = {k: v for k, v in model.state_dict().items() if "running" in k}
        if run == "bfloat16":
            opt, _ = build_optimizer({"lr": 1e-3}, [p for p in named.values() if p.requires_grad])
            opt.step()
            assert all(torch.equal(v, vit[k]) for k, v in model.image_encoder.state_dict().items())
    for name in values["bfloat16"]:
        check_bf16(values["bfloat16"][name], values["float32"][name],
                   np.float32(jax_case["bfloat16"]["values"][name]),
                   np.float32(jax_case["float32"]["values"][name]), name, dtype_checked=False)
    jax16, jax32 = ({n: g for n, g in from_jax_params("dinosaur", jax_case[dt]["grads"]).items()
                     if not n.startswith("image_encoder.")} for dt in DTYPES)
    check_leaves(grads["bfloat16"], grads["float32"], jax16, jax32, grads["nudged"], ZERO_GRAD)
    # the statistics' moves: the running values less the start, 1 % of a batch's
    start = convert_batch_stats(jax_case["stats"])
    want16, want32 = (convert_batch_stats(jax_case[dt]["stats"]) for dt in DTYPES)
    for name, b in buffers["bfloat16"].items():
        assert b.dtype == torch.float32
        check_bf16(b - start[name], buffers["float32"][name] - start[name],
                   want16[name] - start[name], want32[name] - start[name], name,
                   dtype_checked=False)
