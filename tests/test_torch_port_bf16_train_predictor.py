"""The 04 step in ``tpu.compute_dtype: "bfloat16"`` on the CPU: TextOCVP_T5
(here) and OCVPSeq (``test_torch_port_bf16_train_predictors.py``) trained
through the frozen tiny SAVi, against the JAX package's bf16 and float32
steps, and the frozen weights left as they were.

* Sizes and weights: ``test_torch_port_train_predictor.py``'s tiny
  TextOCVP_T5 and ``test_torch_port_predictors.py``'s tiny OCVPSeq, c=1,
  p=3, B=2, through the tiny SAVi of ``test_torch_port_train_savi.py``; the
  JAX init plus noise on both sides, the slot noise drawn on the JAX side.
* The JAX side is ``test_torch_port_train_predictor.py::jax_loss_fn`` (the
  JAX ``PredictorTrainer``'s ``forward_loss``, line for line) with both
  models built in the dtype (``"use_pallas": true`` under
  ``pltpu.force_tpu_interpret_mode()``), one ``jax.value_and_grad`` under
  ``jax.jit``.
* The rule is ``tests/torch_bf16.py``'s on the loss and every trainable
  leaf, each leaf with its spread (``test_torch_port_bf16_train_savi.py``:
  the port's own bf16 gradient under a 2**-10 change of the video); the
  04 loss has no clip. An attention's key bias has a gradient of 0 in exact
  arithmetic and is held with the largest leaf's scale. The frozen SAVi and
  T5 get no gradient and are bit for bit after an update.
* The same bf16 step on two gloo ranks at ``model=2``, against the JAX bf16
  step with the predictor sharded on the ``(4, 2)`` mesh.
"""

import torch_cpu_threads  # noqa: F401  (two torch threads a worker)
import os
from pathlib import Path

os.environ.setdefault("HF_HUB_OFFLINE", "1")
os.environ.setdefault("TRANSFORMERS_OFFLINE", "1")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402
from test_torch_port_bf16_train_savi import NUDGE, check_leaves, with_dtype  # noqa: E402
from test_torch_port_predictors import captions  # noqa: E402
from test_torch_port_predictors import tiny_params as tiny_other_params  # noqa: E402
from test_torch_port_train_predictor import (  # noqa: E402
    TRAINING,
    _perturb,
    jax_loss_fn,
    tiny_pred_params,
)
from test_torch_port_train_savi import _jax_noise, tiny_savi_params  # noqa: E402
from test_torch_port_mesh import run_ranks  # noqa: E402
from torch_bf16 import check_bf16  # noqa: E402

from textocvp_tpu.core.config import add_predictor_params as jax_add_predictor_params  # noqa: E402
from textocvp_tpu.core.config import build_exp_params as jax_build_exp_params  # noqa: E402
from textocvp_tpu.models import setup_model as jax_setup_model  # noqa: E402
from textocvp_tpu.models import setup_predictor as jax_setup_predictor  # noqa: E402
from textocvp_tpu.parallel.mesh import get_mesh, replicated_sharding  # noqa: E402
from textocvp_tpu.parallel.partitioning import shard_predictor_params  # noqa: E402
from textocvp_tpu_torch.convert import from_jax_params  # noqa: E402
from textocvp_tpu_torch.core.config import add_predictor_params, build_exp_params  # noqa: E402
from textocvp_tpu_torch.core.experiment import Experiment  # noqa: E402
from textocvp_tpu_torch.train.checkpoints import save_checkpoint  # noqa: E402
from textocvp_tpu_torch.train.predictor_trainer import PredictorTrainer  # noqa: E402

B, C, P, RES, S, D, TOKENS = 2, 1, 3, 16, 4, 32, 7
DTYPES = ("bfloat16", "float32")
KEY_BIAS = "k.bias"


def predictor_params(build, add, name):
    if name == "TextOCVP_T5":
        return tiny_pred_params(build, add, buffer=2)
    return tiny_other_params(build, add, name, base=tiny_savi_params(build))


def text_of(name, rng):
    """The captions' arrays: random T5 ids with a padded row, or the
    CustomTokenizer's ids and lengths."""
    if name != "TextOCVP_T5":
        tokens, lengths = captions()
        return {"tokens": tokens, "lengths": lengths, "masks": None}
    tokens = rng.integers(2, 32000, (B, TOKENS)).astype(np.int32)
    masks = np.ones((B, TOKENS), np.int32)
    masks[1, 4:] = 0
    tokens[1, 4:] = 0
    return {"tokens": tokens, "masks": masks, "lengths": None}


def build_case(name: str) -> dict:
    """The JAX steps of predictor ``name`` in both dtypes, and their inputs."""
    rng = np.random.default_rng(5)
    video = rng.uniform(0, 1, (B, C + P, RES, RES, 3)).astype(np.float32)
    case, out = {"name": name, "video": video, **text_of(name, rng)}, {}
    for dt in DTYPES:
        jp = with_dtype(predictor_params(jax_build_exp_params, jax_add_predictor_params, name),
                        dt, True)
        jdecomp, jpred = jax_setup_model(jp), jax_setup_predictor(jp)
        with pltpu.force_tpu_interpret_mode():
            if "mparams" not in case:
                mvars = jax.jit(lambda x: jdecomp.init(
                    {"params": jax.random.PRNGKey(0), "slots": jax.random.PRNGKey(1)}, x,
                    decode=True))(jnp.asarray(video))
                case["mparams"] = _perturb(jax.device_get(mvars["params"]), rng)
                case["keys"] = [jax.random.PRNGKey(7)]
                case["noise"] = [_jax_noise(jdecomp, {"params": case["mparams"]}, B,
                                            case["keys"][0])]
                text = {k: jnp.asarray(case[v][:1]) for k, v in (
                    ("caption_tokens", "tokens"), ("caption_lengths", "lengths"),
                    ("attn_masks", "masks")) if case[v] is not None}
                pvars = jpred.init({"params": jax.random.PRNGKey(3)}, jnp.zeros((1, C, S, D)),
                                   **text)
                case["pparams"] = _perturb(jax.device_get(pvars["params"]), rng)
            fn = jax.jit(jax.value_and_grad(
                jax_loss_fn({**case, "jdecomp": jdecomp, "jpred": jpred, "jp": jp}, False),
                has_aux=True))
            (loss, values), grads = fn(case["pparams"], case["keys"][0])
        out[dt] = jax.device_get({"values": values, "grads": grads})
    return {**case, **out}


def write_experiment(root, case, dtype, **tpu) -> Path:
    """The tiny parent and predictor experiments of ``case`` in ``dtype``
    (``tpu`` added to the predictor's ``tpu`` params), the JAX weights as
    their checkpoints. Returns the predictor experiment's path."""
    params = with_dtype(predictor_params(build_exp_params, add_predictor_params, case["name"]),
                        dtype, False)
    params["tpu"].update(tpu)
    params["training"].update({**TRAINING, "batch_size": B})
    parent = Experiment(root / "exp")
    parent.save_params(tiny_savi_params(build_exp_params))
    pred = Experiment(root / "exp" / "predictors" / "tiny")
    pred.save_params(params)
    parent.models_dir.mkdir(parents=True)
    torch.save(from_jax_params("savi", case["mparams"]), parent.checkpoint_path("decomp"))
    save_checkpoint(pred.checkpoint_path("init"),
                    {"params": from_jax_params("predictor", case["pparams"])})
    return pred.exp_path


def port_trainer(root, case, dtype):
    tr = PredictorTrainer(write_experiment(root, case, dtype), "decomp", checkpoint="init",
                          device="cpu")
    tr.setup_model()
    return tr


@pytest.fixture(scope="module")
def jax_case():
    return build_case("TextOCVP_T5")


def test_the_04_step_matches_jax_bf16_and_leaves_the_frozen_weights(jax_case, tmp_path):
    check_step(jax_case, tmp_path)


def check_step(jax_case, tmp_path):
    """The port's bf16 and float32 04 steps against ``build_case``'s."""
    text = {k: torch.from_numpy(jax_case[v]) for k, v in (
        ("caption_tokens", "tokens"), ("caption_lengths", "lengths"), ("attn_masks", "masks"))
        if jax_case[v] is not None}
    noise = torch.from_numpy(np.asarray(jax_case["noise"][0]))
    values, grads = {}, {}
    for run, nudge in (("bfloat16", 1), ("float32", 1), ("nudged", NUDGE)):
        tr = port_trainer(tmp_path / run, jax_case, "bfloat16" if run == "nudged" else run)
        frozen = {k: v.clone() for k, v in tr.decomp_model.state_dict().items()}
        video = torch.from_numpy(jax_case["video"]) * nudge
        total, values[run] = tr.forward_loss(video, noise, **text)
        total.backward()
        named = dict(tr.model.named_parameters())
        t5 = {n for n in named if n.startswith("predictor.text_encoder.") and
              jax_case["name"] == "TextOCVP_T5"}
        assert t5 == {n for n, p in named.items() if not p.requires_grad}
        assert all(named[n].grad is None for n in t5)
        assert all(p.grad is None for p in tr.decomp_model.parameters())
        grads[run] = {n: p.grad for n, p in named.items() if p.requires_grad}
        if run == "bfloat16":
            before = {n: named[n].detach().clone() for n in t5}
            tr.optimizer.step()
            assert all(torch.equal(v, frozen[k]) for k, v in tr.decomp_model.state_dict().items())
            assert all(torch.equal(named[n], before[n]) for n in t5)
    for name in ("pred_img_mse", "pred_slot_mse", "_total"):
        check_bf16(values["bfloat16"][name], values["float32"][name],
                   np.float32(jax_case["bfloat16"]["values"][name]),
                   np.float32(jax_case["float32"]["values"][name]), name, dtype_checked=False)
    jax16, jax32 = ({n: g for n, g in from_jax_params("predictor", jax_case[dt]["grads"]).items()
                     if n in grads["bfloat16"]} for dt in DTYPES)
    zero = [n for n in jax32 if n.endswith(KEY_BIAS)]
    check_leaves(grads["bfloat16"], grads["float32"], jax16, jax32, grads["nudged"], zero)


@pytest.fixture(scope="module")
def jax_mesh_step(jax_case):
    """The JAX bf16 step with the predictor sharded on the JAX package's
    ``(4, 2)`` mesh (``shard_predictor_params``; the batch and the frozen
    SAVi replicated): its loss values and gradients. An interpret-mode
    Pallas call cannot be partitioned, so the frozen SAVi runs its XLA slot
    attention and conv here (``use_pallas`` off), as the JAX evaluators do
    in ``test_torch_port_bf16_eval.py``."""
    jp = with_dtype(predictor_params(jax_build_exp_params, jax_add_predictor_params,
                                     jax_case["name"]), "bfloat16", False)
    jdecomp, jpred = jax_setup_model(jp), jax_setup_predictor(jp)
    mesh = get_mesh(data=4, model=2)
    params = shard_predictor_params(
        jax.device_put(jax_case["pparams"], replicated_sharding(mesh)), mesh)
    assert any(not x.sharding.is_fully_replicated for x in jax.tree_util.tree_leaves(params))
    fn = jax.jit(jax.value_and_grad(
        jax_loss_fn({**jax_case, "jdecomp": jdecomp, "jpred": jpred, "jp": jp}, False),
        has_aux=True))
    with mesh:
        (_, values), grads = fn(params, jax_case["keys"][0])
    return jax.device_get({"values": values, "grads": grads})


def test_the_04_step_at_model2_matches_jax_bf16(jax_case, jax_mesh_step, tmp_path):
    """The bf16 step on a gloo mesh of two ranks at ``model=2``
    (``tests/torch_dist_worker.py``: the predictor's attention and MLPs
    sharded, a row layer's bf16 partials summed in float32 and rounded
    once), its loss and every trainable leaf gathered, against the JAX bf16
    step on the ``(4, 2)`` mesh and the JAX float32 step by the same rule:
    the port's float32 step at world size 1 its float32, its bf16 step at
    world size 1 on the nudged video each leaf's spread."""
    text = {"caption_tokens": torch.from_numpy(jax_case["tokens"]),
            "attn_masks": torch.from_numpy(jax_case["masks"])}
    noise = torch.from_numpy(np.asarray(jax_case["noise"][0]))
    values, grads = {}, {}
    for run, dtype, nudge in (("float32", "float32", 1), ("nudged", "bfloat16", NUDGE)):
        tr = port_trainer(tmp_path / run, jax_case, dtype)
        total, values[run] = tr.forward_loss(torch.from_numpy(jax_case["video"]) * nudge, noise,
                                             **text)
        total.backward()
        grads[run] = {n: p.grad for n, p in tr.model.named_parameters() if p.requires_grad}
    exp = write_experiment(tmp_path / "tp", jax_case, "bfloat16",
                           mesh_axes={"data": 1, "model": 2})
    np.savez(tmp_path / "inputs.npz", video=jax_case["video"], noise=noise.numpy(),
             **{k: v.numpy() for k, v in text.items()})
    job = {"job": "train04", "exp": str(exp), "inputs": str(tmp_path / "inputs.npz")}
    (ranks,) = run_ranks(tmp_path / "w2", [job], 2)
    assert any(".attn." in n for n in ranks[0]["sharded"])
    jax16, jax32 = ({n: g for n, g in from_jax_params("predictor", step["grads"]).items()
                     if n in grads["float32"]} for step in (jax_mesh_step, jax_case["float32"]))
    zero = [n for n in jax32 if n.endswith(KEY_BIAS)]
    for out in ranks:
        for name in ("pred_img_mse", "pred_slot_mse", "_total"):
            check_bf16(out[f"loss/{name}"], values["float32"][name],
                       np.float32(jax_mesh_step["values"][name]),
                       np.float32(jax_case["float32"]["values"][name]), name,
                       dtype_checked=False)
        tp = {n: torch.from_numpy(out[f"grad/{n}"]) for n in grads["float32"]}
        check_leaves(tp, grads["float32"], jax16, jax32, grads["nudged"], zero)
