"""Tensor parallelism of the port's predictors over gloo process groups
(``parallel/partitioning.py``, ``tests/torch_dist_worker.py``): TextOCVP
rollouts with the custom transformer and with T5 at ``(data 2, model 2)``
on 4 ranks against the JAX package's ``(4, 2)`` mesh (its
``tests/test_partitioning.py`` models and limits, rtol 2e-5, atol 1e-5);
then a 04 step at ``model=2`` on 2 ranks against the port's step at world
size 1 (losses 1e-5, gradients and the clip's global norm 1e-4, parameters
after the update 1e-6 of the largest leaf, replicated leaves bit-equal
across the ranks), whose checkpoint loads at world size 1 bit for bit."""

import torch_cpu_threads  # noqa: F401  (two torch threads a worker)
import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_mesh import run_ranks
from test_torch_port_train_predictor import tiny_pred_params
from test_torch_port_train_savi import tiny_savi_params

from textocvp_tpu.core.config import add_predictor_params as jax_add_predictor_params
from textocvp_tpu.core.config import build_exp_params as jax_build_exp_params
from textocvp_tpu.models import setup_predictor as jax_setup_predictor
from textocvp_tpu.parallel.mesh import batch_sharding, get_mesh, replicated_sharding
from textocvp_tpu.parallel.partitioning import shard_predictor_params
from textocvp_tpu_torch.convert import from_jax_params
from textocvp_tpu_torch.core.config import add_predictor_params, build_exp_params
from textocvp_tpu_torch.core.experiment import Experiment
from textocvp_tpu_torch.models import setup_model, setup_predictor
from textocvp_tpu_torch.models.factory import random_init_
from textocvp_tpu_torch.train.checkpoints import load_checkpoint, save_checkpoint
from textocvp_tpu_torch.train.predictor_trainer import PredictorTrainer

B, S, D = 4, 4, 16
ROLLOUTS = {  # name: (text encoder params, num_context, num_preds, text)
    "custom_tf": ({"input_dim": 16, "num_layers": 1, "num_heads": 2, "vocab_size": 30}, 1, 4),
    "t5": ({"vocab_size": 64, "d_model": 32, "d_kv": 16, "d_ff": 64, "num_layers": 2,
            "num_heads": 2}, 2, 3),
}


def _rollout_params(build, add, kind):
    tep, c, p = ROLLOUTS[kind]
    params = build("SAVi", "CATER_Easy")
    params["model"]["model_params"].update(num_slots=S, slot_dim=D)
    params = add(params, "TextOCVP_T5" if kind == "t5" else "TextOCVP_CustomTF")
    pr = params["predictor"]["predictor_params"]
    pr["predictor_params"].update(token_dim=32, n_heads=2, hidden_dim=64, num_layers=2,
                                  residual=True)
    pr["fusion_params"].update(num_heads=2, head_dim=16, mlp_size=64)
    pr["text_encoder_params"] = dict(tep)
    params["prediction_params"].update(num_context=c, num_preds=p, input_buffer_size=3,
                                       teacher_force=False)
    return params


def _rollout_case(tmp, kind):
    """The JAX rollout on the (4, 2) mesh with its predictor sharded, and the
    worker's job."""
    _, c, p = ROLLOUTS[kind]
    wrapper = jax_setup_predictor(_rollout_params(jax_build_exp_params, jax_add_predictor_params,
                                                  kind))
    hist = jax.random.normal(jax.random.PRNGKey(0), (B, c, S, D))
    tokens = np.asarray(jax.random.randint(jax.random.PRNGKey(2), (B, 6), 1, 30), np.int32)
    text = ({"caption_tokens": tokens, "attn_masks": np.ones((B, 6), np.int32)} if kind == "t5"
            else {"caption_tokens": tokens,
                  "caption_lengths": np.array([6, 4, 5, 6], np.int32)})
    params = wrapper.init(jax.random.PRNGKey(1), hist[:1],
                          **{k: v[:1] for k, v in text.items()})["params"]
    mesh = get_mesh(data=4, model=2)
    tp = shard_predictor_params(jax.device_put(params, replicated_sharding(mesh)), mesh)
    put = lambda x: jax.device_put(jnp.asarray(x), batch_sharding(mesh))  # noqa: E731
    with mesh:
        out = jax.jit(lambda v, h, t: wrapper.apply({"params": v}, h, **t))(
            tp, put(hist), {k: put(v) for k, v in text.items()})
    d = tmp / kind
    d.mkdir()
    (d / "params.json").write_text(json.dumps(
        _rollout_params(build_exp_params, add_predictor_params, kind)))
    weights = from_jax_params("predictor", jax.device_get(params))
    np.savez(d / "weights.npz", **{k: v.numpy() for k, v in weights.items()})
    np.savez(d / "inputs.npz", hist=np.asarray(hist), **text)
    job = {"job": "rollout", "data": 2, "model": 2, "params": str(d / "params.json"),
           "weights": str(d / "weights.npz"), "inputs": str(d / "inputs.npz"), "num_preds": p}
    return {"job": job, "jax": np.asarray(out)}


def _step_experiments(root):
    """A parent experiment with a tiny SAVi and two predictor experiments
    with one tiny TextOCVP_T5 (random weights), one on ``model=2``, one on
    the default mesh; a global batch of 4."""
    parent = Experiment(root / "exp")
    parent.save_params(tiny_savi_params(build_exp_params))
    parent.models_dir.mkdir(parents=True)
    gen = torch.Generator().manual_seed(11)
    decomp = random_init_(setup_model(tiny_savi_params(build_exp_params)), gen)
    torch.save(decomp.state_dict(), parent.checkpoint_path("decomp"))
    params = tiny_pred_params(build_exp_params, add_predictor_params, 4)
    params["training"].update(lr=1e-4, batch_size=B, warmup_steps=0, lr_warmup=False,
                              gradient_clipping=True, clipping_max_value=0.05)
    predictor = random_init_(setup_predictor(params), gen)
    paths = {}
    for name, axes in (("tp", {"data": 1, "model": 2}), ("w1", None)):
        exp = Experiment(root / "exp" / "predictors" / name)
        exp.save_params({**params, "tpu": {"mesh_axes": axes}} if axes else params)
        exp.models_dir.mkdir(parents=True)
        save_checkpoint(exp.checkpoint_path("init"), {"params": predictor.state_dict()})
        paths[name] = exp.exp_path
    rng = np.random.default_rng(12)
    inputs = {"video": rng.uniform(0, 1, (B, 4, 16, 16, 3)).astype(np.float32),
              "noise": rng.standard_normal((B, 4, 32)).astype(np.float32),
              "caption_tokens": rng.integers(2, 32000, (B, 7)).astype(np.int32),
              "attn_masks": np.ones((B, 7), np.int32)}
    inputs["attn_masks"][2, 5:] = inputs["caption_tokens"][2, 5:] = 0
    np.savez(root / "step_inputs.npz", **inputs)
    job = {"job": "train04", "exp": str(paths["tp"]), "inputs": str(root / "step_inputs.npz"),
           "checkpoint": "tp_ckpt"}
    return paths, inputs, job


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist_tp")
    rollouts = {kind: _rollout_case(tmp, kind) for kind in ROLLOUTS}
    four = run_ranks(tmp / "w4", [rollouts[k]["job"] for k in ROLLOUTS], 4)
    paths, inputs, job = _step_experiments(tmp)
    (two,) = run_ranks(tmp / "w2", [job], 2)
    return {"rollouts": {k: (rollouts[k], out) for k, out in zip(ROLLOUTS, four)},
            "step": (paths, inputs, two)}


@pytest.mark.parametrize("kind", list(ROLLOUTS))
def test_tp_rollout_matches_the_jax_4x2_mesh(runs, kind):
    case, ranks = runs["rollouts"][kind]
    for out in ranks:
        assert len(out["sharded"]) > 0
        np.testing.assert_allclose(out["pred"], case["jax"], rtol=2e-5, atol=1e-5)
    if kind == "t5":  # the text encoder's layers and its relative-position table shard too
        names = set(ranks[0]["sharded"])
        assert "predictor.text_encoder.layers.0.attn.relative_attention_bias.weight" in names
        assert "predictor.text_encoder.layers.1.wi.weight" in names


def _world1(paths, inputs):
    tr = PredictorTrainer(paths["w1"], "decomp", checkpoint="init", device="cpu")
    tr.setup_model()
    t = {k: torch.from_numpy(v) for k, v in inputs.items()}
    values = tr.backward(t["video"], t["noise"], caption_tokens=t["caption_tokens"],
                         attn_masks=t["attn_masks"])
    grads = {k: p.grad.clone() for k, p in tr.model.named_parameters() if p.grad is not None}
    norm = float(tr.optimizer.step()["grad_norm"])
    return values, grads, norm, tr


def test_tp_04_step_matches_world1_with_the_clip_norm(runs):
    paths, inputs, ranks = runs["step"]
    values, grads, norm, tr = _world1(paths, inputs)
    sharded = set(ranks[0]["sharded"])
    assert any("blocks.0.attn.q" in n for n in sharded)
    largest = max(float(g.abs().max()) for g in grads.values())
    for out in ranks:
        for k, v in values.items():
            np.testing.assert_allclose(float(out[f"loss/{k}"]), float(v), rtol=1e-5, err_msg=k)
        np.testing.assert_allclose(float(out["grad_norm"]), norm, rtol=1e-4)
        assert {k[5:] for k in out if k.startswith("grad/")} == set(grads)
        for k, g in grads.items():
            err = float(np.abs(out[f"grad/{k}"] - g.numpy()).max())
            assert err <= 1e-4 * largest, (k, err)
    state = tr.model.state_dict()
    biggest = max(float(v.abs().max()) for v in state.values())
    for k, v in state.items():
        for out in ranks:
            assert float(np.abs(out[f"param/{k}"] - v.numpy()).max()) <= 1e-6 * biggest, k
    for k in ranks[0]:  # this rank's own leaves: the replicated ones equal on both ranks
        if k.startswith("local/") and k[6:] not in sharded:
            np.testing.assert_array_equal(ranks[0][k], ranks[1][k], err_msg=k)
    for k in sharded:  # the shards differ and make up the whole
        assert not np.array_equal(ranks[0][f"local/{k}"], ranks[1][f"local/{k}"]), k


def test_tp_checkpoint_loads_at_world1_bit_for_bit(runs):
    paths, _, ranks = runs["step"]
    written = paths["tp"] / "models" / "tp_ckpt.pt"
    shutil.copy(written, paths["w1"] / "models" / "tp_ckpt.pt")
    state = load_checkpoint(written)
    for k, v in state["params"].items():
        np.testing.assert_array_equal(v.numpy(), ranks[0][f"param/{k}"], err_msg=k)
    tr = PredictorTrainer(paths["w1"], "decomp", checkpoint="tp_ckpt", resume_training=True,
                          device="cpu")
    tr.setup_model()  # a strict load of the gathered state, the moments at their full shapes
    for k, v in tr.model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), ranks[0][f"param/{k}"], err_msg=k)
    assert tr.optimizer.count == 1 and tr.start_epoch == 1
    assert all(m.shape == p.shape for m, p in zip(tr.optimizer.mu, tr.optimizer.params))
    assert any(torch.any(m != 0) for m in tr.optimizer.mu)
