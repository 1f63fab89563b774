"""Data-parallel training of the port over a gloo process group of 2 ranks
(``train/trainer.py``'s mesh, ``tests/torch_dist_worker.py``): a 02 step and
a 04 step against the JAX package's step on a ``data=2`` mesh, at the port's
limits (losses 1e-5, gradients 1e-4 of each leaf's largest), and against the
port's own step at world size 1 (parameters within 1e-6 of the largest leaf,
bit-equal across the ranks); the slot noise is drawn on the JAX side for the
global batch and handed whole to every rank, which takes its rows. Then a
tiny ExtendedDINOSAUR 02 step, whose BatchNorm normalizes over the global
batch: its running statistics at world 2 within 1e-6 of world 1's."""

import torch_cpu_threads  # noqa: F401  (two torch threads a worker)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_mesh import run_ranks
from test_torch_port_train_dinosaur import tiny_params as tiny_dinosaur_params
from test_torch_port_train_predictor import (
    _perturb,
    jax_loss_fn,
    tiny_pred_params,
    write_pred_experiment,
)
from test_torch_port_train_savi import _jax_noise, tiny_savi_params

from textocvp_tpu.core.config import add_predictor_params as jax_add_predictor_params
from textocvp_tpu.core.config import build_exp_params as jax_build_exp_params
from textocvp_tpu.models import setup_model as jax_setup_model
from textocvp_tpu.models import setup_predictor as jax_setup_predictor
from textocvp_tpu.parallel.mesh import batch_sharding, get_mesh
from textocvp_tpu.train.losses import build_loss_fn as jax_build_loss_fn
from textocvp_tpu_torch.convert import from_jax_params
from textocvp_tpu_torch.core.config import add_predictor_params, build_exp_params
from textocvp_tpu_torch.core.experiment import Experiment
from textocvp_tpu_torch.train.predictor_trainer import PredictorTrainer
from textocvp_tpu_torch.train.trainer import DecompTrainer

B, T, RES = 4, 3, 16  # the global batch; two rows a rank
C, P, TOKENS = 1, 3, 7
TRAINING = {"lr": 1e-5, "scheduler": "cosine_annealing", "scheduler_steps": 100,
            "lr_warmup": False, "warmup_steps": 0, "gradient_clipping": True,
            "clipping_max_value": 0.05, "batch_size": B}


def _jax_mesh():
    return get_mesh(data=2, model=1, devices=jax.devices()[:2])


def _savi_case(tmp):
    """The JAX data-2 02 step of a tiny SAVi, and the port's experiment."""
    rng = np.random.default_rng(5)
    video = rng.uniform(0, 1, (B, T, RES, RES, 3)).astype(np.float32)
    jmodel = jax_setup_model(tiny_savi_params(jax_build_exp_params))
    init = jax.jit(lambda x: jmodel.init({"params": jax.random.PRNGKey(0),
                                          "slots": jax.random.PRNGKey(1)}, x, decode=True))(
        jnp.asarray(video))
    params = _perturb(jax.device_get(init["params"]), rng)
    key = jax.random.PRNGKey(7)
    noise = _jax_noise(jmodel, {"params": params}, B, key)
    loss_fn = jax_build_loss_fn([{"type": "mse", "weight": 1}])

    def loss_of(p, v):
        out = jmodel.apply({"params": p}, v, rngs={"slots": key})
        return loss_fn(pred_imgs=jnp.clip(out["recons_imgs"], 0, 1),
                       target_imgs=jnp.clip(v, 0, 1))[0]

    loss, grads = jax.jit(jax.value_and_grad(loss_of))(
        params, jax.device_put(video, batch_sharding(_jax_mesh())))
    p = tiny_savi_params(build_exp_params)
    p["training"].update(TRAINING)
    exp = Experiment(tmp / "savi")
    exp.save_params(p)
    weights = from_jax_params("savi", params)
    np.savez(tmp / "savi_weights.npz", **{k: v.numpy() for k, v in weights.items()})
    np.savez(tmp / "savi_inputs.npz", video=video, noise=noise)
    job = {"job": "train02", "exp": str(exp.exp_path), "weights": str(tmp / "savi_weights.npz"),
           "inputs": str(tmp / "savi_inputs.npz")}
    return {"job": job, "loss": float(loss), "grads": from_jax_params("savi", jax.device_get(grads)),
            "weights": weights, "video": video, "noise": noise}


def _predictor_case(tmp):
    """The JAX data-2 04 step of a tiny TextOCVP_T5 through the tiny SAVi."""
    rng = np.random.default_rng(6)
    video = rng.uniform(0, 1, (B, C + P, RES, RES, 3)).astype(np.float32)
    tokens = rng.integers(2, 32000, (B, TOKENS)).astype(np.int32)
    masks = np.ones((B, TOKENS), np.int32)
    masks[1, 4:] = tokens[1, 4:] = 0
    jdecomp = jax_setup_model(tiny_savi_params(jax_build_exp_params))
    mvars = jax.jit(lambda x: jdecomp.init({"params": jax.random.PRNGKey(0),
                                            "slots": jax.random.PRNGKey(1)}, x, decode=True))(
        jnp.asarray(video))
    mparams = _perturb(jax.device_get(mvars["params"]), rng)
    jp = tiny_pred_params(jax_build_exp_params, jax_add_predictor_params, 10)
    jpred = jax_setup_predictor(jp)
    pvars = jax.jit(lambda s, t, m: jpred.init({"params": jax.random.PRNGKey(3)}, s,
                                               caption_tokens=t, attn_masks=m))(
        jnp.zeros((1, C, 4, 32)), jnp.asarray(tokens[:1]), jnp.asarray(masks[:1]))
    pparams = _perturb(jax.device_get(pvars["params"]), rng)
    key = jax.random.PRNGKey(7)
    noise = _jax_noise(jdecomp, {"params": mparams}, B, key)
    put = lambda x: jax.device_put(x, batch_sharding(_jax_mesh()))  # noqa: E731
    case = {"jdecomp": jdecomp, "mparams": mparams, "jp": jp, "jpred": jpred,
            "pparams": pparams, "buffer": 10, "video": put(video), "tokens": put(tokens),
            "masks": put(masks)}
    (loss, _), grads = jax.jit(jax.value_and_grad(jax_loss_fn(case, False), has_aux=True))(
        pparams, key)
    exp = write_pred_experiment(tmp / "pred", {**case, "video": video}, False, **TRAINING)
    np.savez(tmp / "pred_inputs.npz", video=video, noise=noise, caption_tokens=tokens,
             attn_masks=masks)
    job = {"job": "train04", "exp": str(exp), "inputs": str(tmp / "pred_inputs.npz")}
    return {"job": job, "exp": exp, "loss": float(loss),
            "grads": from_jax_params("predictor", jax.device_get(grads)),
            "video": video, "noise": noise, "tokens": tokens, "masks": masks}


def _dinosaur_case(tmp):
    """A tiny ExtendedDINOSAUR experiment (random weights from the trainer's
    seeded init), a global batch and its noise."""
    p, _ = tiny_dinosaur_params(build_exp_params, add_predictor_params)
    p["training"].update(TRAINING)
    exp = Experiment(tmp / "dino")
    exp.save_params(p)
    rng = np.random.default_rng(8)
    mp = p["model"]["model_params"]
    img = p["dataset"]["img_size"][0]
    video = rng.uniform(0, 1, (B, 2, img, img, 3)).astype(np.float32)
    noise = rng.standard_normal((B, mp["num_slots"], mp["slot_dim"])).astype(np.float32)
    np.savez(tmp / "dino_inputs.npz", video=video, noise=noise)
    tr = DecompTrainer(exp.exp_path, device="cpu")
    tr.setup_model()
    np.savez(tmp / "dino_weights.npz", **{k: v.numpy() for k, v in tr.model.state_dict().items()})
    job = {"job": "train02", "exp": str(exp.exp_path), "weights": str(tmp / "dino_weights.npz"),
           "inputs": str(tmp / "dino_inputs.npz")}
    return {"job": job, "exp": exp.exp_path, "video": video, "noise": noise}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist_train")
    cases = {"savi": _savi_case(tmp), "pred": _predictor_case(tmp), "dino": _dinosaur_case(tmp)}
    outs = run_ranks(tmp / "ranks", [cases[k]["job"] for k in ("savi", "pred", "dino")], 2)
    return {k: (cases[k], out) for k, out in zip(("savi", "pred", "dino"), outs)}


def _world1_02(case):
    tr = DecompTrainer(case["job"]["exp"], device="cpu")
    tr.setup_model()
    with np.load(case["job"]["weights"]) as w:
        tr.model.load_state_dict({k: torch.from_numpy(w[k]) for k in w.files})
    values = tr.backward(torch.from_numpy(case["video"]), torch.from_numpy(case["noise"]))
    grads = {k: p.grad.clone() for k, p in tr.model.named_parameters() if p.grad is not None}
    tr.optimizer.step()
    return values, grads, tr.model.state_dict()


def _world1_04(case):
    tr = PredictorTrainer(case["exp"], "decomp", checkpoint="init", device="cpu")
    tr.setup_model()
    values = tr.backward(torch.from_numpy(case["video"]), torch.from_numpy(case["noise"]),
                         caption_tokens=torch.from_numpy(case["tokens"]),
                         attn_masks=torch.from_numpy(case["masks"]))
    grads = {k: p.grad.clone() for k, p in tr.model.named_parameters() if p.grad is not None}
    tr.optimizer.step()
    return values, grads, tr.model.state_dict()


def _assert_grads(got: dict, want: dict, rel=1e-4):
    floor = 1e-3 * max(float(np.abs(np.asarray(g)).max()) for g in want.values())
    for name, g in want.items():
        g = np.asarray(g)
        if f"grad/{name}" not in got:  # the frozen T5: no gradient in the port
            assert "text_encoder" in name and not np.any(g), name
            continue
        err = float(np.abs(got[f"grad/{name}"] - g).max())
        assert err <= rel * max(float(np.abs(g).max()), floor), (name, err)


def _assert_step(ranks, world1_params, rel=1e-6):
    """Parameters bit-equal across the ranks and within ``rel`` of the largest
    leaf of world 1's."""
    keys = [k for k in ranks[0] if k.startswith("param/")]
    for k in keys:
        np.testing.assert_array_equal(ranks[0][k], ranks[1][k], err_msg=k)
    largest = max(float(v.abs().max()) for v in world1_params.values() if v.is_floating_point())
    for k in keys:
        want = world1_params[k[len("param/"):]].numpy()
        assert float(np.abs(ranks[0][k] - want).max()) <= rel * largest, k


@pytest.mark.parametrize("kind", ["savi", "pred"], ids=["02_savi", "04_textocvp_t5"])
def test_data_parallel_step_matches_jax_data2_and_world1(runs, kind):
    case, ranks = runs[kind]
    for out in ranks:
        np.testing.assert_allclose(float(out["loss/_total"]), case["loss"], rtol=1e-5)
        _assert_grads(out, case["grads"])
    values, grads, params = (_world1_02 if kind == "savi" else _world1_04)(case)
    np.testing.assert_allclose(float(ranks[0]["loss/_total"]), float(values["_total"]),
                               rtol=1e-6)
    _assert_grads(ranks[0], {k: g.numpy() for k, g in grads.items()}, rel=1e-5)
    _assert_step(ranks, params)


def test_batchnorm_normalizes_over_the_global_batch(runs):
    """ExtendedDINOSAUR's CNN head in ``train()`` at world 2: the step's
    running statistics within 1e-6 of world 1's (the global batch's), its
    loss and parameters as world 1's."""
    case, ranks = runs["dino"]
    values, _, params = _world1_02(case)
    np.testing.assert_allclose(float(ranks[0]["loss/_total"]), float(values["_total"]),
                               rtol=1e-5)
    stats = [k for k in params if "running_" in k]
    assert stats
    for k in stats:
        for out in ranks:
            np.testing.assert_allclose(out[f"param/{k}"], params[k].numpy(), rtol=0,
                                       atol=1e-6, err_msg=k)
    for k in stats:  # they moved, from their initial values
        with np.load(case["job"]["weights"]) as w:
            assert not np.array_equal(w[k], params[k].numpy()), k
    _assert_step(ranks, params, rel=1e-5)
