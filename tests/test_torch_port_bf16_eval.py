"""``tpu.compute_dtype: "bfloat16"`` end to end on the CPU: the port's 05
evaluator and its live service on one tiny CATER experiment (SAVi with
``Learned`` slots + TextOCVP_T5), each against the JAX package's bf16 and
float32 runs of the same checkpoint (the evaluator also on two gloo ranks at
``data=2``), and its evaluator, service and trainers built in bf16 on a
(stubbed) mesh of two ranks.

The experiment's predictor params carry ``"tpu": {"compute_dtype": ...,
"use_pallas": true}`` (the port ignores ``use_pallas``: it always follows the
Pallas arm); the JAX sides run under ``pltpu.force_tpu_interpret_mode()``.
The rule is ``tests/torch_bf16.py``'s, on the framewise metrics of 05 and on
the service's reply in levels / 255 (the reply is uint8 by contract, rounded
from the bf16 frames as the JAX service rounds them), not bit for bit. The
reply checked is one predicted frame: further into the rollout this random
tiny model's masks flip between any two dtypes at a few pixels (the JAX
package's own bf16 and float32 replies differ there by up to 50 levels of
255), and a maximum over pixels then measures that flip, not the port.
"""

import torch_cpu_threads  # noqa: F401  (two torch threads a worker)
import copy
import json
import os
import warnings
from types import SimpleNamespace

os.environ.setdefault("HF_HUB_OFFLINE", "1")
os.environ.setdefault("TRANSFORMERS_OFFLINE", "1")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402
from test_torch_port_evaluator import (  # noqa: E402
    BATCH,
    CAPTIONS,
    NUM_PREDS,
    RES,
    _perturb,
    _tiny_params,
    write_cater_npy,
)
from test_torch_port_mesh import run_ranks  # noqa: E402
from torch_bf16 import check_bf16  # noqa: E402

from textocvp_tpu.models import factory as jax_factory  # noqa: E402
from textocvp_tpu.models import setup_model as jax_setup_model  # noqa: E402
from textocvp_tpu.models import setup_predictor as jax_setup_predictor  # noqa: E402
from textocvp_tpu.train.checkpoints import save_checkpoint  # noqa: E402
from textocvp_tpu.train.evaluator import PredictorEvaluator as JaxPredictorEvaluator  # noqa: E402
from textocvp_tpu_torch.convert import from_jax_params  # noqa: E402
from textocvp_tpu_torch.core.experiment import Experiment  # noqa: E402
from textocvp_tpu_torch.serve import pipeline  # noqa: E402
from textocvp_tpu_torch.serve.pipeline import PredictionService  # noqa: E402
from textocvp_tpu_torch.train import evaluator  # noqa: E402
from textocvp_tpu_torch.train import trainer as trainer_mod  # noqa: E402
from textocvp_tpu_torch.train.evaluator import PredictorEvaluator  # noqa: E402
from textocvp_tpu_torch.train.predictor_trainer import PredictorTrainer  # noqa: E402
from textocvp_tpu_torch.train.trainer import DecompTrainer  # noqa: E402

DTYPES = ("bfloat16", "float32")
REPLY_PREDS = 1  # the predicted frames of the service's reply (module docstring)


def _pred_name(dtype: str) -> str:
    return f"tiny_t5_{dtype}"


@pytest.fixture(scope="module")
def exp_dir(tmp_path_factory):
    """One tiny experiment, both packages' checkpoints; a predictor
    experiment in each compute dtype over the same weights."""
    root = tmp_path_factory.mktemp("bf16_eval")
    params, pred_params = _tiny_params(write_cater_npy(root / "CATER"))
    parent = Experiment(root / "exp")
    parent.save_params(params)
    rng = np.random.default_rng(33)
    mvars = jax_setup_model(params).init({"params": jax.random.PRNGKey(0)},
                                         jnp.zeros((1, 1, RES, RES, 3)), decode=True)
    mparams = _perturb(jax.device_get(mvars["params"]), rng)
    pvars = jax_setup_predictor(pred_params).init(
        {"params": jax.random.PRNGKey(1)}, jnp.zeros((1, 1, 4, 32)),
        caption_tokens=jnp.ones((1, 5), jnp.int32), attn_masks=jnp.ones((1, 5), jnp.int32))
    pparams = _perturb(jax.device_get(pvars["params"]), rng)
    save_checkpoint(parent.models_dir, "ckpt", {"params": mparams})
    torch.save(from_jax_params("savi", mparams), parent.checkpoint_path("ckpt"))
    for dt in DTYPES:
        pred = Experiment(root / "exp" / "predictors" / _pred_name(dt))
        pred.save_params({**copy.deepcopy(pred_params),
                          "tpu": {"compute_dtype": dt, "use_pallas": True}})
        save_checkpoint(pred.models_dir, "ckpt", {"params": pparams})
        torch.save(from_jax_params("predictor", pparams), pred.checkpoint_path("ckpt"))
    return root / "exp"


@pytest.fixture(scope="module")
def eval_runs(exp_dir):
    """The JAX evaluators' results in both dtypes and the port's at world
    size 1. The JAX evaluator shards its steps over the host's devices, and
    an interpret-mode Pallas call cannot be partitioned: it runs its XLA slot
    attention here (``use_pallas`` off), which refines in bf16 where the
    port casts to float32, so this holds the port to the JAX arm it does not
    follow, under the same rule."""
    refs, outs = {}, {}
    with pytest.MonkeyPatch.context() as mp, warnings.catch_warnings():
        mp.setattr(jax_factory, "_use_pallas", lambda exp_params: False)
        warnings.simplefilter("ignore")
        for dt in DTYPES:
            ref_ev = JaxPredictorEvaluator(exp_dir, _pred_name(dt), "ckpt", "ckpt", num_seed=1,
                                           num_preds=NUM_PREDS, results_name="jax")
            ref_ev.load_data()
            videos, others = next(iter(ref_ev.test_loader))
            ref_ev.load_models(videos, others)
            refs[dt] = ref_ev.evaluate()
            ev = PredictorEvaluator(exp_dir, _pred_name(dt), "ckpt", "ckpt", num_seed=1,
                                    num_preds=NUM_PREDS, results_name="torch", device="cpu")
            ev.load_data()
            ev.load_models()
            if dt == "bfloat16":
                assert ev.model.compute_dtype == ev.predictor.compute_dtype == torch.bfloat16
                videos, info = next(iter(ev.test_loader))
                frames = ev.decode_stage(ev.predict_stage(*ev.to_device(videos, info)))
                assert frames.dtype == torch.bfloat16
            outs[dt] = ev.evaluate()
    return {"jax": refs, "port": outs}


def check_metrics(port16: dict, port32: dict, runs: dict):
    """``tests/torch_bf16.py``'s rule on each metric's framewise values."""
    for m in ("psnr", "ssim", "lpips"):
        check_bf16(np.array(port16[m]["framewise"]), np.array(port32[m]["framewise"]),
                   np.array(runs["jax"]["bfloat16"][m]["framewise"]),
                   np.array(runs["jax"]["float32"][m]["framewise"]), m, dtype_checked=False)


def test_evaluator_bf16_matches_jax(eval_runs):
    check_metrics(eval_runs["port"]["bfloat16"], eval_runs["port"]["float32"], eval_runs)


def test_evaluator_bf16_at_data2_matches_jax(exp_dir, eval_runs, tmp_path):
    """The bf16 05 evaluator on a gloo mesh of two ranks at ``data=2``
    (``tests/torch_dist_worker.py``; each rank a row of every batch of
    ``BATCH``, the last batch ragged) against the JAX evaluators by the same
    rule, the port's float32 evaluator at world size 1 its float32."""
    job = {"job": "eval", "kind": "05", "exp": str(exp_dir), "pred": _pred_name("bfloat16"),
           "batch": BATCH, "num_preds": NUM_PREDS, "results": "data2"}
    (ranks,) = run_ranks(tmp_path / "w2", [job], 2)
    pred = Experiment(exp_dir / "predictors" / _pred_name("bfloat16"))
    got = json.loads((pred.results_dir("data2") / "results.json").read_text())
    check_metrics(got, eval_runs["port"]["float32"], eval_runs)
    for out in ranks:
        np.testing.assert_allclose(out["psnr"], got["psnr"]["framewise"], rtol=1e-6)


def _jax_frames(exp_dir, dt, frames, text):
    """The JAX bf16 or float32 prediction of ``frames`` (B, 1, H, W, 3) with
    the service's caption tensors, clipped and rounded to the uint8 grid in
    the compute dtype as the JAX service replies, in levels / 255."""
    pred = Experiment(exp_dir / "predictors" / _pred_name(dt))
    parent = Experiment(exp_dir)
    from textocvp_tpu.train.checkpoints import load_checkpoint as jax_load

    jmodel, jpred = jax_setup_model(pred.params), jax_setup_predictor(pred.params)
    mv = {"params": jax_load(parent.models_dir / "ckpt.msgpack")["params"]}
    pv = {"params": jax_load(pred.models_dir / "ckpt.msgpack")["params"]}

    def run(x):
        slots = jmodel.apply(mv, x, decode=False)["slot_history"]
        preds = jpred.apply(pv, slots, caption_tokens=text["caption_tokens"],
                            attn_masks=text["attn_masks"], num_preds=REPLY_PREDS)
        b, p, s, d = preds.shape
        imgs = jmodel.apply(mv, preds.reshape(b * p, s, d), method="decode")["recons_imgs"]
        imgs = jnp.round(jnp.clip(imgs, 0.0, 1.0) * 255.0).astype(jnp.uint8)
        return imgs.reshape(b, p, *imgs.shape[1:])

    with pltpu.force_tpu_interpret_mode():
        return np.asarray(jax.jit(run)(jnp.asarray(frames))).astype(np.float32) / 255.0


def test_service_reply_bf16_matches_jax(exp_dir):
    video = np.load(sorted((exp_dir.parent / "CATER" / "easy").glob("video_*.npy"))[0])
    frames = np.stack([video[:1], video[1:2]]).astype(np.float32) / 255.0  # (2, 1, H, W, 3)
    caps = CAPTIONS[:2]
    replies, refs = {}, {}
    for dt in DTYPES:
        service = PredictionService(exp_dir, _pred_name(dt), "ckpt", "ckpt", num_seed=1,
                                    num_preds=REPLY_PREDS, batch_size=2, device="cpu")
        assert service.compute_dtype == dt
        replies[dt] = service.predict(frames, caps)
        text = service._tokenize(caps)
        refs[dt] = _jax_frames(exp_dir, dt, frames, {k: jnp.asarray(v) for k, v in text.items()})
        if dt == "bfloat16":
            with torch.no_grad():
                slots = service.predict_module(torch.from_numpy(frames), None,
                                               {k: torch.from_numpy(v) for k, v in text.items()})
            assert slots.dtype == torch.bfloat16
    assert replies["bfloat16"].shape == (2, REPLY_PREDS, RES, RES, 3)
    check_bf16(replies["bfloat16"], replies["float32"], refs["bfloat16"], refs["float32"],
               "reply", dtype_checked=False)


# ------------------------------------------------------------------ bf16 on a mesh


def _bf16_experiment(exp_dir, tmp_path, **tpu):
    """A copy of the tiny experiment (parent and bf16 predictor) whose params
    compute in bf16, with ``tpu`` added."""
    parent = Experiment(tmp_path / "exp")
    params = Experiment(exp_dir).params
    parent.save_params({**params, "tpu": {"compute_dtype": "bfloat16", **tpu}})
    src = Experiment(exp_dir / "predictors" / _pred_name("bfloat16"))
    pred = Experiment(tmp_path / "exp" / "predictors" / "p")
    pred.save_params({**src.params, "tpu": {"compute_dtype": "bfloat16", **tpu}})
    for dst, src_exp in ((parent, Experiment(exp_dir)), (pred, src)):
        dst.models_dir.mkdir(parents=True, exist_ok=True)
        torch.save(torch.load(src_exp.checkpoint_path("ckpt")), dst.checkpoint_path("ckpt"))
    return parent, pred


def test_the_trainers_take_bf16_on_a_mesh(exp_dir, tmp_path, monkeypatch):
    """On a (stubbed) mesh of two ranks the 02 and 04 trainers build in bf16
    (``test_torch_port_bf16_mesh.py`` holds a bf16 step on gloo ranks)."""
    parent, pred = _bf16_experiment(exp_dir, tmp_path)
    mesh = SimpleNamespace(world=2, data=2, model=1, device=torch.device("cpu"))
    monkeypatch.setattr(trainer_mod, "get_runtime_mesh", lambda *a, **k: mesh)
    monkeypatch.setattr(trainer_mod, "maybe_initialize_distributed", lambda: None)
    for tr in (DecompTrainer(parent.exp_path, device="cpu"),
               PredictorTrainer(pred.exp_path, "ckpt", device="cpu")):
        assert tr.mesh is mesh


def test_bf16_on_a_mesh_of_more_than_one_rank_builds(exp_dir, monkeypatch):
    """The 05 evaluator and the service build in bf16 on a (stubbed) mesh of
    two ranks (``test_torch_port_bf16_mesh.py`` runs them on gloo ranks)."""
    mesh = SimpleNamespace(world=2, data=2, model=1, rank=0, backend="gloo",
                           tensor_parallel=False, device=torch.device("cpu"))
    monkeypatch.setattr(evaluator, "get_runtime_mesh", lambda *a, **k: mesh)
    monkeypatch.setattr(pipeline, "get_runtime_mesh", lambda *a, **k: mesh)
    monkeypatch.setattr(pipeline, "maybe_initialize_distributed", lambda: None)
    ev = PredictorEvaluator(exp_dir, _pred_name("bfloat16"), "ckpt", "ckpt", device="cpu")
    assert ev.mesh is mesh
    svc = PredictionService(exp_dir, _pred_name("bfloat16"), "ckpt", "ckpt", device="cpu",
                            mesh_axes={"data": 2})
    assert svc.mesh is mesh and svc.compute_dtype == "bfloat16"
