"""Inference over the port's mesh in gloo process groups
(``tests/torch_dist_worker.py``): the service (``PredictionService(mesh_axes=
...)``) at ``data=2``, at ``(data 2, model 2)`` on 4 ranks, and at batch 1
under sequence-parallel decode, against the single-process service from the
same generator state; its refusal to export; then the 03 and 05 evaluators
at world size 2 over a dataset whose last batch is ragged, against world
size 1, with one ``results.json``.

Replies are compared as float frames (``torch_dist_worker.float_frames_``
on every rank and on the single-process service): the uint8 reply rounds,
and a float difference of 1e-7 next to a rounding edge is a whole 1/255.
The ``data=2`` service is also held to the uint8 reply bit for bit."""

import torch_cpu_threads  # noqa: F401  (two torch threads a worker)
import json

import numpy as np
import pytest
import torch
from test_torch_port_batching import CAPTIONS, _frames
from test_torch_port_evaluator import _tiny_params as tiny_eval_params
from test_torch_port_evaluator import write_cater_npy
from test_torch_port_mesh import run_ranks
from test_torch_port_service import MAX_TOKENS, _tiny_params
from torch_dist_worker import float_frames_

from textocvp_tpu_torch.core.experiment import Experiment
from textocvp_tpu_torch.models import setup_model, setup_predictor
from textocvp_tpu_torch.models.factory import random_init_
from textocvp_tpu_torch.serve import PredictionService
from textocvp_tpu_torch.train.evaluator import DecompEvaluator, PredictorEvaluator

SERVES = {  # name: (mesh axes, service batch, request rows, float reply, world)
    "data2": ({"data": 2, "model": 1}, 4, [4, 3], True, 2),
    "data2_uint8": ({"data": 2, "model": 1}, 4, [4], False, 2),
    "seq_parallel": ({"data": 2, "model": 1}, 1, [1], True, 2),
    "data2_model2": ({"data": 2, "model": 2}, 4, [4, 2], True, 4),
    "model2_seq_parallel": ({"data": 2, "model": 2}, 1, [1], True, 4),
}
NUM_PREDS, EVAL_BATCH = 3, 4  # 5 videos: a batch of 4, then a ragged one of 1


def _write(root, params, pred_params, gen):
    for p in (params, pred_params):
        p["model"]["model_params"]["initializer"] = "LearnedRandom"
    model = random_init_(setup_model(params), gen)
    predictor = random_init_(setup_predictor(pred_params), gen)
    with torch.no_grad():  # a gentle rollout: slots of order 1 over the steps
        predictor.predictor.mlp_out.weight.mul_(0.02)
    parent = Experiment(root)
    parent.save_params(params)
    pred = Experiment(root / "predictors" / "tiny_t5")
    pred.save_params(pred_params)
    for exp, module in ((parent, model), (pred, predictor)):
        exp.models_dir.mkdir(parents=True, exist_ok=True)
        torch.save(module.state_dict(), exp.checkpoint_path("ckpt"))
    return root


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist_serve")
    serve_exp = _write(tmp / "serve", *_tiny_params("SAVi"), torch.Generator().manual_seed(5))
    eval_exp = _write(tmp / "eval", *tiny_eval_params(write_cater_npy(tmp / "CATER")),
                      torch.Generator().manual_seed(6))
    np.savez(tmp / "inputs.npz", frames=_frames(11, 4),
             state=torch.Generator().manual_seed(14).get_state().numpy())
    jobs = {2: [], 4: []}
    names = {2: [], 4: []}
    for name, (axes, batch, rows, float_reply, world) in SERVES.items():
        jobs[world].append({"job": "serve", "exp": str(serve_exp), "batch": batch,
                            "max_tokens": MAX_TOKENS, "mesh_axes": axes, "rows": rows,
                            "captions": CAPTIONS, "float_reply": float_reply,
                            "inputs": str(tmp / "inputs.npz")})
        names[world].append(name)
    for kind in ("03", "05"):
        jobs[2].append({"job": "eval", "kind": kind, "exp": str(eval_exp), "batch": EVAL_BATCH,
                        "num_preds": NUM_PREDS, "results": f"mesh_{kind}"})
        names[2].append(kind)
    out = {}
    for world in (2, 4):
        out.update(zip(names[world], run_ranks(tmp / f"w{world}", jobs[world], world)))
    return {"serve_exp": serve_exp, "eval_exp": eval_exp, "inputs": tmp / "inputs.npz",
            **out}


def _single_process(runs, batch, rows, float_reply):
    svc = PredictionService(runs["serve_exp"], "tiny_t5", "ckpt", "ckpt", batch_size=batch,
                            max_tokens=MAX_TOKENS, device="cpu")
    if float_reply:
        float_frames_(svc)
    d = np.load(runs["inputs"])
    svc.generator.set_state(torch.from_numpy(d["state"]))
    return [svc.predict(d["frames"][:r], CAPTIONS[:r]) for r in rows]


@pytest.mark.parametrize("name", list(SERVES))
def test_mesh_service_matches_the_single_process_service(runs, name):
    axes, batch, rows, float_reply, world = SERVES[name]
    ranks = runs[name]
    assert bool(ranks[0]["seq_parallel"]) == (batch < axes["data"])
    want = _single_process(runs, batch, rows, float_reply)
    tol = 1e-5 if axes["model"] == 1 else 1e-4
    for i, ref in enumerate(want):
        got = ranks[0][f"reply{i}"]
        assert got.shape == ref.shape == (rows[i], NUM_PREDS, 16, 16, 3)
        if float_reply:
            assert float(np.abs(got - ref).max()) <= tol * float(np.abs(ref).max()), name
        else:
            np.testing.assert_array_equal(got, ref)
    assert "single-process by design" in str(ranks[0]["export_error"])
    assert all("reply0" not in out for out in ranks[1:])  # the followers answer nobody


@pytest.mark.parametrize("kind", ["03", "05"])
def test_mesh_evaluators_equal_world1_with_a_ragged_batch(runs, kind):
    exp = runs["eval_exp"]
    if kind == "03":
        ev = DecompEvaluator(exp, "ckpt", batch_size=EVAL_BATCH, results_name="w1_03",
                             device="cpu")
        ev.load_data()
        ev.load_model()
        results_dir = Experiment(exp).results_dir
    else:
        ev = PredictorEvaluator(exp, "tiny_t5", "ckpt", "ckpt", num_seed=1, num_preds=NUM_PREDS,
                                batch_size=EVAL_BATCH, results_name="w1_05", device="cpu")
        ev.load_data()
        ev.load_models()
        results_dir = Experiment(exp / "predictors" / "tiny_t5").results_dir
    assert [len(v) for v, _ in ev.test_loader] == [EVAL_BATCH, 1]
    want = ev.evaluate()
    got = json.loads((results_dir(f"mesh_{kind}") / "results.json").read_text())
    assert set(got) == set(want)
    for metric, vals in want.items():
        if isinstance(vals, dict):
            np.testing.assert_allclose(got[metric]["framewise"], vals["framewise"], rtol=1e-5,
                                       atol=1e-6, err_msg=metric)
            np.testing.assert_allclose(got[metric]["mean"], vals["mean"], rtol=1e-5)
    for out in runs[kind]:  # every rank aggregates the whole set
        np.testing.assert_allclose(out["psnr"], want["psnr"]["framewise"], rtol=1e-5)
