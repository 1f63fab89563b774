"""ExtendedDINOSAUR served over the port's mesh (``PredictionService(mesh_axes=
...)``, ``tests/torch_dist_worker.py``), against the single-process service
from the same generator state (float frames, ``torch_dist_worker.
float_frames_``), with the tiny CLIPort experiment of
``test_torch_port_service.py`` (a 1-block ViT-S at 28 px):

* ``data=1, model=2``: the decomposition model sharded (``shard_decomp_``),
  replies within 1e-4 of their largest value, as the predictors' tensor
  parallelism is held;
* ``data=2, model=2`` at batch 1 on 4 ranks: sequence-parallel decode with
  the decoder sharded, the frames split over the data axis alone (1e-4);
* int8 (``tpu.decode_quant`` and ``tpu.encode_quant``) at ``data=2`` and at
  ``model=2``: no refusal, the calibrated scales one process's (bit for bit
  at ``data=2``; at ``model=2`` within 1e-6, as the sharded predictor's sums
  in another order reach the slots the decode calibrates on), the replies
  within 1e-3 of their largest value (under one int8 step, 1/127); the
  export still refused on a mesh;
* the 05 evaluator with ``tpu.decode_quant`` at ``data=2`` over a ragged
  CATER set: no refusal, its scales and framewise PSNR world 1's (scales bit
  for bit, PSNR rtol 1e-5)."""

import torch_cpu_threads  # noqa: F401  (two torch threads a worker)
import json

import numpy as np
import pytest
import torch
from test_torch_port_dist_serve import _write
from test_torch_port_evaluator import _tiny_params as tiny_eval_params
from test_torch_port_evaluator import write_cater_npy
from test_torch_port_mesh import run_ranks
from test_torch_port_service import CAPTIONS, DINO_RES, MAX_TOKENS, NUM_PREDS, _tiny_params
from torch_dist_worker import float_frames_

from textocvp_tpu_torch.core.experiment import Experiment
from textocvp_tpu_torch.serve import PredictionService
from textocvp_tpu_torch.train.evaluator import PredictorEvaluator

INT8 = {"decode_quant": "int8", "encode_quant": "int8"}
SERVES = {  # name: (mesh axes, int8, service batch, request rows, tolerance, world)
    "model2": ({"data": 1, "model": 2}, False, 2, [2, 1], 1e-4, 2),
    "int8_data2": ({"data": 2, "model": 1}, True, 2, [2], 1e-3, 2),
    "int8_model2": ({"data": 1, "model": 2}, True, 2, [2], 1e-3, 2),
    "model2_seq_parallel": ({"data": 2, "model": 2}, False, 1, [1], 1e-4, 4),
}
EVAL_BATCH = 4  # 5 videos: a batch of 4, then a ragged one of 1


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist_decomp_serve")
    exps = {}
    for name, tpu in (("float", None), ("int8", INT8)):
        params, pred_params = _tiny_params("ExtendedDINOSAUR")
        if tpu:
            pred_params["tpu"] = dict(tpu)
        exps[name] = _write(tmp / name, params, pred_params, torch.Generator().manual_seed(7))
    params, pred_params = tiny_eval_params(write_cater_npy(tmp / "CATER"))
    pred_params["tpu"] = {"decode_quant": "int8"}
    eval_exp = _write(tmp / "eval", params, pred_params, torch.Generator().manual_seed(8))
    frames = np.random.default_rng(16).random((2, 1, DINO_RES, DINO_RES, 3), np.float32)
    np.savez(tmp / "inputs.npz", frames=frames,
             state=torch.Generator().manual_seed(14).get_state().numpy())
    jobs, names = {2: [], 4: []}, {2: [], 4: []}
    for name, (axes, int8, batch, rows, _, world) in SERVES.items():
        jobs[world].append({"job": "serve", "exp": str(exps["int8" if int8 else "float"]),
                            "batch": batch, "max_tokens": MAX_TOKENS, "mesh_axes": axes,
                            "rows": rows, "captions": CAPTIONS, "float_reply": True,
                            "inputs": str(tmp / "inputs.npz")})
        names[world].append(name)
    jobs[2].append({"job": "eval", "kind": "05", "exp": str(eval_exp), "batch": EVAL_BATCH,
                    "num_preds": NUM_PREDS, "results": "mesh_int8"})
    names[2].append("eval")
    out = {"exps": exps, "eval_exp": eval_exp, "inputs": tmp / "inputs.npz"}
    for world in (2, 4):
        out.update(zip(names[world], run_ranks(tmp / f"w{world}", jobs[world], world)))
    return out


def _single_process(runs, int8, batch, rows):
    svc = float_frames_(PredictionService(runs["exps"]["int8" if int8 else "float"], "tiny_t5",
                                          "ckpt", "ckpt", batch_size=batch,
                                          max_tokens=MAX_TOKENS, device="cpu"))
    d = np.load(runs["inputs"])
    svc.generator.set_state(torch.from_numpy(d["state"]))
    return svc, [svc.predict(d["frames"][:r], CAPTIONS[:r]) for r in rows]


@pytest.mark.parametrize("name", list(SERVES))
def test_dinosaur_mesh_service_matches_the_single_process_service(runs, name):
    axes, int8, batch, rows, tol, _ = SERVES[name]
    ranks = runs[name]
    assert bool(ranks[0]["decomp_sharded"]) == (axes["model"] > 1)
    assert bool(ranks[0]["seq_parallel"]) == (batch < axes["data"])
    svc, want = _single_process(runs, int8, batch, rows)
    for i, ref in enumerate(want):
        got = ranks[0][f"reply{i}"]
        assert got.shape == ref.shape == (rows[i], NUM_PREDS, DINO_RES, DINO_RES, 3)
        assert float(np.abs(got - ref).max()) <= tol * float(np.abs(ref).max()), name
    if int8:  # under model=2 the rollout's sums, in another order, reach the decode's
        rtol = 0 if axes["model"] == 1 else 1e-6
        for key, module in (("quant_scales", svc.decode_module),
                            ("encode_scales", svc.predict_module)):
            np.testing.assert_allclose(ranks[0][key], getattr(module, key).numpy(), rtol=rtol,
                                       atol=0, err_msg=key)
    assert "single-process by design" in str(ranks[0]["export_error"])


def test_int8_05_evaluator_at_data2_equals_world1(runs):
    exp = runs["eval_exp"]
    ev = PredictorEvaluator(exp, "tiny_t5", "ckpt", "ckpt", num_seed=1, num_preds=NUM_PREDS,
                            batch_size=EVAL_BATCH, results_name="w1_int8", device="cpu")
    ev.load_data()
    ev.load_models()
    want = ev.evaluate()
    assert want["decode_quant"] == "int8"
    results = Experiment(exp / "predictors" / "tiny_t5").results_dir("mesh_int8")
    got = json.loads((results / "results.json").read_text())
    assert got["decode_quant"] == "int8"
    np.testing.assert_allclose(got["psnr"]["framewise"], want["psnr"]["framewise"], rtol=1e-5)
    for out in runs["eval"]:
        np.testing.assert_array_equal(out["dec_scales"], ev.decode_quant_scales.numpy())
