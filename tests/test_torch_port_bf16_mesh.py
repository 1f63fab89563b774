"""``tpu.compute_dtype: "bfloat16"`` on the port's mesh, over gloo process
groups (``tests/torch_dist_worker.py``), on the CPU at a small size:

* the row-parallel dense (``parallel/partitioning.py::RowParallelLinear``)
  at ``(data 2, model 2)`` on 4 ranks against a bf16 dot whose contraction
  the JAX package's ``(4, 2)`` mesh shards: bit for bit, on inputs whose
  float32 sums are exact in any order (multiples of 1/128 below 2^14/128),
  so that only the order of rounding can differ. XLA all-reduces the
  partial dots in float32 and rounds once after the sum; summing the
  partials rounded to bf16 (two roundings) gives other bits, which the test
  shows on the same inputs;
* TextOCVP_T5's rollout at ``(data 2, model 2)`` on 4 ranks against the JAX
  rollout on the ``(4, 2)`` mesh in bf16 and in float32
  (``tests/torch_bf16.py``'s rule; the port's float32 rollout at world
  size 1 as its own float32);
* the 05 evaluator at ``data=2`` on 2 ranks, over a dataset whose last batch
  is ragged, against the port's bf16 05 at world size 1: rows are
  independent, so the framewise metrics agree as float32's do (rtol 1e-5,
  atol 1e-6);
* a bf16 04 step at ``model=2`` on 2 ranks against the port's bf16 and
  float32 steps at world size 1 (``tests/torch_bf16.py``'s rule with the
  world-1 bf16 step as the bf16 reference: the losses, and every gradient
  leaf over the largest leaf's max |g|); the parameters stay float32.
"""

import torch_cpu_threads  # noqa: F401  (two torch threads a worker)
import copy
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P
from test_torch_port_dist_serve import EVAL_BATCH, NUM_PREDS, _write
from test_torch_port_dist_tp import B, ROLLOUTS, _rollout_params, _step_experiments
from test_torch_port_evaluator import _tiny_params as tiny_eval_params
from test_torch_port_evaluator import write_cater_npy
from test_torch_port_mesh import run_ranks
from torch_bf16 import check_bf16

from textocvp_tpu.core.config import add_predictor_params as jax_add_predictor_params
from textocvp_tpu.core.config import build_exp_params as jax_build_exp_params
from textocvp_tpu.models import setup_predictor as jax_setup_predictor
from textocvp_tpu.parallel.mesh import batch_sharding, get_mesh, replicated_sharding
from textocvp_tpu.parallel.partitioning import shard_predictor_params
from textocvp_tpu_torch.convert import from_jax_params
from textocvp_tpu_torch.core.config import add_predictor_params, build_exp_params
from textocvp_tpu_torch.core.experiment import Experiment
from textocvp_tpu_torch.models import setup_predictor
from textocvp_tpu_torch.train.evaluator import PredictorEvaluator
from textocvp_tpu_torch.train.predictor_trainer import PredictorTrainer

KIND = "t5"
ROW = (6, 64, 16)  # (M, K, N) of the row-parallel dense


def _with_dtype(params, dtype):
    params = copy.deepcopy(params)
    params["tpu"] = {**(params.get("tpu") or {}), "compute_dtype": dtype}
    return params


def _row_case(tmp):
    """Exact-sum bf16 inputs, the JAX mesh's sharded dot, and the worker's job."""
    m, k, n = ROW
    rng = np.random.default_rng(21)
    x = (rng.integers(-15, 16, (m, k)) / 8).astype(np.float32)
    w = (rng.integers(-15, 16, (k, n)) / 16).astype(np.float32)  # flax (in, out)
    mesh = get_mesh(data=4, model=2)
    xs = jax.device_put(jnp.asarray(x, jnp.bfloat16), NamedSharding(mesh, P(None, "model")))
    ws = jax.device_put(jnp.asarray(w, jnp.bfloat16), NamedSharding(mesh, P("model", None)))
    ref = jax.jit(jnp.dot, out_shardings=NamedSharding(mesh, P()))(xs, ws)
    np.savez(tmp / "row.npz", x=x, w=w.T.copy())
    return {"job": {"job": "row_bf16", "data": 2, "model": 2, "inputs": str(tmp / "row.npz")},
            "x": x, "w": w, "jax": np.asarray(ref.astype(jnp.float32))}


def _rollout_case(tmp):
    """The JAX rollout on the (4, 2) mesh in bf16 and float32, the port's
    float32 rollout at world size 1, and the worker's bf16 job."""
    _, c, p = ROLLOUTS[KIND]
    hist = jax.random.normal(jax.random.PRNGKey(0), (B, c, 4, 16))
    tokens = np.asarray(jax.random.randint(jax.random.PRNGKey(2), (B, 6), 1, 30), np.int32)
    text = {"caption_tokens": tokens, "attn_masks": np.ones((B, 6), np.int32)}
    mesh = get_mesh(data=4, model=2)
    put = lambda x: jax.device_put(jnp.asarray(x), batch_sharding(mesh))  # noqa: E731
    jax_out, params = {}, None
    for dt in ("bfloat16", "float32"):
        wrapper = jax_setup_predictor(_with_dtype(
            _rollout_params(jax_build_exp_params, jax_add_predictor_params, KIND), dt))
        if params is None:
            params = wrapper.init(jax.random.PRNGKey(1), hist[:1],
                                  **{k: v[:1] for k, v in text.items()})["params"]
        tp = shard_predictor_params(jax.device_put(params, replicated_sharding(mesh)), mesh)
        with mesh:
            jax_out[dt] = np.asarray(jax.jit(lambda v, h, t, w=wrapper: w.apply(
                {"params": v}, h, **t))(tp, put(hist), {k: put(v) for k, v in text.items()}
                                        ).astype(jnp.float32))
    weights = from_jax_params("predictor", jax.device_get(params))
    port_params = _rollout_params(build_exp_params, add_predictor_params, KIND)
    f32 = setup_predictor(port_params).eval()
    f32.load_state_dict(weights)
    with torch.no_grad():
        port_f32 = f32(torch.from_numpy(np.asarray(hist)), num_preds=p,
                       **{k: torch.from_numpy(v) for k, v in text.items()})
    d = tmp / "rollout"
    d.mkdir()
    (d / "params.json").write_text(json.dumps(_with_dtype(port_params, "bfloat16")))
    np.savez(d / "weights.npz", **{k: v.numpy() for k, v in weights.items()})
    np.savez(d / "inputs.npz", hist=np.asarray(hist), **text)
    job = {"job": "rollout", "data": 2, "model": 2, "params": str(d / "params.json"),
           "weights": str(d / "weights.npz"), "inputs": str(d / "inputs.npz"), "num_preds": p}
    return {"job": job, "jax": jax_out, "port_f32": port_f32.numpy()}


def _eval_case(tmp):
    """A tiny CATER 05 experiment whose predictor computes in bf16 on the
    default mesh (data over every rank)."""
    params, pred_params = tiny_eval_params(write_cater_npy(tmp / "CATER"))
    exp = _write(tmp / "eval", params, _with_dtype(pred_params, "bfloat16"),
                 torch.Generator().manual_seed(6))
    job = {"job": "eval", "kind": "05", "exp": str(exp), "batch": EVAL_BATCH,
           "num_preds": NUM_PREDS, "results": "mesh_05"}
    return {"exp": exp, "job": job}


def _step_case(tmp):
    """The 04 step experiments of ``test_torch_port_dist_tp.py`` in bf16 (and
    their float32 world-1 twin), and the worker's ``model=2`` job."""
    paths, inputs, job = _step_experiments(tmp)
    f32 = Experiment(tmp / "exp" / "predictors" / "w1_f32")
    f32.save_params(Experiment(paths["w1"]).params)
    f32.models_dir.mkdir(parents=True)
    torch.save(torch.load(Experiment(paths["w1"]).checkpoint_path("init")),
               f32.checkpoint_path("init"))
    for name in ("tp", "w1"):
        exp = Experiment(paths[name])
        exp.save_params(_with_dtype(exp.params, "bfloat16"))
    job = {**job, "checkpoint": None}
    return {"paths": {**paths, "w1_f32": f32.exp_path}, "inputs": inputs, "job": job}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("bf16_mesh")
    row, rollout = _row_case(tmp), _rollout_case(tmp)
    row_out, rollout_out = run_ranks(tmp / "w4", [row["job"], rollout["job"]], 4)
    ev, step = _eval_case(tmp / "ev"), _step_case(tmp / "step")
    eval_out, step_out = run_ranks(tmp / "w2", [ev["job"], step["job"]], 2)
    return {"row": (row, row_out), "rollout": (rollout, rollout_out), "eval": (ev, eval_out),
            "step": (step, step_out)}


def test_row_parallel_bf16_rounds_once_as_the_jax_mesh(runs):
    case, ranks = runs["row"]
    half = ROW[1] // 2
    x, w = (torch.from_numpy(a).double() for a in (case["x"], case["w"]))
    exact = (x @ w).float()  # every sum exact in float32
    assert np.array_equal(exact.to(torch.bfloat16).float().numpy(), case["jax"])
    parts = [(x[:, s] @ w[s]).float().to(torch.bfloat16) for s in (slice(0, half),
                                                                  slice(half, None))]
    twice = (parts[0].float() + parts[1].float()).to(torch.bfloat16).float().numpy()
    assert (twice != case["jax"]).any()  # the order the port must not take
    for out in ranks:
        assert str(out["dtype"]) == "torch.bfloat16"
        np.testing.assert_array_equal(out["y"], case["jax"])


def test_bf16_tp_rollout_matches_the_jax_4x2_mesh(runs):
    case, ranks = runs["rollout"]
    for out in ranks:
        check_bf16(out["pred"], case["port_f32"], case["jax"]["bfloat16"],
                   case["jax"]["float32"], "rollout", dtype_checked=False)


def test_bf16_data2_05_matches_world1(runs):
    case, ranks = runs["eval"]
    ev = PredictorEvaluator(case["exp"], "tiny_t5", "ckpt", "ckpt", num_seed=1,
                            num_preds=NUM_PREDS, batch_size=EVAL_BATCH, results_name="w1_05",
                            device="cpu")
    ev.load_data()
    ev.load_models()
    assert ev.model.compute_dtype == torch.bfloat16
    assert [len(v) for v, _ in ev.test_loader] == [EVAL_BATCH, 1]
    want = ev.evaluate()
    results_dir = Experiment(case["exp"] / "predictors" / "tiny_t5").results_dir
    got = json.loads((results_dir("mesh_05") / "results.json").read_text())
    assert set(got) == set(want)
    for metric, vals in want.items():
        if isinstance(vals, dict):
            np.testing.assert_allclose(got[metric]["framewise"], vals["framewise"], rtol=1e-5,
                                       atol=1e-6, err_msg=metric)
    for out in ranks:
        np.testing.assert_allclose(out["psnr"], want["psnr"]["framewise"], rtol=1e-5)


def _world1_step(path, inputs):
    tr = PredictorTrainer(path, "decomp", checkpoint="init", device="cpu")
    tr.setup_model()
    t = {k: torch.from_numpy(v) for k, v in inputs.items()}
    values = tr.backward(t["video"], t["noise"], caption_tokens=t["caption_tokens"],
                         attn_masks=t["attn_masks"])
    grads = {k: p.grad.clone() for k, p in tr.model.named_parameters() if p.grad is not None}
    return tr, values, grads


def test_bf16_tp_04_step_matches_world1(runs):
    case, ranks = runs["step"]
    tr, values, grads = _world1_step(case["paths"]["w1"], case["inputs"])
    assert tr.model.compute_dtype == torch.bfloat16
    _, values32, grads32 = _world1_step(case["paths"]["w1_f32"], case["inputs"])
    largest = max(float(g.abs().max()) for g in grads32.values())
    assert any("blocks.0.attn.q" in n for n in ranks[0]["sharded"])
    for out in ranks:
        for k, v in values.items():
            check_bf16(out[f"loss/{k}"], values32[k], v, values32[k], f"loss {k}",
                       dtype_checked=False, scale=float(abs(values32[k])))
        assert {k[5:] for k in out if k.startswith("grad/")} == set(grads)
        for k, g in grads.items():
            assert out[f"grad/{k}"].dtype == np.float32, k
            check_bf16(out[f"grad/{k}"], grads32[k], g, grads32[k], k, dtype_checked=False,
                       scale=largest)
