"""Gradient accumulation over the port's data axis: each rank's microbatch i
is its share of the global microbatch i, as the JAX step reshapes the global
batch to ``(accum, micro_b)`` and shards each microbatch over ``data``
(``data/loader.py::microbatch_rows``, ``EpochLoader(accum=...)``,
``Trainer.backward``).

* The rows: every rank's share of each microbatch, put together in rank
  order, is the JAX microbatch, for full and ragged global batches; a
  microbatch that the data axis does not divide is every rank's whole; at
  ``accum`` 1 the split is the loader's contiguous one.
* A tiny ExtendedDINOSAUR 02 step (``test_torch_port_train_dinosaur.py``'s
  model, the JAX step copied from ``textocvp_tpu/train/trainer.py``) at
  ``accum_steps`` 2 on 2 gloo ranks against the JAX step on a ``data=2``
  mesh: the CNN head's BatchNorm in training mode normalizes over each
  global microbatch. Losses rtol 1e-5; every gradient leaf within 1e-4 of
  its largest |g| (floored at a thousandth of the largest leaf's), the
  conv biases before the BatchNorm, whose gradient is 0 in exact
  arithmetic, within 1e-4 of the largest leaf's; the running statistics
  after the step within 1e-6. The slot noise of each microbatch is drawn
  from its own key on the JAX side, as that step draws it."""

import torch_cpu_threads  # noqa: F401  (two torch threads a worker)
import jax
import numpy as np
import pytest
from test_torch_port_cliport import _perturb, _perturb_stats
from test_torch_port_mesh import _Items, run_ranks
from test_torch_port_train_dinosaur import TRAINING, ZERO_GRAD, jax_train_step, tiny_params
from test_torch_port_train_savi import _jax_noise

from textocvp_tpu.core.config import add_predictor_params as jax_add_predictor_params
from textocvp_tpu.core.config import build_exp_params as jax_build_exp_params
from textocvp_tpu.models import setup_model as jax_setup_model
from textocvp_tpu.parallel.mesh import batch_sharding, get_mesh
from textocvp_tpu.train.losses import build_loss_fn as jax_build_loss_fn
from textocvp_tpu.train.schedulers import build_optimizer as jax_build_optimizer
from textocvp_tpu.train.trainer import freeze_labels
from textocvp_tpu.train.trainer import ragged_accum as jax_ragged_accum
from textocvp_tpu_torch.convert import convert_batch_stats, from_jax_params
from textocvp_tpu_torch.core.config import add_predictor_params, build_exp_params
from textocvp_tpu_torch.core.experiment import Experiment
from textocvp_tpu_torch.data.loader import EpochLoader, microbatch_rows

B, T, IMG, ACCUM = 4, 2, 42, 2  # the global batch: two microbatches of one row a rank


@pytest.mark.parametrize("n,accum,batch,data", [
    (8, 2, 8, 2), (16, 8, 16, 2), (16, 2, 16, 4), (6, 2, 8, 2), (12, 4, 16, 2), (8, 1, 8, 2),
    (8, 4, 8, 4)])
def test_rank_shares_put_together_are_the_jax_microbatches(n, accum, batch, data):
    a = jax_ragged_accum(n, accum, batch)
    mb = n // a
    shares = [microbatch_rows(n, accum, batch, data, r) for r in range(data)]
    assert all(count == a for count, _ in shares)
    for i in range(a):
        got = [rows.reshape(a, -1)[i] for _, rows in shares]
        if mb % data:  # the JAX microbatch, replicated: every rank's whole
            assert all(np.array_equal(g, np.arange(i * mb, (i + 1) * mb)) for g in got)
        else:
            np.testing.assert_array_equal(np.concatenate(got), np.arange(i * mb, (i + 1) * mb))
    if accum == 1:
        per = n // data
        for r, (_, rows) in enumerate(shares):
            np.testing.assert_array_equal(rows, np.arange(r * per, (r + 1) * per))


def test_loader_loads_each_ranks_microbatch_shares():
    """13 items in global batches of 8 over 2 processes at ``accum`` 2: the
    full batch's microbatches split row by row, the ragged one (5 padded to
    6 by its last item: 2 microbatches of 3) whole on both."""
    loaders = [EpochLoader(_Items(13), 8, num_workers=0, process_index=r, process_count=2,
                           accum=2) for r in range(2)]
    batches = [[info["caption"] for _, info in loader] for loader in loaders]
    assert batches[0][0] == ["cap0", "cap1", "cap4", "cap5"]
    assert batches[1][0] == ["cap2", "cap3", "cap6", "cap7"]
    assert batches[0][1] == batches[1][1] == [f"cap{i}" for i in (8, 9, 10, 11, 12, 12)]


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist_accum")
    rng = np.random.default_rng(17)
    video = rng.uniform(0, 1, (B, T, IMG, IMG, 3)).astype(np.float32)
    jp, _ = tiny_params(jax_build_exp_params, jax_add_predictor_params)
    jmodel = jax_setup_model(jp)
    variables = jax.jit(lambda x: jmodel.init({"params": jax.random.PRNGKey(0),
                                               "slots": jax.random.PRNGKey(1)}, x,
                                              decode=True))(video[:1, :1])
    params = _perturb(jax.device_get(variables["params"]), rng)
    stats = _perturb_stats(jax.device_get(variables["batch_stats"]), rng)
    tx, _ = jax_build_optimizer(TRAINING, freeze_mask=freeze_labels(params, ("image_encoder",)))
    train_step, _ = jax_train_step(jmodel, jax_build_loss_fn(jp["loss"]), tx, ACCUM)
    key = jax.random.PRNGKey(7)
    noise = np.concatenate([_jax_noise(jmodel, {"params": params}, B // ACCUM, k)
                            for k in jax.random.split(key, ACCUM)])
    mesh = get_mesh(data=2, model=1, devices=jax.devices()[:2])
    _, new_stats, _, values, grads = train_step(
        params, stats, tx.init(params), jax.device_put(video, batch_sharding(mesh)), key)
    ours, _ = tiny_params(build_exp_params, add_predictor_params)
    ours["training"].update(TRAINING, batch_size=B, accum_steps=ACCUM)
    exp = Experiment(tmp / "dino")
    exp.save_params(ours)
    weights = from_jax_params("dinosaur", params, batch_stats=stats)
    np.savez(tmp / "weights.npz", **{k: v.numpy() for k, v in weights.items()})
    np.savez(tmp / "inputs.npz", video=video, noise=noise)
    job = {"job": "train02_accum", "exp": str(exp.exp_path), "weights": str(tmp / "weights.npz"),
           "inputs": str(tmp / "inputs.npz")}
    (ranks,) = run_ranks(tmp / "ranks", [job], 2)
    return {"ranks": ranks, "values": {k: float(v) for k, v in values.items()},
            "grads": from_jax_params("dinosaur", jax.device_get(grads)),
            "stats": convert_batch_stats(jax.device_get(new_stats))}


def test_accum2_data2_step_matches_the_jax_data2_step(case):
    grads = {k: g.numpy() for k, g in case["grads"].items()}
    top = max(float(np.abs(g).max()) for g in grads.values())
    for out in case["ranks"]:
        for k, v in case["values"].items():
            np.testing.assert_allclose(float(out[f"loss/{k}"]), v, rtol=1e-5, err_msg=k)
        for name, g in grads.items():
            if name.startswith("image_encoder."):  # frozen: 0 in JAX, none in the port
                assert not g.any() and f"grad/{name}" not in out, name
                continue
            err = float(np.abs(out[f"grad/{name}"] - g).max())
            scale = top if name in ZERO_GRAD else max(float(np.abs(g).max()), 1e-3 * top)
            assert err <= 1e-4 * scale, (name, err, scale)


def test_accum2_data2_running_statistics_are_the_jax_ones(case):
    stats = {k: v for k, v in case["stats"].items() if "running_" in k}
    assert stats
    for out in case["ranks"]:
        for k, v in stats.items():
            np.testing.assert_allclose(out[f"param/{k}"], v.numpy(), rtol=0, atol=1e-6,
                                       err_msg=k)
