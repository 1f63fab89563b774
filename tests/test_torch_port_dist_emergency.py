"""The emergency checkpoint of the 04 trainer under tensor parallelism, on
two gloo ranks at ``model=2`` (``tests/torch_dist_worker.py::
job_emergency04``; the tiny SAVi and TextOCVP_T5 of
``test_torch_port_train_predictor.py``, two epochs of two steps over a CATER
``.npy`` fixture).

* Both ranks raise as epoch 1 starts. Each writes its own file,
  ``emergency_checkpoint_epoch_1.rank<R>.pt``; the set, joined by
  ``load_checkpoint``, is the state the collective gather gives at that
  moment, bit for bit; ``--resume_training`` from it runs epoch 1 as the
  uninterrupted run does, to the same final checkpoint, bit for bit (the
  same operations on the same numbers on the CPU).
* Model rank 1 alone raises in its first training step's forward while rank 0 waits in the
  step's collective (a process-group timeout of 30 s). Rank 1's file is
  there with no collective, and loading the set then raises, naming model
  rank 0; rank 0 writes its own file once its collective fails.
"""

import torch_cpu_threads  # noqa: F401  (two torch threads a worker)

import numpy as np
import pytest
import torch
from test_torch_port_mesh import run_ranks
from test_torch_port_train_predictor import tiny_pred_params
from test_torch_port_train_savi import tiny_savi_params, write_cater

from textocvp_tpu_torch.core.config import add_predictor_params, build_exp_params
from textocvp_tpu_torch.core.experiment import Experiment
from textocvp_tpu_torch.models import setup_model
from textocvp_tpu_torch.models.factory import random_init_
from textocvp_tpu_torch.parallel.partitioning import join_slices, slice_full
from textocvp_tpu_torch.train.checkpoints import load_checkpoint, load_params, shard_path

B = 2


def _experiments(root):
    """The parent (a random tiny SAVi over the fixture) and two identical
    predictor experiments on ``model=2``."""
    data = write_cater(root / "CATER", splits=(("train", 4), ("test", 2)))
    parent = Experiment(root / "exp")
    params = tiny_savi_params(build_exp_params)
    params["dataset"].update(root=str(data), num_frames=4)
    parent.save_params(params)
    parent.models_dir.mkdir(parents=True)
    decomp = random_init_(setup_model(params), torch.Generator().manual_seed(3))
    torch.save(decomp.state_dict(), parent.checkpoint_path("decomp"))
    pred = tiny_pred_params(build_exp_params, add_predictor_params)
    pred["dataset"] = dict(params["dataset"])
    pred["training"].update(num_epochs=2, batch_size=B, save_frequency=10, log_frequency=1,
                            lr=1e-3, warmup_steps=0, lr_warmup=False)
    pred["tpu"] = {"mesh_axes": {"data": 1, "model": 2}}
    paths = {}
    for name in ("straight", "failing"):
        exp = Experiment(parent.exp_path / "predictors" / name)
        exp.save_params(pred)
        paths[name] = str(exp.exp_path)
    return paths


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("emergency")
    both = _experiments(tmp / "both")
    (out_both,) = run_ranks(tmp / "w_both", [{"job": "emergency04", "case": "both", **both}], 2)
    one = _experiments(tmp / "one")
    (out_one,) = run_ranks(tmp / "w_one", [{"job": "emergency04", "case": "rank1", **one}], 2,
                           pg_timeout_s=30)
    return {"both": (both, out_both), "rank1": (one, out_one)}


def test_joined_shards_are_the_gathered_state_bit_for_bit(runs):
    paths, ranks = runs["both"]
    models = Experiment(paths["failing"]).models_dir
    name = models / "emergency_checkpoint_epoch_1.pt"
    assert not name.exists()
    for r in range(2):
        assert shard_path(name, r).is_file()
        assert str(ranks[r]["error"]) == "fault on every rank"
    gathered = ranks[0]
    joined = load_checkpoint(name)
    assert (joined["epoch"], joined["step"]) == tuple(gathered["gathered/epoch_step"])
    assert joined["opt_state"]["count"] == int(gathered["gathered/count"])
    params = {k[len("gathered/param/"):] for k in gathered if k.startswith("gathered/param/")}
    assert set(joined["params"]) == params
    for k, v in joined["params"].items():
        np.testing.assert_array_equal(v.numpy(), gathered[f"gathered/param/{k}"], err_msg=k)
    for key in ("mu", "nu"):
        assert len(joined["opt_state"][key]) == len(
            [k for k in gathered if k.startswith(f"gathered/{key}/")])
        for i, v in enumerate(joined["opt_state"][key]):
            np.testing.assert_array_equal(v.numpy(), gathered[f"gathered/{key}/{i}"])
    # one file alone names its set; load_params takes the set as a .pt
    assert set(load_checkpoint(shard_path(name, 1))["params"]) == params
    assert set(load_params(name)) == params
    # each file holds that rank's slices, not the whole leaves
    local = torch.load(shard_path(name, 1), weights_only=True)
    sharded = local["tp"]["params"]
    assert sharded and all(local["params"][k].shape != joined["params"][k].shape
                           for k in sharded)


def test_a_resume_from_the_shards_continues_as_the_uninterrupted_run(runs):
    paths, ranks = runs["both"]
    for out in ranks:  # epoch 1 from its start, with the step and updates of epoch 0's end
        assert list(out["resumed_at"]) == [1, 3, 2]
    straight = load_checkpoint(Experiment(paths["straight"]).checkpoint_path(
        "checkpoint_epoch_final"))
    resumed = load_checkpoint(Experiment(paths["failing"]).checkpoint_path(
        "checkpoint_epoch_final"))
    assert (resumed["epoch"], resumed["step"]) == (straight["epoch"], straight["step"]) == (2, 6)
    for k, v in straight["params"].items():
        assert torch.equal(resumed["params"][k], v), k
    assert resumed["opt_state"]["count"] == straight["opt_state"]["count"] == 4
    for key in ("mu", "nu"):
        for a, b in zip(resumed["opt_state"][key], straight["opt_state"][key]):
            assert torch.equal(a, b)


def test_a_rank_that_fails_alone_writes_its_shard_with_no_collective(runs):
    paths, ranks = runs["rank1"]
    rank0, rank1 = ranks
    assert str(rank1["error"]) == "RuntimeError: fault on model rank 1"
    assert bool(rank1["own_file"]) and list(rank1["files"]) == [1]  # rank 0 still waiting
    assert "lacks model rank(s) [0] of 2" in str(rank1["incomplete"])
    assert float(rank1["seconds"]) < 20  # it wrote without waiting for its peer
    assert bool(rank0["own_file"])  # rank 0 too, once its collective failed
    name = Experiment(paths["failing"]).checkpoint_path("emergency_checkpoint_epoch_0")
    joined = load_checkpoint(name)  # the set complete now, its two files of one step
    assert joined["epoch"] == 0 and joined["opt_state"]["count"] == 0


@pytest.mark.parametrize("dim, size, groups", [(0, 2, 1), (1, 4, 1), (0, 2, 3)])
def test_join_slices_inverts_slice_full(dim, size, groups):
    """A fused ``[q; k; v]`` (``groups`` 3) too: each rank's slice takes its
    part of every block, and the join puts the blocks back in order."""
    full = torch.randn(12, 24, generator=torch.Generator().manual_seed(dim + size))
    parts = [slice_full(full, (dim, r, size, groups)) for r in range(size)]
    assert torch.equal(join_slices(parts, (dim, 0, size, groups)), full)
    with pytest.raises(ValueError, match="slices of a leaf sharded"):
        join_slices(parts[:-1], (dim, 0, size, groups))
