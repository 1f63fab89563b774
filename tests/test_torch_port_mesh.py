"""The port's mesh (``textocvp_tpu_torch/parallel/``) against the JAX
package's: mesh arithmetic and its refusals, the loader's process split and
``pad_batch`` against the JAX ``DataLoader``'s and ``pad_batch``, the set of
predictor weights that tensor parallelism shards against
``predictor_param_specs``, and the collectives and Megatron's pair of
``autograd.Function``s in gloo process groups of 2 and 4 ranks
(``tests/torch_dist_worker.py``, one torch thread a rank).

:func:`run_ranks` is the other ``test_torch_port_dist_*.py`` files' way to
spawn ranks."""

import torch_cpu_threads  # noqa: F401  (two torch threads a worker)
import json
import os
import socket
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from textocvp_tpu.core.config import add_predictor_params as jax_add_predictor_params
from textocvp_tpu.core.config import build_exp_params as jax_build_exp_params
from textocvp_tpu.data.loader import DataLoader as JaxDataLoader
from textocvp_tpu.models import setup_predictor as jax_setup_predictor
from textocvp_tpu.parallel.mesh import get_mesh
from textocvp_tpu.parallel.mesh import pad_batch as jax_pad_batch
from textocvp_tpu.parallel.partitioning import predictor_param_specs
from textocvp_tpu_torch.cli.serve import serve_args
from textocvp_tpu_torch.convert import convert_tree
from textocvp_tpu_torch.core.config import add_predictor_params, build_exp_params
from textocvp_tpu_torch.data.loader import EpochLoader
from textocvp_tpu_torch.models import setup_predictor
from textocvp_tpu_torch.nn.blocks import MLP
from textocvp_tpu_torch.parallel import distributed as pdist
from textocvp_tpu_torch.parallel.mesh import Mesh, pad_batch, shard_batch
from textocvp_tpu_torch.parallel.partitioning import shard_predictor_, sharded_names

ROOT = Path(__file__).resolve().parent.parent
WORKER = Path(__file__).resolve().parent / "torch_dist_worker.py"
LAUNCH_ENV = ("TEXTOCVP_COORDINATOR", "TEXTOCVP_NUM_PROCESSES", "TEXTOCVP_PROCESS_ID",
              "MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK",
              "LOCAL_WORLD_SIZE")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(tmp: Path, jobs: list, world: int, timeout: float = 120,
              pg_timeout_s: float | None = None) -> list:
    """Run ``jobs`` on ``world`` gloo ranks of ``torch_dist_worker.py``;
    returns, job by job, each rank's arrays. ``pg_timeout_s`` sets the
    process group's collective timeout."""
    tmp.mkdir(parents=True, exist_ok=True)
    spec = tmp / "spec.json"
    extra = {} if pg_timeout_s is None else {"timeout_s": pg_timeout_s}
    spec.write_text(json.dumps({"jobs": jobs, **extra}))
    out = tmp / "out"
    out.mkdir(exist_ok=True)
    port = _free_port()
    env = {k: v for k, v in os.environ.items() if k not in LAUNCH_ENV}
    env.update(TEXTOCVP_COORDINATOR=f"127.0.0.1:{port}", TEXTOCVP_NUM_PROCESSES=str(world),
               TEXTOCVP_NUM_WORKERS="0", OMP_NUM_THREADS="1",
               CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=os.pathsep.join([str(ROOT), env.get("PYTHONPATH", "")]))
    procs = [subprocess.Popen([sys.executable, str(WORKER), str(spec), str(out)],
                              env={**env, "TEXTOCVP_PROCESS_ID": str(r)}, cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(
        f"--- rank {r} ({p.returncode})\n{log[-3000:]}" for r, (p, log) in
        enumerate(zip(procs, logs)))
    return [[dict(np.load(out / f"{i}_rank{r}.npz")) for r in range(world)]
            for i in range(len(jobs))]


# ------------------------------------------------------------------ in-process


def test_mesh_without_a_process_group_is_one_rank_and_refuses_more(monkeypatch):
    for name in LAUNCH_ENV:
        monkeypatch.delenv(name, raising=False)
    assert pdist.maybe_initialize_distributed() is False
    mesh = pdist.get_runtime_mesh({"mesh_axes": {"data": -1, "model": 1}})
    assert (mesh.world, mesh.rank, mesh.data, mesh.model) == (1, 0, 1, 1)
    assert mesh.data_group is None and mesh.model_group is None and mesh.backend is None
    assert not mesh.tensor_parallel and pdist.loader_process_kwargs(mesh) == {}
    assert pdist.get_runtime_mesh(None).data == 1
    with pytest.raises(ValueError, match="mesh 2x1 != 1 processes"):
        Mesh(data=2, model=1)
    with pytest.raises(ValueError, match="not divisible by model=2"):
        Mesh(data=-1, model=2)
    with pytest.raises(ValueError, match="model=0"):
        Mesh(data=1, model=0)
    assert pdist.is_process_zero()


def test_launch_env_reads_both_launchers(monkeypatch):
    for name in LAUNCH_ENV:
        monkeypatch.delenv(name, raising=False)
    assert pdist.launch_env() is None
    monkeypatch.setenv("TEXTOCVP_COORDINATOR", "host0:1234")
    monkeypatch.setenv("TEXTOCVP_NUM_PROCESSES", "4")
    monkeypatch.setenv("TEXTOCVP_PROCESS_ID", "3")
    assert pdist.launch_env() == {"init_method": "tcp://host0:1234", "world": 4, "rank": 3,
                                  "local_rank": 3, "local_world": 4}
    monkeypatch.delenv("TEXTOCVP_COORDINATOR")
    for k, v in dict(MASTER_ADDR="h", MASTER_PORT="1", RANK="5", WORLD_SIZE="8",
                     LOCAL_RANK="1", LOCAL_WORLD_SIZE="4").items():
        monkeypatch.setenv(k, v)
    assert pdist.launch_env() == {"init_method": "env://", "world": 8, "rank": 5,
                                  "local_rank": 1, "local_world": 4}
    assert pdist.pick_backend(1) == ("nccl" if torch.cuda.is_available() else "gloo")


class _Items:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return np.full((2, 4, 4, 3), i, np.float32), f"cap{i}"


@pytest.mark.parametrize("n,batch,shuffle", [(16, 8, True), (20, 8, False), (13, 4, True)])
@pytest.mark.parametrize("count", [1, 2, 4])
def test_loader_process_split_matches_jax(n, batch, shuffle, count):
    """Each process's rows of every batch, padding of the ragged one and
    ``num_valid`` as the JAX ``DataLoader``'s, for 1, 2 and 4 processes."""
    kw = {} if count == 1 else {"pad_to_multiple": count}
    for index in range(count):
        split = dict(process_index=index, process_count=count, **kw)
        ours = list(EpochLoader(_Items(n), batch, shuffle=shuffle, seed=7, num_workers=0,
                                **split))
        theirs = list(JaxDataLoader(_Items(n), batch_size=batch, shuffle=shuffle, seed=7,
                                    num_workers=0, **split))
        assert len(ours) == len(theirs)
        for (v, info), (jv, jinfo) in zip(ours, theirs):
            np.testing.assert_array_equal(v, jv)
            assert info["caption"] == jinfo["caption"]
            assert info.get("num_valid") == jinfo.get("num_valid")


def test_loader_process_split_refusals():
    with pytest.raises(ValueError, match="must divide evenly over 3 processes"):
        EpochLoader(_Items(8), 8, process_index=0, process_count=3)
    with pytest.raises(ValueError, match="must be a multiple of process_count"):
        EpochLoader(_Items(8), 8, process_index=0, process_count=2, pad_to_multiple=3)
    with pytest.raises(ValueError, match="outside"):
        EpochLoader(_Items(8), 8, process_index=2, process_count=2)


@pytest.mark.parametrize("rows,data", [(5, 8), (6, 2), (8, 4), (3, 4)])
def test_pad_batch_and_shard_batch_match_jax(rows, data):
    rng = np.random.default_rng(rows)
    videos = rng.uniform(0, 1, (rows, 2, 4, 4, 3)).astype(np.float32)
    text = {"caption_tokens": rng.integers(0, 9, (rows, 5)).astype(np.int32)}
    jmesh = get_mesh(data=data, model=1, devices=jax.devices()[:data])
    (jv, jt), jb = jax_pad_batch((videos, text), jmesh)
    mesh = SimpleNamespace(data=data, data_index=0)
    (v, t), b = pad_batch((videos, text), mesh)
    assert b == jb == rows
    np.testing.assert_array_equal(v, jv)
    np.testing.assert_array_equal(t["caption_tokens"], jt["caption_tokens"])
    (tv,), _ = pad_batch((torch.from_numpy(videos),), mesh)
    np.testing.assert_array_equal(tv.numpy(), jv)
    parts = [shard_batch(v, SimpleNamespace(data=data, data_index=i)) for i in range(data)]
    np.testing.assert_array_equal(np.concatenate(parts), jv)
    with pytest.raises(ValueError, match="does not divide"):
        shard_batch(np.zeros((rows * data + 1, 2)), SimpleNamespace(data=data, data_index=0))


def _tiny(name):
    """Both packages' params of a predictor whose heads and hidden widths the
    model axis 2 divides."""
    params = []
    for build, add in ((jax_build_exp_params, jax_add_predictor_params),
                       (build_exp_params, add_predictor_params)):
        p = build("SAVi", "CATER_Easy")
        p["model"]["model_params"].update(num_slots=3, slot_dim=8)
        p = add(p, name)
        pr = p["predictor"]["predictor_params"]
        if name.startswith("TextOCVP"):
            pr["predictor_params"].update(token_dim=16, n_heads=2, hidden_dim=32, num_layers=2)
            pr["fusion_params"].update(num_heads=2, head_dim=8, mlp_size=32)
            pr["text_encoder_params"] = (
                dict(vocab_size=64, d_model=16, d_kv=8, num_heads=2, d_ff=32, num_layers=2)
                if name == "TextOCVP_T5" else
                dict(input_dim=16, num_layers=1, num_heads=2, vocab_size=30))
        else:
            pr.update(token_dim=16, hidden_dim=32, num_layers=1, n_heads=2)
        p["prediction_params"].update(num_context=1, num_preds=2, input_buffer_size=3)
        params.append(p)
    return params


@pytest.mark.parametrize("name", ["TextOCVP_T5", "TextOCVP_CustomTF", "OCVPSeq", "OCVPPar"])
def test_sharded_weights_are_the_jax_specs(name):
    """The weights the port shards, mapped by name (``convert.py``), are the
    kernels ``predictor_param_specs`` marks; the column layers' biases and
    T5's relative-position table are sharded with them."""
    jp, pp = _tiny(name)
    jwrapper = jax_setup_predictor(jp)
    hist = jnp.zeros((1, 1, 3, 8))
    text = {"TextOCVP_T5": {"caption_tokens": jnp.ones((1, 4), jnp.int32),
                            "attn_masks": jnp.ones((1, 4), jnp.int32)},
            "TextOCVP_CustomTF": {"caption_tokens": jnp.ones((1, 4), jnp.int32),
                                  "caption_lengths": jnp.full((1,), 4, jnp.int32)}}.get(name, {})
    params = jax.eval_shape(lambda: jwrapper.init(jax.random.PRNGKey(0), hist, **text))["params"]
    specs = predictor_param_specs(params)

    def marked(tree, spec):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                sub = marked(v, spec[k])
                if sub:
                    out[k] = sub
            elif tuple(spec[k]) != ():
                out[k] = np.zeros(v.shape, np.float32)
        return out

    want = set(convert_tree(marked(params, specs)))
    wrapper = setup_predictor(pp)
    full = {k: v.clone() for k, v in wrapper.state_dict().items()}
    mesh = SimpleNamespace(tensor_parallel=True, model=2, model_index=1, model_group=None)
    names = shard_predictor_(wrapper, mesh)
    assert names == sharded_names(wrapper)
    got = {n for n in names if n.endswith("weight") and full[n].dim() == 2
           and "relative_attention_bias" not in n}
    assert got == want
    assert want  # every predictor has sharded layers
    for n, p in wrapper.named_parameters():
        if n in names:  # model rank 1's half, contiguous
            dim = p.tp_shard[0]
            torch.testing.assert_close(p.detach(), full[n].narrow(dim, p.shape[dim],
                                                                  p.shape[dim]), rtol=0, atol=0)
    if name == "OCVPPar":  # self_attn_obj / self_attn_time are not JAX spec names
        assert not any("self_attn" in n for n in names)


def test_serve_cli_refuses_mesh_model_without_mesh_data(capsys):
    base = ["-d", "/x", "--name_pred_exp", "p", "--decomp_ckpt", "c", "--pred_ckpt", "c"]
    with pytest.raises(SystemExit):
        serve_args(base + ["--mesh_model", "2"])
    assert "--mesh_model needs a mesh" in capsys.readouterr().err
    args = serve_args(base + ["--mesh_data", "-1", "--mesh_model", "2"])
    assert (args.mesh_data, args.mesh_model) == (-1, 2)


# ------------------------------------------------------------------ process groups


@pytest.fixture(scope="module")
def helper_runs(tmp_path_factory):
    """The helpers job on (data 2, model 1), (data 1, model 2) and (data 2,
    model 2); a tensor-parallel MLP pair's weights and input."""
    tmp = tmp_path_factory.mktemp("mesh_helpers")
    gen = torch.Generator().manual_seed(3)
    mlp = MLP(4, [8, 4])
    for p in mlp.parameters():
        torch.nn.init.normal_(p, generator=gen)
    np.savez(tmp / "weights.npz", **{k: v.numpy() for k, v in mlp.state_dict().items()})
    x = torch.randn((3, 4), generator=gen)
    np.savez(tmp / "inputs.npz", x=x.numpy())
    xr = x.clone().requires_grad_(True)
    (mlp(xr) * torch.arange(4.0)).sum().backward()
    ref = {"x_grad": xr.grad.numpy(),
           **{f"grad/mlp.{k}": p.grad.numpy() for k, p in mlp.named_parameters()}}
    job = {"job": "helpers", "weights": str(tmp / "weights.npz"), "inputs": str(tmp / "inputs.npz")}
    two = run_ranks(tmp / "w2", [{**job, "data": 2, "model": 1}, {**job, "data": 1, "model": 2}],
                    2)
    four = run_ranks(tmp / "w4", [{**job, "data": 2, "model": 2}], 4)
    return {"ref": ref, (2, 1): two[0], (1, 2): two[1], (2, 2): four[0]}


@pytest.mark.parametrize("axes", [(2, 1), (1, 2), (2, 2)], ids=lambda a: f"data{a[0]}_model{a[1]}")
def test_mesh_groups_and_collectives(helper_runs, axes):
    data, model = axes
    ranks = helper_runs[axes]
    for r, out in enumerate(ranks):
        assert tuple(out["indices"]) == (r // model, r % model)
        assert list(out["data_ranks"]) == list(range(r % model, data * model, model))
        assert list(out["model_ranks"]) == list(range(r // model * model, r // model * model
                                                      + model))
        assert float(out["data_sum"][0]) == sum(out["data_ranks"])
        assert float(out["model_sum"][0]) == sum(out["model_ranks"])
        np.testing.assert_array_equal(out["gathered"][:, 0],
                                      np.repeat(out["data_ranks"], 2).astype(np.float32))
        assert int(out["broadcast"]) == 0
        per = 8 // data
        np.testing.assert_array_equal(out["shard"], np.arange(8)[r // model * per:
                                                                 (r // model + 1) * per])


@pytest.mark.parametrize("axes", [(2, 1), (1, 2), (2, 2)], ids=lambda a: f"data{a[0]}_model{a[1]}")
def test_megatron_pair_gradients_equal_the_whole_layers(helper_runs, axes):
    """A column-then-row MLP pair over the model group gives the unsharded
    pair's input and weight gradients: the row exit's backward is the
    identity (an all-reduce there would double them) and the column entry
    sums the input gradient's parts."""
    ref = helper_runs["ref"]
    for out in helper_runs[axes]:
        sharded = set(out["sharded"])
        assert sharded == ({"mlp.layers.0.weight", "mlp.layers.0.bias", "mlp.layers.1.weight"}
                           if axes[1] == 2 else set())
        np.testing.assert_allclose(out["x_grad"], ref["x_grad"], rtol=1e-6, atol=1e-6)
        for k, g in ref.items():
            if k.startswith("grad/"):
                np.testing.assert_allclose(out[k], g, rtol=1e-6, atol=1e-6, err_msg=k)
