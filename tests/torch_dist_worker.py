"""One rank of the port's multi-process tests (``tests/test_torch_port_dist_*.py``).

    TEXTOCVP_COORDINATOR=127.0.0.1:PORT TEXTOCVP_NUM_PROCESSES=N TEXTOCVP_PROCESS_ID=R \\
        python tests/torch_dist_worker.py SPEC.json OUT_DIR

``SPEC.json`` is ``{"jobs": [{"job": name, ...}, ...]}`` and, optionally,
``"timeout_s"``, the process group's collective timeout (default
``parallel/distributed.py::TIMEOUT_S``): each job runs in turn on every rank
in one gloo process group, and rank ``R`` writes ``OUT_DIR/<i>_rank<R>.npz``
(the job's arrays) for the ``i``-th job. Imports
torch and the port only, never JAX: the parent test computes the JAX side and
hands inputs and weights over as ``.npz`` files. One torch thread a rank.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import torch
from torch import distributed as dist

from textocvp_tpu_torch.parallel import distributed as pdist
from textocvp_tpu_torch.parallel.mesh import (
    Mesh,
    all_gather_rows,
    all_reduce,
    barrier,
    broadcast_object,
    shard_batch,
)
from textocvp_tpu_torch.parallel.partitioning import (
    gather_full,
    gather_state_dict,
    shard_predictor_,
    sharded_names,
)


def _tensors(path) -> dict:
    with np.load(path) as f:
        return {k: torch.from_numpy(f[k]) for k in f.files}


def _grads(model, group) -> dict:
    """Every gradient by name, sharded ones gathered to their full shapes."""
    out = {}
    for name, p in model.named_parameters():
        if p.grad is None:
            continue
        shard = getattr(p, "tp_shard", None)
        g = gather_full(p.grad, shard, group) if shard else p.grad
        out[f"grad/{name}"] = g.numpy()
    return out


def job_helpers(spec):
    """The mesh's indices and groups, the collective helpers, and a
    tensor-parallel MLP pair's gradients."""
    from textocvp_tpu_torch.nn.blocks import MLP

    mesh = Mesh(spec["data"], spec["model"])
    rank = mesh.rank
    out = {"indices": np.array([mesh.data_index, mesh.model_index]),
           "data_ranks": np.array(dist.get_process_group_ranks(mesh.data_group)),
           "model_ranks": np.array(dist.get_process_group_ranks(mesh.model_group)),
           "data_sum": all_reduce(torch.tensor([float(rank)]), mesh.data_group).numpy(),
           "model_sum": all_reduce(torch.tensor([float(rank)]), mesh.model_group).numpy(),
           "gathered": all_gather_rows(torch.full((2, 3), float(rank)), mesh.data_group).numpy(),
           "broadcast": np.array(broadcast_object({"rank": rank} if rank == 0 else None)["rank"]),
           "shard": shard_batch(np.arange(8), mesh)}
    host = torch.nn.Module()
    host.mlp = MLP(4, [8, 4])
    host.mlp.load_state_dict({k: v for k, v in _tensors(spec["weights"]).items()})
    out["sharded"] = np.array(shard_predictor_(host, mesh))
    x = _tensors(spec["inputs"])["x"].requires_grad_(True)
    (host.mlp(x) * torch.arange(4.0)).sum().backward()
    out["x_grad"] = x.grad.numpy()
    out.update(_grads(host, mesh.model_group))
    return out


def _decomp_trainer(spec):
    from textocvp_tpu_torch.train.trainer import DecompTrainer

    tr = DecompTrainer(spec["exp"], device="cpu")
    tr.setup_model()
    tr.model.load_state_dict(_tensors(spec["weights"]))
    return tr


def job_train02(spec):
    """One 02 step on this rank's rows of the global batch, with the global
    noise the parent drew."""
    tr = _decomp_trainer(spec)
    d = _tensors(spec["inputs"])
    video, noise = shard_batch((d["video"], d["noise"]), tr.mesh)
    values = tr.backward(video, noise)
    out = {f"loss/{k}": v.numpy() for k, v in values.items()}
    out.update(_grads(tr.model, tr.mesh.model_group))
    tr.optimizer.step()
    out.update({f"param/{k}": v.numpy() for k, v in tr.model.state_dict().items()})
    return out


def _pred_trainer(spec):
    from textocvp_tpu_torch.train.predictor_trainer import PredictorTrainer

    tr = PredictorTrainer(spec["exp"], "decomp", checkpoint="init", device="cpu")
    tr.setup_model()
    return tr


def job_train04(spec):
    """One 04 step (this rank's rows, the parent's global noise): losses,
    gradients and the clip's norm, the parameters after the update (full and
    this rank's own), then a checkpoint written by rank 0 when asked."""
    tr = _pred_trainer(spec)
    d = _tensors(spec["inputs"])
    text = {k: d[k] for k in ("caption_tokens", "attn_masks")}
    video, noise, text = shard_batch((d["video"], d["noise"], text), tr.mesh)
    values = tr.backward(video, noise, **text)
    out = {f"loss/{k}": v.numpy() for k, v in values.items()}
    out.update(_grads(tr.model, tr.mesh.model_group))
    out["grad_norm"] = np.asarray(tr.optimizer.step()["grad_norm"])
    group = tr.mesh.model_group if tr.mesh.tensor_parallel else None
    full = gather_state_dict(tr.model, group) if group is not None else tr.model.state_dict()
    out.update({f"param/{k}": v.numpy() for k, v in full.items()})
    out.update({f"local/{k}": v.numpy() for k, v in tr.model.state_dict().items()})
    out["sharded"] = np.array(sharded_names(tr.model), dtype=str)
    out["decomp_sharded"] = np.array(sharded_names(tr.decomp_model), dtype=str)
    if spec.get("checkpoint"):
        from textocvp_tpu_torch.train.checkpoints import save_checkpoint

        # a collective under tensor parallelism; rank 0 writes
        save_checkpoint(tr.exp.checkpoint_path(spec["checkpoint"]), tr._state(1))
        barrier()
    return out


def job_rollout(spec):
    """A predictor's rollout on this data index's rows, sharded over the model
    axis, gathered over the data group."""
    from textocvp_tpu_torch.models import setup_predictor

    mesh = Mesh(spec["data"], spec["model"])
    wrapper = setup_predictor(json.loads(Path(spec["params"]).read_text()))
    wrapper.load_state_dict(_tensors(spec["weights"]))
    wrapper.eval()
    names = shard_predictor_(wrapper, mesh)
    d = _tensors(spec["inputs"])
    hist = d.pop("hist")
    hist, text = shard_batch((hist, d), mesh)
    with torch.no_grad():
        pred = wrapper(hist, num_preds=spec["num_preds"], **text)
    return {"pred": all_gather_rows(pred, mesh.data_group).float().numpy(),
            "sharded": np.array(names, dtype=str)}


def job_eval(spec):
    """03 or 05 over the experiment on the mesh; rank 0 writes results.json."""
    from textocvp_tpu_torch.train.evaluator import DecompEvaluator, PredictorEvaluator

    if spec["kind"] == "03":
        ev = DecompEvaluator(spec["exp"], "ckpt", batch_size=spec["batch"],
                             results_name=spec["results"], device="cpu")
        ev.load_data()
        ev.load_model()
    else:
        ev = PredictorEvaluator(spec["exp"], spec.get("pred", "tiny_t5"), "ckpt", "ckpt",
                                num_seed=1,
                                num_preds=spec["num_preds"], batch_size=spec["batch"],
                                results_name=spec["results"], device="cpu")
        ev.load_data()
        ev.load_models()
    results = ev.evaluate()
    out = {"psnr": np.asarray(results["psnr"]["framewise"])}
    if ev.decode_quant_scales is not None:
        out["dec_scales"] = ev.decode_quant_scales.numpy()
    return out


def job_decomp_tp(spec):
    """A tiny ExtendedDINOSAUR on the ``(data, model)`` mesh (sharded by
    ``shard_decomp_`` under ``model`` > 1), on this data index's rows: its
    sharded names and shards' layout, the float forward, the weights the
    slot-attention kernel reads, the state gathered back, and the int8
    encode and decode calibrated over the data group."""
    from textocvp_tpu_torch.models import setup_model
    from textocvp_tpu_torch.models.quant import calibrate_decode_scales, calibrate_encode_scales
    from textocvp_tpu_torch.parallel.partitioning import shard_decomp_

    mesh = Mesh(spec["data"], spec["model"])
    model = setup_model(json.loads(Path(spec["params"]).read_text()))
    model.load_state_dict(_tensors(spec["weights"]))
    model.eval()
    names = shard_decomp_(model, mesh)
    d = _tensors(spec["inputs"])
    video, noise, slots = shard_batch((d["video"], d["noise"], d["slots"]), mesh)
    with torch.no_grad():
        out = model(video, noise=noise, decode=True)
        enc = calibrate_encode_scales(model, video, mesh.data_group)
        dec = calibrate_decode_scales(model, slots, mesh.data_group)
        feats8 = model.frozen_features(video, enc)
        dec8 = model.decode(slots, quant_scales=dec)
    block = model.image_encoder.blocks[0]
    full = gather_state_dict(model, mesh.model_group)
    return {"sharded": np.array(names, dtype=str), "heads": np.array(block.num_heads),
            "qkv": block.qkv.weight.detach().numpy(),
            **{f"out/{k}": out[k].numpy() for k in ("recons_imgs", "recons_feats")},
            **{f"kernel/{k}": v.detach().numpy()
               for k, v in model.slot_attention.iteration_params().items()},
            **{f"full/{k}": v.numpy() for k, v in full.items()},
            "enc_scales": enc.numpy(), "dec_scales": dec.numpy(),
            "feats8": feats8.numpy(), "imgs8": dec8["recons_imgs"].numpy(),
            "recons_feats8": dec8["recons_feats"].numpy()}


def job_train02_accum(spec):
    """One 02 step on this rank's share of each global microbatch
    (``microbatch_rows``), with the global noise the parent drew."""
    from textocvp_tpu_torch.data.loader import microbatch_rows

    tr = _decomp_trainer(spec)
    d = _tensors(spec["inputs"])
    n = d["video"].shape[0]
    rows = torch.from_numpy(microbatch_rows(n, tr.accum, tr.training_params["batch_size"],
                                            tr.mesh.data, tr.mesh.data_index)[1])
    values = tr.backward(d["video"][rows], d["noise"][rows])
    out = {f"loss/{k}": v.numpy() for k, v in values.items()}
    out.update(_grads(tr.model, tr.mesh.model_group))
    tr.optimizer.step()
    out.update({f"param/{k}": v.numpy() for k, v in tr.model.state_dict().items()})
    return out


def job_emergency04(spec):
    """The 04 trainer's emergency checkpoint under tensor parallelism.

    ``case`` "both": an uninterrupted run of two epochs (``straight``); then
    the same run (``failing``) in which every rank raises as epoch 1 starts,
    after the collective gather of its state, which this job returns
    (``gathered/...``); then ``failing`` resumed from its emergency
    checkpoint, a set of per-rank files, to the end.

    ``case`` "rank1": model rank 1 alone raises in its first training
    step's forward, while model rank 0 waits in the step's collective. Rank 1 then reports
    its own file and what loading the set says, before anything else; rank
    0 writes its file once its collective fails."""
    import time

    from textocvp_tpu_torch.train.checkpoints import load_checkpoint, shard_files, shard_path
    from textocvp_tpu_torch.train.predictor_trainer import PredictorTrainer

    def trainer(name, **kw):
        tr = PredictorTrainer(spec[name], "decomp", device="cpu", **kw)
        tr.load_data()
        tr.setup_model()
        return tr

    out = {}
    emergency = Path(spec["failing"]) / "models" / "emergency_checkpoint_epoch_1.pt"
    if spec["case"] == "both":
        trainer("straight").training_loop()
        tr = trainer("failing")
        valid = tr.valid_epoch

        def failing(epoch):
            if epoch == 1:
                state = tr._state(epoch)  # the collective gather, as the checkpoints take it
                out.update({f"gathered/param/{k}": v.numpy() for k, v in state["params"].items()})
                for key in ("mu", "nu"):
                    out.update({f"gathered/{key}/{i}": v.numpy()
                                for i, v in enumerate(state["opt_state"][key])})
                out["gathered/count"] = np.array(state["opt_state"]["count"])
                out["gathered/epoch_step"] = np.array([state["epoch"], state["step"]])
                raise RuntimeError("fault on every rank")
            return valid(epoch)

        tr.valid_epoch = failing
        try:
            tr.training_loop()
        except RuntimeError as e:
            out["error"] = np.array(str(e))
        barrier()  # every rank's file is written
        resumed = trainer("failing", checkpoint="emergency_checkpoint_epoch_1",
                          resume_training=True)
        out["resumed_at"] = np.array([resumed.start_epoch, resumed.global_step,
                                      resumed.optimizer.count])
        resumed.training_loop()
        return out

    tr = trainer("failing")
    rank = tr.mesh.rank
    forward_loss = tr.forward_loss

    def failing_forward(*args, **kwargs):
        if tr.mesh.model_index == 1 and torch.is_grad_enabled():  # a training step
            raise RuntimeError("fault on model rank 1")
        return forward_loss(*args, **kwargs)

    tr.forward_loss = failing_forward
    t = time.perf_counter()
    try:
        tr.training_loop()
    except Exception as e:  # rank 0: its collective's timeout or its peer's exit
        out["error"] = np.array(f"{type(e).__name__}: {e}")
    out["seconds"] = np.array(time.perf_counter() - t)
    emergency = tr.exp.checkpoint_path("emergency_checkpoint_epoch_0")
    out["own_file"] = np.array(shard_path(emergency, rank).is_file())
    out["files"] = np.array(sorted(shard_files(emergency)))
    if rank == 1:  # model rank 0 is still in its collective
        try:
            load_checkpoint(emergency)
        except ValueError as e:
            out["incomplete"] = np.array(str(e))
    return out


def float_frames_(svc):
    """Have ``svc``'s decode stage return its clipped float32 frames times
    255, unrounded, in place of the uint8 reply, so that ``predict`` (which
    divides by 255) hands back the frames before the reply's rounding: a
    1e-7 difference at a rounding edge is a whole 1/255 of the uint8 reply,
    so the mesh's checks hold these to a tolerance instead. An int8 stage
    decodes with its calibrated scales, as the stage does. Returns ``svc``."""
    stage = svc.decode_module

    def forward(pred_slots):
        b, p, s, d = pred_slots.shape
        kw = {} if stage.quant_scales is None else {"quant_scales": stage.quant_scales}
        imgs = stage.model.decode(pred_slots.reshape(b * p, s, d), **kw)["recons_imgs"]
        return (imgs.clamp(0.0, 1.0) * 255.0).reshape(b, p, *imgs.shape[1:])

    stage.forward = forward
    return svc


def job_serve(spec):
    """A mesh service: rank 0 answers the requests (after setting the
    generator's state) and tries to export; the others follow."""
    from textocvp_tpu_torch.serve import PredictionService
    from textocvp_tpu_torch.serve.export import export_service

    svc = PredictionService(spec["exp"], "tiny_t5", "ckpt", "ckpt", batch_size=spec["batch"],
                            max_tokens=spec["max_tokens"], device="cpu",
                            mesh_axes=spec["mesh_axes"])
    if spec.get("float_reply", False):
        float_frames_(svc)
    out = {"seq_parallel": np.array(svc._seq_parallel),
           "decomp_sharded": np.array(svc._decomp_sharded)}
    if svc.mesh.rank != 0:
        svc.follow()
        return out
    d = np.load(spec["inputs"])
    svc.generator.set_state(torch.from_numpy(d["state"]))
    for i, rows in enumerate(spec["rows"]):
        out[f"reply{i}"] = svc.predict(d["frames"][:rows], list(spec["captions"][:rows]))
    for name in ("quant_scales", "encode_scales"):
        module = svc.decode_module if name == "quant_scales" else svc.predict_module
        if getattr(module, name) is not None:
            out[name] = getattr(module, name).numpy()
    try:
        export_service(svc, Path(spec["exp"]) / "artifact")
    except ValueError as e:
        out["export_error"] = np.array(str(e))
    svc.close()
    return out


def job_row_bf16(spec):
    """A bias-free bf16 row-parallel dense (``RowParallelLinear``) on this
    model index's columns of ``x`` (M, K) and of the (N, K) weight: its
    output as float32, and its dtype."""
    from textocvp_tpu_torch.nn.precision import Linear, set_compute_dtype
    from textocvp_tpu_torch.parallel.partitioning import RowParallelLinear, slice_full

    mesh = Mesh(spec["data"], spec["model"])
    d = _tensors(spec["inputs"])
    dense = set_compute_dtype(Linear(d["w"].shape[1], d["w"].shape[0], bias=False),
                              torch.bfloat16)
    with torch.no_grad():
        dense.weight.copy_(d["w"])
    row = RowParallelLinear(dense, mesh.model_index, mesh.model, mesh.model_group)
    x = slice_full(d["x"], (1, mesh.model_index, mesh.model, 1)).to(torch.bfloat16)
    with torch.no_grad():
        y = row(x)
    return {"y": y.float().numpy(), "dtype": np.array(str(y.dtype))}


JOBS = {name[4:]: fn for name, fn in globals().items() if name.startswith("job_")}


def main():
    torch.set_num_threads(1)
    spec_path, out_dir = sys.argv[1:3]
    spec = json.loads(Path(spec_path).read_text())
    pdist.TIMEOUT_S = spec.get("timeout_s", pdist.TIMEOUT_S)
    assert pdist.maybe_initialize_distributed(), "no process group in the environment"
    rank = dist.get_rank()
    for i, job in enumerate(spec["jobs"]):
        out = JOBS[job["job"]](job)
        np.savez(Path(out_dir) / f"{i}_rank{rank}.npz", **out)
    pdist.destroy()


if __name__ == "__main__":
    main()
