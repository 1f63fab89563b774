"""The 04 trainer through a frozen ExtendedDINOSAUR sharded over the mesh's
``model`` axis (``train/predictor_trainer.py``, ``parallel/partitioning.py::
shard_decomp_``): one 04 step of the tiny CLIPort TextOCVP_T5 of
``test_torch_port_service.py`` at ``model=2`` on 2 gloo ranks against the
port's step at world size 1, at ``test_torch_port_dist_tp.py``'s limits
(losses 1e-5, gradients and the clip's global norm 1e-4 of the largest
leaf, parameters after the update 1e-6 of the largest leaf). The image
loss's gradient reaches the predictor through the sharded patch decoder
(its column layers sum their input gradient over the model group), so a
wrong collective there moves every predictor gradient."""

import torch_cpu_threads  # noqa: F401  (two torch threads a worker)
import numpy as np
import pytest
import torch
from test_torch_port_mesh import run_ranks
from test_torch_port_service import DINO_RES, _tiny_params

from textocvp_tpu_torch.core.experiment import Experiment
from textocvp_tpu_torch.models import setup_model, setup_predictor
from textocvp_tpu_torch.models.factory import random_init_
from textocvp_tpu_torch.train.checkpoints import save_checkpoint
from textocvp_tpu_torch.train.predictor_trainer import PredictorTrainer

B, TOKENS = 2, 7


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("dist_decomp_train")
    params, pred_params = _tiny_params("ExtendedDINOSAUR")
    pred_params["training"].update(lr=1e-4, batch_size=B, warmup_steps=0, lr_warmup=False,
                                   gradient_clipping=True, clipping_max_value=0.05)
    gen = torch.Generator().manual_seed(21)
    parent = Experiment(root / "exp")
    parent.save_params(params)
    parent.models_dir.mkdir(parents=True)
    torch.save(random_init_(setup_model(params), gen).state_dict(),
               parent.checkpoint_path("decomp"))
    predictor = random_init_(setup_predictor(pred_params), gen)
    paths = {}
    for name, axes in (("tp", {"data": 1, "model": 2}), ("w1", None)):
        exp = Experiment(root / "exp" / "predictors" / name)
        exp.save_params({**pred_params, "tpu": {"mesh_axes": axes}} if axes else pred_params)
        exp.models_dir.mkdir(parents=True)
        save_checkpoint(exp.checkpoint_path("init"), {"params": predictor.state_dict()})
        paths[name] = exp.exp_path
    rng = np.random.default_rng(22)
    pp = pred_params["prediction_params"]
    mp = params["model"]["model_params"]
    inputs = {"video": rng.uniform(0, 1, (B, pp["num_context"] + pp["num_preds"], DINO_RES,
                                          DINO_RES, 3)).astype(np.float32),
              "noise": rng.standard_normal((B, mp["num_slots"], mp["slot_dim"])
                                           ).astype(np.float32),
              "caption_tokens": rng.integers(2, 32000, (B, TOKENS)).astype(np.int32),
              "attn_masks": np.ones((B, TOKENS), np.int32)}
    inputs["attn_masks"][1, 5:] = inputs["caption_tokens"][1, 5:] = 0
    np.savez(root / "inputs.npz", **inputs)
    (ranks,) = run_ranks(root / "ranks", [{"job": "train04", "exp": str(paths["tp"]),
                                           "inputs": str(root / "inputs.npz")}], 2)
    return paths, inputs, ranks


def test_04_step_through_the_sharded_frozen_dinosaur_matches_world1(runs):
    paths, inputs, ranks = runs
    tr = PredictorTrainer(paths["w1"], "decomp", checkpoint="init", device="cpu")
    tr.setup_model()
    t = {k: torch.from_numpy(v) for k, v in inputs.items()}
    values = tr.backward(t["video"], t["noise"], caption_tokens=t["caption_tokens"],
                         attn_masks=t["attn_masks"])
    grads = {k: p.grad.clone() for k, p in tr.model.named_parameters() if p.grad is not None}
    norm = float(tr.optimizer.step()["grad_norm"])
    largest = max(float(g.abs().max()) for g in grads.values())
    state = tr.model.state_dict()
    biggest = max(float(v.abs().max()) for v in state.values())
    for out in ranks:
        decomp = set(out["decomp_sharded"])
        assert {"image_encoder.blocks.0.qkv.weight", "patch_decoder.mlps.1.weight",
                "transition.mlp.layers.0.weight"} <= decomp
        assert not any(n.startswith("slot_attention.") for n in decomp)
        for k, v in values.items():
            np.testing.assert_allclose(float(out[f"loss/{k}"]), float(v), rtol=1e-5, err_msg=k)
        np.testing.assert_allclose(float(out["grad_norm"]), norm, rtol=1e-4)
        assert {k[5:] for k in out if k.startswith("grad/")} == set(grads)
        for k, g in grads.items():
            err = float(np.abs(out[f"grad/{k}"] - g.numpy()).max())
            assert err <= 1e-4 * largest, (k, err)
        for k, v in state.items():
            assert float(np.abs(out[f"param/{k}"] - v.numpy()).max()) <= 1e-6 * biggest, k
