"""06a (``DecompFigGenerator``) in ``tpu.compute_dtype: "bfloat16"`` on the
CPU against the JAX generator in bf16 on the same checkpoint (a tiny SAVi
over a CATER ``.npy`` set, one sequence): the file tree and the writers'
calls equal; the reconstructions and masks handed to the writers held by
``tests/torch_bf16.py``'s rule, the ground-truth frames equal. The float32
reference of the rule is the port's float32 06a, which
``test_torch_port_fig_generation.py`` holds to the JAX generator's within
1e-5 of the largest value. The
frames reach the writers in float32, as the metrics' host fetch casts them.
The JAX generator runs its XLA slot attention (``use_pallas`` off, as
``test_torch_port_bf16_eval.py``'s evaluator does), which refines in bf16
where the port casts to float32.
"""

import torch_cpu_threads  # noqa: F401  (two torch threads a worker)
import shutil
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import torch
from test_torch_port_evaluator import _perturb, _tiny_params, write_cater_npy
from test_torch_port_fig_generation import move_plots, record, tree
from torch_bf16 import check_bf16

from textocvp_tpu.models import factory as jax_factory
from textocvp_tpu.models import setup_model as jax_setup_model
from textocvp_tpu.train import fig_generation as jax_fig_generation
from textocvp_tpu.train.checkpoints import save_checkpoint
from textocvp_tpu.viz import figures as jax_figures
from textocvp_tpu_torch.convert import from_jax_params
from textocvp_tpu_torch.core.experiment import Experiment
from textocvp_tpu_torch.train.fig_generation import DecompFigGenerator
from textocvp_tpu_torch.viz import figures as port_figures

NUM_SEQS = 1


def write_savi_experiment(root):
    """Both packages' checkpoints ``ckpt`` of a tiny SAVi over five CATER
    videos (``test_torch_port_fig_generation.py``'s, initialised under
    ``jit``)."""
    params, _ = _tiny_params(write_cater_npy(root / "CATER"))
    params["training"]["batch_size"] = 1
    exp = Experiment(root / "exp")
    exp.save_params(params)
    res = params["dataset"]["img_size"][0]
    init = jax.jit(lambda x: jax_setup_model(params).init({"params": jax.random.PRNGKey(0)}, x,
                                                          decode=True))(
        jnp.zeros((1, 1, res, res, 3)))
    mparams = _perturb(jax.device_get(init["params"]), np.random.default_rng(61))
    save_checkpoint(exp.models_dir, "ckpt", {"params": mparams})
    torch.save(from_jax_params("savi", mparams), exp.checkpoint_path("ckpt"))
    return exp.exp_path


def _jax_06a(exp_path, dest):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        gen = jax_fig_generation.DecompFigGenerator(exp_path, "ckpt", num_seqs=NUM_SEQS)
        gen.load_data()
        gen.load_model(next(iter(gen.test_loader))[0])
        gen.generate_figs()
    move_plots(exp_path, dest)


def test_06a_in_bf16_matches_the_jax_generator(monkeypatch, tmp_path):
    exp_path = write_savi_experiment(tmp_path / "figs")
    monkeypatch.setattr(jax_factory, "_use_pallas", lambda exp_params: False)
    params = Experiment(exp_path).params
    calls = {}
    for dt in ("float32", "bfloat16"):
        Experiment(exp_path).save_params({**params, "tpu": {"compute_dtype": dt}})
        if dt == "bfloat16":
            with monkeypatch.context() as m:
                calls["jax_bfloat16"] = record(m, jax_figures)
                _jax_06a(exp_path, tmp_path / "jax_bfloat16")
        with monkeypatch.context() as m:
            rec = record(m, port_figures)
            gen = DecompFigGenerator(exp_path, "ckpt", num_seqs=NUM_SEQS, device="cpu")
            gen.load_data()
            gen.load_model()
            assert gen.model.compute_dtype == {"float32": torch.float32,
                                               "bfloat16": torch.bfloat16}[dt]
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                out_dir = gen.generate_figs()
            calls[f"port_{dt}"] = dict(rec)
        names = {"recons.png", "recons.gif", "objects.png", "masks.png", "segmentation.png"}
        assert {f for _, f in tree(out_dir)} == names
        shutil.rmtree(exp_path / "plots")
    keys = set(calls["jax_bfloat16"])
    assert all(set(c) == keys for c in calls.values())
    for key in sorted(keys):
        name = calls["jax_bfloat16"][key][0]
        assert {c[key][0] for c in calls.values()} == {name}, key
        arrays = {k: c[key][1] for k, c in calls.items()}
        if key[1] == "recons.png":  # the ground truth, then the reconstruction
            np.testing.assert_array_equal(arrays["port_bfloat16"][0], arrays["jax_bfloat16"][0])
            checked = [1]
        elif key[1] in ("recons.gif", "masks.png"):
            checked = [0]
        else:  # objects and overlays: products and argmaxes of the masks above
            continue
        for i in checked:
            check_bf16(arrays["port_bfloat16"][i], arrays["port_float32"][i],
                       arrays["jax_bfloat16"][i], arrays["port_float32"][i], str(key),
                       dtype_checked=False)
