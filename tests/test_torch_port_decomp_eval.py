"""The port's 03 evaluate-decomposition protocol on the CPU: its
``results.json`` against the JAX ``DecompEvaluator``'s on a tiny SAVi over a
CATER ``.npy`` set (``test_torch_port_decomp_eval_cliport.py``: a tiny
ExtendedDINOSAUR over a CLIPort color cache), the CLI, and the refusals.

The experiment directory holds both packages' checkpoints of the same
weights (the JAX init plus noise), the port's carried by
``from_jax_params``. The model uses the ``Learned`` initializer, so no
random draw differs. Five CATER videos of 3 frames in batches of 2 leave a
ragged last batch, which the JAX package pads to its mesh and slices, and
the port runs as it is. Framewise and mean PSNR agree within 1e-3 dB, SSIM
and LPIPS within 1e-4: float32 on both sides through the encoder, slot
attention over every frame and the decode, sums in other orders.
"""

import json
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_cliport import _perturb_stats, tiny_cliport_params
from test_torch_port_evaluator import RES, VIDEOS, _perturb, _tiny_params, write_cater_npy

from textocvp_tpu.models import setup_model as jax_setup_model
from textocvp_tpu.train.checkpoints import save_checkpoint
from textocvp_tpu.train import evaluator as jax_evaluator
from textocvp_tpu.train.evaluator import DecompEvaluator as JaxDecompEvaluator
from textocvp_tpu_torch.cli import evaluate_decomp
from textocvp_tpu_torch.convert import from_jax_params
from textocvp_tpu_torch.core.config import add_predictor_params, build_exp_params
from textocvp_tpu_torch.core.experiment import Experiment
from textocvp_tpu_torch.train.evaluator import DecompEvaluator

TOL = {"psnr": 1e-3, "ssim": 1e-4, "lpips": 1e-4}
CATER_FRAMES, BATCH = 3, 2


def write_experiment(root, params, kind, res, seed):
    """Both packages' checkpoints ``ckpt`` of one tiny model at ``root``."""
    exp = Experiment(root)
    exp.save_params(params)
    rng = np.random.default_rng(seed)
    variables = jax_setup_model(params).init({"params": jax.random.PRNGKey(0)},
                                             jnp.zeros((1, 1, res, res, 3)), decode=True)
    mparams = _perturb(jax.device_get(variables["params"]), rng)
    state = {"params": mparams}
    if "batch_stats" in variables:
        state["batch_stats"] = _perturb_stats(jax.device_get(variables["batch_stats"]), rng)
    save_checkpoint(exp.models_dir, "ckpt", state)
    torch.save(from_jax_params(kind, mparams, batch_stats=state.get("batch_stats")),
               exp.checkpoint_path("ckpt"))
    return exp.exp_path


@pytest.fixture(scope="module")
def savi_exp(tmp_path_factory):
    root = tmp_path_factory.mktemp("decomp_savi")
    params, _ = _tiny_params(write_cater_npy(root / "CATER"))
    params["dataset"]["num_frames"] = CATER_FRAMES
    return write_experiment(root / "exp", params, "savi", RES, 51)


def jax_results(exp_dir, monkeypatch):
    # the JAX package's framewise plots (matplotlib) change no number
    monkeypatch.setattr(jax_evaluator, "_save_framewise_plots", lambda *a, **k: None)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ev = JaxDecompEvaluator(exp_dir, "ckpt", results_name="jax")
        ev.load_data()
        videos, _ = next(iter(ev.test_loader))
        ev.load_model(videos)
        return ev.evaluate()


def port_evaluator(exp_dir, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # LPIPS's random AlexNet
        ev = DecompEvaluator(exp_dir, "ckpt", device="cpu", **kw)
    ev.load_data()
    ev.load_model()
    return ev


def check_against_jax(exp_dir, monkeypatch, frames, videos):
    """The port's 03 ``results.json`` against the JAX evaluator's."""
    ref = jax_results(exp_dir, monkeypatch)
    ev = port_evaluator(exp_dir)
    assert ev.batch_size == BATCH and ev.results_name == "eval_decomp_ckpt"
    assert len(ev.test_set) == videos and [b[0].shape[0] for b in ev.test_loader] == [2] * (
        videos // 2) + [1]
    out = ev.evaluate()
    assert json.loads((exp_dir / "results" / "eval_decomp_ckpt" / "results.json").read_text()) \
        == out
    assert set(out) == set(ref) and {"psnr", "ssim", "lpips"} <= set(out)
    assert out["lpips"]["comparable"] is False
    for m, tol in TOL.items():
        assert len(out[m]["framewise"]) == len(ref[m]["framewise"]) == frames
        got = np.array(out[m]["framewise"] + [out[m]["mean"]])
        want = np.array(ref[m]["framewise"] + [ref[m]["mean"]])
        assert np.isfinite(got).all() and np.abs(got - want).max() <= tol, (m, got, want)


def check_ragged_rows(exp_dir):
    """A ragged batch's rows equal the full batch's, and given initial slots
    the initializer's own give the same metrics."""
    ev = port_evaluator(exp_dir)

    videos, _ = next(iter(ev.test_loader))
    full = ev.eval_step(videos)
    one = ev.eval_step(videos[1:])
    learned = ev.model.slot_initializer(BATCH)
    given = ev.eval_step(videos, initial_slots=learned)
    for m in TOL:
        assert full[m].shape == (BATCH, videos.shape[1])
        torch.testing.assert_close(one[m][0], full[m][1], rtol=0, atol=1e-5)
        torch.testing.assert_close(given[m], full[m], rtol=0, atol=0)


def test_results_match_the_jax_decomp_evaluator(savi_exp, monkeypatch):
    check_against_jax(savi_exp, monkeypatch, CATER_FRAMES, VIDEOS)


def test_a_ragged_batch_equals_the_full_batchs_rows(savi_exp):
    check_ragged_rows(savi_exp)


def test_the_cli_on_the_cpu(savi_exp, capsys):
    assert evaluate_decomp.main(["-d", str(savi_exp), "--decomp_ckpt", "ckpt", "--results_name",
                                 "results_DecompModel", "--batch_size", "4",
                                 "--device", "cpu"]) == 0
    assert "Results: {" in capsys.readouterr().out
    out = json.loads((savi_exp / "results" / "results_DecompModel" / "results.json").read_text())
    assert {p.name for p in (savi_exp / "results" / "results_DecompModel").glob("*.png")} == {
        f"{m}_framewise.png" for m in TOL}
    ref = port_evaluator(savi_exp).evaluate()  # batches of 2
    for m, tol in TOL.items():
        np.testing.assert_allclose(out[m]["framewise"], ref[m]["framewise"], rtol=0, atol=tol)


def test_what_the_evaluator_refuses(savi_exp, tmp_path):
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            DecompEvaluator(savi_exp, "ckpt")
    params, _ = tiny_cliport_params(build_exp_params, add_predictor_params, tmp_path)
    params["model"]["model_params"]["decoder"]["decoder_params"]["reconstruct_images"] = False
    Experiment(tmp_path / "features").save_params(params)
    with pytest.raises(ValueError, match="reconstruct_images"):
        DecompEvaluator(tmp_path / "features", "ckpt", device="cpu")
    ev = port_evaluator(savi_exp, batch_size=3, results_name="mine")
    assert ev.batch_size == 3 and ev.results_name == "mine"
    with pytest.raises(FileNotFoundError, match="absent.pt"):
        DecompEvaluator(savi_exp, "absent", device="cpu").load_model()
