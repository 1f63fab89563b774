"""The evaluators' opt-in int8 (``tpu.decode_quant`` / ``tpu.encode_quant``)
on the CPU: 05 on a tiny CATER SAVi + TextOCVP_T5 and 03 on a tiny
ExtendedDINOSAUR over a CLIPort color cache, each against the same
evaluator without int8 on the same weights (random, from a seed).

As the JAX evaluators do: the scales are calibrated on the first batch (05:
the decoder's on that batch's predicted slots; 03: the ViT's on its frames,
the decoder's on the slots of a float encode from the same initial slots),
that batch runs quantized like the others, and ``results.json`` carries
``"decode_quant": "int8"`` / ``"encode_quant": "int8"``. The calibrated
scales are held bit for bit to a calibration of the first batch made apart.
"""

import torch_cpu_threads  # noqa: F401  (two torch threads a worker)
import json
import warnings

import numpy as np
import pytest
import torch
from test_torch_port_cliport import tiny_cliport_params, write_cliport
from test_torch_port_evaluator import _tiny_params, write_cater_npy

from textocvp_tpu_torch.cli.evaluate_predictor import main as evaluate_predictor
from textocvp_tpu_torch.core.config import add_predictor_params, build_exp_params
from textocvp_tpu_torch.core.experiment import Experiment
from textocvp_tpu_torch.models import setup_model, setup_predictor
from textocvp_tpu_torch.models.factory import random_init_
from textocvp_tpu_torch.models.quant import calibrate_decode_scales, calibrate_encode_scales
from textocvp_tpu_torch.train.evaluator import DecompEvaluator, PredictorEvaluator

METRICS = ("psnr", "ssim", "lpips")


def _save(exp: Experiment, params, module):
    exp.save_params(params)
    exp.models_dir.mkdir(parents=True, exist_ok=True)
    torch.save(module.state_dict(), exp.checkpoint_path("ckpt"))


@pytest.fixture(scope="module")
def cater_exp(tmp_path_factory):
    """A tiny SAVi experiment with two TextOCVP_T5 experiments of the same
    weights: ``float`` and ``int8`` (``tpu.decode_quant``)."""
    root = tmp_path_factory.mktemp("quant_eval_cater")
    params, pred_params = _tiny_params(write_cater_npy(root / "CATER"))
    gen = torch.Generator().manual_seed(41)
    _save(Experiment(root / "exp"), params, random_init_(setup_model(params), gen))
    predictor = random_init_(setup_predictor(pred_params), gen)
    for name, tpu in (("float", {}), ("int8", {"decode_quant": "int8"})):
        _save(Experiment(root / "exp" / "predictors" / name), {**pred_params, "tpu": tpu},
              predictor)
    return root / "exp"


def _predictor_evaluator(exp_dir, name):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # LPIPS's random AlexNet
        ev = PredictorEvaluator(exp_dir, name, "ckpt", "ckpt", batch_size=2, device="cpu")
    ev.load_data()
    ev.load_models()
    return ev


def test_05_calibrates_on_its_first_batch_and_flags_its_results(cater_exp):
    results = {name: _predictor_evaluator(cater_exp, name).evaluate()
               for name in ("float", "int8")}
    assert "decode_quant" not in results["float"] and "encode_quant" not in results["float"]
    assert results["int8"]["decode_quant"] == "int8" and "encode_quant" not in results["int8"]
    for m in METRICS:
        assert np.isfinite(results["int8"][m]["framewise"]).all()
    # the int8 decode changes what the decoder outputs
    assert results["int8"]["psnr"]["framewise"] != results["float"]["psnr"]["framewise"]

    ev = _predictor_evaluator(cater_exp, "int8")
    videos, info = next(iter(ev.test_loader))
    assert ev.decode_quant_scales is None
    first = ev.eval_step(videos, info)
    scales = ev.decode_quant_scales
    assert scales.shape == (1,)  # the tiny decoder's one tail conv before the final one
    again = _predictor_evaluator(cater_exp, "int8")
    v, text = again.to_device(videos, info)
    with torch.inference_mode():
        slots = again.predict_stage(v, text)
        want = calibrate_decode_scales(again.model, slots.reshape(-1, *slots.shape[2:]))
    assert torch.equal(scales, want)
    # the first batch ran quantized: the same metrics as a second run of it
    assert all(torch.equal(ev.eval_step(videos, info)[m], first[m]) for m in METRICS)


def test_05_cli_writes_the_flag(cater_exp):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert evaluate_predictor(["-d", str(cater_exp), "--name_pred_exp", "int8",
                                   "--decomp_ckpt", "ckpt", "--pred_ckpt", "ckpt",
                                   "--num_preds", "2", "--batch_size", "4",
                                   "--device", "cpu"]) == 0
    res = json.loads((cater_exp / "predictors" / "int8" / "results"
                      / "eval_pred_ckpt_NumSeed=1_NumPreds=2" / "results.json").read_text())
    assert res["decode_quant"] == "int8"


def test_03_with_both_modes_flags_its_results(tmp_path):
    params, _ = tiny_cliport_params(build_exp_params, add_predictor_params,
                                    write_cliport(tmp_path / "CLIPort"))
    params["dataset"]["num_frames"] = 2
    model = random_init_(setup_model(params), torch.Generator().manual_seed(42))
    for name, tpu in (("float", {}), ("int8", {"decode_quant": "int8", "encode_quant": "int8"})):
        _save(Experiment(tmp_path / name), {**params, "tpu": tpu}, model)
    evs = {}
    for name in ("float", "int8"):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            evs[name] = DecompEvaluator(tmp_path / name, "ckpt", batch_size=2, device="cpu")
        evs[name].load_data()
        evs[name].load_model()
    videos, _ = next(iter(evs["int8"].test_loader))
    results = {name: ev.evaluate() for name, ev in evs.items()}
    assert "decode_quant" not in results["float"] and "encode_quant" not in results["float"]
    assert results["int8"]["decode_quant"] == results["int8"]["encode_quant"] == "int8"
    for m in METRICS:
        assert np.isfinite(results["int8"][m]["framewise"]).all()
    ev = evs["int8"]
    depth = len(ev.model.image_encoder.blocks)
    assert ev.encode_quant_scales.shape == (depth, 4)
    assert ev.decode_quant_scales.shape == (ev.model.patch_decoder.num_quant_layers(),)
    with torch.inference_mode():
        want = calibrate_encode_scales(ev.model, ev.to_device(videos))
    assert torch.equal(ev.encode_quant_scales, want)
