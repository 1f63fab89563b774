"""The 05 evaluator and the service of the port's four other predictors
(VanillaTransformer, OCVPSeq, OCVPPar, TextOCVP_CustomTF) on the CPU,
against the JAX package (their 04 step: ``test_torch_port_train_predictors.py``;
the 04 / 05 CLIs: ``_train_predictors_cli.py``).

* 05 and the service: one tiny experiment with both packages' checkpoints of
  the same weights, SAVi's ``Learned`` initializer (no random draw differs),
  CustomTokenizer captions; ``results.json`` (five decimals on both sides)
  within one unit of its fifth decimal, as ``test_torch_port_cliport.py``;
  served frames within one uint8 level.
"""

import torch_cpu_threads  # noqa: F401  (two torch threads a worker)
import os
import warnings

os.environ.setdefault("HF_HUB_OFFLINE", "1")
os.environ.setdefault("TRANSFORMERS_OFFLINE", "1")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
from test_torch_port_cliport import TOL  # noqa: E402
from test_torch_port_evaluator import write_cater_npy  # noqa: E402
from test_torch_port_predictors import captions, tiny_params  # noqa: E402
from test_torch_port_train_predictor import _perturb  # noqa: E402
from test_torch_port_train_predictors import B, P, RES, S, D  # noqa: E402

from textocvp_tpu.models import setup_model as jax_setup_model  # noqa: E402
from textocvp_tpu.models import setup_predictor as jax_setup_predictor  # noqa: E402
from textocvp_tpu.serve import PredictionService as JaxPredictionService  # noqa: E402
from textocvp_tpu.train.checkpoints import save_checkpoint as jax_save_checkpoint  # noqa: E402
from textocvp_tpu.train.evaluator import PredictorEvaluator as JaxPredictorEvaluator  # noqa: E402
from textocvp_tpu_torch.convert import from_jax_params  # noqa: E402
from textocvp_tpu_torch.core.config import add_predictor_params, build_exp_params  # noqa: E402
from textocvp_tpu_torch.core.experiment import Experiment  # noqa: E402
from textocvp_tpu_torch.serve import PredictionService  # noqa: E402
from textocvp_tpu_torch.train.evaluator import PredictorEvaluator  # noqa: E402


# ------------------------------------------------------- 05 and the service


CUSTOM = ("OCVPSeq", "TextOCVP_CustomTF")


@pytest.fixture(scope="module")
def custom_exp(tmp_path_factory):
    """One tiny SAVi experiment over a CATER .npy fixture whose dataset reads
    the CustomTokenizer, with an OCVPSeq and a TextOCVP_CustomTF predictor
    experiment: both packages' checkpoints of the same weights."""
    from test_torch_port_evaluator import _tiny_params

    root = tmp_path_factory.mktemp("custom_eval")
    params, _ = _tiny_params(write_cater_npy(root / "CATER"))
    params["dataset"]["tokenizer"] = "CustomTokenizer"
    parent = Experiment(root / "exp")
    parent.save_params(params)
    rng = np.random.default_rng(33)
    mvars = jax.jit(lambda x: jax_setup_model(params).init(
        {"params": jax.random.PRNGKey(0)}, x, decode=True))(jnp.zeros((1, 1, RES, RES, 3)))
    mparams = _perturb(jax.device_get(mvars["params"]), rng)
    jax_save_checkpoint(parent.models_dir, "ckpt", {"params": mparams})
    torch.save(from_jax_params("savi", mparams), parent.checkpoint_path("ckpt"))
    tokens, lengths = captions()
    for name in CUSTOM:
        pp = tiny_params(build_exp_params, add_predictor_params, name, base=params)
        pred = Experiment(parent.exp_path / "predictors" / name)
        pred.save_params(pp)
        pvars = jax.jit(lambda z, t, n, jp=jax_setup_predictor(pp): jp.init(
            {"params": jax.random.PRNGKey(1)}, z, caption_tokens=t, caption_lengths=n))(
            jnp.zeros((1, 1, S, D)), jnp.asarray(tokens[:1]), jnp.asarray(lengths[:1]))
        pparams = _perturb(jax.device_get(pvars["params"]), rng)
        jax_save_checkpoint(pred.models_dir, "ckpt", {"params": pparams})
        torch.save(from_jax_params("predictor", pparams), pred.checkpoint_path("ckpt"))
    return parent.exp_path


@pytest.mark.parametrize("name", CUSTOM)
def test_evaluator_matches_jax(custom_exp, name):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref_ev = JaxPredictorEvaluator(custom_exp, name, "ckpt", "ckpt", num_seed=1,
                                       num_preds=P, results_name="jax")
        ref_ev.load_data()
        videos, others = next(iter(ref_ev.test_loader))
        ref_ev.load_models(videos, others)
        ref = ref_ev.evaluate()
        ev = PredictorEvaluator(custom_exp, name, "ckpt", "ckpt", num_seed=1, num_preds=P,
                                results_name="torch", device="cpu")
    ev.load_data()
    _, info = next(iter(ev.test_loader))
    assert info["attn_masks"] is None and info["caption_lengths"].shape == (B,)
    ev.load_models()
    out = ev.evaluate()
    assert set(out) == set(ref) == {"psnr", "ssim", "lpips"}
    for m in ("psnr", "ssim", "lpips"):
        assert len(out[m]["framewise"]) == P
        got = np.asarray(out[m]["framewise"] + [out[m]["mean"]])
        want = np.asarray(ref[m]["framewise"] + [ref[m]["mean"]])
        assert np.abs(got - want).max() <= TOL + 1e-12, (m, got, want)


def test_custom_tf_service_matches_the_jax_chain(custom_exp):
    name = "TextOCVP_CustomTF"
    frames = np.random.default_rng(2).uniform(0, 1, (B, 1, RES, RES, 3)).astype(np.float32)
    texts = ["the cone is sliding to (1, -2)", "the snitch is rotating"]
    service = PredictionService(custom_exp, name, "ckpt", "ckpt", batch_size=B, max_tokens=16,
                                device="cpu")
    jax_service = JaxPredictionService(custom_exp, name, "ckpt", "ckpt", batch_size=B,
                                       max_tokens=16)
    ours, theirs = service._tokenize(texts), jax_service._tokenize(texts)
    assert set(ours) == set(theirs) == {"caption_tokens", "caption_lengths"}
    for key in ours:
        np.testing.assert_array_equal(ours[key], theirs[key])
    ref = jax_service.predict(frames, texts)
    out = service.predict(frames, texts)
    assert out.shape == ref.shape == (B, P, RES, RES, 3)
    # uint8 outputs within one level on every pixel (rounding at a .5 boundary)
    levels = np.abs(np.rint(out * 255).astype(int) - np.rint(ref * 255).astype(int))
    assert levels.max() <= 1, levels.max()
