"""Model and predictor factories over ``experiment_params``: SAVi and
ExtendedDINOSAUR; the five predictors of the JAX package."""

from __future__ import annotations

import math

import torch
from torch import nn

from textocvp_tpu_torch.core.config import check_compute_dtype
from textocvp_tpu_torch.models.extended_dinosaur import ExtendedDINOSAUR
from textocvp_tpu_torch.models.predictors import (
    OCVPPar,
    OCVPSeq,
    PredictorWrapper,
    TextOCVP,
    VanillaTransformerPredictor,
)
from textocvp_tpu_torch.models.savi import SAVi
from textocvp_tpu_torch.nn.precision import COMPUTE_DTYPES, set_compute_dtype

MODELS = ["SAVi", "ExtendedDINOSAUR"]
PREDICTORS = ["VanillaTransformer", "OCVPSeq", "OCVPPar", "TextOCVP_CustomTF", "TextOCVP_T5"]
UNCONDITIONED = {"VanillaTransformer": VanillaTransformerPredictor, "OCVPSeq": OCVPSeq,
                 "OCVPPar": OCVPPar}


def check_image_reconstruction(exp_params: dict, purpose: str = "evaluate"):
    """Raise when an ExtendedDINOSAUR experiment cannot produce RGB frames: an
    MLPPatchDecoder with ``reconstruct_images: false`` decodes ViT patch
    features only, so there is nothing to render, compare or serve."""
    dp = exp_params["model"]["model_params"].get("decoder", {})
    if (dp.get("decoder_name") == "MLPPatchDecoder"
            and not dp.get("decoder_params", {}).get("reconstruct_images")):
        raise ValueError(
            "this experiment's MLPPatchDecoder has reconstruct_images "
            "disabled — it decodes ViT patch features, not RGB frames, so "
            f"there is nothing to {purpose}; retrain with reconstruct_images "
            "or use a SAVi-decoder experiment")


def _dtype_of(exp_params: dict) -> torch.dtype:
    """The torch dtype of ``tpu.compute_dtype`` (the JAX factory's ``_dtype_of``,
    which maps any other name to float32 where :func:`check_compute_dtype`
    raises)."""
    return COMPUTE_DTYPES[check_compute_dtype(exp_params)]


def setup_model(exp_params: dict) -> SAVi | ExtendedDINOSAUR:
    """The decomposition model of ``exp_params``, in its compute dtype."""
    dtype = _dtype_of(exp_params)
    model_name = exp_params["model"]["model_name"]
    if model_name not in MODELS:
        raise NameError(f"Model '{model_name}' is not ported; the port has {MODELS}")
    mp = exp_params["model"]["model_params"]
    common = dict(
        num_slots=mp["num_slots"],
        slot_dim=mp["slot_dim"],
        encoder=mp["encoder"],
        decoder=mp["decoder"],
        num_iterations=mp.get("num_iterations", 1),
        num_iterations_first=mp.get("num_iterations_first", 3),
        mlp_hidden=mp.get("mlp_hidden", 128),
        initializer=mp.get("initializer", "LearnedRandom"),
        transition_module=mp.get("transition_module"),
    )
    if model_name == "ExtendedDINOSAUR":
        model = ExtendedDINOSAUR(img_size=mp["img_size"],
                                 mlp_encoder_dim=mp.get("mlp_encoder_dim", 768), **common)
    else:
        model = SAVi(in_channels=mp.get("in_channels", 3),
                     mlp_encoder_dim=mp.get("mlp_encoder_dim", 128), **common)
    return set_compute_dtype(model, dtype)


def setup_predictor(exp_params: dict) -> PredictorWrapper:
    """The predictor of ``exp_params`` in its rollout wrapper: an
    unconditioned one from ``predictor_params`` as they stand, a TextOCVP
    from its nested ``predictor_params``, ``fusion_params`` and
    ``text_encoder_params``, its text encoder named by the predictor; in its
    compute dtype."""
    dtype = _dtype_of(exp_params)
    name = exp_params["predictor"]["predictor_name"]
    if name not in PREDICTORS:
        raise NameError(f"Predictor '{name}' is not ported; the port has {PREDICTORS}")
    mp = exp_params["model"]["model_params"]
    prediction = exp_params["prediction_params"]
    params = exp_params["predictor"]["predictor_params"]
    if name in UNCONDITIONED:
        predictor = UNCONDITIONED[name](
            num_slots=mp["num_slots"], slot_dim=mp["slot_dim"],
            input_buffer_size=prediction["input_buffer_size"], **params)
    else:
        pp = params.get("predictor_params", {})
        fusion = params.get("fusion_params", {})
        predictor = TextOCVP(
            num_slots=mp["num_slots"],
            slot_dim=mp["slot_dim"],
            token_dim=pp.get("token_dim", 512),
            n_heads=pp.get("n_heads", 8),
            hidden_dim=pp.get("hidden_dim", 2048),
            num_layers=pp.get("num_layers", 8),
            residual=pp.get("residual", True),
            input_buffer_size=prediction["input_buffer_size"],
            fusion_num_heads=fusion.get("num_heads", 8),
            fusion_head_dim=fusion.get("head_dim", 64),
            fusion_mlp_size=fusion.get("mlp_size", 2048),
            text_encoder_type="t5" if name == "TextOCVP_T5" else "custom_tf",
            text_encoder_params=params.get("text_encoder_params"),
        )
    wrapper = PredictorWrapper(predictor, num_context=prediction["num_context"],
                               num_preds=prediction["num_preds"],
                               input_buffer_size=prediction.get("input_buffer_size"),
                               teacher_force=prediction.get("teacher_force", False))
    return set_compute_dtype(wrapper, dtype)


@torch.no_grad()
def random_init_(module: nn.Module, generator: torch.Generator, bias_scale: float = 0.05):
    """Draw every parameter of ``module`` from ``generator`` (on the CPU), for
    runs with random weights: matrices and conv kernels Xavier-uniform,
    embeddings N(0, 1), norm scales 1 + U(-bias_scale, bias_scale), and every
    other vector (biases, slot and PE tables) U(-bias_scale, bias_scale)."""

    def uniform(shape, lim):
        return (torch.rand(shape, generator=generator) * 2 - 1) * lim

    for mod in module.modules():
        for name, p in mod.named_parameters(recurse=False):
            if isinstance(mod, nn.Embedding):
                new = torch.randn(p.shape, generator=generator)
            elif name.startswith("weight") and p.dim() >= 2:
                fan_out, fan_in = p.shape[0], p[0].numel()
                recept = p[0, 0].numel() if p.dim() > 2 else 1
                new = uniform(p.shape, math.sqrt(6.0 / (fan_in + fan_out * recept)))
            elif name == "weight":
                new = 1 + uniform(p.shape, bias_scale)
            else:
                new = uniform(p.shape, bias_scale)
            p.copy_(new.to(p.device, p.dtype))
    return module
