"""
05 evaluate-predictor protocol of the port (counterpart of
``textocvp_tpu/train/evaluator.py::PredictorEvaluator``).

Per batch, on one device: the seed encode of the first ``num_seed`` frames
(the decomposition model's encoder and slot attention), the predictor's
rollout of ``num_preds`` slot frames, the decode of all B * num_preds
predicted frames, and PSNR/SSIM/LPIPS of the predictions, clipped to [0, 1],
against the true frames, clipped too. Only the seed frames are encoded: the
slot recurrence is causal.

Overrides as in the JAX package: ``num_seed`` overrides ``num_context``,
``num_preds`` the rollout length, and the dataset's ``num_frames`` becomes
``num_seed + num_preds``. A ragged last batch runs as it is; its rows'
metrics equal the JAX package's pad-and-slice. Float32 throughout, TF32
off for matmuls and cuDNN. ``LearnedRandom`` slot noise comes from one
``torch.Generator`` on the device seeded 14 (it cannot match ``jax.random``).
The decode is not chunked: at B = 64 on CATER one activation of the decoder
tail is 9728 x 64 x 64 x 64 float32, 10.2 GB, and the tail holds two at once.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np
import torch

from textocvp_tpu_torch.core.experiment import Experiment
from textocvp_tpu_torch.data.loader import EpochLoader, load_data
from textocvp_tpu_torch.data.tokenizers import text_tensors
from textocvp_tpu_torch.data.wire import as_float_video
from textocvp_tpu_torch.models.factory import (
    check_image_reconstruction,
    setup_model,
    setup_predictor,
)
from textocvp_tpu_torch.train.checkpoints import load_params
from textocvp_tpu_torch.train.metrics import MetricTracker


def _tokenizer_fallback_flags(dataset) -> dict:
    """Results made with the hash tokenizer (ids that are not T5's) say so."""
    tok = getattr(dataset, "tokenizer", None)
    if tok is not None and getattr(tok, "is_fallback", False):
        return {"tokenizer_fallback": True}
    return {}


class PredictorEvaluator:
    """Evaluate a predictor checkpoint on the video-prediction protocol.

    ``exp_path`` is the decomposition experiment; ``name_pred_exp`` names its
    nested predictor experiment (``predictors/<name>``) or is a path to it.
    Checkpoints are ``models/<ckpt>.pt``, training checkpoints or bare state
    dicts (``train/checkpoints.py::load_params``). Call :meth:`load_data`,
    :meth:`load_models`, then :meth:`evaluate`.
    """

    def __init__(self, exp_path, name_pred_exp: str, decomp_ckpt: str, pred_ckpt: str,
                 num_seed: Optional[int] = None, num_preds: Optional[int] = None,
                 batch_size: Optional[int] = None, results_name: Optional[str] = None,
                 metrics=("psnr", "ssim", "lpips"), device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("PredictorEvaluator: no CUDA device; pass device='cpu' to "
                               "evaluate on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

        self.parent = Experiment(exp_path)
        pred_path = Path(name_pred_exp)
        self.exp = Experiment(pred_path if pred_path.is_absolute()
                              else self.parent.exp_path / "predictors" / name_pred_exp)
        self.exp_params = self.exp.params
        self.decomp_ckpt = decomp_ckpt
        self.pred_ckpt = pred_ckpt

        pp = self.exp_params["prediction_params"]
        if num_seed is not None:
            pp["num_context"] = num_seed
        if num_preds is not None:
            pp["num_preds"] = num_preds
        self.num_context = pp["num_context"]
        self.num_preds = pp["num_preds"]
        self.exp_params["dataset"]["num_frames"] = self.num_context + self.num_preds
        self.batch_size = batch_size or self.exp_params["training"]["batch_size"]
        self.results_name = results_name or (
            f"eval_pred_{pred_ckpt}_NumSeed={self.num_context}_NumPreds={self.num_preds}")

        check_image_reconstruction(self.exp_params, purpose="evaluate predictions on")
        self.model = setup_model(self.exp_params)
        self.predictor = setup_predictor(self.exp_params)
        self.metric_tracker = MetricTracker(metrics, device=self.device)
        self.generator = torch.Generator(self.device).manual_seed(14)

    def load_data(self):
        self.test_set = load_data(self.exp_params, split="test")
        self.test_loader = EpochLoader(self.test_set, self.batch_size)

    def load_models(self):
        self.model = self._load(self.model, self.parent.checkpoint_path(self.decomp_ckpt))
        self.predictor = self._load(self.predictor, self.exp.checkpoint_path(self.pred_ckpt))

    def _load(self, module, path):
        module.load_state_dict(load_params(path))
        return module.to(self.device).eval().requires_grad_(False)

    @torch.inference_mode()
    def predict_stage(self, videos, text: dict, initial_slots=None):
        """Seed encode + rollout: videos (B, T, H, W, 3) on the device ->
        predicted slots (B, num_preds, S, D)."""
        seed = videos[:, :self.num_context]
        slots = self.model.decompose(
            seed, initial_slots=None if initial_slots is None else initial_slots.to(self.device),
            generator=self.generator)["slot_history"]
        return self.predictor(slots, num_preds=self.num_preds, teacher_force=False, **text)

    @torch.inference_mode()
    def decode_stage(self, pred_slots):
        """All B * num_preds predicted frames -> (B, num_preds, H, W, 3), clipped to [0, 1]."""
        b, p, s, d = pred_slots.shape
        imgs = self.model.decode(pred_slots.reshape(b * p, s, d))["recons_imgs"]
        return imgs.reshape(b, p, *imgs.shape[1:]).clamp(0.0, 1.0)

    @torch.inference_mode()
    def metrics_stage(self, pred_imgs, videos) -> dict:
        c, p = self.num_context, self.num_preds
        targets = videos[:, c:c + p].clamp(0.0, 1.0)
        return self.metric_tracker.compute(pred_imgs, targets)

    def to_device(self, videos, info: dict):
        """A loader batch -> float video and caption tensors on the device
        (``data/tokenizers.py::text_tensors``)."""
        videos = as_float_video(torch.as_tensor(np.asarray(videos)).to(self.device))
        return videos, text_tensors(info, self.device)

    def eval_step(self, videos, info: dict, initial_slots=None) -> dict:
        """One batch: framewise metrics {name: (B, num_preds)} on the device."""
        videos, text = self.to_device(videos, info)
        pred_imgs = self.decode_stage(self.predict_stage(videos, text, initial_slots))
        return self.metrics_stage(pred_imgs, videos)

    def evaluate(self) -> dict:
        self.metric_tracker.reset()
        for videos, info in self.test_loader:
            self.metric_tracker.accumulate(precomputed=self.eval_step(videos, info))
        self.metric_tracker.aggregate()
        results = self.metric_tracker.to_json()
        results.update(_tokenizer_fallback_flags(self.test_set))
        self.exp.save_results(self.results_name, results)
        print(f"Results: { {k: v['mean'] for k, v in results.items() if isinstance(v, dict)} }")
        return results
