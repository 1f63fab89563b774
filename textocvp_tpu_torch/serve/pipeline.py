"""
Inference service of the port: load a trained experiment once, answer
prediction requests at a fixed batch and caption length.

A request is (B, num_context, H, W, 3) frames, uint8 or float32 in [0, 1],
and B captions. It is padded to the service's batch (and its captions to
``max_tokens``), runs two stages on the device, and the padding is sliced off
the reply:

1. predict: the decomposition model's encode (SAVi's conv stack, or
   ExtendedDINOSAUR's frozen ViT) + slot attention on the context frames,
   then the predictor's rollout of ``num_preds`` slot frames (the caption
   read by TextOCVP, ignored by the predictors without text);
2. decode: the model's decoder (SAVi's spatial-broadcast conv decoder, or
   ExtendedDINOSAUR's MLP patch decoder and CNN head) on every predicted
   frame, clipped to [0, 1] and rounded to uint8 on the device.

Numerics: float32 throughout, as the JAX package serves by default. TF32 is
off for matmuls and for cuDNN convolutions (``torch.backends.cuda.matmul.
allow_tf32 = False``, ``torch.backends.cudnn.allow_tf32 = False``); bf16
compute is later work.
"""

from __future__ import annotations

import threading
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from textocvp_tpu_torch.core.experiment import Experiment
from textocvp_tpu_torch.core.logger import Logger
from textocvp_tpu_torch.data.tokenizers import TEXT_KEYS, get_tokenizer
from textocvp_tpu_torch.data.vocabularies import (
    CATER_EASY_VOCAB,
    CATER_HARD_VOCAB,
    CLIPORT_VOCAB,
    SYNTHETIC_VOCAB,
)
from textocvp_tpu_torch.data.wire import as_float_video, to_uint8_frames
from textocvp_tpu_torch.models.factory import (
    check_image_reconstruction,
    setup_model,
    setup_predictor,
)
from textocvp_tpu_torch.train.checkpoints import load_params

_VOCABS = {
    "CATER_Easy": CATER_EASY_VOCAB,
    "CATER_Hard": CATER_HARD_VOCAB,
    "CLIPort": CLIPORT_VOCAB,
    "Synthetic": SYNTHETIC_VOCAB,
}


def serving_tokenizer(exp_params: dict):
    """The dataset config's tokenizer (``T5`` by default), a CustomTokenizer
    over the dataset's vocabulary, as the JAX service picks it."""
    ds = exp_params["dataset"]
    return get_tokenizer(ds.get("tokenizer", "T5"),
                         vocabulary=_VOCABS.get(ds.get("dataset_name")))


class InferenceFrontend:
    """Host-side request handling: validation, batch and caption padding,
    tokenization. Subclasses provide ``_predict_stage`` and ``_decode_stage``
    and the contract attributes (batch_size, num_context, num_preds,
    resolution, max_tokens, tokenizer, wire_dtype)."""

    def _tokenize(self, captions: Sequence[str]) -> dict:
        """{key of TEXT_KEYS: array} of the captions, each (B, L) array padded
        to ``max_tokens``, ``caption_lengths`` as it is; None values left out."""
        try:
            info = self.tokenizer(list(captions))
        except KeyError as e:
            # a CustomTokenizer's vocabulary is closed: a request error
            raise ValueError(f"caption contains out-of-vocabulary word: {e}") from e
        out = {}
        for key in TEXT_KEYS:
            if info.get(key) is None:
                continue
            v = np.asarray(info[key])
            if v.ndim == 2:
                if v.shape[1] > self.max_tokens:
                    # rejected, not truncated: a silent cut would degrade the
                    # prediction with no signal to the client
                    raise ValueError(f"caption too long: {v.shape[1]} tokens exceed "
                                     f"max_tokens={self.max_tokens}")
                v = np.pad(v, ((0, 0), (0, self.max_tokens - v.shape[1])))
            out[key] = v
        return out

    def _warmup_caption(self) -> str:
        """The in-vocabulary word of lowest id that is not a special token
        (a closed vocabulary refuses any other), else ``"warmup"``."""
        vocab = getattr(self.tokenizer, "vocabulary", None)
        if isinstance(vocab, dict):
            for word, _ in sorted(vocab.items(), key=lambda kv: kv[1]):
                if not (word.startswith("[") and word.endswith("]")):
                    return word
        return "warmup"

    def warmup(self):
        """One dummy request: builds the kernel and warms the device up."""
        h, w = self.resolution
        self.predict(np.zeros((1, self.num_context, h, w, 3), np.float32),
                     [self._warmup_caption()])

    def predict(self, frames: np.ndarray, captions: Sequence[str]) -> np.ndarray:
        """frames (B, num_context, H, W, 3) uint8 or float32 in [0, 1]; B captions.
        Returns (B, num_preds, H, W, 3) float32 in [0, 1], on the 1/255 grid.
        The dispatch lock covers the H2D copy, both stages and the start of the
        D2H copy; the wait for the reply's bytes runs outside it."""
        frames = np.asarray(frames)
        if self.wire_dtype == "uint8":
            frames = to_uint8_frames(frames)
        elif frames.dtype == np.uint8:
            frames = as_float_video(frames)
        else:
            frames = frames.astype(np.float32, copy=False)
        b = frames.shape[0] if frames.ndim else 0
        if b < 1:
            raise ValueError("empty request: at least one video is required")
        if b > self.batch_size:
            raise ValueError(f"request batch {b} exceeds the service batch {self.batch_size}")
        if len(captions) != b:
            raise ValueError(f"{b} videos but {len(captions)} captions")
        if frames.shape[1:] != (self.num_context, *self.resolution, 3):
            raise ValueError(f"expected frames (B, {self.num_context}, {self.resolution[0]}, "
                             f"{self.resolution[1]}, 3), got {frames.shape}")
        pad = self.batch_size - b
        if pad:
            frames = np.concatenate([frames, np.repeat(frames[-1:], pad, axis=0)], axis=0)
            captions = list(captions) + [captions[-1]] * pad
        text = self._tokenize(captions)
        with self._lock:
            imgs, done = self._start_fetch(self._decode_stage(self._predict_stage(frames, text)))
        # wait outside the lock, as the JAX service does: a second caller
        # (serve/batching.py's dispatchers) enqueues batch N+1 while batch N's
        # bytes come back
        if done is not None:
            done.synchronize()
        return imgs.numpy()[:b].astype(np.float32) / 255.0

    @staticmethod
    def _start_fetch(imgs):
        """Start the copy of ``imgs`` to the host -> (host tensor, event). On a
        CUDA device a ``non_blocking`` copy into pinned memory and an event
        recorded after it, to wait on before reading; on the CPU ``imgs``
        itself and None."""
        if imgs.device.type != "cuda":
            return imgs, None
        host = torch.empty(imgs.shape, dtype=imgs.dtype, pin_memory=True)
        host.copy_(imgs, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return host, done


class PredictionService(InferenceFrontend):
    """Text-conditioned video prediction over one trained experiment, on one device.

    ``exp_path`` is the decomposition experiment; ``name_pred_exp`` names its
    nested predictor experiment (``predictors/<name>``) or is a path to it.
    Checkpoints are ``models/<ckpt>.pt``, training checkpoints or bare state
    dicts (``train/checkpoints.py::load_params``), BatchNorm running
    statistics included. The model is SAVi or ExtendedDINOSAUR, as
    the experiment's params say; the input resolution is the dataset's
    ``img_size``. ``generator``
    draws the slot noise of a ``LearnedRandom`` initializer; by default one
    on ``device`` seeded with 14.
    """

    def __init__(self, exp_path, name_pred_exp: str, decomp_ckpt: str, pred_ckpt: str,
                 num_seed: Optional[int] = None, num_preds: Optional[int] = None,
                 batch_size: int = 8, max_tokens: int = 24, wire_dtype: str = "float32",
                 device="cuda", generator: Optional[torch.Generator] = None):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("PredictionService: no CUDA device; pass device='cpu' to "
                               "run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

        self.parent = Experiment(exp_path)
        pred_path = Path(name_pred_exp)
        self.exp = Experiment(pred_path if pred_path.is_absolute()
                              else self.parent.exp_path / "predictors" / name_pred_exp)
        Logger(self.exp.exp_path)
        self.exp_params = self.exp.params
        pp = self.exp_params["prediction_params"]
        if num_seed is not None:
            pp["num_context"] = num_seed
        if num_preds is not None:
            pp["num_preds"] = num_preds
        self.num_context = pp["num_context"]
        self.num_preds = pp["num_preds"]
        self.batch_size = int(batch_size)
        self.max_tokens = int(max_tokens)
        if wire_dtype not in ("float32", "uint8"):
            raise ValueError(f"wire_dtype {wire_dtype!r}: use float32|uint8")
        self.wire_dtype = wire_dtype

        mp = self.exp_params["model"]["model_params"]
        self.num_slots, self.slot_dim = mp["num_slots"], mp["slot_dim"]
        res = (self.exp_params["dataset"].get("img_size")
               or mp.get("resolution") or mp.get("img_size"))
        if isinstance(res, int):
            res = (res, res)
        self.resolution = (int(res[0]), int(res[1]))

        check_image_reconstruction(self.exp_params, purpose="serve")
        self.tokenizer = serving_tokenizer(self.exp_params)
        self.model = self._load(setup_model(self.exp_params),
                                self.parent.checkpoint_path(decomp_ckpt))
        self.predictor = self._load(setup_predictor(self.exp_params),
                                    self.exp.checkpoint_path(pred_ckpt))
        self.generator = generator or torch.Generator(self.device).manual_seed(14)
        self._lock = threading.Lock()

    def _load(self, module, path):
        module.load_state_dict(load_params(path))
        return module.to(self.device).eval().requires_grad_(False)

    @torch.inference_mode()
    def _predict_stage(self, frames: np.ndarray, text: dict):
        videos = as_float_video(torch.from_numpy(frames).to(self.device))
        slots = self.model.decompose(videos, generator=self.generator)
        text = {k: torch.from_numpy(v).to(self.device) for k, v in text.items()}
        return self.predictor(slots["slot_history"], num_preds=self.num_preds,
                              teacher_force=False, **text)

    @torch.inference_mode()
    def _decode_stage(self, pred_slots):
        b, p, s, d = pred_slots.shape
        imgs = self.model.decode(pred_slots.reshape(b * p, s, d))["recons_imgs"]
        # uint8 on the device: the reply is 8-bit by contract, and fetching
        # uint8 moves a quarter of the bytes
        imgs = torch.round(imgs.clamp(0.0, 1.0) * 255.0).to(torch.uint8)
        return imgs.reshape(b, p, *imgs.shape[1:])
