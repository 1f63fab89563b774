"""
Stage-2 (predictor) trainer of the port for any of the five predictors on
SAVi (CATER) or ExtendedDINOSAUR (CLIPort) (counterpart of the JAX package's
``textocvp_tpu/train/predictor_trainer.py::PredictorTrainer``).

A nested predictor experiment (``<exp>/predictors/<name>``) trains its
predictor through the parent experiment's frozen decomposition model, loaded
from ``decomp_ckpt`` (a training checkpoint or a bare state dict,
``train/checkpoints.py::load_params``) and run in ``eval()``: an
ExtendedDINOSAUR's BatchNorm normalizes with its running statistics, as the
JAX ``decomp_vars()`` hand it. Each (micro)batch of ``num_context +
num_preds`` frames:

1. is encoded into slots by the frozen model under ``torch.no_grad()`` (the
   JAX ``stop_gradient``), ``forward(..., decode=False)``, with the slot
   noise of the shared stream (``Trainer._noise``, every train and every
   valid batch);
2. is rolled out by the predictor for ``num_preds`` frames, with teacher
   forcing when the config's ``teacher_force`` says so (the valid step never
   forces), the caption's arrays (``TEXT_KEYS`` that the tokenizer filled)
   handed to it as keywords;
3. has its predicted slots decoded by the frozen decoder, all B * num_preds
   frames at once, and the config's ``predictor_loss`` (``pred_img_mse`` +
   ``pred_slot_mse`` by default) taken against the true frames and the
   encoded slots. The predicted images are not clipped, as in the JAX
   trainer.

The image loss's gradient flows back through the frozen decoder (SAVi's
conv decoder, or ExtendedDINOSAUR's MLP patch decoder and CNN head) into the
predictor. Adam (``train/schedulers.py``) updates the predictor's parameters
that require grad: every one but the frozen T5's (TextOCVP_CustomTF's text
encoder trains). On the card every
slot-attention call of the encode launches ``csrc/slot_attention.cu``
(forward only), every ViT block of an ExtendedDINOSAUR's encode launches
``csrc/vit_attention.cu``, and every SAVi decoder-tail conv launches
``csrc/conv5.cu`` forward and again for its input gradient; the decoder is
frozen, so no weight gradient is computed.

It has the 02 trainer's extras (``train/trainer.py``): ``logs.txt``,
TensorBoard (its image strip the ground truth over a free-running rollout's
decode, the JAX ``viz_forward``), ``TEXTOCVP_PROFILE``, the background
checkpoint writer, and ``tpu.remat``, which recomputes the rollout and the
frozen decode of the predicted slots in the backward, the decode region by
region (``trainer.py::remat_frames``), while the frozen encode's slots,
computed outside the regions, are kept.

Not ported (ROADMAP.md): ``train_decode_chunks`` / ``valid_decode_kwargs``
and the mesh.
"""

from __future__ import annotations

from typing import Optional

import torch

from textocvp_tpu_torch.core.logger import log_function
from textocvp_tpu_torch.data.tokenizers import text_tensors
from textocvp_tpu_torch.models.factory import random_init_, setup_model, setup_predictor
from textocvp_tpu_torch.train.checkpoints import load_params
from textocvp_tpu_torch.train.losses import build_loss_fn
from textocvp_tpu_torch.train.trainer import INIT_SEED, Trainer, remat, remat_frames


class PredictorTrainer(Trainer):
    """Trainer of a slot predictor with the parent experiment's frozen
    decomposition model. ``model`` is the predictor (a ``PredictorWrapper``),
    ``decomp_model`` the SAVi or ExtendedDINOSAUR.

    Call :meth:`load_data`, :meth:`setup_model`, then :meth:`training_loop`."""

    IMAGE_TAG = "train/predictions"

    def __init__(self, exp_path, decomp_ckpt: str, checkpoint: Optional[str] = None,
                 resume_training: bool = False, device="cuda"):
        super().__init__(exp_path, checkpoint, resume_training, device)
        self.parent = self.exp.parent
        if self.parent is None:
            raise ValueError(f"{exp_path} is not a nested predictor experiment "
                             "(<exp>/predictors/<name>)")
        pp = self.exp_params["prediction_params"]
        self.num_context, self.num_preds = pp["num_context"], pp["num_preds"]
        # the clips hold the context and the frames to predict
        # (reference basePredictorTrainer.py:88-93)
        self.exp_params = {**self.exp_params, "dataset": {
            **self.exp_params["dataset"], "num_frames": self.num_context + self.num_preds}}
        self.decomp_ckpt = decomp_ckpt
        self.decomp_model = setup_model(self.exp_params)
        self.model = setup_predictor(self.exp_params)
        self.loss_fn = build_loss_fn(self.exp_params["predictor_loss"])

    @log_function
    def setup_model(self):
        """The frozen decomposition model from the parent's ``decomp_ckpt``, in
        ``eval()``; the predictor from
        ``random_init_`` with a generator seeded ``INIT_SEED``, or from
        ``checkpoint``, with ``resume_training`` also the optimizer state, the
        epoch and the step."""
        self.decomp_model.load_state_dict(
            load_params(self.parent.checkpoint_path(self.decomp_ckpt)))
        self.decomp_model.to(self.device).eval().requires_grad_(False)
        random_init_(self.model, torch.Generator().manual_seed(INIT_SEED))
        self.model.to(self.device).train()
        self._setup_optimizer()

    def batch_to_device(self, videos, info) -> tuple:
        return self.to_device(videos), text_tensors(info, self.device)

    @torch.no_grad()
    def encode(self, videos, noise):
        """Slots (B, c + p, S, D) of the first c + p frames, by the frozen model."""
        return self.decomp_model(videos[:, :self.num_context + self.num_preds], noise=noise,
                                 decode=False)["slot_history"]

    def rollout(self, slot_history, teacher_force: Optional[bool], text: dict):
        """Predicted slots (B, p, S, D)."""
        return self.model(slot_history, teacher_force=teacher_force, **text)

    def decode_frames(self, slots):
        """Slots (N, S, D) -> the frozen decoder's frames (N, H, W, C)."""
        return self.decomp_model.decode(slots)["recons_imgs"]

    def predict_loss(self, videos, slot_history, teacher_force: Optional[bool] = None,
                     **text):
        """(total, {name: value}): the rollout from the encoded slots, the
        decode of every predicted frame (with ``tpu.remat``: the rollout one
        :func:`remat` region, the decode :func:`remat_frames`) and the
        losses."""
        c, p = self.num_context, self.num_preds
        if self.remat and torch.is_grad_enabled():
            pred_slots = remat(self.rollout, slot_history, teacher_force, text)
            pred_imgs = remat_frames(self.decode_frames, pred_slots.flatten(0, 1))
        else:
            pred_slots = self.rollout(slot_history, teacher_force, text)
            pred_imgs = self.decode_frames(pred_slots.flatten(0, 1))
        target_imgs = videos[:, c:c + p]
        return self.loss_fn(pred_slots=pred_slots, target_slots=slot_history[:, c:c + p],
                            pred_imgs=pred_imgs.reshape(target_imgs.shape),
                            target_imgs=target_imgs)

    def forward_loss(self, videos, noise, teacher_force: Optional[bool] = None, **text):
        """(total, {name: value}) of one (micro)batch on the device;
        ``teacher_force`` None is the config's; ``text`` the caption's
        tensors by their ``TEXT_KEYS`` names."""
        return self.predict_loss(videos, self.encode(videos, noise), teacher_force, **text)

    def image_strip(self, videos, noise, **text):
        """Ground truth over a free-running rollout's decode, the predicted
        frames left to right (the JAX ``viz_forward``)."""
        c, p = self.num_context, self.num_preds
        pred_slots = self.rollout(self.encode(videos, noise), False, text)
        imgs = self.decode_frames(pred_slots.flatten(0, 1))
        panel = torch.cat([videos[0, c:c + p].clamp(0, 1), imgs.clamp(0, 1)], dim=1)
        return torch.cat(list(panel), dim=1).permute(2, 0, 1)

    @torch.no_grad()
    def valid_step(self, videos, **text) -> dict:
        with self.evaluating():
            return self.forward_loss(videos, self._noise(videos.shape[0]), teacher_force=False,
                                     **text)[1]
