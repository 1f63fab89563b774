"""
Stage-1 (decomposition) trainer of the port for SAVi and ExtendedDINOSAUR
(counterpart of the JAX package's ``textocvp_tpu/train/trainer.py::
DecompTrainer``), and the loop it shares with the 04 predictor trainer
(:class:`Trainer`, ``train/predictor_trainer.py``).

What it keeps of the JAX trainer:

* the validation epoch runs before each training epoch, the loaders in the
  JAX ``DataLoader``'s order (``data/loader.py::EpochLoader``); checkpoints
  ``checkpoint_last_saved`` every epoch, ``checkpoint_epoch_<E>`` every
  ``save_frequency`` epochs, ``checkpoint_epoch_final`` at the end and
  ``emergency_checkpoint_epoch_<E>`` on an exception or an interrupt
  (``train/checkpoints.py``); the log lines' text;
* the loss: the config's losses on the reconstruction and the video, both
  clipped to [0, 1] (``mse`` for SAVi); ExtendedDINOSAUR adds the
  reconstructed ViT features and the frozen ViT's own, both clipped too
  (``pred_feature_mse`` + ``mse``);
* the freeze: Adam, and its global-norm clip, take the parameters that
  require grad, which are the JAX ``"train"`` leaves (every top-level
  subtree but ExtendedDINOSAUR's ``image_encoder``); the frozen ViT stays in
  the checkpoints;
* BatchNorm (ExtendedDINOSAUR's CNN head): a training (micro)batch
  normalizes with its own statistics and moves the running ones, the
  microbatches of a step in order, as the JAX step threads ``batch_stats``
  through them; the validation step runs the model in ``eval()``, with the
  running statistics and no update (the JAX ``train=False``);
* the step: forward, loss, backward, the global-norm clip, Adam at the
  schedule of the number of updates made (``train/schedulers.py``);
  ``training.accum_steps`` equal microbatches whose gradients are averaged
  into one update, a ragged last batch split as ``ragged_accum`` says;
* the slot noise: each call of :meth:`_noise` (every training and every
  validation batch, as the JAX ``_rng``) advances ``global_step`` and draws
  from a generator seeded by ``(14, global_step)``, the counterpart of
  ``fold_in(PRNGKey(14), step)``; a resumed run continues the stream. The
  noise is drawn on the CPU, so a run on the card and one on the CPU draw
  the same.

On the card every slot-attention call and every decoder-tail conv runs its
CUDA kernel, their gradients through ``ops.slot_attention_kernel.
SlotAttentionFunction`` and ``ops.conv5.Conv5Function``; the frozen ViT's
attention runs its kernel forward only, under ``torch.no_grad()``. Float32 with TF32
off for matmuls and cuDNN. The weights start from ``random_init_`` with a
seeded generator (the JAX package's flax initializers draw from
``jax.random``, which torch cannot reproduce) or from a checkpoint.

Not ported (ROADMAP.md): TensorBoard scalars and image panels, the
``TEXTOCVP_PROFILE`` trace, ``tpu.remat``, ``tpu.train_decode_chunks``, the
background checkpoint writer and the mesh.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Optional

import numpy as np
import torch

from textocvp_tpu_torch.core.experiment import Experiment
from textocvp_tpu_torch.data.loader import EpochLoader, load_data
from textocvp_tpu_torch.data.wire import as_float_video
from textocvp_tpu_torch.models.factory import random_init_, setup_model
from textocvp_tpu_torch.train.checkpoints import load_checkpoint, save_checkpoint
from textocvp_tpu_torch.train.losses import build_loss_fn
from textocvp_tpu_torch.train.schedulers import build_optimizer

NOISE_SEED = 14
INIT_SEED = 0


def accum_steps_of(training_params: dict) -> int:
    """``training.accum_steps`` (default 1), checked: it must divide
    ``batch_size`` so that the microbatches are equal, which is what makes
    their averaged gradient the full batch's."""
    raw = training_params.get("accum_steps")
    accum = 1 if raw is None else int(raw)
    if accum < 1:
        raise ValueError(f"training.accum_steps must be >= 1, got {accum}")
    bs = training_params["batch_size"]
    if bs % accum:
        raise ValueError(
            f"training.accum_steps ({accum}) must divide batch_size ({bs}) "
            "so microbatches are equal-sized (equal sizes are what make the "
            "averaged gradient equal the full-batch gradient)")
    return accum


def ragged_accum(n: int, accum: int, batch_size: int) -> int:
    """Microbatches for a batch of ``n`` sequences: ``accum`` when it divides
    ``n``, else the fewest equal microbatches no larger than the configured
    ``batch_size // accum``."""
    if n % accum == 0:
        return accum
    mb = max(1, batch_size // accum)
    return min(d for d in range(1, n + 1) if n % d == 0 and n // d <= mb)


def noise_generator(step: int) -> torch.Generator:
    """A CPU generator seeded by (NOISE_SEED, step), a hash of both."""
    state = np.random.SeedSequence([NOISE_SEED, step]).generate_state(1)[0]
    return torch.Generator().manual_seed(int(state))


class Trainer:
    """The training loop both trainers share: the loaders, Adam over the
    trained module's parameters that require grad, the slot-noise stream,
    accumulation, the epochs and the checkpoints.

    A subclass builds ``model`` (the module trained and checkpointed) and
    ``loss_fn``, and defines :meth:`setup_model` and :meth:`forward_loss`
    ``(videos, noise, **text) -> (total, values)``. ``device`` is ``cuda``
    unless the caller asks for ``cpu``; without a CUDA device ``cuda``
    raises."""

    def __init__(self, exp_path, checkpoint: Optional[str] = None,
                 resume_training: bool = False, device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"{type(self).__name__}: no CUDA device; pass device='cpu' to "
                               "train on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.exp = Experiment(exp_path)
        self.exp_params = self.exp.params
        self.training_params = self.exp_params["training"]
        self.checkpoint = checkpoint
        self.resume_training = resume_training
        self.accum = accum_steps_of(self.training_params)
        self.start_epoch = 0
        self.global_step = 0

    # ------------------------------------------------------------------ data
    def load_data(self):
        bs = self.training_params["batch_size"]
        ds = self.exp_params["dataset"]
        self.train_set = load_data(self.exp_params, split="train")
        self.valid_set = load_data(self.exp_params, split="valid")
        self.train_loader = EpochLoader(self.train_set, bs, shuffle=ds.get("shuffle_train", True))
        self.valid_loader = EpochLoader(self.valid_set, bs, shuffle=ds.get("shuffle_eval", False))
        print(f"Loaded {len(self.train_set)} train / {len(self.valid_set)} valid sequences",
              flush=True)

    def to_device(self, videos):
        """A loader batch (numpy, uint8 or float) -> float video on the device."""
        return as_float_video(torch.as_tensor(np.asarray(videos)).to(self.device))

    def batch_to_device(self, videos, info) -> tuple:
        """A loader batch -> (video, {name: tensor} of what :meth:`forward_loss`
        takes besides the video and the noise) on the device."""
        return self.to_device(videos), {}

    # ----------------------------------------------------------------- model
    def _setup_optimizer(self):
        """Adam over the parameters of ``model`` that require grad; with
        ``checkpoint`` its weights from that checkpoint, and with
        ``resume_training`` also the optimizer state, the epoch and the step."""
        self.optimizer, self.lr_schedule = build_optimizer(
            self.training_params, [p for p in self.model.parameters() if p.requires_grad])
        if self.checkpoint is not None:
            state = load_checkpoint(self.exp.checkpoint_path(self.checkpoint))
            self.model.load_state_dict(state["params"])
            if self.resume_training:
                self.optimizer.load_state_dict(state["opt_state"])
                self.start_epoch = int(state["epoch"])
                self.global_step = int(state["step"])
                print(f"Resuming training from epoch {self.start_epoch}", flush=True)

    def _noise(self, batch_size: int) -> torch.Tensor:
        """The slot noise of the next batch; advances ``global_step``."""
        self.global_step += 1
        mp = self.exp_params["model"]["model_params"]
        shape = (batch_size, mp["num_slots"], mp["slot_dim"])
        return torch.randn(shape, generator=noise_generator(self.global_step))

    def backward(self, videos, noise, **text) -> dict:
        """Fresh gradients of the batch's loss in every parameter's ``.grad``,
        averaged over its microbatches; returns the loss values."""
        b = videos.shape[0]
        accum = ragged_accum(b, self.accum, self.training_params["batch_size"])
        mb = b // accum
        self.optimizer.zero_grad()
        values = []
        for i in range(0, b, mb):
            part = {k: t[i:i + mb] for k, t in text.items()}
            total, vals = self.forward_loss(videos[i:i + mb], noise[i:i + mb], **part)
            (total / accum).backward()
            values.append({k: x.detach() for k, x in vals.items()})
        return {k: torch.stack([v[k] for v in values]).mean() for k in values[0]}

    def train_step(self, videos, noise=None, **text) -> dict:
        """One update from a batch on the device; ``noise`` (B, S, D) in place
        of the stream's (which then does not advance)."""
        if noise is None:
            noise = self._noise(videos.shape[0])
        values = self.backward(videos, noise, **text)
        self.optimizer.step()
        return values

    @contextmanager
    def evaluating(self):
        """``model`` in ``eval()`` inside, ``train()`` again after: BatchNorm
        normalizes with its running statistics and moves none."""
        self.model.eval()
        try:
            yield
        finally:
            self.model.train()

    @torch.no_grad()
    def valid_step(self, videos, **text) -> dict:
        with self.evaluating():
            return self.forward_loss(videos, self._noise(videos.shape[0]), **text)[1]

    # ------------------------------------------------------------------ loop
    def train_epoch(self, epoch: int) -> float:
        losses = []
        log_freq = self.training_params.get("log_frequency", 100)
        for i, (videos, info) in enumerate(self.train_loader):
            videos, text = self.batch_to_device(videos, info)
            values = self.train_step(videos, **text)
            loss = float(values["_total"])
            if i % log_freq == 0:
                print(f"  epoch {epoch} iter {i}: loss={loss:.6f}", flush=True)
            losses.append(loss)
        return float(np.mean(losses)) if losses else float("nan")

    def valid_epoch(self, epoch: int) -> float:
        losses = []
        for videos, info in self.valid_loader:
            videos, text = self.batch_to_device(videos, info)
            losses.append(float(self.valid_step(videos, **text)["_total"]))
        return float(np.mean(losses)) if losses else float("nan")

    def _save(self, name: str, epoch: int):
        save_checkpoint(self.exp.checkpoint_path(name),
                        {"params": self.model.state_dict(),
                         "opt_state": self.optimizer.state_dict(),
                         "epoch": epoch, "step": self.global_step})

    def training_loop(self):
        """Epochs from ``start_epoch`` to ``num_epochs``: validation, then
        training, then the checkpoints; the emergency checkpoint on an
        exception or an interrupt, which is raised again."""
        num_epochs = self.training_params["num_epochs"]
        save_freq = self.training_params.get("save_frequency", 25)
        epoch = self.start_epoch
        try:
            for epoch in range(self.start_epoch, num_epochs):
                t0 = time.time()
                # each epoch's shuffle and clip starts follow its number, so a
                # resumed run draws what the uninterrupted one would have
                self.train_loader.epoch = self.valid_loader.epoch = epoch
                val_loss = self.valid_epoch(epoch)
                train_loss = self.train_epoch(epoch)
                dt = time.time() - t0
                print(f"Epoch {epoch + 1}/{num_epochs}: train={train_loss:.6f} "
                      f"valid={val_loss:.6f} ({dt:.1f}s)", flush=True)
                self._save("checkpoint_last_saved", epoch + 1)
                if (epoch + 1) % save_freq == 0:
                    self._save(f"checkpoint_epoch_{epoch + 1}", epoch + 1)
            self._save("checkpoint_epoch_final", num_epochs)
        except (Exception, KeyboardInterrupt) as e:
            self._save(f"emergency_checkpoint_epoch_{epoch}", epoch)
            print(f"Emergency checkpoint saved at epoch {epoch} ({type(e).__name__})", flush=True)
            raise


class DecompTrainer(Trainer):
    """Trainer of a SAVi or ExtendedDINOSAUR decomposition model.

    Call :meth:`load_data`, :meth:`setup_model`, then :meth:`training_loop`."""

    def __init__(self, exp_path, checkpoint: Optional[str] = None,
                 resume_training: bool = False, device="cuda"):
        super().__init__(exp_path, checkpoint, resume_training, device)
        self.model_name = self.exp_params["model"]["model_name"]
        self.model = setup_model(self.exp_params)
        self.loss_fn = build_loss_fn(self.exp_params["loss"])

    def setup_model(self):
        """Weights from ``random_init_`` with a generator seeded ``INIT_SEED``,
        or from ``checkpoint``; with ``resume_training`` also the optimizer
        state, the epoch and the step."""
        random_init_(self.model, torch.Generator().manual_seed(INIT_SEED))
        self.model.to(self.device).train()
        self._setup_optimizer()

    def _loss_tensors(self, out: dict, videos) -> dict:
        tensors = {"pred_imgs": out["recons_imgs"].clamp(0, 1),
                   "target_imgs": videos.clamp(0, 1)}
        if self.model_name == "ExtendedDINOSAUR":
            tensors["preds_feats"] = out["recons_feats"].clamp(0, 1)
            tensors["targets_feats"] = out["encoded_img_feats"].clamp(0, 1)
        return tensors

    def forward_loss(self, videos, noise):
        """(total, {name: value}) of one (micro)batch on the device."""
        out = self.model(videos, noise=noise, decode=True)
        return self.loss_fn(**self._loss_tensors(out, videos))

    def log_architecture(self):
        """The module structure and the count of learnable parameters, to
        ``model_architecture.txt``."""
        n_params = sum(p.numel() for p in self.model.parameters() if p.requires_grad)
        with open(self.exp.exp_path / "model_architecture.txt", "w") as f:
            f.write(str(self.model) + "\n")
            f.write(f"\nLearnable parameters: {n_params}\n")

    def training_loop(self):
        self.log_architecture()
        super().training_loop()
