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

The JAX trainer's extras:

* ``logs.txt`` (``core/logger.py``): the log lines, the calls of the
  trainer's public steps and any exception;
* TensorBoard (``tboard_logs/``), where ``torch.utils.tensorboard``
  imports: the train losses and ``train/lr`` every ``log_frequency``
  iterations, the valid loss each epoch, and a strip of ground truth over
  reconstruction (02) or prediction (04) every ``image_log_frequency``
  iterations, its slot noise drawn apart from the step stream, so that the
  stream does not depend on whether TensorBoard is installed (the JAX
  trainers draw it from the stream);
* ``TEXTOCVP_PROFILE=<dir>``: the first epoch traced by ``torch.profiler``
  (CPU, and CUDA on the card), a Chrome trace written into ``<dir>``;
* ``tpu.async_checkpoint``: checkpoints copied to the host in the loop and
  written by a thread (``train/checkpoints.py::AsyncCheckpointWriter``); the
  emergency path waits for them before it writes its own;
* ``tpu.remat``: the trainable forward in regions of
  ``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)`` (:func:`remat`),
  their activations recomputed in the backward, one region at a time. The
  frozen parts are computed outside the regions and kept, the JAX
  ``save_only_these_names("frozen_feats")`` policy: ExtendedDINOSAUR's ViT
  features (02) and the frozen encode's slots (04). In the 02 step the
  decomposition is one region and the decode REMAT_REGIONS more, of
  consecutive frames (:func:`remat_frames`); ExtendedDINOSAUR's CNN head,
  whose BatchNorm spans all frames, is a region a block. The weight
  gradient of the frame-wise decode is then summed region by region, equal
  to the plain step's to the last few bits. In the 04 step the rollout is
  one region and the frozen decode of the predicted frames REMAT_REGIONS
  more, equal bit for bit. BatchNorm moves its running statistics in the
  forward only, not in the recompute.

Not ported (ROADMAP.md): ``tpu.train_decode_chunks`` and the mesh.
"""

from __future__ import annotations

import os
import time
from contextlib import contextmanager
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from textocvp_tpu_torch.core.experiment import Experiment
from textocvp_tpu_torch.core.logger import Logger, log_exception, log_function, log_info, print_
from textocvp_tpu_torch.data.loader import EpochLoader, load_data
from textocvp_tpu_torch.data.wire import as_float_video
from textocvp_tpu_torch.models.factory import random_init_, setup_model
from textocvp_tpu_torch.nn.blocks import running_stats_frozen
from textocvp_tpu_torch.train.checkpoints import (
    load_checkpoint,
    make_checkpoint_saver,
    save_checkpoint,
)
from textocvp_tpu_torch.train.losses import build_loss_fn
from textocvp_tpu_torch.train.schedulers import build_optimizer

NOISE_SEED = 14
IMAGE_NOISE_SEED = 15  # the image strips' slot noise, apart from the step stream
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


def noise_generator(step: int, seed: int = NOISE_SEED) -> torch.Generator:
    """A CPU generator seeded by (seed, step), a hash of both."""
    state = np.random.SeedSequence([seed, step]).generate_state(1)[0]
    return torch.Generator().manual_seed(int(state))


def remat(fn, *args):
    """``fn(*args)`` under ``torch.utils.checkpoint.checkpoint(...,
    use_reentrant=False)``: its activations are not kept but recomputed in
    the backward. The recompute runs with BatchNorm's running statistics
    frozen (``nn/blocks.py::running_stats_frozen``), so that they move once,
    in the forward. ``fn`` draws no random numbers of its own: the noise
    comes in ``args``."""
    from torch.utils.checkpoint import checkpoint

    calls = [0]

    def run(*a):
        calls[0] += 1
        with running_stats_frozen(calls[0] > 1):
            return fn(*a)

    return checkpoint(run, *args, use_reentrant=False)


REMAT_REGIONS = 8  # remat regions of a frame-wise stage (remat_frames)


def remat_frames(fn, x):
    """``fn(x)`` as :func:`remat` regions of consecutive frames of ``x`` (its
    first axis), for a ``fn`` that treats each frame apart and returns a
    tensor or a dict of them: the backward recomputes one region at a time,
    and the peak holds one region's activations. Where ``fn``'s weights
    train, their gradient is summed region by region, in another order
    than one call sums it (equal to the last few bits)."""
    size = -(-x.shape[0] // REMAT_REGIONS)
    parts = [remat(fn, x[i:i + size]) for i in range(0, x.shape[0], size)]
    if isinstance(parts[0], dict):
        return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}
    return torch.cat(parts)


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
        Logger(self.exp.exp_path)
        self.exp_params = self.exp.params
        self.training_params = self.exp_params["training"]
        self.checkpoint = checkpoint
        self.resume_training = resume_training
        self.accum = accum_steps_of(self.training_params)
        self.remat = bool((self.exp_params.get("tpu") or {}).get("remat", False))
        self.start_epoch = 0
        self.global_step = 0
        self.writer = None
        self.image_strips = 0  # strips written to TensorBoard

    # ------------------------------------------------------------------ data
    @log_function
    def load_data(self):
        bs = self.training_params["batch_size"]
        ds = self.exp_params["dataset"]
        self.train_set = load_data(self.exp_params, split="train")
        self.valid_set = load_data(self.exp_params, split="valid")
        self.train_loader = EpochLoader(self.train_set, bs, shuffle=ds.get("shuffle_train", True))
        self.valid_loader = EpochLoader(self.valid_set, bs, shuffle=ds.get("shuffle_eval", False))
        print_(f"Loaded {len(self.train_set)} train / {len(self.valid_set)} valid sequences")

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
                print_(f"Resuming training from epoch {self.start_epoch}")

    def _noise(self, batch_size: int, generator: Optional[torch.Generator] = None
               ) -> torch.Tensor:
        """The slot noise of the next batch, which advances ``global_step``;
        with ``generator``, a draw from it, and the step stays."""
        if generator is None:
            self.global_step += 1
            generator = noise_generator(self.global_step)
        mp = self.exp_params["model"]["model_params"]
        shape = (batch_size, mp["num_slots"], mp["slot_dim"])
        return torch.randn(shape, generator=generator)

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

    # ------------------------------------------------------------------ logs
    def _setup_writer(self):
        """TensorBoard's writer into ``tboard_logs/``, or None where
        ``torch.utils.tensorboard`` does not import (no ``tensorboard``)."""
        try:
            from torch.utils.tensorboard import SummaryWriter

            self.writer = SummaryWriter(log_dir=str(self.exp.exp_path / "tboard_logs"))
        except Exception as e:
            log_info(f"no TensorBoard writer: {type(e).__name__}: {e}")
            self.writer = None

    def _log_scalars(self, values: dict, prefix: str):
        if self.writer is not None:
            for k, v in values.items():
                self.writer.add_scalar(f"{prefix}/{k}", float(v), self.global_step)

    def image_strip(self, videos, noise, **text) -> torch.Tensor:
        """A (3, H', W') image of the first sequence for TensorBoard; a
        subclass defines it."""
        raise NotImplementedError

    @torch.no_grad()
    def _log_images(self, videos, **text):
        """The image strip of the batch's first sequence, with slot noise of
        its own (the step stream does not move), in ``eval()``. A failure is
        logged to ``logs.txt`` and training goes on."""
        try:
            noise = self._noise(1, noise_generator(self.global_step, IMAGE_NOISE_SEED))
            with self.evaluating():
                strip = self.image_strip(videos[:1], noise.to(self.device),
                                         **{k: t[:1] for k, t in text.items()})
            self.writer.add_image(self.IMAGE_TAG, strip.clamp(0, 1).cpu(), self.global_step)
            self.image_strips += 1
        except Exception as e:
            log_info(f"image logging skipped: {type(e).__name__}: {e}")

    def _start_profile(self):
        """A ``torch.profiler`` trace (CPU, and CUDA on the card), started."""
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities)
        prof.__enter__()
        return prof

    def _stop_profile(self, prof, profile_dir: str, epoch: int):
        """Stop ``prof`` and write its Chrome trace into ``profile_dir``."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof.__exit__(None, None, None)
        path = Path(profile_dir) / f"{type(self).__name__}_epoch{epoch}.pt.trace.json"
        path.parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(path))
        print_(f"Profile of epoch {epoch} written to {path}")
        return path

    # ------------------------------------------------------------------ loop
    @log_function
    def train_epoch(self, epoch: int) -> float:
        losses = []
        log_freq = self.training_params.get("log_frequency", 100)
        img_freq = self.training_params.get("image_log_frequency", 300)
        for i, (videos, info) in enumerate(self.train_loader):
            videos, text = self.batch_to_device(videos, info)
            values = self.train_step(videos, **text)
            loss = float(values["_total"])
            if i % log_freq == 0:
                self._log_scalars(values, "train")
                if self.writer is not None:
                    self.writer.add_scalar("train/lr", self.lr_schedule(self.optimizer.count),
                                           self.global_step)
                print_(f"  epoch {epoch} iter {i}: loss={loss:.6f}")
            if self.writer is not None and i % img_freq == 0:
                self._log_images(videos, **text)
            losses.append(loss)
        return float(np.mean(losses)) if losses else float("nan")

    @log_function
    def valid_epoch(self, epoch: int) -> float:
        losses = []
        for videos, info in self.valid_loader:
            videos, text = self.batch_to_device(videos, info)
            losses.append(float(self.valid_step(videos, **text)["_total"]))
        mean = float(np.mean(losses)) if losses else float("nan")
        self._log_scalars({"_total": mean}, "valid")
        return mean

    def _state(self, epoch: int) -> dict:
        return {"params": self.model.state_dict(), "opt_state": self.optimizer.state_dict(),
                "epoch": epoch, "step": self.global_step}

    def _save(self, name: str, epoch: int):
        save_checkpoint(self.exp.checkpoint_path(name), self._state(epoch))

    @log_function
    def training_loop(self):
        """Epochs from ``start_epoch`` to ``num_epochs``: validation, then
        training, then the checkpoints (through the background writer under
        ``tpu.async_checkpoint``); the first epoch traced under
        ``TEXTOCVP_PROFILE``; the emergency checkpoint on an exception or an
        interrupt, after the pending writes, which is raised again."""
        self._setup_writer()
        num_epochs = self.training_params["num_epochs"]
        save_freq = self.training_params.get("save_frequency", 25)
        epoch = self.start_epoch
        profile_dir = os.environ.get("TEXTOCVP_PROFILE")
        prof = self._start_profile() if profile_dir else None
        save_ckpt, flush_ckpts = make_checkpoint_saver(self.exp_params)
        try:
            for epoch in range(self.start_epoch, num_epochs):
                t0 = time.time()
                # each epoch's shuffle and clip starts follow its number, so a
                # resumed run draws what the uninterrupted one would have
                self.train_loader.epoch = self.valid_loader.epoch = epoch
                val_loss = self.valid_epoch(epoch)
                train_loss = self.train_epoch(epoch)
                dt = time.time() - t0
                print_(f"Epoch {epoch + 1}/{num_epochs}: train={train_loss:.6f} "
                       f"valid={val_loss:.6f} ({dt:.1f}s)")
                save_ckpt(self.exp.checkpoint_path("checkpoint_last_saved"),
                          self._state(epoch + 1))
                if (epoch + 1) % save_freq == 0:
                    save_ckpt(self.exp.checkpoint_path(f"checkpoint_epoch_{epoch + 1}"),
                              self._state(epoch + 1))
                if prof is not None:
                    self._stop_profile(prof, profile_dir, epoch)
                    prof = None
            save_ckpt(self.exp.checkpoint_path("checkpoint_epoch_final"), self._state(num_epochs))
            flush_ckpts()
        except (Exception, KeyboardInterrupt) as e:
            try:
                flush_ckpts()  # the pending writes first
            except BaseException as flush_err:
                print_(f"async checkpoint flush failed during emergency handling: {flush_err}",
                       "error")
            self._save(f"emergency_checkpoint_epoch_{epoch}", epoch)
            log_exception(e)
            print_(f"Emergency checkpoint saved at epoch {epoch} ({type(e).__name__})", "error")
            raise
        finally:
            if prof is not None:
                prof.__exit__(None, None, None)
            if self.writer is not None:
                self.writer.close()


class DecompTrainer(Trainer):
    """Trainer of a SAVi or ExtendedDINOSAUR decomposition model.

    Call :meth:`load_data`, :meth:`setup_model`, then :meth:`training_loop`."""

    IMAGE_TAG = "train/recons"

    def __init__(self, exp_path, checkpoint: Optional[str] = None,
                 resume_training: bool = False, device="cuda"):
        super().__init__(exp_path, checkpoint, resume_training, device)
        self.model_name = self.exp_params["model"]["model_name"]
        self.model = setup_model(self.exp_params)
        self.loss_fn = build_loss_fn(self.exp_params["loss"])

    @log_function
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

    def forward(self, videos, noise) -> dict:
        """The model's output dict of one (micro)batch; under ``tpu.remat``
        in regions: the decomposition one :func:`remat` region (the frozen
        ViT's features of ExtendedDINOSAUR computed outside it and kept), the
        decode :meth:`remat_decode`."""
        if not (self.remat and torch.is_grad_enabled()):  # nothing to recompute without grad
            return self.model(videos, noise=noise, decode=True)
        m = self.model
        frozen = getattr(m, "frozen_features", None)
        if frozen is None:  # SAVi: nothing frozen
            out = remat(lambda v, n: m(v, noise=n, decode=False), videos, noise)
        else:
            out = remat(lambda v, n, f: m(v, noise=n, decode=False, img_feats=f),
                        videos, noise, frozen(videos))
        out.update(m.decoded(out["slot_history"], decode=self.remat_decode))
        return out

    def remat_decode(self, slots) -> dict:
        """The decode of (N, S, D) slots in remat regions of frames
        (:func:`remat_frames`): SAVi's whole decoder, ExtendedDINOSAUR's
        per-frame ``mix``; its CNN head, whose BatchNorm normalizes over all
        N frames, a region a block (``render_stages``)."""
        dec = getattr(self.model, "patch_decoder", None)
        if dec is None:
            return remat_frames(self.model.decode, slots)
        out = remat_frames(dec.mix, slots)
        recons_imgs = None
        if dec.cnns is not None:
            recons_imgs = out["recons_feats"]
            for stage in dec.render_stages():
                recons_imgs = remat(stage, recons_imgs)
        return {"recons_imgs": recons_imgs, **out}

    def forward_loss(self, videos, noise):
        """(total, {name: value}) of one (micro)batch on the device."""
        return self.loss_fn(**self._loss_tensors(self.forward(videos, noise), videos))

    def image_strip(self, videos, noise):
        """Ground truth over reconstruction, the frames left to right."""
        recons = self.model(videos, noise=noise, decode=True)["recons_imgs"][0].clamp(0, 1)
        panel = torch.cat([videos[0].clamp(0, 1), recons], dim=1)  # (T, 2H, W, C)
        return torch.cat(list(panel), dim=1).permute(2, 0, 1)

    @log_function
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
