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

``tpu.compute_dtype: "bfloat16"`` trains as the JAX trainers do: the models
compute in bf16 (``nn/precision.py``; the softmaxes, the normalisations'
statistics, BatchNorm's running statistics and the slot-attention kernel in
float32), the losses in float32 (``train/losses.py``), and the parameters,
their gradients as Adam reads them, Adam's state and the checkpoints stay
float32: each cast records its backward, so a bf16 gradient reaches its
float32 parameter through it. On the card the decoder tail's convs and their
input gradients launch conv5's bf16 kernel (``ops/conv5.py``), the ViT its
bf16 attention. On a mesh the row-parallel layers sum float32 partials and
round once (``parallel/partitioning.py``); the data axis's gradients are the
float32 ones Adam reads.

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

The mesh (``tpu.mesh_axes``, ``parallel/``), in a process group that
``torchrun`` or the ``TEXTOCVP_*`` environment starts, one process per GPU:

* each data index loads its rows of every global batch (``EpochLoader``'s
  process split; a ragged global batch padded by repeating its last row,
  which then weighs twice in that step, as in the JAX package's
  multi-process runs). Under ``accum_steps`` they are its share of each of
  the global batch's microbatches, the JAX step's ``(accum, micro_b)``
  reshape of the global batch (``data/loader.py::microbatch_rows``), so
  that microbatch i of every rank together is the JAX microbatch i and
  BatchNorm normalizes over it; a ragged batch's microbatch that the data
  axis does not divide is computed whole on every rank;
* every rank draws the global batch's slot noise from ``noise_generator``
  and takes the rows it loaded, so a step does not depend on the world size;
* the gradients are averaged over the data group once a step, after the
  microbatches and before the clip, by one all-reduce of all of them
  flattened into one buffer (not DDP: the hand-written Adam reads
  ``.grad``, DDP's buckets would reduce every microbatch unless held off
  by ``no_sync``, and its wrapper renames the state dict); the loss values
  too, so that every rank reports the global batch's;
* BatchNorm (ExtendedDINOSAUR's CNN head) normalizes with the global
  (micro)batch's statistics when the data axis is larger than 1;
* the 04 trainer shards its predictor over ``model``
  (``parallel/partitioning.py``); checkpoints gather it back;
* rank 0 alone writes TensorBoard, ``logs.txt``, the architecture, the
  checkpoints (the others wait for the last one) and the profile; the image
  strips are skipped when the world is larger than 1, since the writer
  exists on rank 0 only and a collective must not run on one rank alone.
  Under tensor parallelism every rank writes its own file of the emergency
  checkpoint, its slices with their ``tp_shard``, with no collective (the
  gather is one that a failed rank may never join;
  ``train/checkpoints.py::save_shard``); the readers join the set.

Without a process group the mesh is of one rank and runs no collective: the
step is the same as before.

Not ported (ROADMAP.md): ``tpu.train_decode_chunks``.
"""

from __future__ import annotations

import os
import time
from contextlib import contextmanager
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from textocvp_tpu_torch.core.config import tpu_option
from textocvp_tpu_torch.core.experiment import Experiment
from textocvp_tpu_torch.core.logger import Logger, log_exception, log_function, log_info, print_
from textocvp_tpu_torch.data.loader import (  # noqa: F401  (ragged_accum: the trainers' name)
    EpochLoader,
    load_data,
    microbatch_rows,
    ragged_accum,
)
from textocvp_tpu_torch.data.wire import as_float_video
from textocvp_tpu_torch.models.factory import random_init_, setup_model
from textocvp_tpu_torch.nn.blocks import running_stats_frozen, set_batchnorm_group
from textocvp_tpu_torch.parallel.distributed import (
    get_runtime_mesh,
    is_process_zero,
    loader_process_kwargs,
    maybe_initialize_distributed,
)
from textocvp_tpu_torch.parallel.mesh import all_reduce, barrier, pad_batch_to_multiple
from textocvp_tpu_torch.parallel.partitioning import gather_state_dict
from textocvp_tpu_torch.train.checkpoints import (
    load_checkpoint,
    make_checkpoint_saver,
    save_checkpoint,
    save_shard,
)
from textocvp_tpu_torch.train.losses import build_loss_fn, clip01
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
        maybe_initialize_distributed()
        self.exp = Experiment(exp_path)
        Logger(self.exp.exp_path)
        self.exp_params = self.exp.params
        self.training_params = self.exp_params["training"]
        self.mesh = get_runtime_mesh(self.exp_params.get("tpu"), self.device)
        self.device = self.mesh.device
        self.checkpoint = checkpoint
        self.resume_training = resume_training
        self.accum = accum_steps_of(self.training_params)
        bs, d = self.training_params["batch_size"], self.mesh.data
        if bs % d:
            print_(f"batch_size {bs} is not divisible by the data axis ({d}); the batch "
                   "cannot split over the processes", "warning")
        elif (bs // self.accum) % d:
            print_(f"the microbatch of {bs // self.accum} rows is not divisible by the data "
                   f"axis ({d}); every rank computes each microbatch whole", "warning")
        self.remat = bool(tpu_option(self.exp_params, "remat"))
        self.start_epoch = 0
        self.global_step = 0
        self.writer = None
        self.image_strips = 0  # strips written to TensorBoard
        self.tokenizer = None  # the datasets' (load_data)

    # ------------------------------------------------------------------ data
    @log_function
    def load_data(self):
        bs = self.training_params["batch_size"]
        ds = self.exp_params["dataset"]
        self.train_set = load_data(self.exp_params, split="train")
        self.valid_set = load_data(self.exp_params, split="valid")
        self.tokenizer = getattr(self.train_set, "tokenizer", None)
        split = loader_process_kwargs(self.mesh)
        self.train_loader = EpochLoader(self.train_set, bs, shuffle=ds.get("shuffle_train", True),
                                        accum=self.accum, **split)
        self.valid_loader = EpochLoader(self.valid_set, bs, shuffle=ds.get("shuffle_eval", False),
                                        **split)
        print_(f"Loaded {len(self.train_set)} train / {len(self.valid_set)} valid sequences")

    def to_device(self, videos):
        """A loader batch (numpy, uint8 or float) -> float video on the device."""
        return as_float_video(torch.as_tensor(np.asarray(videos)).to(self.device))

    def batch_to_device(self, videos, info) -> tuple:
        """A loader batch -> (video, {name: tensor} of what :meth:`forward_loss`
        takes besides the video and the noise) on the device."""
        return self.to_device(videos), {}

    # ----------------------------------------------------------------- model
    def shard_model(self):
        """Hook between the weights' load and the optimizer's build: the mesh's
        placement of ``model`` (the 04 trainer shards its predictor)."""

    def _setup_optimizer(self):
        """Adam over the parameters of ``model`` that require grad; with
        ``checkpoint`` its weights from that checkpoint (loaded whole, before
        :meth:`shard_model`), and with ``resume_training`` also the optimizer
        state, the epoch and the step."""
        state = None
        if self.checkpoint is not None:
            state = load_checkpoint(self.exp.checkpoint_path(self.checkpoint))
            self.model.load_state_dict(state["params"])
        self.shard_model()
        self.optimizer, self.lr_schedule = build_optimizer(
            self.training_params, [p for p in self.model.parameters() if p.requires_grad],
            model_group=self.mesh.model_group if self.mesh.tensor_parallel else None)
        if state is not None:
            if self.resume_training:
                self.optimizer.load_state_dict(state["opt_state"])
                self.start_epoch = int(state["epoch"])
                self.global_step = int(state["step"])
                print_(f"Resuming training from epoch {self.start_epoch}")

    def _noise(self, batch_size: int, generator: Optional[torch.Generator] = None,
               global_batch: Optional[int] = None, accum: int = 1) -> torch.Tensor:
        """The slot noise of the next batch, which advances ``global_step``;
        with ``generator``, a draw from it, and the step stays. On a mesh the
        draw is the global batch's (``global_batch`` rows, by default
        ``batch_size`` a data index), and this data index takes the rows it
        loaded: under ``accum`` its share of each microbatch
        (:func:`microbatch_rows`), else its contiguous ``batch_size``."""
        if generator is None:
            self.global_step += 1
            generator = noise_generator(self.global_step)
        mp = self.exp_params["model"]["model_params"]
        d = self.mesh.data
        n = global_batch or batch_size * d
        noise = torch.randn((n, mp["num_slots"], mp["slot_dim"]), generator=generator)
        if d == 1:
            return noise
        rows = self._rows(n, accum)[1]
        return noise[torch.from_numpy(rows)]

    def _rows(self, n: int, accum: int) -> tuple:
        """(microbatches, this data index's rows) of a global batch of ``n``."""
        return microbatch_rows(n, accum, self.training_params["batch_size"], self.mesh.data,
                               self.mesh.data_index)

    def global_batch(self, info: dict) -> Optional[int]:
        """The padded global batch of a loader batch on a mesh (``num_valid``
        real rows), None on a data axis of 1."""
        if self.mesh.data == 1 or "num_valid" not in info:
            return None
        return pad_batch_to_multiple(int(info["num_valid"]), self.mesh)

    def _data_mean(self, values: dict) -> dict:
        """Loss values averaged over the data group (the global batch's); as
        they are without a process group."""
        group = self.mesh.data_group
        if group is None:
            return values
        keys = sorted(values)
        total = all_reduce(torch.stack([values[k].detach().float() for k in keys]), group)
        return dict(zip(keys, total / self.mesh.data))

    def average_gradients(self):
        """Every ``.grad`` averaged over the data group: one all-reduce of all
        of them flattened into one buffer. Nothing without a process group."""
        group = self.mesh.data_group
        if group is None:
            return
        params = self.optimizer.params
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        flat = all_reduce(torch.cat([p.grad.reshape(-1) for p in params]), group)
        flat /= self.mesh.data
        offset = 0
        for p in params:
            n = p.grad.numel()
            p.grad.copy_(flat[offset:offset + n].view_as(p.grad))
            offset += n

    def backward(self, videos, noise, global_batch: Optional[int] = None, **text) -> dict:
        """Fresh gradients of the batch's loss in every parameter's ``.grad``,
        averaged over its microbatches and, on a mesh, over the data group;
        returns the loss values. On a mesh the rows are this rank's of a
        global batch of ``global_batch`` rows (by default the rows times the
        data axis), as the loader split them (:func:`microbatch_rows`): its
        share of each global microbatch, in order."""
        b = videos.shape[0]
        accum, rows = self._rows(global_batch or b * self.mesh.data, self.accum)
        if len(rows) != b:
            raise ValueError(f"{b} rows, but this rank's share of a global batch of "
                             f"{global_batch} is {len(rows)}")
        mb = b // accum
        self.optimizer.zero_grad()
        values = []
        for i in range(0, b, mb):
            part = {k: t[i:i + mb] for k, t in text.items()}
            total, vals = self.forward_loss(videos[i:i + mb], noise[i:i + mb], **part)
            (total / accum).backward()
            values.append({k: x.detach() for k, x in vals.items()})
        self.average_gradients()
        return self._data_mean({k: torch.stack([v[k] for v in values]).mean()
                                for k in values[0]})

    def train_step(self, videos, noise=None, global_batch: Optional[int] = None, **text) -> dict:
        """One update from a batch on the device; ``noise`` (B, S, D) in place
        of the stream's (which then does not advance); ``global_batch`` as
        :meth:`backward` takes it."""
        if noise is None:
            noise = self._noise(videos.shape[0], global_batch=global_batch, accum=self.accum)
        values = self.backward(videos, noise, global_batch, **text)
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
            return self._data_mean(
                self.forward_loss(videos, self._noise(videos.shape[0]), **text)[1])

    # ------------------------------------------------------------------ logs
    def _setup_writer(self):
        """TensorBoard's writer into ``tboard_logs/``, or None where
        ``torch.utils.tensorboard`` does not import (no ``tensorboard``) and
        on ranks other than 0."""
        if not is_process_zero():
            self.writer = None
            return
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
            n = self.global_batch(info)  # a mesh's padded global batch
            values = self.train_step(videos, **text, **({} if n is None else {"global_batch": n}))
            loss = float(values["_total"])
            if i % log_freq == 0:
                self._log_scalars(values, "train")
                if self.writer is not None:
                    self.writer.add_scalar("train/lr", self.lr_schedule(self.optimizer.count),
                                           self.global_step)
                print_(f"  epoch {epoch} iter {i}: loss={loss:.6f}")
            if self.writer is not None and i % img_freq == 0 and self.mesh.world == 1:
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
        """The checkpoint's state, sharded leaves gathered to their full shapes
        (a collective of the model group under tensor parallelism)."""
        params = (gather_state_dict(self.model, self.mesh.model_group)
                  if self.mesh.tensor_parallel else self.model.state_dict())
        return {"params": params, "opt_state": self.optimizer.state_dict(),
                "epoch": epoch, "step": self.global_step}

    def _local_state(self, epoch: int) -> dict:
        """This rank's file of a shard set (``train/checkpoints.py::
        save_shard``): its own slices and their layout, with no collective."""
        mesh = self.mesh
        sharded = {n: list(p.tp_shard) for n, p in self.model.named_parameters()
                   if getattr(p, "tp_shard", None)}
        return {"params": self.model.state_dict(),
                "opt_state": self.optimizer.local_state_dict(),
                "epoch": epoch, "step": self.global_step,
                "tp": {"mesh": [mesh.data, mesh.model], "data_index": mesh.data_index,
                       "model_index": mesh.model_index, "params": sharded,
                       "opt": [list(s) if s else None for s in self.optimizer.shards]}}

    def _save(self, name: str, epoch: int):
        """The emergency checkpoint: the gathered state, written by rank 0;
        under tensor parallelism each rank's own file, written with no
        collective, since a failed rank may never join one."""
        path = self.exp.checkpoint_path(name)
        if self.mesh.tensor_parallel:
            save_shard(path, self._local_state(epoch), self.mesh.rank)
        else:
            save_checkpoint(path, self._state(epoch))

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
        profile_dir = os.environ.get("TEXTOCVP_PROFILE") if is_process_zero() else None
        prof = self._start_profile() if profile_dir else None
        # every rank gathers the state (a collective under tensor parallelism),
        # rank 0 writes it (save_checkpoint)
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
            barrier()  # the other ranks may read what rank 0 wrote
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

    def shard_model(self):
        """BatchNorm over the global batch when the data axis is larger than 1."""
        if self.mesh.data > 1:
            set_batchnorm_group(self.model, self.mesh.data_group)

    def _loss_tensors(self, out: dict, videos) -> dict:
        tensors = {"pred_imgs": clip01(out["recons_imgs"]), "target_imgs": clip01(videos)}
        if self.model_name == "ExtendedDINOSAUR":
            tensors["preds_feats"] = clip01(out["recons_feats"])
            tensors["targets_feats"] = clip01(out["encoded_img_feats"])
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
        (:func:`remat_frames`): SAVi's whole decoder (one region when it has
        BatchNorms, which normalize over all N frames), ExtendedDINOSAUR's
        per-frame ``mix``; its CNN head, whose BatchNorm normalizes over all
        N frames, a region a block (``render_stages``)."""
        dec = getattr(self.model, "patch_decoder", None)
        if dec is None:
            if self.model.image_decoder.batch_norm:  # its statistics span all N frames
                return remat(self.model.decode, slots)
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
        ``model_architecture.txt`` (rank 0)."""
        if not is_process_zero():
            return
        n_params = sum(p.numel() for p in self.model.parameters() if p.requires_grad)
        with open(self.exp.exp_path / "model_architecture.txt", "w") as f:
            f.write(str(self.model) + "\n")
            f.write(f"\nLearnable parameters: {n_params}\n")

    def training_loop(self):
        self.log_architecture()
        super().training_loop()
