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

Each stage is a module of its own (:class:`PredictStage`, :class:`DecodeStage`)
and a pure function of its tensors: the predict stage takes the videos, the
initial slots' noise and the caption tensors; the host draws the noise from
the service's ``generator``. ``serve/export.py`` exports the two modules as
they are, so an artifact replays the live service bit for bit.

Numerics: float32 by default, as the JAX package serves. TF32 is off for
matmuls and for cuDNN convolutions (``torch.backends.cuda.matmul.
allow_tf32 = False``, ``torch.backends.cudnn.allow_tf32 = False``). With
``tpu.compute_dtype: "bfloat16"`` both stages compute in bf16
(``nn/precision.py``) and the reply is ``round(clamp(x, 0, 1) * 255)`` of the
bf16 frames, computed in bf16 as the JAX service computes it (above 128 the
bf16 grid is 1.0 apart), on a mesh and in an artifact as on one process.
Opt-in int8 (``tpu.decode_quant``, ``tpu.encode_quant``; ``models/quant.py``;
in bf16 too) calibrates its activation scales
on the first request, or on :meth:`InferenceFrontend.calibrate`'s frames, and
keeps them in the stages' ``quant_scales`` / ``encode_scales`` buffers.

Several GPUs (``PredictionService(mesh_axes=...)``, ``cli/serve.py
--mesh_data / --mesh_model``), one process each in a process group
(``parallel/``): rank 0's frontend validates and pads a request, draws its
slot noise, and broadcasts frames, caption tensors and noise to the other
ranks, which run :meth:`PredictionService.follow` until rank 0's
:meth:`PredictionService.close` broadcasts the stop message.

* Data parallelism: each data index runs its rows of the batch, and the
  frames are gathered in rank order. A batch that the data axis does not
  divide runs at the next multiple (the padding cut off each reply).
* With ``model > 1`` the predictor is sharded (``parallel/partitioning.py::
  shard_predictor_``), and so is ExtendedDINOSAUR (``shard_decomp_``: its
  ViT blocks, patch-decoder MLP and transition block); SAVi stays
  replicated.
* Sequence-parallel decode, when the batch is smaller than the data axis:
  every rank runs the whole encode and rollout and decodes its slice of the
  ``B * num_preds`` frames. The frames split over the data axis alone when
  the decoder is sharded (each model group decodes the same frames with its
  shards), over data x model when it is replicated, as the JAX service
  takes its axes; they are zero-padded to the multiple, gathered, and the
  padding cut before the uint8 fetch.
* int8: the first request calibrates, each data index on its rows, the
  amaxes max-reduced over the data group (``models/quant.py``); under
  sequence-parallel decode every rank calibrates the decode on all the real
  frames, before the split.

``tpu.mesh_axes`` is not consulted, as in the JAX package: a serving process
does not change its batch split with the host's device count. The serving
artifact (``serve/export.py``) is single-process, as in the JAX package.
"""

from __future__ import annotations

import threading
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from textocvp_tpu_torch.core.config import check_compute_dtype
from textocvp_tpu_torch.core.experiment import Experiment
from textocvp_tpu_torch.core.logger import Logger, print_
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
from textocvp_tpu_torch.models.quant import (
    calibrate_decode_scales,
    calibrate_encode_scales,
    decode_quant_mode,
    encode_quant_mode,
)
from textocvp_tpu_torch.parallel.distributed import (
    get_runtime_mesh,
    is_process_zero,
    maybe_initialize_distributed,
)
from textocvp_tpu_torch.parallel.mesh import all_gather_rows, broadcast_object, shard_batch
from textocvp_tpu_torch.parallel.partitioning import (
    decomp_tp_enabled,
    shard_decomp_,
    shard_predictor_,
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


class PredictStage(nn.Module):
    """The predict stage as a pure function: videos (B, num_context, H, W, 3)
    uint8 or float32, the initial slots' noise (B, S, D) and the caption
    tensors -> predicted slots (B, num_preds, S, D). The decomposition
    model's encode (its ViT's denses in int8 once ``encode_scales`` is set)
    and slot attention, then the predictor's rollout."""

    def __init__(self, model, predictor, num_preds: int):
        super().__init__()
        self.model = model
        self.predictor = predictor
        self.num_preds = num_preds
        self.register_buffer("encode_scales", None)

    def forward(self, videos, noise, text: dict):
        videos = as_float_video(videos)
        kw = {} if self.encode_scales is None else {"encode_quant_scales": self.encode_scales}
        initial = self.model.slot_initializer(videos.shape[0], noise=noise)
        slots = self.model.decompose(videos, initial_slots=initial, **kw)
        return self.predictor(slots["slot_history"], num_preds=self.num_preds,
                              teacher_force=False, **text)


class DecodeStage(nn.Module):
    """The decode stage: predicted slots (B, P, S, D) -> (B, P, H, W, 3)
    uint8 frames, clipped to [0, 1] and rounded on the device (the reply is
    8-bit by contract, and fetching uint8 moves a quarter of the bytes). The
    decoder in int8 once ``quant_scales`` is set."""

    def __init__(self, model):
        super().__init__()
        self.model = model
        self.register_buffer("quant_scales", None)

    def forward(self, pred_slots):
        b, p, s, d = pred_slots.shape
        kw = {} if self.quant_scales is None else {"quant_scales": self.quant_scales}
        imgs = self.model.decode(pred_slots.reshape(b * p, s, d), **kw)["recons_imgs"]
        imgs = torch.round(imgs.clamp(0.0, 1.0) * 255.0).to(torch.uint8)
        return imgs.reshape(b, p, *imgs.shape[1:])


class InferenceFrontend:
    """Host-side request handling: validation, batch and caption padding,
    tokenization, the slot noise. Subclasses provide the two stage modules
    ``predict_module`` and ``decode_module`` and the contract attributes
    (batch_size, num_context, num_preds, num_slots, slot_dim, resolution,
    max_tokens, tokenizer, wire_dtype, device, generator)."""

    _quant_mode = None
    _encode_quant_mode = None
    _run_batch = None  # the batch a request is padded to, when not batch_size

    def _finalize_token(self, key: str, v: np.ndarray) -> np.ndarray:
        """Hook: a token array in the dtype the stage takes."""
        return v

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
            out[key] = self._finalize_token(key, v)
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
        """One dummy request: builds the kernels and warms the device up. A
        quantized service calibrates on its first request, so its dummy is
        uniform noise (seed 14), whose ranges are not degenerate as a black
        video's are; :meth:`calibrate` with real frames gives tighter scales."""
        h, w = self.resolution
        shape = (1, self.num_context, h, w, 3)
        if self._quant_mode or self._encode_quant_mode:
            frames = np.random.default_rng(14).uniform(0, 1, shape).astype(np.float32)
        else:
            frames = np.zeros(shape, np.float32)
        self.predict(frames, [self._warmup_caption()])

    def calibrate(self, frames: np.ndarray, captions: Sequence[str]):
        """Calibrate a quantized service on representative frames: one
        request, whose activations set the int8 scales. Only the first
        request calibrates; later calls answer as any request does."""
        if not (self._quant_mode or self._encode_quant_mode):
            raise ValueError("calibrate() only applies to services with "
                             "tpu.decode_quant or tpu.encode_quant set")
        self.predict(frames, captions)

    def _draw_noise(self, b: int):
        """The initial slots' noise of a batch of ``b``, from ``generator``."""
        return torch.randn((b, self.num_slots, self.slot_dim),
                           generator=self.generator, device=self.generator.device)

    @torch.inference_mode()
    def _predict_stage(self, frames: np.ndarray, text: dict, noise=None):
        """The host part of the predict stage: the request on the device and
        the initial slots' noise (drawn from ``generator`` unless given); then
        :meth:`_run_predict`."""
        videos = torch.from_numpy(frames).to(self.device)
        if noise is None:
            noise = self._draw_noise(frames.shape[0])
        text = {k: torch.from_numpy(v).to(self.device) for k, v in text.items()}
        return self._run_predict(videos, noise.to(self.device), text)

    def _run_predict(self, videos, noise, text):
        return self.predict_module(videos, noise, text)

    @torch.inference_mode()
    def _decode_stage(self, pred_slots):
        return self.decode_module(pred_slots)

    def _dispatch(self, frames: np.ndarray, text: dict):
        """Both stages of a padded request -> uint8 frames on the device."""
        return self._decode_stage(self._predict_stage(frames, text))

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
        pad = (self._run_batch or self.batch_size) - b
        if pad:
            frames = np.concatenate([frames, np.repeat(frames[-1:], pad, axis=0)], axis=0)
            captions = list(captions) + [captions[-1]] * pad
        text = self._tokenize(captions)
        with self._lock:
            imgs, done = self._start_fetch(self._dispatch(frames, text))
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

    ``mesh_axes`` (``{"data": d, "model": m}``, ``data`` -1 for the ranks
    left) serves over the process group that the environment names, as the
    module docstring says; every rank builds the service, rank 0 answers and
    the others call :meth:`follow`.
    """

    def __init__(self, exp_path, name_pred_exp: str, decomp_ckpt: str, pred_ckpt: str,
                 num_seed: Optional[int] = None, num_preds: Optional[int] = None,
                 batch_size: int = 8, max_tokens: int = 24, wire_dtype: str = "float32",
                 device="cuda", generator: Optional[torch.Generator] = None,
                 mesh_axes: Optional[dict] = None):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("PredictionService: no CUDA device; pass device='cpu' to "
                               "run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.mesh = None
        self._seq_parallel = False
        self._closed = False
        if mesh_axes:
            maybe_initialize_distributed()
            self.mesh = get_runtime_mesh({"mesh_axes": mesh_axes}, self.device)
            self.device = self.mesh.device

        self.parent = Experiment(exp_path)
        pred_path = Path(name_pred_exp)
        self.exp = Experiment(pred_path if pred_path.is_absolute()
                              else self.parent.exp_path / "predictors" / name_pred_exp)
        Logger(self.exp.exp_path)
        self.exp_params = self.exp.params
        self.compute_dtype = check_compute_dtype(self.exp_params)
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
        self._quant_mode = decode_quant_mode(self.exp_params)
        self._encode_quant_mode = encode_quant_mode(self.exp_params)
        self._decomp_sharded = False
        if self.mesh is not None:
            d = self.mesh.data
            self._decomp_sharded = self.mesh.tensor_parallel and decomp_tp_enabled(
                self.exp_params)
            self._seq_parallel = self.batch_size < d
            if self._seq_parallel:
                print_(f"serve: batch {self.batch_size} < data axis {d}: sequence-parallel "
                       "decode (encode and rollout on every rank, the decode's frames "
                       f"split over {d if self._decomp_sharded else self.mesh.world} ranks)")
            elif self.batch_size % d:
                self._run_batch = -(-self.batch_size // d) * d
                print_(f"serve: batch {self.batch_size} not divisible by data axis {d}: "
                       f"running at padded batch {self._run_batch}")
            print_(f"serve: mesh data={d} model={self.mesh.model}, rank {self.mesh.rank}, "
                   f"backend {self.mesh.backend}")
        self.model = self._load(setup_model(self.exp_params),
                                self.parent.checkpoint_path(decomp_ckpt))
        self.predictor = self._load(setup_predictor(self.exp_params),
                                    self.exp.checkpoint_path(pred_ckpt))
        if self.mesh is not None:
            shard_predictor_(self.predictor, self.mesh)
            if self._decomp_sharded:
                shard_decomp_(self.model, self.mesh)
        self.predict_module = PredictStage(self.model, self.predictor, self.num_preds)
        self.decode_module = DecodeStage(self.model)
        self.generator = generator or torch.Generator(self.device).manual_seed(14)
        self._lock = threading.Lock()

    def _load(self, module, path):
        module.load_state_dict(load_params(path))
        return module.to(self.device).eval().requires_grad_(False)

    # ----------------------------------------------------------------- mesh
    def _dispatch(self, frames: np.ndarray, text: dict):
        if self.mesh is None:
            return super()._dispatch(frames, text)
        noise = self._draw_noise(frames.shape[0]).cpu()
        broadcast_object((frames, text, noise))
        return self._mesh_run(frames, text, noise)

    @torch.inference_mode()
    def _mesh_run(self, frames: np.ndarray, text: dict, noise):
        """One padded request on this rank's share of the mesh -> the whole
        batch's uint8 frames (B, P, H, W, 3) on the device, on every rank."""
        if not self._seq_parallel:
            frames, text, noise = shard_batch((frames, text, noise), self.mesh)
            imgs = self._decode_stage(self._predict_stage(frames, text, noise))
            return all_gather_rows(imgs, self.mesh.data_group)
        pred_slots = self._predict_stage(frames, text, noise)
        b, p, s, d = pred_slots.shape
        mesh = self.mesh
        n, index, group = ((mesh.data, mesh.data_index, mesh.data_group) if self._decomp_sharded
                           else (mesh.world, mesh.rank, mesh.world_group))
        per = -(-(b * p) // n)
        flat = pred_slots.reshape(b * p, s, d)
        self._calibrate_decode(flat)  # on all the real frames, before the split
        flat = torch.cat([flat, flat.new_zeros((per * n - b * p, s, d))])
        mine = flat[index * per:(index + 1) * per]
        imgs = self._decode_stage(mine[:, None])[:, 0]
        imgs = all_gather_rows(imgs, group)[:b * p]
        return imgs.reshape(b, p, *imgs.shape[1:])

    def follow(self):
        """The loop of a rank other than 0: run each request that rank 0
        broadcasts, until it broadcasts the stop message (:meth:`close`)."""
        if self.mesh is None or is_process_zero():
            raise RuntimeError("follow() runs on the ranks other than 0 of a mesh service")
        while True:
            msg = broadcast_object(None)
            if msg is None:
                return
            self._mesh_run(*msg)

    def close(self):
        """Rank 0 of a mesh service: send the other ranks the stop message
        (once). Nothing on a single-process service."""
        if self.mesh is not None and is_process_zero() and not self._closed:
            self._closed = True
            broadcast_object(None)

    def _data_group(self):
        return None if self.mesh is None else self.mesh.data_group

    def _run_predict(self, videos, noise, text):
        # int8 ViT: calibrated on the first request's context frames (under
        # the dispatch lock, so once), as the JAX service does
        if self._encode_quant_mode and self.predict_module.encode_scales is None:
            self.predict_module.encode_scales = calibrate_encode_scales(
                self.model, as_float_video(videos), self._data_group())
        return self.predict_module(videos, noise, text)

    def _calibrate_decode(self, slots):
        """int8 decode: the scales of the first request's predicted slots (N,
        S, D), its rows over the data group."""
        if self._quant_mode and self.decode_module.quant_scales is None:
            self.decode_module.quant_scales = calibrate_decode_scales(
                self.model, slots, self._data_group())

    @torch.inference_mode()
    def _decode_stage(self, pred_slots):
        self._calibrate_decode(pred_slots.reshape(-1, self.num_slots, self.slot_dim))
        return self.decode_module(pred_slots)
