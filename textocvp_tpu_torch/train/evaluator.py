"""
03 evaluate-decomposition and 05 evaluate-predictor protocols of the port
(counterparts of ``textocvp_tpu/train/evaluator.py::DecompEvaluator`` and
``PredictorEvaluator``).

03 (:class:`DecompEvaluator`): each test video of the dataset's
``num_frames`` frames is decomposed whole (every frame encoded, the slot
recurrence over all of them) and all B * T frames decoded in one call;
PSNR/SSIM/LPIPS of the reconstructions, clipped to [0, 1], against the
frames, clipped too, for every frame. The JAX class's chunked, autotuned and
multi-device branches change no output and are not ported.

05 (:class:`PredictorEvaluator`): per batch, on one device, the seed encode
of the first ``num_seed`` frames (the decomposition model's encoder and slot
attention), the predictor's rollout of ``num_preds`` slot frames, the decode
of all B * num_preds predicted frames, and PSNR/SSIM/LPIPS of the
predictions, clipped to [0, 1], against the true frames, clipped too. Only
the seed frames are encoded: the slot recurrence is causal.

Opt-in int8 (``tpu.decode_quant`` / ``tpu.encode_quant``, ``models/quant.py``)
as in the JAX evaluators: the scales are calibrated on the first batch (05:
the ViT's on its seed frames, the decoder's on its predicted slots; 03: the
ViT's on its frames, the decoder's on the slots of a float encode with the
same initial slots), and that batch, like every other, then runs quantized;
``results.json`` carries ``"decode_quant": "int8"`` / ``"encode_quant":
"int8"``.

Both write ``<metric>_framewise.png`` beside ``results.json`` for every metric
with framewise values (``viz/figures.py::visualize_metric``, PIL), its x axis
from frame 0 (03) or ``num_context`` (05), as the JAX evaluators do.

Overrides as in the JAX package: ``num_seed`` overrides ``num_context``,
``num_preds`` the rollout length, and the dataset's ``num_frames`` becomes
``num_seed + num_preds``. A ragged last batch runs as it is; its rows'
metrics equal the JAX package's pad-and-slice. Float32 throughout, TF32
off for matmuls and cuDNN. ``LearnedRandom`` slot noise comes from one
``torch.Generator`` on the device seeded 14 (it cannot match ``jax.random``).
The decode is not chunked: at B = 64 on CATER one activation of the decoder
tail is 9728 x 64 x 64 x 64 float32, 10.2 GB, and the tail holds two at once.

On a mesh (``tpu.mesh_axes`` in a process group, ``parallel/``) each data
index evaluates its contiguous rows of every batch, a ragged batch padded to
the data multiple by repeating its last row (``EpochLoader``'s process
split). Every rank draws the initial slots of the batch's real rows from its
generator, as one process does, pads and takes its rows; the per-sample
metric rows are gathered in rank order and cut to the real rows, so the
aggregate is one process's. Under ``model > 1`` the predictor is sharded
(``parallel/partitioning.py::shard_predictor_``), and so is ExtendedDINOSAUR
(``shard_decomp_``: its ViT blocks, patch-decoder MLP and transition block;
SAVi stays replicated). Rank 0 alone writes ``results.json`` and the plots.
int8 runs on any mesh: each rank calibrates on its rows of the first batch
and the amaxes are max-reduced over the data group (``models/quant.py``), so
that every rank holds the global first batch's scales.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np
import torch

from textocvp_tpu_torch.core.experiment import Experiment
from textocvp_tpu_torch.core.logger import Logger, print_
from textocvp_tpu_torch.data.loader import EpochLoader, load_data
from textocvp_tpu_torch.data.tokenizers import text_tensors
from textocvp_tpu_torch.data.wire import as_float_video
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
    loader_process_kwargs,
    maybe_initialize_distributed,
)
from textocvp_tpu_torch.parallel.mesh import (
    all_gather_rows,
    global_tokens,
    pad_batch,
    shard_batch,
)
from textocvp_tpu_torch.parallel.partitioning import (
    decomp_tp_enabled,
    shard_decomp_,
    shard_predictor_,
)
from textocvp_tpu_torch.train.checkpoints import load_params
from textocvp_tpu_torch.train.metrics import MetricTracker
from textocvp_tpu_torch.viz.figures import visualize_metric


def _setup_device(device, who: str) -> torch.device:
    """The evaluators' device, float32 matmuls and convolutions (TF32 off);
    raises on a CUDA device where there is none."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{who}: no CUDA device; pass device='cpu' to evaluate on the CPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return device


class _MeshEval:
    """The evaluators' data split: :meth:`mesh_step` runs ``step(videos, info,
    initial_slots)`` on this rank's rows and returns the global batch's real
    rows of its metrics. ``single_process`` (the 06 generators, as in the JAX
    package): no process group, a mesh of one rank."""

    single_process = False

    def _setup_mesh(self, device):
        """Join the process group that the environment names
        (``parallel/distributed.py``) and make the mesh of ``tpu.mesh_axes``."""
        if self.single_process:
            self.mesh = get_runtime_mesh(None, device)
            return self.mesh.device
        maybe_initialize_distributed()
        self.mesh = get_runtime_mesh(self.exp_params.get("tpu"), device)
        return self.mesh.device

    def _shard_decomp(self, model):
        """ExtendedDINOSAUR over the model axis (``shard_decomp_``); SAVi and
        a model axis of 1 leave ``model`` whole."""
        if decomp_tp_enabled(self.exp_params):
            shard_decomp_(model, self.mesh)
        return model

    def _loader(self, dataset):
        return EpochLoader(dataset, self.batch_size, **loader_process_kwargs(self.mesh))

    def mesh_step(self, model, step, videos, info) -> dict:
        if self.mesh.data == 1:
            return step(videos, info, None)
        n = int(info["num_valid"])
        initial = model.slot_initializer(n, self.generator)
        initial = shard_batch(pad_batch(initial, self.mesh)[0], self.mesh)
        vals = step(videos, info, initial)
        return {k: all_gather_rows(v, self.mesh.data_group)[:n] for k, v in vals.items()}

    def _write(self, results: dict, start_x: int):
        if is_process_zero():  # one results.json and plot set an experiment
            self.exp.save_results(self.results_name, results)
            _save_framewise_plots(self.exp, self.results_name, results, start_x=start_x)


def _load(module, path, device):
    """``module`` with the weights of ``path`` on ``device``, in ``eval()``, frozen."""
    module.load_state_dict(load_params(path))
    return module.to(device).eval().requires_grad_(False)


def _tokenizer_fallback_flags(dataset) -> dict:
    """Results made with the hash tokenizer (ids that are not T5's) say so."""
    tok = getattr(dataset, "tokenizer", None)
    if tok is not None and getattr(tok, "is_fallback", False):
        return {"tokenizer_fallback": True}
    return {}


class _Quant:
    """The int8 modes of an experiment and their scales, None until the first
    batch calibrates them."""

    def __init__(self, exp_params: dict):
        self._quant_mode = decode_quant_mode(exp_params)
        self._encode_quant_mode = encode_quant_mode(exp_params)
        self.decode_quant_scales = self.encode_quant_scales = None

    def _encode_kwargs(self, model, videos) -> dict:
        """decompose's int8 ViT argument, calibrated on ``videos`` (over the
        mesh's data group) the first time."""
        if not self._encode_quant_mode:
            return {}
        if self.encode_quant_scales is None:
            self.encode_quant_scales = calibrate_encode_scales(model, videos,
                                                               self.mesh.data_group)
        return {"encode_quant_scales": self.encode_quant_scales}

    def _decode_kwargs(self, model, slots) -> dict:
        """decode's int8 argument, calibrated on ``slots()`` (N, S, D) (over
        the mesh's data group) the first time."""
        if not self._quant_mode:
            return {}
        if self.decode_quant_scales is None:
            self.decode_quant_scales = calibrate_decode_scales(model, slots(),
                                                               self.mesh.data_group)
        return {"quant_scales": self.decode_quant_scales}

    def _quant_flags(self) -> dict:
        """The honesty flags of results.json."""
        flags = {}
        if self._quant_mode:
            flags["decode_quant"] = self._quant_mode
        if self._encode_quant_mode:
            flags["encode_quant"] = self._encode_quant_mode
        return flags


def _save_framewise_plots(exp, results_name: str, results: dict, start_x: int = 0):
    """Per-frame metric curves next to results.json (reference
    metrics.py:128-144, baseEvaluator.py:211-216)."""
    out_dir = exp.results_dir(results_name)
    for metric, vals in results.items():
        if isinstance(vals, dict) and "framewise" in vals:
            visualize_metric(vals["framewise"], savepath=out_dir / f"{metric}_framewise.png",
                             title=metric, start_x=start_x)


class DecompEvaluator(_Quant, _MeshEval):
    """Evaluate a decomposition checkpoint on whole-sequence reconstruction.

    ``checkpoint`` is ``models/<checkpoint>.pt`` of the experiment at
    ``exp_path`` (a training checkpoint or a bare state dict,
    ``train/checkpoints.py::load_params``). ``batch_size`` defaults to the
    training batch size, ``results_name`` to ``eval_decomp_<checkpoint>``.
    A ragged last batch runs as it is; its rows' metrics equal the JAX
    package's pad-and-slice. Float32 throughout, TF32 off. ``LearnedRandom``
    slot noise comes from one ``torch.Generator`` on the device seeded 14 (it
    cannot match ``jax.random``). Call :meth:`load_data`, :meth:`load_model`,
    then :meth:`evaluate`.
    """

    # DecompFigGenerator draws what a features-only decoder gives (masks and
    # objects); the metrics need RGB reconstructions
    requires_image_reconstruction = True

    def __init__(self, exp_path, checkpoint: str, batch_size: Optional[int] = None,
                 results_name: Optional[str] = None, metrics=("psnr", "ssim", "lpips"),
                 device="cuda"):
        self.exp = Experiment(exp_path)
        Logger(self.exp.exp_path)
        self.exp_params = self.exp.params
        if self.requires_image_reconstruction:
            check_image_reconstruction(self.exp_params,
                                       purpose="compute reconstruction metrics for")
        self.device = self._setup_mesh(_setup_device(device, "DecompEvaluator"))
        _Quant.__init__(self, self.exp_params)
        self.checkpoint = checkpoint
        self.batch_size = batch_size or self.exp_params["training"]["batch_size"]
        self.results_name = results_name or f"eval_decomp_{checkpoint}"
        self.model = setup_model(self.exp_params)
        self.metric_tracker = MetricTracker(metrics, device=self.device)
        self.generator = torch.Generator(self.device).manual_seed(14)

    def load_data(self):
        self.test_set = load_data(self.exp_params, split="test")
        self.test_loader = self._loader(self.test_set)

    def load_model(self):
        self.model = self._shard_decomp(
            _load(self.model, self.exp.checkpoint_path(self.checkpoint), self.device))

    def to_device(self, videos):
        """A loader batch's videos -> float (B, T, H, W, 3) on the device."""
        return as_float_video(torch.as_tensor(np.asarray(videos)).to(self.device))

    @torch.inference_mode()
    def reconstruct(self, videos, initial_slots=None):
        """The model's whole-sequence forward on videos (B, T, H, W, 3) on the
        device: decompose all T frames, then decode all B * T frames in one
        call -> reconstructions (B, T, H, W, 3) clipped to [0, 1]. The initial
        slots are ``initial_slots`` when given, else the initializer's."""
        b, t = videos.shape[:2]
        init = (self.model.slot_initializer(b, self.generator) if initial_slots is None
                else initial_slots.to(self.device))
        ekw = self._encode_kwargs(self.model, videos)
        slots = self.model.decompose(videos, initial_slots=init, **ekw)["slot_history"]
        flat = slots.reshape(b * t, *slots.shape[2:])

        def float_slots():  # the JAX calibration decodes a float encode's slots
            if not ekw:
                return flat
            return self.model.decompose(videos, initial_slots=init)["slot_history"].reshape(
                flat.shape)

        imgs = self.model.decode(flat, **self._decode_kwargs(self.model, float_slots))
        imgs = imgs["recons_imgs"]
        return imgs.reshape(b, t, *imgs.shape[1:]).clamp(0.0, 1.0)

    @torch.inference_mode()
    def eval_step(self, videos, initial_slots=None) -> dict:
        """One batch: framewise metrics {name: (B, T)} on the device."""
        videos = self.to_device(videos)
        recons = self.reconstruct(videos, initial_slots)
        return self.metric_tracker.compute(recons, videos.clamp(0.0, 1.0))

    def evaluate(self) -> dict:
        self.metric_tracker.reset()
        step = lambda videos, info, initial: self.eval_step(videos, initial)
        for videos, info in self.test_loader:
            self.metric_tracker.accumulate(
                precomputed=self.mesh_step(self.model, step, videos, info))
        self.metric_tracker.aggregate()
        results = self.metric_tracker.to_json()
        results.update(_tokenizer_fallback_flags(self.test_set))
        results.update(self._quant_flags())
        self._write(results, start_x=0)
        print_(f"Results: { {k: v['mean'] for k, v in results.items() if isinstance(v, dict)} }")
        return results


class PredictorEvaluator(_Quant, _MeshEval):
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
        self.device = _setup_device(device, "PredictorEvaluator")
        self.parent = Experiment(exp_path)
        pred_path = Path(name_pred_exp)
        self.exp = Experiment(pred_path if pred_path.is_absolute()
                              else self.parent.exp_path / "predictors" / name_pred_exp)
        Logger(self.exp.exp_path)
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
        self.device = self._setup_mesh(self.device)

        check_image_reconstruction(self.exp_params, purpose="evaluate predictions on")
        _Quant.__init__(self, self.exp_params)
        self.model = setup_model(self.exp_params)
        self.predictor = setup_predictor(self.exp_params)
        self.metric_tracker = MetricTracker(metrics, device=self.device)
        self.generator = torch.Generator(self.device).manual_seed(14)

    def load_data(self):
        self.test_set = load_data(self.exp_params, split="test")
        self.test_loader = self._loader(self.test_set)

    def load_models(self):
        self.model = self._shard_decomp(
            _load(self.model, self.parent.checkpoint_path(self.decomp_ckpt), self.device))
        self.predictor = _load(self.predictor, self.exp.checkpoint_path(self.pred_ckpt),
                               self.device)
        shard_predictor_(self.predictor, self.mesh)

    @torch.inference_mode()
    def predict_stage(self, videos, text: dict, initial_slots=None):
        """Seed encode + rollout: videos (B, T, H, W, 3) on the device ->
        predicted slots (B, num_preds, S, D)."""
        seed = videos[:, :self.num_context]
        slots = self.model.decompose(
            seed, initial_slots=None if initial_slots is None else initial_slots.to(self.device),
            generator=self.generator, **self._encode_kwargs(self.model, seed))["slot_history"]
        return self.predictor(slots, num_preds=self.num_preds, teacher_force=False, **text)

    @torch.inference_mode()
    def decode_stage(self, pred_slots):
        """All B * num_preds predicted frames -> (B, num_preds, H, W, 3), clipped to [0, 1]."""
        b, p, s, d = pred_slots.shape
        flat = pred_slots.reshape(b * p, s, d)
        imgs = self.model.decode(flat, **self._decode_kwargs(self.model, lambda: flat))
        return imgs["recons_imgs"].reshape(b, p, *imgs["recons_imgs"].shape[1:]).clamp(0.0, 1.0)

    @torch.inference_mode()
    def metrics_stage(self, pred_imgs, videos) -> dict:
        c, p = self.num_context, self.num_preds
        targets = videos[:, c:c + p].clamp(0.0, 1.0)
        return self.metric_tracker.compute(pred_imgs, targets)

    def to_device(self, videos, info: dict):
        """A loader batch -> float video and caption tensors on the device
        (``data/tokenizers.py::text_tensors``)."""
        videos = as_float_video(torch.as_tensor(np.asarray(videos)).to(self.device))
        tokenizer = getattr(getattr(self, "test_set", None), "tokenizer", None)
        info = global_tokens(info, tokenizer, self.mesh)
        return videos, text_tensors(info, self.device)

    def eval_step(self, videos, info: dict, initial_slots=None) -> dict:
        """One batch: framewise metrics {name: (B, num_preds)} on the device."""
        videos, text = self.to_device(videos, info)
        pred_imgs = self.decode_stage(self.predict_stage(videos, text, initial_slots))
        return self.metrics_stage(pred_imgs, videos)

    def evaluate(self) -> dict:
        self.metric_tracker.reset()
        for videos, info in self.test_loader:
            self.metric_tracker.accumulate(
                precomputed=self.mesh_step(self.model, self.eval_step, videos, info))
        self.metric_tracker.aggregate()
        results = self.metric_tracker.to_json()
        results.update(_tokenizer_fallback_flags(self.test_set))
        results.update(self._quant_flags())
        self._write(results, start_x=self.num_context)
        print_(f"Results: { {k: v['mean'] for k, v in results.items() if isinstance(v, dict)} }")
        return results
