"""
Serving artifacts of the port (counterpart of the JAX package's
``textocvp_tpu/serve/export.py``): a live :class:`PredictionService`'s two
stages written out with ``torch.export``, weights inside, so that deploying
them needs no model class, no experiment directory and no checkpoint.

An artifact directory holds

* ``predict.pt2``: :class:`serve.pipeline.PredictStage`, (videos, initial
  slots' noise, caption tensors) -> predicted slots, the seed encode and the
  rollout with every weight (and the calibrated ``encode_scales`` of an int8
  ViT);
* ``decode.pt2``: :class:`serve.pipeline.DecodeStage`, predicted slots ->
  uint8 frames (with the calibrated ``quant_scales`` of an int8 decode);
* ``manifest.json``: the request contract (``batch_size``, ``num_context``,
  ``num_preds``, ``resolution``, ``max_tokens``, the caption tensors' shapes
  and dtypes, ``wire_dtype``), the ``dataset`` config that rebuilds the
  tokenizer, the honesty flags ``decode_quant`` / ``encode_quant``, the slot
  noise's shape and the ``device`` the stages were exported on.

:class:`ExportedPredictionService` answers from such a directory with the
host-side request handling of :class:`InferenceFrontend` (validation,
padding, tokenization, the slot noise from its ``generator``), so from the
same generator state it replies as the live service did, bit for bit. It
needs only the port's ops, imported here: the hand-written kernels are ops of
the ``textocvp_torch`` library (``torch.library.custom_op``), one node each in
the exported graphs, and their CUDA kernels build from ``csrc/`` at first
use. An artifact runs on the device it was exported on: loading it on
another raises and names both.

Refused, as in the JAX package: a quantized service that has not been
calibrated (:meth:`InferenceFrontend.warmup` or ``calibrate`` first), since
the artifact keeps its scales for good; and a mesh service
(``PredictionService(mesh_axes=...)``): an artifact is single-process, its
graphs hold no collective. The JAX package's other refusals (the
constant-bake limit, ``decode_autotune``) guard XLA settings the port does
not have.
"""

from __future__ import annotations

import json
import threading
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from textocvp_tpu_torch.nn.precision import COMPUTE_DTYPES
# the ops the exported graphs call: importing the modules registers them
from textocvp_tpu_torch.ops import conv5, conv_int8, slot_attention_kernel, vit_attention  # noqa: F401
from textocvp_tpu_torch.serve.pipeline import InferenceFrontend, serving_tokenizer

MANIFEST = "manifest.json"
PREDICT = "predict.pt2"
DECODE = "decode.pt2"


def export_service(service, out_dir) -> Path:
    """Write ``service``'s stages and manifest into ``out_dir`` (created);
    returns its path. The stages are traced under ``torch.no_grad()`` with
    example inputs on the service's device, at its batch and caption length."""
    if getattr(service, "mesh", None) is not None:
        raise ValueError("a serving artifact is single-process by design (its graphs "
                         "hold no collective); build the service without mesh_axes to export")
    if service._encode_quant_mode and service.predict_module.encode_scales is None:
        raise ValueError(
            "quantized service (tpu.encode_quant) has not been calibrated yet — call "
            "service.calibrate(real_frames, captions) (preferred: the exported artifact "
            "keeps these scales for good) or service.warmup() before export")
    if service._quant_mode and service.decode_module.quant_scales is None:
        raise ValueError(
            "quantized service (tpu.decode_quant) has not been calibrated yet — call "
            "service.calibrate(real_frames, captions) (preferred: the exported artifact "
            "keeps these scales for good) or service.warmup() before export")
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    b, dev = service.batch_size, service.device
    h, w = service.resolution
    wire = torch.uint8 if service.wire_dtype == "uint8" else torch.float32
    text = service._tokenize([service._warmup_caption()] * b)
    videos = torch.zeros((b, service.num_context, h, w, 3), dtype=wire, device=dev)
    noise = torch.zeros((b, service.num_slots, service.slot_dim), device=dev)
    # the predict stage's slots, in the compute dtype, are the decode stage's input
    slots = torch.zeros((b, service.num_preds, service.num_slots, service.slot_dim),
                        dtype=COMPUTE_DTYPES[service.compute_dtype], device=dev)
    with torch.no_grad():
        predict = torch.export.export(
            service.predict_module,
            (videos, noise, {k: torch.from_numpy(v).to(dev) for k, v in text.items()}))
        decode = torch.export.export(service.decode_module, (slots,))
    torch.export.save(predict, out / PREDICT)
    torch.export.save(decode, out / DECODE)
    manifest = {
        "batch_size": b,
        "num_context": service.num_context,
        "num_preds": service.num_preds,
        "resolution": [h, w],
        "max_tokens": service.max_tokens,
        "text_kwargs": {k: [list(v.shape), str(v.dtype)] for k, v in text.items()},
        "dataset": service.exp_params["dataset"],
        "decode_quant": service._quant_mode,
        "encode_quant": service._encode_quant_mode,
        "wire_dtype": service.wire_dtype,
        "noise_shape": [service.num_slots, service.slot_dim],
        "device": str(dev),
    }
    (out / MANIFEST).write_text(json.dumps(manifest, indent=2))
    return out


class ExportedPredictionService(InferenceFrontend):
    """``predict()`` over an artifact directory: no model code, no
    experiment, no checkpoint. ``device`` defaults to the one the artifact
    was exported on, and another raises; ``generator`` draws the slot noise
    (by default one on the device seeded with 14, as the live service's)."""

    def __init__(self, artifact_dir, device=None, generator: Optional[torch.Generator] = None):
        d = Path(artifact_dir)
        manifest = json.loads((d / MANIFEST).read_text())
        exported_on = torch.device(manifest["device"])
        self.device = exported_on if device is None else torch.device(device)
        if self.device.type != exported_on.type:
            raise ValueError(f"the artifact in {d} was exported on {exported_on} and runs "
                             f"there; it cannot load on {self.device}")
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"the artifact in {d} was exported on {exported_on} and runs "
                               "there; this machine has no CUDA device")
        if self.device.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.batch_size = manifest["batch_size"]
        self.num_context = manifest["num_context"]
        self.num_preds = manifest["num_preds"]
        self.resolution = tuple(manifest["resolution"])
        self.max_tokens = manifest["max_tokens"]
        self.wire_dtype = manifest["wire_dtype"]
        self.num_slots, self.slot_dim = manifest["noise_shape"]
        self.decode_quant = manifest["decode_quant"]
        self.encode_quant = manifest["encode_quant"]
        self._text_dtypes = {k: np.dtype(dt)
                             for k, (_, dt) in manifest["text_kwargs"].items()}
        self.tokenizer = serving_tokenizer({"dataset": manifest["dataset"]})
        self.predict_module = torch.export.load(d / PREDICT).module()
        self.decode_module = torch.export.load(d / DECODE).module()
        self.generator = generator or torch.Generator(self.device).manual_seed(14)
        self._lock = threading.Lock()

    def _finalize_token(self, key: str, v: np.ndarray) -> np.ndarray:
        return v.astype(self._text_dtypes[key], copy=False)
