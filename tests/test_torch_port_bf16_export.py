"""``tpu.compute_dtype: "bfloat16"`` under ``07 --export``, on the CPU at a
small size.

* Serving artifacts (``serve/export.py``) of tiny services in bf16: CATER
  (SAVi with the stock tail's shape, so the decode graph holds the conv5
  op), CATER with int8 decode, and CLIPort (ExtendedDINOSAUR, the ViT
  attention op). Each artifact answers a full and a padded request bit for
  bit as the live bf16 service does from the same generator state, and its
  graphs hold the kernels' ops, whose fake implementations keep the bf16
  dtype (conv5, the ViT attention) or return float32 (the int8 conv).
(06 in bf16: ``test_torch_port_bf16_figs.py``.)
"""

import torch_cpu_threads  # noqa: F401  (two torch threads a worker)

import numpy as np
import pytest
import torch
from test_torch_port_export import BATCH, _experiment, _frames, _service

from textocvp_tpu_torch.core.experiment import Experiment
from textocvp_tpu_torch.serve import ExportedPredictionService, export_service

OPS = {"SAVi": ({"slot_attention"}, {"conv5"}),
       "SAVi_int8": ({"slot_attention"}, {"conv_int8"}),
       "ExtendedDINOSAUR": ({"slot_attention", "vit_attention"}, set())}


def _in_bf16(exp_dir):
    """Every params file of the experiment at ``exp_dir`` computing in bf16."""
    for path in (exp_dir, exp_dir / "predictors" / "tiny_t5"):
        exp = Experiment(path)
        params = exp.params
        params["tpu"] = {**(params.get("tpu") or {}), "compute_dtype": "bfloat16"}
        exp.save_params(params)
    return exp_dir


@pytest.mark.parametrize("kind", sorted(OPS))
def test_a_bf16_artifact_replies_bit_for_bit_like_the_live_service(kind, tmp_path):
    service = _service(_in_bf16(_experiment(tmp_path / "exp", kind)))
    assert service.compute_dtype == "bfloat16"
    if service._quant_mode:
        service.calibrate(_frames(service, BATCH, seed=1), ["the cone"] * BATCH)
    artifact = ExportedPredictionService(export_service(service, tmp_path / "artifact"))
    for rows in (BATCH, 1):
        frames = _frames(service, rows, seed=rows)
        captions = [service._warmup_caption()] * rows
        state = service.generator.get_state()
        live = service.predict(frames, captions)
        artifact.generator.set_state(state)
        got = artifact.predict(frames, captions)
        assert got.shape == (rows, service.num_preds, *service.resolution, 3)
        np.testing.assert_array_equal(got, live)
    predict_ops, decode_ops = OPS[kind]
    for stage, want in ((artifact.predict_module, predict_ops),
                        (artifact.decode_module, decode_ops)):
        nodes = [n for n in stage.graph.nodes if str(n.target).startswith("textocvp_torch.")]
        assert {str(n.target).split(".")[1] for n in nodes} == want
        for n in nodes:
            out = n.meta["val"]
            out = out[0] if isinstance(out, (tuple, list)) else out
            name = str(n.target).split(".")[1]
            want_dtype = {"conv_int8": torch.float32, "slot_attention": torch.float32}.get(
                name, torch.bfloat16)
            assert out.dtype == want_dtype, (name, out.dtype)
