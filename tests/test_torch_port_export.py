"""Serving artifacts of the port (``serve/export.py``, ``07 --export``) on
the CPU: tiny CATER (SAVi) and CLIPort (ExtendedDINOSAUR) services, each
with TextOCVP_T5 and random weights, and a quantized CATER one.

An artifact reloaded by ``ExportedPredictionService`` answers the same
requests bit for bit like the live service from the same generator state:
the same stage modules traced, the same slot noise drawn on the host; and
through ``serve()`` and the ``DynamicBatcher`` as a live service does. The
exported graphs call the port's kernels as single ops of the
``textocvp_torch`` library (the CUDA kernels on the card, their plain
versions here). The manifest has the JAX package's keys plus ``device``.
"""

import torch_cpu_threads  # noqa: F401  (two torch threads a worker)
import io
import json
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch
from test_torch_port_service import MAX_TOKENS, _tiny_params

from textocvp_tpu_torch.cli import serve as serve_cli
from textocvp_tpu_torch.core.experiment import Experiment
from textocvp_tpu_torch.models import setup_model, setup_predictor
from textocvp_tpu_torch.models.factory import random_init_
from textocvp_tpu_torch.serve import (
    DynamicBatcher,
    ExportedPredictionService,
    PredictionService,
    export_service,
    serve,
)

BATCH = 2
# serve/export.py's manifest keys in the JAX package
JAX_KEYS = {"batch_size", "num_context", "num_preds", "resolution", "max_tokens", "text_kwargs",
            "dataset", "decode_quant", "encode_quant", "wire_dtype"}
# the ops of each artifact's graphs: the kernels the stages run
OPS = {"SAVi": ({"slot_attention"}, {"conv5"}),
       "SAVi_int8": ({"slot_attention"}, {"conv_int8"}),
       "ExtendedDINOSAUR": ({"slot_attention", "vit_attention"}, set())}


def _experiment(root, kind):
    params, pred_params = _tiny_params("ExtendedDINOSAUR" if kind == "ExtendedDINOSAUR"
                                       else "SAVi")
    for p in (params, pred_params):
        p["model"]["model_params"]["initializer"] = "LearnedRandom"
        if kind != "ExtendedDINOSAUR":  # the stock tail's shape, which runs through conv5
            p["model"]["model_params"]["decoder"]["decoder_params"]["num_channels"] = [64, 64]
        if kind == "SAVi_int8":
            p["tpu"] = {"decode_quant": "int8"}
    gen = torch.Generator().manual_seed(5)
    model = random_init_(setup_model(params), gen)
    predictor = random_init_(setup_predictor(pred_params), gen)
    with torch.no_grad():  # a gentle rollout: slots of order 1 over the steps
        predictor.predictor.mlp_out.weight.mul_(0.02)
    parent = Experiment(root)
    parent.save_params(params)
    pred = Experiment(root / "predictors" / "tiny_t5")
    pred.save_params(pred_params)
    for exp, module in ((parent, model), (pred, predictor)):
        exp.models_dir.mkdir(parents=True, exist_ok=True)
        torch.save(module.state_dict(), exp.checkpoint_path("ckpt"))
    return root


def _service(exp_dir):
    return PredictionService(exp_dir, "tiny_t5", "ckpt", "ckpt", batch_size=BATCH,
                             max_tokens=MAX_TOKENS, device="cpu")


def _frames(service, rows, seed=0):
    h, w = service.resolution
    return np.random.default_rng(seed).random((rows, service.num_context, h, w, 3), np.float32)


@pytest.fixture(scope="module", params=sorted(OPS))
def exported(request, tmp_path_factory):
    """(kind, live service, artifact directory, the artifact loaded) of one
    kind of service."""
    root = tmp_path_factory.mktemp(f"export_{request.param}")
    service = _service(_experiment(root / "exp", request.param))
    if service._quant_mode:
        service.calibrate(_frames(service, BATCH, seed=1), ["the cone"] * BATCH)
    art = export_service(service, root / "artifact")
    return request.param, service, art, ExportedPredictionService(art)


def test_an_artifact_replies_bit_for_bit_like_the_live_service(exported):
    kind, service, _, artifact = exported
    for rows in (BATCH, 1):  # a full request and a padded one
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
        ops = {str(n.target).split(".")[1] for n in stage.graph.nodes
               if str(n.target).startswith("textocvp_torch.")}
        assert ops == want, ops


def test_the_dynamic_batcher_coalesces_an_artifacts_requests(exported):
    """Two concurrent one-row requests to an artifact share one device batch
    and get what a direct two-row predict from the same state gets."""
    _, service, _, artifact = exported
    frames = _frames(service, 2, seed=5)
    captions = [service._warmup_caption()] * 2
    state = artifact.generator.get_state()
    ref = artifact.predict(frames, captions)
    batcher = DynamicBatcher(artifact, max_wait_ms=1000.0)
    try:
        artifact.generator.set_state(state)
        out = {}
        threads = [threading.Thread(target=lambda i=i: out.update(
            {i: batcher.predict(frames[i:i + 1], captions[i:i + 1])})) for i in range(2)]
        threads[0].start()
        time.sleep(0.05)  # request 0 enqueues first
        threads[1].start()
        for t in threads:
            t.join(timeout=60)
        assert batcher._dispatches == 1
        np.testing.assert_array_equal(np.concatenate([out[0], out[1]]), ref)
    finally:
        batcher.close()


def test_the_manifest_carries_the_jax_keys(exported):
    kind, service, art, artifact = exported
    manifest = json.loads((art / "manifest.json").read_text())
    assert JAX_KEYS | {"device", "noise_shape"} == set(manifest)
    assert manifest["batch_size"] == BATCH and manifest["device"] == "cpu"
    assert manifest["decode_quant"] == ("int8" if kind == "SAVi_int8" else None)
    assert manifest["encode_quant"] is None
    assert manifest["dataset"] == service.exp_params["dataset"]
    assert manifest["text_kwargs"]["caption_tokens"] == [[BATCH, MAX_TOKENS], "int32"]
    if kind == "SAVi_int8":  # the calibrated scales are in the artifact
        torch.testing.assert_close(artifact.decode_module.quant_scales,
                                   service.decode_module.quant_scales, rtol=0, atol=0)


def test_an_artifact_refuses_another_device(exported):
    _, _, art, _ = exported
    with pytest.raises(ValueError, match="exported on cpu .* cannot load on cuda"):
        ExportedPredictionService(art, device="cuda")


def test_an_uncalibrated_quantized_service_refuses_to_export(tmp_path):
    service = _service(_experiment(tmp_path / "exp", "SAVi_int8"))
    with pytest.raises(ValueError, match=r"tpu.decode_quant\) has not been calibrated"):
        export_service(service, tmp_path / "artifact")
    assert not (tmp_path / "artifact").exists()
    with pytest.raises(ValueError, match="only applies"):
        _service(_experiment(tmp_path / "float", "SAVi")).calibrate(None, [])


def test_07_export_writes_the_artifact_and_serve_answers_from_it(tmp_path):
    """``07 --export`` calibrates a quantized service (its warmup) and writes
    the artifact; ``serve()`` answers /predict from the artifact as a direct
    predict does."""
    exp_dir = _experiment(tmp_path / "exp", "SAVi_int8")
    assert serve_cli.main(["-d", str(exp_dir), "--name_pred_exp", "tiny_t5",
                           "--decomp_ckpt", "ckpt", "--pred_ckpt", "ckpt",
                           "--batch_size", str(BATCH), "--max_tokens", str(MAX_TOKENS),
                           "--device", "cpu", "--export", str(tmp_path / "art")]) == 0
    assert {p.name for p in (tmp_path / "art").iterdir()} == {
        "predict.pt2", "decode.pt2", "manifest.json"}
    artifact = ExportedPredictionService(tmp_path / "art")
    assert artifact.decode_quant == "int8"
    frames = _frames(artifact, 1, seed=3)
    state = artifact.generator.get_state()
    want = artifact.predict(frames, ["the cone"])
    artifact.generator.set_state(state)
    httpd = serve(artifact, port=0, warmup=False)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        buf = io.BytesIO()
        np.savez(buf, frames=frames, captions=np.array(["the cone"]))
        req = urllib.request.Request(f"http://127.0.0.1:{httpd.server_address[1]}/predict",
                                     data=buf.getvalue(),
                                     headers={"Content-Type": "application/npz"})
        with urllib.request.urlopen(req, timeout=120) as r:
            got = np.load(io.BytesIO(r.read()))["pred_frames"]
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
    np.testing.assert_array_equal(got, np.rint(want * 255).astype(np.uint8))
