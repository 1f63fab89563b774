"""Dynamic request batching of the port (``serve/batching.py::DynamicBatcher``,
``serve(..., dynamic_batch_ms=...)``) on a tiny CPU service, the port's
versions of ``tests/test_serve.py``'s batcher tests, and the service's
fetch outside its dispatch lock.

The service is a tiny SAVi (``LearnedRandom`` slots, so every batch draws
from the service's generator) + TextOCVP_T5 with random weights. A batch's
output depends on the generator's state, so each comparison with a direct
``predict`` sets the generator to the same state first; then the outputs
are equal bit for bit (the same padded rows, the same noise, the same
device).
"""

import io
import json
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch
from test_torch_port_service import MAX_TOKENS, NUM_PREDS, RES, _tiny_params

from textocvp_tpu_torch.cli.serve import serve_args
from textocvp_tpu_torch.core.experiment import Experiment
from textocvp_tpu_torch.models import setup_model, setup_predictor
from textocvp_tpu_torch.models.factory import random_init_
from textocvp_tpu_torch.serve import DynamicBatcher, PredictionService, serve

BATCH = 4
CAPTIONS = ["the cone is sliding to (1, -2)", "the snitch is picked up and placed",
            "the cone is rotating", "the snitch is containing the cone"]


@pytest.fixture(scope="module")
def exp_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("port_batching") / "exp"
    params, pred_params = _tiny_params("SAVi")
    for p in (params, pred_params):
        p["model"]["model_params"]["initializer"] = "LearnedRandom"
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


@pytest.fixture(scope="module")
def service(exp_dir):
    return PredictionService(exp_dir, "tiny_t5", "ckpt", "ckpt", batch_size=BATCH,
                             max_tokens=MAX_TOKENS, device="cpu",
                             generator=torch.Generator().manual_seed(9))


def _frames(seed, rows):
    return np.random.default_rng(seed).random((rows, 1, RES, RES, 3), np.float32)


def test_dynamic_batcher_coalesces_and_matches(service):
    """Two concurrent 1-row requests share ONE device batch and return exactly
    what a direct 2-row predict at the same generator state returns."""
    frames = _frames(11, 2)
    state = service.generator.get_state()
    ref = service.predict(frames, CAPTIONS[:2])
    # the slot noise moves on with the generator: another state, another output
    assert not np.array_equal(service.predict(frames, CAPTIONS[:2]), ref)

    batcher = DynamicBatcher(service, max_wait_ms=1000.0)
    try:
        service.generator.set_state(state)
        results = {}

        def call(i):
            results[i] = batcher.predict(frames[i:i + 1], [CAPTIONS[i]])

        t0 = threading.Thread(target=call, args=(0,))
        t0.start()
        time.sleep(0.05)  # deterministic row order: request 0 enqueues first
        t1 = threading.Thread(target=call, args=(1,))
        t1.start()
        t0.join(timeout=60)
        t1.join(timeout=60)
        assert set(results) == {0, 1}
        assert batcher._dispatches == 1  # coalesced, not two padded batches
        np.testing.assert_array_equal(results[0][0], ref[0])
        np.testing.assert_array_equal(results[1][0], ref[1])
    finally:
        batcher.close()


def test_dynamic_batcher_partial_batch_dispatches_after_window(service):
    """A lone request does not wait for the batch to fill: the window expires
    and it runs padded, exactly like the unbatched service."""
    frames = _frames(12, 1)
    state = service.generator.get_state()
    ref = service.predict(frames, CAPTIONS[:1])
    batcher = DynamicBatcher(service, max_wait_ms=20.0)
    try:
        service.generator.set_state(state)
        t = time.perf_counter()
        out = batcher.predict(frames, CAPTIONS[:1])
        assert time.perf_counter() - t < 30
        np.testing.assert_array_equal(out, ref)
        assert batcher._dispatches == 1
    finally:
        batcher.close()


def test_dynamic_batcher_rejects_bad_requests_individually(service):
    """Validation runs on the caller's thread BEFORE joining a shared batch:
    an over-long caption, a wrong caption count, an empty request, too many
    rows or context frames raise for that caller only and never reach the
    device."""
    batcher = DynamicBatcher(service, max_wait_ms=20.0)
    try:
        frames = _frames(13, 1)
        cases = [((frames, ["the cone " * 12]), "caption too long"),
                 ((frames, ["a", "b"]), "captions"),
                 ((frames[:0], []), "empty request"),
                 ((_frames(13, BATCH + 1), CAPTIONS + CAPTIONS[:1]), "exceeds"),
                 ((np.repeat(frames, 2, axis=1), CAPTIONS[:1]), "context frames")]
        for args, match in cases:
            with pytest.raises(ValueError, match=match):
                batcher.predict(*args)
        assert batcher._dispatches == 0  # nothing dispatched
        out = batcher.predict(frames, CAPTIONS[:1])  # a good request still works
        assert out.shape == (1, NUM_PREDS, RES, RES, 3) and batcher._dispatches == 1
        # uint8 requests coalesce as the service's float32 wire
        out8 = batcher.predict(np.round(frames * 255).astype(np.uint8), CAPTIONS[:1])
        assert out8.dtype == np.float32 and out8.shape == out.shape
    finally:
        batcher.close()
    with pytest.raises(RuntimeError, match="closed"):
        batcher.predict(frames, CAPTIONS[:1])


def test_dynamic_batcher_pipelines_dispatch():
    """pipeline_depth=2 overlaps batch N+1's dispatch with batch N's wait:
    two single-row requests against a service whose predict blocks 200 ms
    complete in well under 2 x 200 ms, while depth=1 serializes them. A stub
    service keeps the timing deterministic on the CPU."""

    class StubService:
        batch_size = 1  # every request is its own device batch
        num_context = 1
        num_preds = 2

        def _tokenize(self, captions):
            return {}

        def predict(self, frames, captions):
            time.sleep(0.2)  # stands in for the device round trip
            return np.repeat(frames, self.num_preds, axis=1)

    def run(depth):
        batcher = DynamicBatcher(StubService(), max_wait_ms=1.0, pipeline_depth=depth)
        frames = np.zeros((1, 1, 4, 4, 3), np.float32)
        try:
            batcher.predict(frames, ["warm"])  # threads up and idle
            outs = {}

            def call(i):
                outs[i] = batcher.predict(frames + i, [f"c{i}"])

            threads = [threading.Thread(target=call, args=(i,)) for i in range(2)]
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=30)
            dt = time.perf_counter() - t0
            assert batcher._dispatches == 3  # batch_size=1: no coalescing
            for i in range(2):
                np.testing.assert_allclose(outs[i][0, 0], i)
            return dt
        finally:
            batcher.close()

    serial, pipelined = run(1), run(2)
    assert serial > 0.35  # two 200 ms dispatches back to back
    assert pipelined < 0.35  # overlapped: about max(200, 200) + overhead


def test_dynamic_batcher_under_many_threads_returns_each_caller_its_rows():
    """Stress: 48 callers of 1-3 rows on a stub service of batch 4 with two
    dispatchers, the interpreter switching threads every microsecond: every
    caller gets its own rows back, every row is dispatched once, and no batch
    is left in flight."""
    import sys

    class StubService:
        batch_size, num_context, num_preds = 4, 1, 1

        def _tokenize(self, captions):
            return {}

        def predict(self, frames, captions):
            assert len(frames) <= self.batch_size
            time.sleep(0.001)
            return frames + 1.0

    service = StubService()
    batcher = DynamicBatcher(service, max_wait_ms=2.0, pipeline_depth=2)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        outs, rows = {}, {}

        def call(i):
            rows[i] = 1 + i % 3
            frames = np.full((rows[i], 1, 2, 2, 3), float(i), np.float32)
            outs[i] = batcher.predict(frames, ["c"] * rows[i])

        threads = [threading.Thread(target=call, args=(i,)) for i in range(48)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
        batcher.close()
    assert sorted(outs) == list(range(48))
    for i, out in outs.items():
        assert out.shape == (rows[i], 1, 2, 2, 3)
        np.testing.assert_array_equal(out, float(i) + 1.0)
    assert batcher._in_flight == 0 and batcher._dispatches >= sum(rows.values()) / 4


def test_dynamic_batcher_pipelined_matches_service(service):
    """Through the real service at pipeline_depth=2: two requests one after
    the other dispatch as two batches whose results equal direct predicts
    from the same generator state."""
    frames = _frames(21, 2)
    state = service.generator.get_state()
    ref0 = service.predict(frames[:1], CAPTIONS[:1])
    ref1 = service.predict(frames[1:], CAPTIONS[1:2])
    batcher = DynamicBatcher(service, max_wait_ms=1.0, pipeline_depth=2)
    try:
        service.generator.set_state(state)
        np.testing.assert_array_equal(batcher.predict(frames[:1], CAPTIONS[:1]), ref0)
        np.testing.assert_array_equal(batcher.predict(frames[1:], CAPTIONS[1:2]), ref1)
        assert batcher._dispatches == 2 and batcher._in_flight == 0
    finally:
        batcher.close()
    assert not any(t.is_alive() for t in batcher._threads)


def test_http_server_dynamic_batching(service):
    """serve(dynamic_batch_ms=...) end to end: concurrent HTTP clients get
    their rows from shared device batches, and /stats counts the batches and
    their fill."""
    httpd = serve(service, port=0, warmup=False, dynamic_batch_ms=300.0, pipeline_depth=1)
    assert isinstance(httpd.batcher, DynamicBatcher)
    port = httpd.server_address[1]
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        def post(i, out):
            buf = io.BytesIO()
            np.savez(buf, frames=np.full((1, 1, RES, RES, 3), i * 0.25, np.float32),
                     captions=np.array([CAPTIONS[i]]))
            req = urllib.request.Request(f"http://127.0.0.1:{port}/predict",
                                         data=buf.getvalue(),
                                         headers={"Content-Type": "application/npz"})
            with urllib.request.urlopen(req, timeout=120) as r:
                out[i] = np.load(io.BytesIO(r.read()))["pred_frames"]

        outs = {}
        threads = [threading.Thread(target=post, args=(i, outs)) for i in range(BATCH)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
        assert set(outs) == set(range(BATCH))
        for i in range(BATCH):
            assert outs[i].shape == (1, NUM_PREDS, RES, RES, 3) and outs[i].dtype == np.uint8
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/stats", timeout=30) as r:
            stats = json.loads(r.read())
        assert stats["requests"] == stats["rows"] == BATCH and stats["errors"] == 0
        assert 1 <= stats["batches_dispatched"] < BATCH  # coalesced
        assert stats["mean_batch_fill"] == BATCH / (stats["batches_dispatched"] * BATCH)
        assert stats["latency_ms_p50"] > 0 and stats["latency_ms_p95"] >= stats["latency_ms_p50"]
    finally:
        httpd.shutdown()
        httpd.server_close()
        httpd.batcher.close()
        thread.join(timeout=30)
    assert not thread.is_alive()


def test_stats_without_a_batcher_have_no_batch_counters(service):
    httpd = serve(service, port=0, warmup=False)
    assert httpd.batcher is None
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{httpd.server_address[1]}/stats",
                                    timeout=30) as r:
            stats = json.loads(r.read())
        assert stats == {"requests": 0, "rows": 0, "errors": 0}
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)


def test_predict_is_unchanged_by_the_fetch_outside_the_lock(service):
    """predict() equals the two stages run and fetched directly, bit for bit,
    at the same generator state; on the CPU the fetch is the tensor itself."""
    frames = _frames(31, 3)
    captions = CAPTIONS[:3]
    state = service.generator.get_state()
    out = service.predict(frames, captions)
    service.generator.set_state(state)
    padded = np.concatenate([frames, frames[-1:]], axis=0)
    imgs = service._decode_stage(service._predict_stage(padded, service._tokenize(
        captions + captions[-1:])))
    np.testing.assert_array_equal(out, imgs.cpu().numpy()[:3].astype(np.float32) / 255.0)
    host, done = service._start_fetch(imgs)
    assert host is imgs and done is None


def test_serve_cli_batching_flags():
    base = ["-d", "/tmp/x", "--name_pred_exp", "p", "--decomp_ckpt", "c", "--pred_ckpt", "c"]
    args = serve_args(base)
    assert args.dynamic_batch_ms is None and args.pipeline_depth == 2
    args = serve_args(base + ["--dynamic_batch_ms", "20", "--pipeline_depth", "1"])
    assert args.dynamic_batch_ms == 20.0 and args.pipeline_depth == 1
