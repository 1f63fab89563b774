"""Minimal stdlib HTTP server around :class:`PredictionService`.

Requests are npz payloads over plain HTTP, which any client builds with numpy.

* ``GET /healthz``: JSON status and the request contract (batch_size,
  num_context, num_preds, resolution, max_tokens, wire_dtype, device).
* ``GET /stats``: JSON request, row and error counts and latency percentiles;
  with dynamic batching, ``batches_dispatched`` and ``mean_batch_fill``.
* ``POST /predict``: body an ``.npz`` with ``frames`` (B, num_context, H, W, 3)
  uint8 or float32 in [0, 1] and ``captions`` (B,) strings; reply an ``.npz``
  with ``pred_frames`` (B, num_preds, H, W, 3) uint8.

Client::

    import io, urllib.request, numpy as np
    buf = io.BytesIO()
    np.savez(buf, frames=frames, captions=np.array(captions))
    req = urllib.request.Request(url + "/predict", data=buf.getvalue(),
                                 headers={"Content-Type": "application/npz"})
    with urllib.request.urlopen(req) as r:
        out = np.load(io.BytesIO(r.read()))["pred_frames"]
"""

from __future__ import annotations

import io
import json
import logging
import threading
import time
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from textocvp_tpu_torch.serve.batching import DynamicBatcher

log = logging.getLogger(__name__)


class _Stats:
    """Thread-safe serving counters for GET /stats."""

    def __init__(self, window: int = 512):
        self._lock = threading.Lock()
        self.requests = 0
        self.rows = 0
        self.errors = 0
        self._lat = deque(maxlen=window)  # seconds, most recent requests

    def record(self, rows: int, seconds: float, error: bool):
        with self._lock:
            self.requests += 1
            if error:
                self.errors += 1
            else:
                self.rows += rows
                self._lat.append(seconds)

    def snapshot(self, service) -> dict:
        with self._lock:
            lat = sorted(self._lat)
            out = {"requests": self.requests, "rows": self.rows, "errors": self.errors}
        if lat:
            out["latency_ms_p50"] = 1000 * lat[len(lat) // 2]
            out["latency_ms_p95"] = 1000 * lat[min(len(lat) - 1, int(len(lat) * 0.95))]
        # the dynamic batcher's device batches and their mean fill (rows a
        # dispatch over the service batch)
        dispatches = getattr(service, "_dispatches", None)
        if dispatches is not None:
            out["batches_dispatched"] = dispatches
            if dispatches:
                out["mean_batch_fill"] = out["rows"] / (dispatches * service.batch_size)
        return out


def make_handler(service):
    stats = _Stats()

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):
            log.info("serve: %s %s", self.address_string(), fmt % args)

        def _reply(self, code: int, body: bytes, ctype: str):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _reply_json(self, code: int, obj: dict):
            self._reply(code, json.dumps(obj).encode(), "application/json")

        def do_GET(self):
            if self.path == "/stats":
                return self._reply_json(200, stats.snapshot(service))
            if self.path != "/healthz":
                return self._reply_json(404, {"error": "unknown path"})
            h, w = service.resolution
            return self._reply_json(200, {
                "status": "ok",
                "batch_size": service.batch_size,
                "num_context": service.num_context,
                "num_preds": service.num_preds,
                "resolution": [h, w],
                "max_tokens": service.max_tokens,
                "wire_dtype": service.wire_dtype,
                "device": str(service.device),
            })

        def do_POST(self):
            # drain the body first: replying without reading it would desync
            # HTTP/1.1 keep-alive
            length = int(self.headers.get("Content-Length", "0"))
            body = self.rfile.read(length) if length else b""
            if self.path != "/predict":
                return self._reply_json(404, {"error": "unknown path"})
            t0 = time.perf_counter()
            rows = 0
            try:
                payload = np.load(io.BytesIO(body), allow_pickle=False)
                frames = payload["frames"]
                captions = [str(c) for c in payload["captions"]]
                rows = int(frames.shape[0]) if frames.ndim else 0
                preds = service.predict(frames, captions)
                buf = io.BytesIO()
                np.savez(buf, pred_frames=np.rint(preds * 255).astype(np.uint8))
                stats.record(rows, time.perf_counter() - t0, error=False)
                return self._reply(200, buf.getvalue(), "application/npz")
            except (KeyError, ValueError) as e:
                stats.record(rows, time.perf_counter() - t0, error=True)
                return self._reply_json(400, {"error": str(e)})
            except Exception as e:  # noqa: BLE001 - the server keeps serving
                log.exception("serve: /predict failed")
                stats.record(rows, time.perf_counter() - t0, error=True)
                return self._reply_json(500, {"error": f"{type(e).__name__}: {e}"})

    return Handler


def serve(service, host: str = "127.0.0.1", port: int = 8000, warmup: bool = True,
          dynamic_batch_ms: Optional[float] = None,
          pipeline_depth: int = 2) -> ThreadingHTTPServer:
    """Create (and return) the HTTP server; the caller runs ``serve_forever()``.
    ``port=0`` binds a free port (``server_address[1]``).

    ``dynamic_batch_ms``: when set, concurrent requests coalesce into shared
    device batches (serve/batching.py); each dispatch waits at most this many
    ms to fill ``batch_size`` rows. Off (None): every request pays its own
    padded batch. ``pipeline_depth``: the batcher's dispatcher threads (2
    packs batch N+1 while N runs on the device; 1 dispatches serially). The
    server's ``batcher`` is the batcher, else None; ``close()`` it after
    ``shutdown()``."""
    if warmup:
        log.info("serve: warmup request")
        service.warmup()
    batcher = None
    if dynamic_batch_ms is not None:
        batcher = service = DynamicBatcher(service, max_wait_ms=dynamic_batch_ms,
                                           pipeline_depth=pipeline_depth)
        log.info("serve: dynamic batching on (window %s ms, pipeline depth %d)",
                 dynamic_batch_ms, pipeline_depth)
    httpd = ThreadingHTTPServer((host, port), make_handler(service))
    log.info("serve: listening on http://%s:%d (batch %d, %d seed -> %d predicted frames)",
             host, httpd.server_address[1], service.batch_size, service.num_context,
             service.num_preds)
    httpd.batcher = batcher
    return httpd
