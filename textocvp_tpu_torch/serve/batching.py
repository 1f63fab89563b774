"""Dynamic request batching for the port's serving layer (counterpart of
``textocvp_tpu/serve/batching.py``).

:class:`~textocvp_tpu_torch.serve.pipeline.PredictionService` runs batches of
``batch_size`` rows behind a dispatch lock, so N concurrent 1-video HTTP
requests would pay N full padded device batches. :class:`DynamicBatcher`
wraps a service: callers block in ``predict`` while dispatcher threads pack
queued requests into one shared batch (waiting at most ``max_wait_ms`` after
the first row arrives, or until ``batch_size`` rows are ready), run ONE
padded device batch, and hand each caller its row slice. Per-request
validation happens at enqueue time so one client's bad caption can never
fail a co-batched stranger's request.

Stochasticity: a ``LearnedRandom`` initializer draws one batch's slot noise
from the service's generator at a time, so a request's predictions depend on
its row position and co-batched neighbours, as the reference's
``LearnedRandom`` (initializers.py:87-94) resamples at every call.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Optional, Sequence

import numpy as np

from textocvp_tpu_torch.data.wire import as_float_video, to_uint8_frames


class _Pending:
    __slots__ = ("frames", "captions", "rows", "done", "result", "error")

    def __init__(self, frames: np.ndarray, captions: list):
        self.frames = frames
        self.captions = captions
        self.rows = frames.shape[0]
        self.done = threading.Event()
        self.result: Optional[np.ndarray] = None
        self.error: Optional[BaseException] = None


class DynamicBatcher:
    """Wrap a prediction service with request coalescing.

    Drop-in for the HTTP handler: exposes ``predict`` plus the service's
    contract attributes (batch_size, num_context, ...). ``predict`` is safe
    to call from many threads; each call blocks until its rows come back.
    """

    def __init__(self, service, max_wait_ms: float = 5.0, pipeline_depth: int = 2):
        """``pipeline_depth``: number of dispatcher threads. The service's
        dispatch lock covers the enqueue of a batch's work on the device, not
        the wait for its reply (pipeline.py predict), so with depth 2 one
        thread packs and dispatches batch N+1 while the other waits for batch
        N's bytes. Depth 1 dispatches strictly serially."""
        self.service = service
        self.max_wait = max(0.0, float(max_wait_ms)) / 1000.0
        self._queue: deque[_Pending] = deque()
        self._cv = threading.Condition()
        self._closed = False
        self._dispatches = 0  # device batches run (observability + tests)
        self._in_flight = 0  # batches currently on-device (packing policy)
        self._threads = [
            threading.Thread(target=self._run, daemon=True)
            for _ in range(max(1, int(pipeline_depth)))]
        for t in self._threads:
            t.start()

    def __getattr__(self, name):
        # contract attributes (batch_size, resolution, ...) and warmup pass
        # through to the wrapped service
        return getattr(self.service, name)

    def _validate(self, frames: np.ndarray, captions: Sequence[str]) -> np.ndarray:
        """Reject a bad request on the CALLER's thread, before it can join a
        shared batch. Mirrors InferenceFrontend.predict's checks and dry-runs
        tokenization (OOV / over-length captions)."""
        frames = np.asarray(frames)
        # coalesced rows must share the service's wire dtype (data/wire.py)
        if getattr(self.service, "wire_dtype", "float32") == "uint8":
            if frames.dtype != np.uint8:
                frames = to_uint8_frames(np.asarray(frames, np.float32))
        elif frames.dtype == np.uint8:
            frames = as_float_video(frames)
        b = frames.shape[0]
        if b < 1:
            raise ValueError("empty request: at least one video is required")
        if b > self.service.batch_size:
            raise ValueError(
                f"request batch {b} exceeds the service batch {self.service.batch_size}")
        if len(captions) != b:
            raise ValueError(f"{b} videos but {len(captions)} captions")
        if frames.shape[1] != self.service.num_context:
            raise ValueError(
                f"expected {self.service.num_context} context frames, "
                f"got {frames.shape[1]}")
        self.service._tokenize(list(captions))  # validation only
        return frames

    def predict(self, frames: np.ndarray, captions: Sequence[str]) -> np.ndarray:
        frames = self._validate(frames, captions)
        item = _Pending(frames, list(captions))
        with self._cv:
            if self._closed:
                raise RuntimeError("DynamicBatcher is closed")
            self._queue.append(item)
            self._cv.notify_all()
        item.done.wait()
        if item.error is not None:
            raise item.error
        return item.result

    def _take_batch(self) -> list:
        """Block until work exists, then collect up to batch_size rows,
        waiting at most max_wait after the first row arrived.

        Packing policy with pipelined dispatchers: a PARTIAL batch only
        dispatches when no other batch is on-device — greedy pipelining
        would split a filling batch in two and halve the device efficiency.
        While a batch is in flight the window stretches until it returns
        (the rows would have queued behind the device anyway); a FULL batch
        always dispatches immediately, overlapping with the in-flight one."""
        cap = self.service.batch_size
        with self._cv:
            while not self._queue and not self._closed:
                self._cv.wait()
            if self._closed and not self._queue:
                return []
            deadline = time.monotonic() + self.max_wait
            while True:
                rows = sum(i.rows for i in self._queue)
                if rows >= cap or self._closed:
                    break
                remaining = deadline - time.monotonic()
                if remaining <= 0 and self._in_flight == 0:
                    break
                # window expired but a batch is in flight: keep packing;
                # completion notifies the cv (the timeout is a backstop)
                self._cv.wait(timeout=remaining if remaining > 0 else 0.05)
            batch, total = [], 0
            while self._queue and total + self._queue[0].rows <= cap:
                item = self._queue.popleft()
                batch.append(item)
                total += item.rows
            # an oversized head can't happen (validated <= cap) unless items
            # behind it fill the batch first; the head then leads the next one
            if batch:
                self._in_flight += 1
            return batch

    def _run(self):
        while True:
            batch = self._take_batch()
            if not batch:
                with self._cv:
                    if self._closed and not self._queue:
                        return
                continue
            try:
                frames = np.concatenate([i.frames for i in batch], axis=0)
                captions = [c for i in batch for c in i.captions]
                out = self.service.predict(frames, captions)
                with self._cv:
                    self._dispatches += 1
                row = 0
                for i in batch:
                    i.result = out[row:row + i.rows]
                    row += i.rows
            except BaseException as e:  # surface to every caller in the batch
                for i in batch:
                    i.error = e
                if not isinstance(e, Exception):
                    raise  # interrupts and exits end the thread, after the callers are woken
            finally:
                with self._cv:
                    self._in_flight -= 1
                    self._cv.notify_all()  # packers waiting on the policy
                for i in batch:
                    i.done.set()

    def close(self):
        """Reject new requests, drain the queue, retire the threads."""
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        for t in self._threads:
            t.join()
