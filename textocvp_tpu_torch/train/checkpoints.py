"""
Checkpoint I/O of the port (counterpart of the JAX package's
``textocvp_tpu/train/checkpoints.py``).

A training checkpoint is one ``torch.save`` file in the experiment's
``models/`` directory (``Experiment.checkpoint_path``) holding ``{"params":
<the model's state dict>, "opt_state": <Adam.state_dict()>, "epoch": E,
"step": S}``, written to a unique temporary file and moved into place with
``os.replace``. Names follow the JAX package's cadence, with ``.pt`` in place
of ``.msgpack``:

* ``checkpoint_last_saved.pt``   every epoch
* ``checkpoint_epoch_<E>.pt``    every ``save_frequency`` epochs
* ``checkpoint_epoch_final.pt``  at the end of training
* ``emergency_checkpoint_epoch_<E>.pt`` on an exception or an interrupt

Under ``tpu.async_checkpoint`` the trainers save through an
:class:`AsyncCheckpointWriter` (:func:`make_checkpoint_saver`): the loop
copies the state to the host and a writer thread writes it.

Readers of model weights (the 04 trainer's frozen decomposition model, the
03 and 05 evaluators, the service) go through :func:`load_params`, which takes
a training checkpoint or a bare state dict.

:func:`from_jax_checkpoint` reads a checkpoint of the JAX package (flax's
``msgpack_serialize`` of ``{params, batch_stats, opt_state, epoch, step}``)
with a small decoder of its own (:func:`msgpack_restore`), since the port
runs where neither ``msgpack`` nor flax is installed, and returns the port's
state dict of its model.
"""

from __future__ import annotations

import os
import pickle
import struct
from pathlib import Path

import numpy as np
import torch


def _to_cpu(obj, copy: bool = False):
    """Tensors of ``obj`` (nested dicts, lists, tuples) on the CPU; with
    ``copy`` each one a copy of its own, even where it is on the CPU already."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=copy)
    if isinstance(obj, dict):
        return {k: _to_cpu(v, copy) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v, copy) for v in obj)
    return obj


def save_checkpoint(path, state: dict) -> Path:
    """Write one checkpoint (tensors moved to the CPU) atomically; returns its path."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    # a unique temporary name: two savers must not truncate each other's file
    tmp = path.with_name(f"{path.name}.tmp.{os.getpid()}")
    torch.save(_to_cpu(state), tmp)
    os.replace(tmp, path)
    return path


class AsyncCheckpointWriter:
    """Checkpoints written on a thread of their own (``tpu.async_checkpoint``;
    the JAX package's ``train/checkpoints.py::AsyncCheckpointWriter``).

    :meth:`save` copies the state to the host before it returns (the next
    step updates the parameters in place), then the writer thread serializes
    it and moves it into place, in the order of the calls. A failed write is
    raised by the next :meth:`save` or by :meth:`wait`. The queue holds two
    states: when the disk is slower than the epochs, :meth:`save` waits."""

    def __init__(self):
        import queue
        import threading

        self._q = queue.Queue(maxsize=2)
        self._error = None
        self._closed = False
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="AsyncCheckpointWriter")
        self._thread.start()

    def _run(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            try:
                save_checkpoint(*item)
            except BaseException as e:  # raised by the next save() or wait()
                self._error = e
            finally:
                self._q.task_done()

    def _check(self):
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("async checkpoint write failed") from err

    def save(self, path, state: dict):
        if self._closed:
            raise RuntimeError("AsyncCheckpointWriter is closed")
        self._check()
        self._q.put((path, _to_cpu(state, copy=True)))

    def wait(self):
        """Block until every submitted checkpoint is on disk."""
        self._q.join()
        self._check()

    def close(self):
        """:meth:`wait`, then end the writer thread; later saves raise."""
        if self._closed:
            return
        try:
            self.wait()
        finally:
            self._closed = True
            self._q.put(None)
            self._thread.join()


def make_checkpoint_saver(exp_params: dict):
    """``(save, flush)`` under ``tpu.async_checkpoint``: ``save(path, state)``
    returns after the host copy when it is set (an
    :class:`AsyncCheckpointWriter` writes), after the write when it is not;
    ``flush()`` waits for every write and ends the writer, once, when
    training ends (the emergency path flushes, then writes with
    :func:`save_checkpoint`)."""
    if (exp_params.get("tpu") or {}).get("async_checkpoint"):
        writer = AsyncCheckpointWriter()
        return writer.save, writer.close
    return save_checkpoint, lambda: None


def load_checkpoint(path) -> dict:
    """Read a checkpoint onto the CPU; raises, naming the file, if it is
    missing or torch cannot read it."""
    path = Path(path)
    if not path.is_file():
        raise FileNotFoundError(f"Checkpoint {path} not found")
    try:
        return torch.load(path, map_location="cpu", weights_only=True)
    except (pickle.UnpicklingError, RuntimeError, EOFError) as e:
        raise ValueError(f"Checkpoint {path} is not a torch file of tensors: {e}") from e


def _is_state_dict(obj) -> bool:
    return (isinstance(obj, dict) and bool(obj)
            and all(isinstance(k, str) and isinstance(v, torch.Tensor) for k, v in obj.items()))


def load_params(path) -> dict:
    """A module's state dict from ``path``: ``state["params"]`` of a training
    checkpoint, or the file itself when it is a bare state dict. Raises,
    naming the file, when it is neither."""
    state = load_checkpoint(path)
    if isinstance(state, dict) and _is_state_dict(state.get("params")):
        return state["params"]
    if _is_state_dict(state):
        return state
    keys = list(state)[:8] if isinstance(state, dict) else type(state).__name__
    raise ValueError(f"Checkpoint {path} holds neither a training checkpoint "
                     f"({{'params': <state dict>, ...}}) nor a state dict: {keys}")



# ------------------------------------------------------- the JAX package's files

_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3  # flax's _MsgpackExtType


class _Reader:
    """A decoder of the msgpack format over one buffer: maps, arrays,
    strings, binaries, integers, floats, nil and booleans, and flax's ext
    types 1 (an ndarray as ``[shape, dtype name, bytes]``) and 3 (a numpy
    scalar, the same layout). Any other ext type raises."""

    def __init__(self, buf: bytes, what: str):
        self.buf, self.pos, self.what = memoryview(buf), 0, what

    def fail(self, msg):
        raise ValueError(f"{self.what}: {msg} at byte {self.pos}")

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            self.fail("truncated msgpack data")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self):
        b = self.unpack(">B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.str(b & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        sized = {0xC4: (">B", self.bin), 0xC5: (">H", self.bin), 0xC6: (">I", self.bin),
                 0xD9: (">B", self.str), 0xDA: (">H", self.str), 0xDB: (">I", self.str),
                 0xDC: (">H", self.array), 0xDD: (">I", self.array),
                 0xDE: (">H", self.map), 0xDF: (">I", self.map)}
        if b in sized:
            fmt, read = sized[b]
            return read(self.unpack(fmt))
        numbers = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                   0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in numbers:
            return self.unpack(numbers[b])
        exts = {0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}
        if b in exts:
            return self.ext(self.unpack(exts[b]))
        if 0xD4 <= b <= 0xD8:
            return self.ext(1 << (b - 0xD4))
        self.fail(f"unknown msgpack type byte 0x{b:02x}")

    def bin(self, n):
        return bytes(self.take(n))

    def str(self, n):
        return str(self.take(n), "utf-8")

    def array(self, n):
        return [self.value() for _ in range(n)]

    def map(self, n):
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out

    def ext(self, n):
        code = self.unpack(">b")
        data = bytes(self.take(n))
        if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            self.fail(f"msgpack ext type {code}, not an ndarray (1) or a numpy scalar (3)")
        shape, name, raw = _Reader(data, self.what).value()
        name = name.decode() if isinstance(name, bytes) else name
        try:
            dtype = np.dtype(name)
        except TypeError:
            dtype = None
        # numpy's own kinds only: bfloat16 and the like need ml_dtypes
        if dtype is None or dtype.kind not in "biufc" or dtype.type.__module__ != "numpy":
            self.fail(f"an array of dtype {name!r}, not one of numpy's own")
        arr = np.frombuffer(raw, dtype=dtype).reshape(shape).copy()  # writable, for torch
        return arr[()] if code == _EXT_NPSCALAR else arr


def msgpack_restore(data: bytes, what: str = "msgpack data"):
    """The tree that flax's ``msgpack_serialize`` wrote into ``data``, as
    ``flax.serialization.msgpack_restore`` returns it (ndarray leaves, here
    copies that torch can take). A chunked array (a leaf over 1 GiB) raises; ``what``
    names the source in every error."""
    reader = _Reader(data, what)
    tree = reader.value()
    if reader.pos != len(data):
        reader.fail(f"{len(data) - reader.pos} bytes after the msgpack value")

    def check(node):
        if isinstance(node, dict):
            if "__msgpack_chunked_array__" in node:
                raise ValueError(f"{what}: a chunked array (a leaf over 1 GiB), which this "
                                 "reader does not join")
            for v in node.values():
                check(v)

    check(tree)
    return tree


def from_jax_checkpoint(path, kind: str) -> dict:
    """The port's state dict of the model in a JAX package checkpoint: its
    ``params`` (and ``batch_stats``) through ``convert.from_jax_params(kind,
    ...)``, ``kind`` "savi", "dinosaur" or "predictor"."""
    from textocvp_tpu_torch.convert import from_jax_params

    path = Path(path)
    if not path.is_file():
        raise FileNotFoundError(f"Checkpoint {path} not found")
    state = msgpack_restore(path.read_bytes(), what=f"Checkpoint {path}")
    if not isinstance(state, dict) or not isinstance(state.get("params"), dict):
        raise ValueError(f"Checkpoint {path} holds no 'params' tree")
    return from_jax_params(kind, state["params"], batch_stats=state.get("batch_stats") or None)
