"""
Host input pipeline of the port: the dataset factory and a batching loader
(counterpart of ``textocvp_tpu/data/loader.py``): CATER_Easy, CATER_Hard and
CLIPort (``data/datasets.py``: frame directories, PNG episodes, arrays and
caches), and the procedural Synthetic set (``data/synthetic.py``).

:class:`EpochLoader` keeps the JAX package's batch contract: ``(videos,
info)`` with videos (B, T, H, W, C) as a numpy array (uint8 under the
``uint8_wire`` knob, else float32) and ``info = {caption, caption_tokens,
caption_lengths, attn_masks}`` from the dataset's tokenizer; and the JAX
``DataLoader``'s order: in order, or shuffled by
``numpy.random.default_rng(seed + epoch)``, the last batch ragged unless
``drop_last``, the epoch handed to the dataset (``set_epoch``) before any
item is fetched.

Several processes (the mesh's data axis, ``parallel/distributed.py::
loader_process_kwargs``): with ``process_count > 1`` each process loads its
contiguous rows of every global batch (``batch_size`` stays the global batch
and must divide over the processes), in the one shuffle order every process
draws; a ragged global batch is padded globally to ``pad_to_multiple`` by
repeating its last row, so that every process gets as many equal batches,
and ``info["num_valid"]`` says how many rows of the global batch are real.
The JAX ``DataLoader``'s ``process_index`` / ``process_count`` semantics.
With ``accum`` > 1 (a training loader under ``training.accum_steps``) a
process's rows are its share of each of the global batch's microbatches
instead (:func:`microbatch_rows`), in microbatch order, so that microbatch i
of every process together is the JAX step's microbatch i.

Items are fetched on ``num_workers`` threads (the decode and resize run in
C++ with the GIL released), and a producer thread keeps up to
:data:`PREFETCH` batches ready. ``num_workers`` 0 fetches in the calling
thread. The batches and their order are the same for
any worker count, and a worker's exception is raised in the consumer.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np

from textocvp_tpu_torch.core.config import CONFIG
from textocvp_tpu_torch.data.datasets import CATER, CLIPort
from textocvp_tpu_torch.data.synthetic import SyntheticBalls
from textocvp_tpu_torch.data.tokenizers import get_tokenizer

DATASETS = ["CATER_Easy", "CATER_Hard", "CLIPort", "Synthetic"]
PREFETCH = 2  # batches a producer keeps ready, as the JAX DataLoader's default


def ragged_accum(n: int, accum: int, batch_size: int) -> int:
    """Microbatches for a batch of ``n`` sequences: ``accum`` when it divides
    ``n``, else the fewest equal microbatches no larger than the configured
    ``batch_size // accum``."""
    if n % accum == 0:
        return accum
    mb = max(1, batch_size // accum)
    return min(d for d in range(1, n + 1) if n % d == 0 and n // d <= mb)


def microbatch_rows(n: int, accum: int, batch_size: int, data: int = 1,
                    index: int = 0) -> tuple:
    """``(a, rows)``: the microbatches of a (padded) global batch of ``n``
    rows, ``a = ragged_accum(n, accum, batch_size)`` of ``n // a`` consecutive
    rows each as the JAX step reshapes the batch to ``(a, n // a)``, and data
    index ``index``'s rows of them: its ``1 / data`` of each microbatch, the
    microbatches in order. A microbatch that the data axis does not divide (a
    ragged batch's) is every data index's whole, the JAX step's replicated
    microbatch: the data group's sums then see ``data`` equal copies of it,
    which changes no mean. At ``accum`` 1 the rows are the contiguous
    ``n // data`` of the process split."""
    a = ragged_accum(n, accum, batch_size)
    mb = n // a
    if mb % data:
        return a, np.arange(n)
    share = mb // data
    return a, (np.arange(a)[:, None] * mb + index * share + np.arange(share)).reshape(-1)


def load_data(exp_params: dict, split: str = "train"):
    """The dataset of ``exp_params["dataset"]`` with its tokenizer attached."""
    db_params = dict(exp_params["dataset"])
    db_name = db_params.pop("dataset_name")
    if db_name not in DATASETS:
        raise NotImplementedError(f"Dataset {db_name!r} is not ported; the port reads {DATASETS}")
    tokenizer_name = db_params.pop("tokenizer", "T5")
    # uint8 on the wire: items stay uint8 and are normalized on the device
    uint8_wire = bool(db_params.pop("uint8_wire", False))
    db_params.setdefault("uint8_output", uint8_wire)
    if db_name == "CLIPort":
        dataset = CLIPort(split=split, **db_params)
    elif db_name == "Synthetic":
        n = db_params.pop("num_train_seqs", 64) if split == "train" \
            else db_params.pop("num_eval_seqs", 16)
        for key in ("num_train_seqs", "num_eval_seqs", "root"):
            db_params.pop(key, None)
        dataset = SyntheticBalls(split=split, num_seqs=n, **db_params)
    else:
        dataset = CATER(split=split, mode="easy" if db_name == "CATER_Easy" else "hard",
                        **db_params)
    dataset.tokenizer = get_tokenizer(tokenizer_name, vocabulary=dataset.vocabulary)
    return dataset


class Collate:
    """Stack the items' frames and tokenize their captions."""

    def __init__(self, tokenizer=None):
        self.tokenizer = tokenizer

    def __call__(self, items, num_valid: Optional[int] = None):
        videos = np.stack([it[0] for it in items], axis=0)
        if videos.dtype != np.uint8:
            videos = videos.astype(np.float32)
        captions = [it[1] for it in items]
        info = {"caption": captions}
        if self.tokenizer is not None:
            info.update(self.tokenizer(captions))
        if num_valid is not None:
            info["num_valid"] = num_valid
        return videos, info


class EpochLoader:
    """Batches of ``(videos, info)`` in the JAX package's ``DataLoader`` order.

    Each iteration is one epoch: it first hands the dataset its epoch
    (``set_epoch``, the random clip starts), then walks ``0..len-1``,
    shuffled by ``np.random.default_rng(seed + epoch)`` when ``shuffle``, in
    batches of ``batch_size`` (the last one ragged unless ``drop_last``).
    ``num_workers`` (default ``CONFIG["num_workers"]``) threads fetch the
    items, :data:`PREFETCH` batches ahead. ``process_index`` /
    ``process_count`` / ``pad_to_multiple`` / ``accum``: this process's rows
    of each global batch, as the module docstring says."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 drop_last: bool = False, seed: int = 14, num_workers: Optional[int] = None,
                 process_index: int = 0, process_count: int = 1,
                 pad_to_multiple: Optional[int] = None, accum: int = 1):
        if not 0 <= process_index < process_count:
            raise ValueError(f"process_index {process_index} outside [0, {process_count})")
        if process_count > 1 and batch_size % process_count:
            raise ValueError(f"global batch_size {batch_size} must divide evenly over "
                             f"{process_count} processes")
        if process_count > 1 and pad_to_multiple is None:
            pad_to_multiple = process_count
        if pad_to_multiple is not None and pad_to_multiple % process_count:
            raise ValueError(f"pad_to_multiple {pad_to_multiple} must be a multiple of "
                             f"process_count {process_count}")
        self.process_index, self.process_count = process_index, process_count
        self.pad_to_multiple = pad_to_multiple
        self.accum = accum
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.epoch = 0
        self.num_workers = CONFIG["num_workers"] if num_workers is None else int(num_workers)
        self.collate = Collate(getattr(dataset, "tokenizer", None))

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def batch_indices(self, epoch: int) -> list:
        """This process's item indices of each batch of ``epoch``."""
        return [idxs for idxs, _ in self.batches(epoch)]

    def batches(self, epoch: int) -> list:
        """(this process's item indices, the global batch's real rows) of
        each batch of ``epoch``."""
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + epoch).shuffle(order)
        batches = [order[i:i + self.batch_size] for i in range(0, len(order), self.batch_size)]
        if self.drop_last and batches and len(batches[-1]) < self.batch_size:
            batches.pop()
        out = []
        for b in batches:
            valid, m = len(b), self.pad_to_multiple
            if m is not None and valid % m:
                b = np.concatenate([b, np.full(-(-valid // m) * m - valid, b[-1])])
            if self.process_count > 1:  # padding at the global tail: the last process's
                b = b[microbatch_rows(len(b), self.accum, self.batch_size, self.process_count,
                                      self.process_index)[1]]
            out.append((b, valid))
        return out

    def __iter__(self):
        epoch = self.epoch
        set_epoch = getattr(self.dataset, "set_epoch", None)
        if set_epoch is not None:  # before any item is fetched, and before workers start
            set_epoch(epoch)
        self.epoch += 1
        valid = self.pad_to_multiple is not None
        batches = [(idxs, n if valid else None) for idxs, n in self.batches(epoch)]
        if self.num_workers <= 0:
            for idxs, n in batches:
                yield self.collate([self.dataset[int(i)] for i in idxs], n)
            return
        yield from self._prefetched(batches)

    def _prefetched(self, batches):
        """The batches from a producer thread that keeps :data:`PREFETCH` ready;
        the producer stops when the consumer stops early."""
        q: queue.Queue = queue.Queue(maxsize=PREFETCH)
        stop = threading.Event()
        done = object()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    pass
            return False

        def producer():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for idxs, n in batches:
                        if stop.is_set():
                            return
                        items = list(pool.map(self.dataset.__getitem__, [int(i) for i in idxs]))
                        if not put(self.collate(items, n)):
                            return
            except BaseException as e:  # raised again in the consumer
                put(e)
            finally:
                put(done)

        thread = threading.Thread(target=producer, daemon=True, name="EpochLoader")
        thread.start()
        try:
            while True:
                item = q.get()
                if item is done:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            thread.join()

