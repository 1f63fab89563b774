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

    def __call__(self, items):
        videos = np.stack([it[0] for it in items], axis=0)
        if videos.dtype != np.uint8:
            videos = videos.astype(np.float32)
        captions = [it[1] for it in items]
        info = {"caption": captions}
        if self.tokenizer is not None:
            info.update(self.tokenizer(captions))
        return videos, info


class EpochLoader:
    """Batches of ``(videos, info)`` in the JAX package's ``DataLoader`` order.

    Each iteration is one epoch: it first hands the dataset its epoch
    (``set_epoch``, the random clip starts), then walks ``0..len-1``,
    shuffled by ``np.random.default_rng(seed + epoch)`` when ``shuffle``, in
    batches of ``batch_size`` (the last one ragged unless ``drop_last``).
    ``num_workers`` (default ``CONFIG["num_workers"]``) threads fetch the
    items, :data:`PREFETCH` batches ahead."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 drop_last: bool = False, seed: int = 14, num_workers: Optional[int] = None):
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
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + epoch).shuffle(order)
        batches = [order[i:i + self.batch_size] for i in range(0, len(order), self.batch_size)]
        if self.drop_last and batches and len(batches[-1]) < self.batch_size:
            batches.pop()
        return batches

    def __iter__(self):
        epoch = self.epoch
        set_epoch = getattr(self.dataset, "set_epoch", None)
        if set_epoch is not None:  # before any item is fetched, and before workers start
            set_epoch(epoch)
        self.epoch += 1
        batches = self.batch_indices(epoch)
        if self.num_workers <= 0:
            for idxs in batches:
                yield self.collate([self.dataset[int(i)] for i in idxs])
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
                    for idxs in batches:
                        if stop.is_set():
                            return
                        items = list(pool.map(self.dataset.__getitem__, [int(i) for i in idxs]))
                        if not put(self.collate(items)):
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

