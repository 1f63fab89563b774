"""
Host input pipeline of the port: the dataset factory and a batching loader
(counterpart of ``textocvp_tpu/data/loader.py``): CATER_Easy, CATER_Hard and
CLIPort from their pre-decoded arrays (``data/datasets.py``), and the
procedural Synthetic set (``data/synthetic.py``).

:class:`EpochLoader` keeps the JAX package's batch contract: ``(videos,
info)`` with videos (B, T, H, W, C) as a numpy array (uint8 under the
``uint8_wire`` knob, else float32) and ``info = {caption, caption_tokens,
caption_lengths, attn_masks}`` from the dataset's tokenizer; and the JAX
``DataLoader``'s order: in order, or shuffled by
``numpy.random.default_rng(seed + epoch)``, the last batch ragged unless
``drop_last``, the epoch handed to the dataset (``set_epoch``) first. It
runs in the calling thread: the memory-mapped ``.npy`` route needs no decode
workers.
"""

from __future__ import annotations

import numpy as np

from textocvp_tpu_torch.data.datasets import CATER, CLIPort
from textocvp_tpu_torch.data.synthetic import SyntheticBalls
from textocvp_tpu_torch.data.tokenizers import get_tokenizer

DATASETS = ["CATER_Easy", "CATER_Hard", "CLIPort", "Synthetic"]


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
    batches of ``batch_size`` (the last one ragged unless ``drop_last``)."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 drop_last: bool = False, seed: int = 14):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.epoch = 0
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
        if set_epoch is not None:
            set_epoch(epoch)
        self.epoch += 1
        for idxs in self.batch_indices(epoch):
            yield self.collate([self.dataset[int(i)] for i in idxs])
