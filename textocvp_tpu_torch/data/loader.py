"""
Host input pipeline of the port: the dataset factory and a batching loader
(counterpart of ``textocvp_tpu/data/loader.py``, CATER only).

The loader is ``torch.utils.data.DataLoader`` with a ``collate_fn`` that
keeps the JAX package's batch contract: ``(videos, info)`` with videos
(B, T, H, W, C) as a numpy array (uint8 under the ``uint8_wire`` knob, else
float32) and ``info = {caption, caption_tokens, caption_lengths,
attn_masks}`` from the dataset's tokenizer, in order, the last batch ragged
(a single-process loader: the memory-mapped ``.npy`` route needs no decode
workers).
"""

from __future__ import annotations

import numpy as np
from torch.utils.data import DataLoader

from textocvp_tpu_torch.data.datasets import CATER
from textocvp_tpu_torch.data.tokenizers import get_tokenizer

DATASETS = ["CATER_Easy", "CATER_Hard"]


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
    dataset = CATER(split=split, mode="easy" if db_name == "CATER_Easy" else "hard", **db_params)
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


def make_loader(dataset, batch_size: int) -> DataLoader:
    """Batches of ``(videos, info)`` in the JAX package's collate contract."""
    return DataLoader(dataset, batch_size=batch_size, shuffle=False,
                      collate_fn=Collate(getattr(dataset, "tokenizer", None)))
