"""
Host-side caption tokenization, the same ids as the JAX package's tokenizers.

* ``CustomTokenizer``: word-level over a fixed vocabulary with
  [CLS]/[SEP]/[PAD] specials.
* ``T5TokenizerWrapper``: HuggingFace's T5 SentencePiece tokenizer, used only
  when its files are on the machine (nothing is downloaded). Otherwise
  ``get_tokenizer("T5")`` falls back to ``HashFallbackT5Tokenizer``, which
  gives valid T5-range ids that do NOT match the real vocabulary; results
  made with it carry ``tokenizer_fallback: true``.
"""

from __future__ import annotations

import hashlib
import os
import re
import warnings
from typing import Optional

import numpy as np
import torch

# what a tokenizer returns besides the captions; a key whose value is None
# (a CustomTokenizer's attn_masks) is left out of what a predictor gets
TEXT_KEYS = ("caption_tokens", "caption_lengths", "attn_masks")

_WORD_RE = re.compile(r"-?\d+|[A-Za-z_]+|[^\w\s]")


def word_tokenize(text: str) -> list[str]:
    return _WORD_RE.findall(text)


class CustomTokenizer:
    """Fixed-vocabulary word tokenizer with batch padding."""

    is_fallback = False

    def __init__(self, vocabulary: dict[str, int]):
        if "[PAD]" not in vocabulary:
            raise ValueError("Vocabulary must contain '[PAD]' token")
        self.vocabulary = vocabulary
        self.padding_idx = vocabulary["[PAD]"]

    def tokenize(self, caption: str) -> np.ndarray:
        ids = [self.vocabulary["[CLS]"]]
        ids += [self.vocabulary[w] for w in word_tokenize(caption)]
        ids.append(self.vocabulary["[SEP]"])
        return np.asarray(ids, dtype=np.int32)

    def __call__(self, captions: list[str]):
        toks = [self.tokenize(c) for c in captions]
        lengths = np.asarray([len(t) for t in toks], dtype=np.int32)
        out = np.full((len(captions), lengths.max()), self.padding_idx, dtype=np.int32)
        for i, t in enumerate(toks):
            out[i, : len(t)] = t
        return {"caption_tokens": out, "caption_lengths": lengths, "attn_masks": None}


class HashFallbackT5Tokenizer:
    """Each word maps to a stable id in [1000, 31000) from its md5; EOS (1) is
    appended, padding is 0, and attention masks mark the real tokens."""

    is_fallback = True
    eos_id = 1
    pad_id = 0

    def _word_id(self, word: str) -> int:
        h = int(hashlib.md5(word.lower().encode()).hexdigest(), 16)
        return 1000 + (h % 30000)

    def __call__(self, captions: list[str]):
        seqs = [[self._word_id(w) for w in word_tokenize(c)] + [self.eos_id]
                for c in captions]
        max_len = max(len(s) for s in seqs)
        tokens = np.full((len(seqs), max_len), self.pad_id, dtype=np.int32)
        masks = np.zeros((len(seqs), max_len), dtype=np.int32)
        for i, s in enumerate(seqs):
            tokens[i, : len(s)] = s
            masks[i, : len(s)] = 1
        lengths = np.full((len(seqs),), max_len, dtype=np.int32)
        return {"caption_tokens": tokens, "caption_lengths": lengths, "attn_masks": masks}


class T5TokenizerWrapper:
    """HuggingFace T5 tokenizer from local files: padded ids + attention masks."""

    is_fallback = False

    def __init__(self, model_name: str = "t5-small"):
        # never reach for the hub: the files are on the machine or absent
        os.environ.setdefault("HF_HUB_OFFLINE", "1")
        os.environ.setdefault("TRANSFORMERS_OFFLINE", "1")
        from transformers import T5Tokenizer

        self.tok = T5Tokenizer.from_pretrained(model_name, local_files_only=True)

    def __call__(self, captions: list[str]):
        out = self.tok(captions, padding=True, return_tensors="np")
        tokens = out["input_ids"].astype(np.int32)
        masks = out["attention_mask"].astype(np.int32)
        lengths = np.full((tokens.shape[0],), tokens.shape[1], dtype=np.int32)
        return {"caption_tokens": tokens, "caption_lengths": lengths, "attn_masks": masks}


def get_tokenizer(name: str, vocabulary: Optional[dict] = None):
    """'T5' (real vocabulary when present, else the hash fallback) or
    'CustomTokenizer' (needs ``vocabulary``)."""
    if name == "CustomTokenizer":
        if vocabulary is None:
            raise ValueError("CustomTokenizer requires a vocabulary")
        return CustomTokenizer(vocabulary)
    if name == "T5":
        try:
            return T5TokenizerWrapper()
        except (ImportError, OSError, ValueError):
            warnings.warn(
                "T5 SentencePiece vocab unavailable offline: using the "
                "deterministic HASH tokenizer. Token ids do not match the real "
                "T5 vocabulary; results carry 'tokenizer_fallback': true.",
                stacklevel=2,
            )
            return HashFallbackT5Tokenizer()
    raise NameError(f"Unknown tokenizer {name!r}. Use 'T5'|'CustomTokenizer'")


def text_tensors(info: dict, device) -> dict:
    """The tokenizer's arrays in ``info`` as tensors on ``device``: each key of
    TEXT_KEYS whose value is not None (the JAX package's ``_text_kwargs``)."""
    return {k: torch.as_tensor(np.asarray(info[k])).to(device) for k in TEXT_KEYS
            if info.get(k) is not None}
