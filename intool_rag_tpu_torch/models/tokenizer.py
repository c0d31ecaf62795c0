"""Hashing tokenizer for the encoder path (port of ``SimpleTokenizer`` in
``intool_rag_tpu/models/tokenizer.py``; the HF tokenizer waits).

ids: 0 = CLS, 1 = PAD, 2 = SEP, 3 = UNK; words from the BM25 analyzer hash
(md5, stable across processes) into [4, vocab_size).
"""

from __future__ import annotations

import hashlib

import numpy as np

from ..index.analyzer import tokenize as analyze


class SimpleTokenizer:
    """Deterministic hashing tokenizer (no vocab files)."""

    cls_id = 0
    pad_id = 1
    sep_id = 2
    unk_id = 3
    _reserved = 4

    def __init__(self, vocab_size: int = 1024, max_length: int = 128) -> None:
        self.vocab_size = vocab_size
        self.max_length = max_length
        self._id_cache: dict[str, int] = {}

    def _word_id(self, word: str) -> int:
        wid = self._id_cache.get(word)
        if wid is None:
            h = int.from_bytes(hashlib.md5(word.encode()).digest()[:4], "little")
            wid = self._reserved + h % (self.vocab_size - self._reserved)
            if len(self._id_cache) < 1_000_000:
                self._id_cache[word] = wid
        return wid

    def encode_batch(self, texts: list[str], max_length: int | None = None) -> tuple[np.ndarray, np.ndarray]:
        """Returns ``(input_ids [B, S] i32, attention_mask [B, S] i32)``
        with S the longest row, at most ``max_length``."""
        max_length = max_length or self.max_length
        word_id = self._word_id
        toks = [
            [self.cls_id] + [word_id(w) for w in analyze(t)][: max_length - 2] + [self.sep_id]
            for t in texts
        ]
        s = max(len(t) for t in toks) if toks else 2
        ids = np.full((len(texts), s), self.pad_id, np.int32)
        mask = np.zeros((len(texts), s), np.int32)
        for i, t in enumerate(toks):
            ids[i, : len(t)] = t
            mask[i, : len(t)] = 1
        return ids, mask
