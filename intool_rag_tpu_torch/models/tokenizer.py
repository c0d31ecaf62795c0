"""Tokenization for the encoder path (port of
``intool_rag_tpu/models/tokenizer.py``).

:func:`get_tokenizer` prefers an HF fast tokenizer
(``transformers.AutoTokenizer``, local files only: a cached hub name or a
directory) and falls back to :class:`SimpleTokenizer` on any failure, a
missing ``transformers`` package included, as the JAX package does. It
also falls back when the HF vocabulary has more ids than the encoder has
embedding rows: the JAX package keeps such a tokenizer (its ids past the
table embed as NaN there), but here they would raise a device-side assert
in ``nn.functional.embedding`` on CUDA.
:class:`SimpleTokenizer` ids: 0 = CLS, 1 = PAD, 2 = SEP, 3 = UNK; words from
the BM25 analyzer hash (md5, stable across processes) into [4, vocab_size).
"""

from __future__ import annotations

import hashlib

import numpy as np

from ..logging import get_logger
from ..index.analyzer import tokenize as analyze

logger = get_logger(__name__)


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


class HFTokenizer:
    """``transformers.AutoTokenizer`` over local files only; ``transformers``
    is imported here, on first use, since it is optional."""

    def __init__(self, model_name: str, max_length: int = 8192) -> None:
        from transformers import AutoTokenizer

        self.tok = AutoTokenizer.from_pretrained(model_name, local_files_only=True)
        self.max_length = max_length
        self.pad_id = self.tok.pad_token_id

    def encode_batch(self, texts: list[str], max_length: int | None = None) -> tuple[np.ndarray, np.ndarray]:
        out = self.tok(texts, padding=True, truncation=True, max_length=max_length or self.max_length,
                       return_tensors="np")
        return out["input_ids"].astype(np.int32), out["attention_mask"].astype(np.int32)


def get_tokenizer(model_name: str, vocab_size: int, max_length: int):
    """The HF tokenizer if its files are local and its ids fit in
    ``vocab_size`` embedding rows, else the hashing tokenizer."""
    try:
        tok = HFTokenizer(model_name, max_length)
    except Exception:  # no transformers, no local files, or no usable tokenizer there
        return SimpleTokenizer(vocab_size=vocab_size, max_length=max_length)
    if len(tok.tok) > vocab_size:
        logger.warning("tokenizer %s has %d ids but the encoder %d rows: using the hashing tokenizer",
                       model_name, len(tok.tok), vocab_size)
        return SimpleTokenizer(vocab_size=vocab_size, max_length=max_length)
    return tok
