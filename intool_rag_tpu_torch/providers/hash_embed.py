"""Deterministic feature-hashing embedder, the offline provider (port of
``intool_rag_tpu/providers/hash_embed.py``).

Signed feature hashing of the analyzer's terms and their character
3-grams into D dimensions, L2-normalised; md5 makes it stable across
processes. It runs on the host: it has no kernel and touches no device.
"""

from __future__ import annotations

import hashlib

import numpy as np

from ..index.analyzer import tokenize
from .base import instruction_prefix


class HashEmbeddingProvider:
    def __init__(self, dimension: int = 256) -> None:
        self._dim = dimension

    @property
    def dimension(self) -> int:
        return self._dim

    @property
    def model_name(self) -> str:
        return f"hash-{self._dim}"

    def _features(self, text: str) -> list[str]:
        words = tokenize(text)
        feats = list(words)
        for w in words:
            padded = f"#{w}#"
            feats.extend(padded[i : i + 3] for i in range(len(padded) - 2))
        return feats

    def embed_batch(self, texts: list[str], *, is_query: bool = False) -> np.ndarray:
        prefix = instruction_prefix(is_query)
        out = np.zeros((len(texts), self._dim), np.float32)
        for i, text in enumerate(texts):
            if prefix:
                text = prefix + text
            for feat in self._features(text):
                digest = hashlib.md5(feat.encode()).digest()
                idx = int.from_bytes(digest[:4], "little") % self._dim
                out[i, idx] += 1.0 if digest[4] & 1 else -1.0
            norm = np.linalg.norm(out[i])
            if norm > 0:
                out[i] /= norm
            else:
                out[i, 0] = 1.0  # empty text: a fixed unit vector
        return out

    def embed_single(self, text: str, *, is_query: bool = False) -> np.ndarray:
        return self.embed_batch([text], is_query=is_query)[0]
