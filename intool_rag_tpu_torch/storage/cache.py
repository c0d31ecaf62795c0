"""Embedding and query-result caches on disk (port of
``intool_rag_tpu/storage/cache.py``; the same keys and file layout).

- ``EmbeddingCache``: ``md5(model, instruction, text)`` → one ``.npy`` per
  text under ``CACHE_DIR/embeddings``; ``CachingEmbeddingProvider`` reads
  it before it embeds (ingest re-runs embed only what is new).
- ``QueryResultCache``: ``md5(question, project, params, corpus version)``
  → JSON under ``CACHE_DIR/queries``. The corpus version in the key drops
  every answer after an ingest or a delete.
"""

from __future__ import annotations

import hashlib
import json
from pathlib import Path

import numpy as np

from ..config import get_config


def _key(*parts: str) -> str:
    return hashlib.md5("\x1f".join(parts).encode()).hexdigest()


class EmbeddingCache:
    def __init__(self, cache_dir: Path | str | None = None) -> None:
        base = Path(cache_dir or get_config().CACHE_DIR) / "embeddings"
        base.mkdir(parents=True, exist_ok=True)
        self.dir = base
        self.hits = 0
        self.misses = 0

    def _path(self, model: str, instruction: str, text: str) -> Path:
        return self.dir / f"{_key(model, instruction, text)}.npy"

    def get(self, model: str, instruction: str, text: str) -> np.ndarray | None:
        path = self._path(model, instruction, text)
        if path.exists():
            try:
                vec = np.load(path)
                self.hits += 1
                return vec
            except (OSError, ValueError, EOFError):  # a torn or foreign file: drop it, embed again
                path.unlink(missing_ok=True)
        self.misses += 1
        return None

    def put(self, model: str, instruction: str, text: str, vec: np.ndarray) -> None:
        np.save(self._path(model, instruction, text), np.asarray(vec, np.float32))

    def clear(self) -> int:
        n = 0
        for p in self.dir.glob("*.npy"):
            p.unlink()
            n += 1
        return n


class CachingEmbeddingProvider:
    """An embedding provider that consults the cache text by text and
    embeds the misses in one batch."""

    def __init__(self, inner, cache: EmbeddingCache | None = None) -> None:
        self.inner = inner
        self.cache = cache or EmbeddingCache()

    @property
    def dimension(self) -> int:
        return self.inner.dimension

    @property
    def model_name(self) -> str:
        return self.inner.model_name

    def embed_batch(self, texts: list[str], *, is_query: bool = False) -> np.ndarray:
        from ..providers.base import instruction_prefix

        instruction = instruction_prefix(is_query)
        out = np.zeros((len(texts), self.dimension), np.float32)
        missing: list[int] = []
        for i, text in enumerate(texts):
            vec = self.cache.get(self.model_name, instruction, text)
            if vec is not None and vec.shape == (self.dimension,):
                out[i] = vec
            else:
                missing.append(i)
        if missing:
            fresh = self.inner.embed_batch([texts[i] for i in missing], is_query=is_query)
            for j, i in enumerate(missing):
                out[i] = fresh[j]
                self.cache.put(self.model_name, instruction, texts[i], fresh[j])
        return out

    def embed_single(self, text: str, *, is_query: bool = False) -> np.ndarray:
        return self.embed_batch([text], is_query=is_query)[0]


class QueryResultCache:
    def __init__(self, cache_dir: Path | str | None = None) -> None:
        base = Path(cache_dir or get_config().CACHE_DIR) / "queries"
        base.mkdir(parents=True, exist_ok=True)
        self.dir = base
        self.hits = 0
        self.misses = 0

    def _path(self, question: str, project: str, params: str, version: int) -> Path:
        return self.dir / f"{_key(question, project, params, str(version))}.json"

    def get(self, question: str, project: str, params: str, version: int):
        path = self._path(question, project, params, version)
        if path.exists():
            try:
                result = json.loads(path.read_text(encoding="utf-8"))
                self.hits += 1
                return result
            except (OSError, ValueError):  # a torn file: drop it, answer again
                path.unlink(missing_ok=True)
        self.misses += 1
        return None

    def put(self, question: str, project: str, params: str, version: int, result) -> None:
        self._path(question, project, params, version).write_text(
            json.dumps(result, ensure_ascii=False), encoding="utf-8"
        )

    def clear(self) -> int:
        n = 0
        for p in self.dir.glob("*.json"):
            p.unlink()
            n += 1
        return n
