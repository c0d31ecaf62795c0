"""Ollama embedding provider over ``POST /api/embed`` (port of
``intool_rag_tpu/providers/ollama_embed.py``)."""

from __future__ import annotations

import numpy as np

from ..config import get_config
from ..exceptions import EmbeddingProviderError
from .base import instruction_prefix
from .http_utils import request_with_retry


class OllamaEmbeddingProvider:
    def __init__(self, model: str | None = None, base_url: str | None = None) -> None:
        cfg = get_config()
        self.model = model or cfg.EMBEDDING_MODEL
        self.base_url = (base_url or cfg.LLM_BASE_URL).rstrip("/")
        self._dim: int | None = None

    @property
    def model_name(self) -> str:
        return self.model

    @property
    def dimension(self) -> int:
        if self._dim is None:
            self._dim = int(self.embed_batch(["dimension probe"]).shape[1])
        return self._dim

    def embed_batch(self, texts: list[str], *, is_query: bool = False) -> np.ndarray:
        prefix = instruction_prefix(is_query)
        if prefix:
            texts = [prefix + t for t in texts]
        resp = request_with_retry("POST", f"{self.base_url}/api/embed", json={"model": self.model, "input": texts})
        if resp.status_code != 200:
            raise EmbeddingProviderError(f"ollama embed failed: {resp.status_code}")
        vecs = np.asarray(resp.json()["embeddings"], np.float32)
        if self._dim is None and vecs.size:
            self._dim = vecs.shape[1]
        norms = np.linalg.norm(vecs, axis=1, keepdims=True)
        return vecs / np.maximum(norms, 1e-9)

    def embed_single(self, text: str, *, is_query: bool = False) -> np.ndarray:
        return self.embed_batch([text], is_query=is_query)[0]
