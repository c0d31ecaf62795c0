"""EmbeddingProvider capability (port of
``intool_rag_tpu/llm/embeddings/base.py``)."""

from __future__ import annotations

import abc

import numpy as np


class EmbeddingProvider(abc.ABC):
    """Text → unit-norm vector capability."""

    @property
    @abc.abstractmethod
    def dimension(self) -> int:
        ...

    @property
    def model_name(self) -> str:
        return type(self).__name__

    @abc.abstractmethod
    def embed_batch(self, texts: list[str], *, is_query: bool = False) -> np.ndarray:
        """Embed texts → ``[len(texts), dimension]`` float32, L2-normalised;
        ``is_query=True`` applies the query instruction prefix."""

    def embed_single(self, text: str, *, is_query: bool = False) -> np.ndarray:
        return self.embed_batch([text], is_query=is_query)[0]
