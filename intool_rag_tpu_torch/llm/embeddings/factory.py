"""Embedding provider factory (port of
``intool_rag_tpu/llm/embeddings/factory.py``), chosen by
``EMBEDDING_PROVIDER``.

The JAX package's table: ``hash``; ``ollama``; ``gemini``, or any choice
left empty while ``GEMINI_API_KEY`` is set; the encoder for ``""``,
``cuda`` (the JAX package's ``tpu``, which works here too) or ``hf``;
hash embeddings with a warning for anything else, ``gemini`` without a key
included. One difference: where the JAX package drops to hash embeddings
when its encoder provider cannot start, the port's encoder provider raises
(a missing CUDA device among them), since hash embeddings there would hide
the device.
"""

from __future__ import annotations

import threading

import torch

from ...logging import get_logger
from ...config import get_config

logger = get_logger(__name__)

_provider = None
_lock = threading.Lock()
ENCODER_CHOICES = ("", "cuda", "tpu", "hf")


def _build(device: str | torch.device | None):
    cfg = get_config()
    choice = cfg.EMBEDDING_PROVIDER.lower()
    if choice == "hash":
        from ...providers.hash_embed import HashEmbeddingProvider

        return HashEmbeddingProvider()
    if choice == "ollama":
        from ...providers.ollama_embed import OllamaEmbeddingProvider

        return OllamaEmbeddingProvider()
    if cfg.GEMINI_API_KEY and choice in ("gemini", ""):
        from ...providers.gemini import GeminiEmbeddingProvider

        return GeminiEmbeddingProvider()
    if choice in ENCODER_CHOICES:
        from ...providers.cuda_embed import CudaEmbeddingProvider

        return CudaEmbeddingProvider(device=device)
    from ...providers.hash_embed import HashEmbeddingProvider

    logger.warning("EMBEDDING_PROVIDER=%r has no provider here: falling back to hash embeddings",
                   cfg.EMBEDDING_PROVIDER)
    return HashEmbeddingProvider()


def get_embedding_provider(device: str | torch.device | None = None):
    """The process's provider, built on the first call (the encoder on
    ``device``, default CUDA)."""
    global _provider
    if _provider is None:
        with _lock:
            if _provider is None:
                _provider = _build(device)
    return _provider


def reset_embedding_provider() -> None:
    global _provider
    _provider = None
