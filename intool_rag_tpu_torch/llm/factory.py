"""LLM factory with its fallback chain (port of
``intool_rag_tpu/llm/factory.py``), chosen by ``LLM_PROVIDER``: ``fake``;
``cuda`` or the JAX package's ``tpu``, the in-process decoder on the card
(without a CUDA device it raises, never falls back); ``gemini``, or an
empty choice while ``GEMINI_API_KEY`` is set, when the key is there;
Ollama for an empty choice or ``ollama`` / ``local`` / ``http`` when its
server answers; else the extractive fake LLM, with a warning."""

from __future__ import annotations

import threading

import torch

from ..logging import get_logger
from ..config import get_config
from .base import BaseLLM

logger = get_logger(__name__)

_llm: BaseLLM | None = None
_lock = threading.Lock()


def _build(device: str | torch.device | None) -> BaseLLM:
    cfg = get_config()
    choice = cfg.LLM_PROVIDER.lower()
    if choice == "fake":
        from ..providers.fake import FakeLLM

        return FakeLLM()
    if choice in ("cuda", "tpu"):
        from ..providers.cuda_llm import CudaLLM

        return CudaLLM(device=device)
    if choice == "gemini" or (not choice and cfg.GEMINI_API_KEY):
        from ..providers.gemini import GeminiLLM

        llm = GeminiLLM()
        if llm.is_ready():
            return llm
        logger.warning("gemini LLM not ready, falling through")
    if choice in ("", "ollama", "local", "http"):
        from ..providers.ollama import OllamaLLM

        llm = OllamaLLM()
        if llm.is_ready():
            return llm
        logger.warning("ollama not reachable at %s", cfg.LLM_BASE_URL)
    from ..providers.fake import FakeLLM

    logger.warning("no LLM provider reachable: using the extractive FakeLLM")
    return FakeLLM()


def get_llm(device: str | torch.device | None = None) -> BaseLLM:
    """The process's LLM, built on the first call (the decoder on
    ``device``, default CUDA)."""
    global _llm
    if _llm is None:
        with _lock:
            if _llm is None:
                _llm = _build(device)
    return _llm


def reset_llm() -> None:
    global _llm
    _llm = None
