"""Semantic analyzer factory (port of
``intool_rag_tpu/llm/semantic/factory.py``), chosen by ``LLM_PROVIDER``:
``fake`` or ``heuristic`` select the heuristic analyzer; otherwise Gemini
when ``GEMINI_API_KEY`` is set, else Ollama when its server answers, else
the heuristic analyzer with a warning. The default configuration (no
provider, no key, no Ollama) thus ingests through the heuristic analyzer,
as the JAX package's does. It runs on the host and touches no device.
"""

from __future__ import annotations

import threading

from ...logging import get_logger
from ...config import get_config
from .base import SemanticAnalyzer

logger = get_logger(__name__)

_analyzer: SemanticAnalyzer | None = None
_lock = threading.Lock()


def _build() -> SemanticAnalyzer:
    cfg = get_config()
    choice = cfg.LLM_PROVIDER.lower()
    if choice in ("fake", "heuristic"):
        from ...providers.heuristic_semantic import HeuristicSemanticAnalyzer

        return HeuristicSemanticAnalyzer()
    if cfg.GEMINI_API_KEY:
        from ...providers.gemini import GeminiSemanticAnalyzer

        return GeminiSemanticAnalyzer()
    from ...providers.ollama import OllamaLLM, OllamaSemanticAnalyzer

    llm = OllamaLLM()
    if llm.is_ready():
        return OllamaSemanticAnalyzer(llm)
    from ...providers.heuristic_semantic import HeuristicSemanticAnalyzer

    logger.warning("no LLM reachable: using the heuristic structure analyzer")
    return HeuristicSemanticAnalyzer()


def get_semantic_analyzer() -> SemanticAnalyzer:
    global _analyzer
    if _analyzer is None:
        with _lock:
            if _analyzer is None:
                _analyzer = _build()
    return _analyzer


def reset_semantic_analyzer() -> None:
    global _analyzer
    _analyzer = None
