"""Semantic analyzer factory (port of
``intool_rag_tpu/llm/semantic/factory.py``), chosen by ``LLM_PROVIDER``.

The port serves the heuristic analyzer, which is what the JAX package
serves offline. The Gemini and Ollama analyzers are not ported yet (ROADMAP
Queue A item 8): asking for one raises rather than quietly falling to the
heuristic analyzer, so a store's trees never come from another analyzer
than the one configured.
"""

from __future__ import annotations

import threading

from ...config import get_config
from .base import SemanticAnalyzer

_analyzer: SemanticAnalyzer | None = None
_lock = threading.Lock()


def _build() -> SemanticAnalyzer:
    cfg = get_config()
    choice = cfg.LLM_PROVIDER.lower()
    if choice in ("fake", "heuristic"):
        from ...providers.heuristic_semantic import HeuristicSemanticAnalyzer

        return HeuristicSemanticAnalyzer()
    raise NotImplementedError(
        f"LLM_PROVIDER={cfg.LLM_PROVIDER!r} selects the Gemini or the Ollama semantic analyzer, "
        "which the port does not have yet (ROADMAP Queue A item 8); set LLM_PROVIDER=heuristic"
    )


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
