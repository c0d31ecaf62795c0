from .base import SectionSpec, SemanticAnalyzer  # noqa: F401
from .factory import get_semantic_analyzer, reset_semantic_analyzer  # noqa: F401


def analyze_document(pages: list[str]) -> list[SectionSpec]:
    """Façade (reference: rag/llm/semantic/analyzer.py:5-12)."""
    return get_semantic_analyzer().analyze(pages)
