"""SemanticAnalyzer interface (copy of ``intool_rag_tpu/llm/semantic/base.py``;
reference: rag/llm/semantic/base.py:5-29)."""

from __future__ import annotations

import abc
import dataclasses


@dataclasses.dataclass
class SectionSpec:
    """One section from document-structure analysis (matches the JSON the
    reference's structure prompt demands — rag/ingest/prompts.py)."""

    title: str
    level: str  # chapter | section | subsection | paragraph
    page_index: int
    summary: str = ""


class SemanticAnalyzer(abc.ABC):
    @abc.abstractmethod
    def analyze(self, pages: list[str]) -> list[SectionSpec]:
        """Segment a document (list of page texts) into semantic sections."""
