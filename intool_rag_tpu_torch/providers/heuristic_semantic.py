"""Heuristic (no-LLM) document-structure analyzer (copy of
``intool_rag_tpu/providers/heuristic_semantic.py``).

Offline implementation of the SemanticAnalyzer port: detects headings by
typography (short lines, numbering patterns, title case, all-caps) and
assigns levels from numbering depth. Serves as the deterministic fallback
when no LLM provider is reachable — the reference has no offline path at
all (its factory chain ends at Ollama, llm/semantic/factory.py:21-39).
"""

from __future__ import annotations

import re

from ..llm.semantic.base import SectionSpec, SemanticAnalyzer

_NUMBERED = re.compile(r"^\s*(\d+(?:\.\d+)*)[.)]?\s+(\S.*)$")
_APPENDIX = re.compile(r"^\s*(chapter|section|appendix|part)\s+[\divxlc]+", re.I)


def _looks_like_heading(line: str) -> bool:
    line = line.strip()
    if not (2 <= len(line) <= 80) or line.endswith((".", ",", ";", ":")):
        return False
    if _NUMBERED.match(line) or _APPENDIX.match(line):
        return True
    words = line.split()
    if len(words) > 10:
        return False
    if line.isupper() and len(words) <= 8:
        return True
    # Title Case: most words capitalized, no sentence punctuation inside
    caps = sum(1 for w in words if w[:1].isupper())
    return caps >= max(2, int(0.8 * len(words))) and "," not in line


def _level_for(line: str) -> str:
    m = _NUMBERED.match(line.strip())
    if m:
        depth = m.group(1).count(".")
        return ("chapter", "section", "subsection")[min(depth, 2)]
    if line.strip().isupper():
        return "chapter"
    return "section"


class HeuristicSemanticAnalyzer(SemanticAnalyzer):
    def __init__(self, max_sections: int = 40) -> None:
        self.max_sections = max_sections

    def analyze(self, pages: list[str]) -> list[SectionSpec]:
        sections: list[SectionSpec] = []
        for page_idx, text in enumerate(pages):
            for raw in text.splitlines():
                line = raw.strip()
                if line and _looks_like_heading(line):
                    sections.append(
                        SectionSpec(
                            title=line,
                            level=_level_for(line),
                            page_index=page_idx,
                            summary="",
                        )
                    )
                    if len(sections) >= self.max_sections:
                        return sections
        if not sections and pages:
            first_line = next(
                (ln.strip() for ln in pages[0].splitlines() if ln.strip()),
                "Document",
            )
            title = " ".join(first_line.split()[:8])[:80]
            sections.append(
                SectionSpec(title=title, level="chapter", page_index=0)
            )
        return sections
