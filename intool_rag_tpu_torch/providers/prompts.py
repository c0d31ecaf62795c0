"""Structure-analysis prompt for the LLM semantic analyzers (port of
``intool_rag_tpu/providers/prompts.py``): segment the document into 3-10
semantic sections, strict JSON output with title, level, page_index and
summary."""

from __future__ import annotations

STRUCTURE_ANALYSIS_PROMPT = """You are a document-structure analyst. \
Segment the document below into between 3 and 10 semantic sections.

Rules:
- Output ONLY a JSON object of the form:
  {{"sections": [{{"title": str, "level": "chapter"|"section"|"subsection"|"paragraph", "page_index": int, "summary": str}}]}}
- "title": a short heading (max 12 words) taken from or summarizing the section start.
- "level": "chapter" for top-level parts, "section" for subdivisions,
  "subsection" for finer structure, "paragraph" only for isolated fragments.
- "page_index": the 0-based page (from the [PAGE n] tags) where the section starts.
- "summary": one sentence describing the section's content.
- Sections must appear in reading order and cover the whole document.

Document:
{document}
"""


def tag_pages(pages: list[str]) -> str:
    """The pages as one ``[PAGE n]``-tagged text."""
    return "\n\n".join(f"[PAGE {i}]\n{text}" for i, text in enumerate(pages))
