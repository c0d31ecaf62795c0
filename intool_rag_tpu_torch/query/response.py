"""Response assembly: context blocks, prompt, citations, confidence (port
of ``intool_rag_tpu/query/response.py``)."""

from __future__ import annotations

from ..config import get_config
from .prompts import RAG_CONTEXT_TEMPLATE
from .retriever import PageRanking


class ResponseAssembler:
    """Context blocks with page / section headers under a length budget
    in characters."""

    def __init__(self, max_context_length: int | None = None) -> None:
        self.max_context_length = max_context_length or get_config().MAX_CONTEXT_LENGTH

    @staticmethod
    def _header(page: PageRanking) -> str:
        """``[Page N | Chapter | Section | Title]``, N 1-based."""
        parts = [f"Page {page.page + 1}"]
        for field in (page.chapter, page.section, page.title):
            if field and field not in parts:
                parts.append(field)
        return "[" + " | ".join(parts) + "]"

    def assemble_context(self, ranked_pages: list[PageRanking], max_length: int | None = None) -> str:
        max_length = max_length or self.max_context_length
        blocks: list[str] = []
        used = 0
        for page in ranked_pages:
            block = f"{self._header(page)}\n{page.context_text}"
            if used + len(block) > max_length:
                remaining = max_length - used
                if remaining > 200:  # a truncated block only when enough of it is left
                    blocks.append(block[:remaining])
                break
            blocks.append(block)
            used += len(block) + 2
        return "\n\n".join(blocks)

    def build_prompt(self, question: str, context: str) -> str:
        return RAG_CONTEXT_TEMPLATE.format(context=context, question=question)


class CitationFormatter:
    def format_sources(self, ranked_pages: list[PageRanking]) -> dict:
        all_sources = [self._source(p) for p in ranked_pages]
        return {
            "primary_sources": all_sources[: get_config().CONTEXT_MAX_RESULTS],
            "all_sources": all_sources,
        }

    @staticmethod
    def _source(page: PageRanking) -> dict:
        return {
            "page": page.page + 1,  # 1-based for people
            "chapter": page.chapter,
            "section": page.section,
            "subsection": page.subsection,
            "title": page.title,
            "source_file": page.source_file or None,
            "relevance_score": round(float(page.score), 4),
        }


def estimate_confidence(ranked_pages: list[PageRanking]) -> str:
    """Mean page score above 0.8: high, above 0.6: medium, else low."""
    if not ranked_pages:
        return "low"
    avg = sum(p.score for p in ranked_pages) / len(ranked_pages)
    if avg > 0.8:
        return "high"
    if avg > 0.6:
        return "medium"
    return "low"


def build_rag_prompt(question: str, ranked_pages: list[PageRanking], max_context_length: int | None = None) -> str:
    assembler = ResponseAssembler(max_context_length)
    return assembler.build_prompt(question, assembler.assemble_context(ranked_pages))


def create_page_aware_response(answer: str, ranked_pages: list[PageRanking]) -> dict:
    return {
        "answer": answer,
        "sources": CitationFormatter().format_sources(ranked_pages),
        "confidence": estimate_confidence(ranked_pages),
    }
