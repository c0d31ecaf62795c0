"""Agent pipeline steps (port of ``intool_rag_tpu/agent/steps.py``):
normalize, classify, search, select, assemble, generate, validate and
format. Retrieval goes through the port's page retriever, so the dense
stage runs the store's kernel (K1 or K2) on the card."""

from __future__ import annotations

import re

from ..index.analyzer import tokenize
from ..llm.base import BaseLLM
from ..providers.json_utils import sanitize_json
from ..query.retriever import PageLevelRetriever, PageRanking
from .state import MIN_PAGE_SCORE, AgentState, QueryIntent

_FILLERS = re.compile(
    r"\b(please|kindly|could you|can you|would you|tell me|i want to know|"
    r"i would like to know|let me know)\b",
    re.I,
)

_INTENT_PATTERNS: list[tuple[QueryIntent, re.Pattern]] = [
    (QueryIntent.COMPARE, re.compile(r"\b(compare|versus|vs\.?|difference between|differ)\b", re.I)),
    (QueryIntent.SUMMARIZE, re.compile(r"\b(summar\w*|overview|main points|gist|tl;?dr)\b", re.I)),
    (QueryIntent.EXPLAIN, re.compile(r"\b(how|why|explain|describe|what does .+ mean)\b", re.I)),
]


class QueryNormalizer:
    """Filler words out, whitespace collapsed."""

    def normalize(self, query: str) -> str:
        out = _FILLERS.sub("", query)
        return re.sub(r"\s{2,}", " ", out).strip()


class IntentClassifier:
    """The first intent whose pattern matches; LOOKUP otherwise."""

    def classify(self, query: str) -> QueryIntent:
        for intent, pattern in _INTENT_PATTERNS:
            if pattern.search(query):
                return intent
        return QueryIntent.LOOKUP


class Searcher:
    """Chunks from the retriever, grouped into ranked pages."""

    def __init__(self, retriever: PageLevelRetriever) -> None:
        self.retriever = retriever

    def run(self, state: AgentState, project: str | None) -> None:
        cfg = state.retrieval_config
        state.chunks = self.retriever.retrieve_chunks(state.normalized_query, project=project, limit=cfg["top_k"])
        state.pages = self.retriever.rank_pages(state.chunks, top_pages=cfg["max_pages"])


class PageSelector:
    """Pages at or above MIN_PAGE_SCORE, else the best page alone."""

    def run(self, state: AgentState) -> None:
        state.selected_pages = [p for p in state.pages if p.score >= MIN_PAGE_SCORE] or state.pages[:1]


class ContextAssembler:
    """A header and the chunks in chunk order for each selected page, within
    the intent's character budget. For EXPLAIN and COMPARE intents, with the
    semantic tree at hand, the best page's nodes bring their parent and
    sibling sections (``query/context.py``)."""

    def __init__(self, registry=None) -> None:
        self.registry = registry

    def _node_blocks(self, state: AgentState) -> str:
        """Hierarchy blocks around the best page's nodes."""
        from ..query.context import ContextBuilder, format_blocks

        if self.registry is None or not state.selected_pages:
            return ""
        best = state.selected_pages[0]
        page_index = self.registry.page_indexes.get(best.doc_id)
        if page_index is None:
            return ""
        node_texts: dict[str, str] = {}
        matches: list[tuple[str, float]] = []
        for chunk in best.chunks:
            node_id = self.registry.chunk_nodes.get((best.doc_id, chunk.chunk_id), "")
            if not node_id:
                continue
            node_texts[node_id] = node_texts.get(node_id, "") + ("\n" if node_id in node_texts else "") + chunk.text
            matches.append((node_id, chunk.score))
        if not matches:
            return ""
        builder = ContextBuilder(page_index, node_texts)
        blocks, _ = builder.build_adaptive(
            state.normalized_query, matches, token_budget=state.retrieval_config["context_budget"] // 4
        )
        return format_blocks([b for b in blocks if b.role != "primary"])

    def run(self, state: AgentState) -> None:
        budget = state.retrieval_config["context_budget"]
        blocks: list[str] = []
        used = 0
        for page in state.selected_pages:
            header = f"[Page {page.page + 1}"
            if page.chapter:
                header += f" | {page.chapter}"
            if page.section:
                header += f" | {page.section}"
            header += "]"
            body = "\n".join(c.text for c in sorted(page.chunks, key=lambda c: c.chunk_id))
            block = f"{header}\n{body}"
            if used + len(block) > budget:
                block = block[: budget - used]
            blocks.append(block)
            used += len(block) + 2
            if used >= budget:
                break
        if state.intent in (QueryIntent.EXPLAIN, QueryIntent.COMPARE) and used < budget:
            extra = self._node_blocks(state)
            if extra:
                blocks.append(extra[: budget - used])
        state.context = "\n\n".join(blocks)


_ANSWER_PROMPT = """Answer the question from the context only. Respond with a JSON object:
{{"answer": "<direct answer>", "confidence": "high"|"medium"|"low", "uses_context": true|false}}

Context:
{context}

Question: {question}

JSON:"""


class AnswerGenerator:
    """A JSON answer from the LLM, retried ``max_retries`` times while it
    is empty; text that is not JSON (the extractive fake LLM's) is the
    answer itself."""

    def __init__(self, llm: BaseLLM, max_retries: int = 1) -> None:
        self.llm = llm
        self.max_retries = max_retries

    def run(self, state: AgentState) -> None:
        prompt = _ANSWER_PROMPT.format(context=state.context, question=state.normalized_query)
        for _ in range(self.max_retries + 1):
            raw = self.llm.generate(prompt)
            try:
                data = sanitize_json(raw)
                state.answer = str(data.get("answer", "")).strip()
                state.answer_confidence = data.get("confidence", "low")
                state.uses_context = bool(data.get("uses_context", False))
            except Exception:  # not JSON: the raw text answers
                state.answer = raw.strip()
                state.answer_confidence = "medium" if raw.strip() else "low"
                state.uses_context = bool(raw.strip())
            if state.answer:
                return
        state.answer = "I could not generate an answer from the context."


class Validator:
    """Heuristic checks: length, the uses-context flag, and the share of
    the answer's terms that the context holds."""

    def run(self, state: AgentState) -> None:
        answer_terms = set(tokenize(state.answer))
        context_terms = set(tokenize(state.context))
        overlap = len(answer_terms & context_terms) / max(1, len(answer_terms))
        checks = {
            "min_length": len(state.answer) >= 10,
            "uses_context": state.uses_context,
            "context_overlap": overlap >= 0.3,
        }
        state.validation = {"checks": checks, "overlap": round(overlap, 3), "passed": sum(checks.values()) >= 2}


class Formatter:
    """The response body: answer, confidence, intent, sources, validation,
    time and the state's dump."""

    @staticmethod
    def _source(page: PageRanking) -> dict:
        return {
            "page": page.page + 1,
            "chapter": page.chapter,
            "section": page.section,
            "subsection": page.subsection,
            "title": page.title,
            "source_file": page.source_file or None,
            "relevance_score": round(float(page.score), 4),
        }

    def run(self, state: AgentState) -> dict:
        best = state.selected_pages[0] if state.selected_pages else None
        return {
            "answer": state.answer,
            "confidence": state.answer_confidence,
            "intent": state.intent.value,
            "source": self._source(best) if best else None,
            "all_sources": [self._source(p) for p in state.selected_pages],
            "validation": state.validation,
            "execution_time_ms": round(state.execution_time_ms(), 2),
            "state": state.dump(),
        }
