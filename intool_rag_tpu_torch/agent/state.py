"""Agent state (port of ``intool_rag_tpu/agent/state.py``): the query
intents, each intent's retrieval configuration, the page-score gate and
the state one query carries through the steps."""

from __future__ import annotations

import dataclasses
import enum
import time
from typing import Any


class QueryIntent(str, enum.Enum):
    LOOKUP = "lookup"
    EXPLAIN = "explain"
    SUMMARIZE = "summarize"
    COMPARE = "compare"


# intent → chunks to retrieve, pages to keep, context characters
INTENT_CONFIG: dict[QueryIntent, dict[str, int]] = {
    QueryIntent.LOOKUP: {"top_k": 30, "max_pages": 3, "context_budget": 4000},
    QueryIntent.EXPLAIN: {"top_k": 50, "max_pages": 5, "context_budget": 8000},
    QueryIntent.SUMMARIZE: {"top_k": 100, "max_pages": 10, "context_budget": 12000},
    QueryIntent.COMPARE: {"top_k": 80, "max_pages": 8, "context_budget": 10000},
}

MIN_PAGE_SCORE = 0.3  # a query answers only from a page scored at least this


@dataclasses.dataclass
class AgentState:
    raw_query: str
    normalized_query: str = ""
    intent: QueryIntent = QueryIntent.LOOKUP
    retrieval_config: dict[str, int] = dataclasses.field(default_factory=dict)
    chunks: list = dataclasses.field(default_factory=list)
    pages: list = dataclasses.field(default_factory=list)
    selected_pages: list = dataclasses.field(default_factory=list)
    context: str = ""
    answer: str = ""
    answer_confidence: str = "low"
    uses_context: bool = False
    validation: dict[str, Any] = dataclasses.field(default_factory=dict)
    started_at: float = dataclasses.field(default_factory=time.time)
    step_log: list[str] = dataclasses.field(default_factory=list)

    def log_step(self, name: str) -> None:
        self.step_log.append(name)

    def is_valid_to_answer(self) -> bool:
        """The gate: at least one selected page scored MIN_PAGE_SCORE or more."""
        return any(p.score >= MIN_PAGE_SCORE for p in self.selected_pages)

    def execution_time_ms(self) -> float:
        return (time.time() - self.started_at) * 1000.0

    def dump(self) -> dict:
        return {
            "raw_query": self.raw_query,
            "normalized_query": self.normalized_query,
            "intent": self.intent.value,
            "retrieval_config": self.retrieval_config,
            "chunks_found": len(self.chunks),
            "pages_ranked": len(self.pages),
            "pages_selected": len(self.selected_pages),
            "context_chars": len(self.context),
            "steps": self.step_log,
            "validation": self.validation,
        }
