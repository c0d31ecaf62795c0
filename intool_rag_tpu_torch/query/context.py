"""Node-level context building with query-type strategies (port of
``intool_rag_tpu/query/context.py``).

Strategies: SIMPLE (the matched nodes' text, most relevant first),
HIERARCHY (plus each match's parent at 0.7 and up to two siblings at 0.6 of
its relevance) and COMPARISON (the two strongest matches first, then the
hierarchy's extra blocks). The question's wording picks the strategy
(:func:`classify_query_type`); a token budget (words / 0.75) keeps every
primary and parent block and fills the rest by relevance.
"""

from __future__ import annotations

import dataclasses
import enum
import re

from ..ingest.chunker import estimate_tokens
from ..ingest.schemas import PageIndex, SemanticNode


class QueryType(str, enum.Enum):
    SIMPLE = "simple"
    DEFINITION = "definition"
    ANALYTICAL = "analytical"
    COMPARISON = "comparison"


_COMPARE = re.compile(r"\b(compare|versus|vs\.?|difference|differ|contrast)\b", re.I)
_DEFINE = re.compile(r"\b(what is|what are|define|definition of|meaning of)\b", re.I)
_ANALYTICAL = re.compile(r"\b(how|why|explain|analy[sz]e)\b", re.I)


def classify_query_type(query: str) -> QueryType:
    if _COMPARE.search(query):
        return QueryType.COMPARISON
    if _DEFINE.search(query):
        return QueryType.DEFINITION
    if _ANALYTICAL.search(query):
        return QueryType.ANALYTICAL
    return QueryType.SIMPLE


@dataclasses.dataclass
class ContextBlock:
    node_id: str
    title: str
    text: str
    relevance: float
    role: str  # primary | parent | sibling

    @property
    def token_estimate(self) -> int:
        return estimate_tokens(self.text)


class ContextBuilder:
    """Ordered context blocks for a set of matched ``(node_id, relevance)``."""

    def __init__(self, page_index: PageIndex, node_texts: dict[str, str]) -> None:
        self.page_index = page_index
        self.node_texts = node_texts

    def _block(self, node: SemanticNode, relevance: float, role: str) -> ContextBlock | None:
        text = self.node_texts.get(node.node_id, node.summary)
        if not text:
            return None
        return ContextBlock(node.node_id, node.title, text, relevance, role)

    def build_simple(self, matches: list[tuple[str, float]]) -> list[ContextBlock]:
        blocks = []
        for node_id, rel in sorted(matches, key=lambda m: -m[1]):
            node = self.page_index.get_node(node_id)
            if node and (b := self._block(node, rel, "primary")):
                blocks.append(b)
        return blocks

    def build_hierarchy(self, matches: list[tuple[str, float]]) -> list[ContextBlock]:
        blocks = self.build_simple(matches)
        seen = {b.node_id for b in blocks}
        extra: list[ContextBlock] = []
        for node_id, rel in matches:
            parent = self.page_index.get_parent(node_id)
            if parent and parent.node_id not in seen:
                if b := self._block(parent, rel * 0.7, "parent"):
                    extra.append(b)
                    seen.add(parent.node_id)
            for sib in self.page_index.get_siblings(node_id)[:2]:
                if sib.node_id not in seen:
                    if b := self._block(sib, rel * 0.6, "sibling"):
                        extra.append(b)
                        seen.add(sib.node_id)
        return blocks + extra

    def build_comparison(self, matches: list[tuple[str, float]]) -> list[ContextBlock]:
        blocks = self.build_hierarchy(matches)
        primaries = [b for b in blocks if b.role == "primary"]
        others = [b for b in blocks if b.role != "primary"]
        return primaries[:2] + others + primaries[2:]

    @staticmethod
    def apply_token_budget(blocks: list[ContextBlock], budget: int) -> list[ContextBlock]:
        """Primary and parent blocks stay whatever the budget; the others
        join by relevance while they fit; the result keeps ``blocks``' order."""
        must_keep = [b for b in blocks if b.role in ("primary", "parent")]
        optional = [b for b in blocks if b.role not in ("primary", "parent")]
        kept: list[ContextBlock] = list(must_keep)
        used = sum(b.token_estimate for b in must_keep)
        for block in sorted(optional, key=lambda b: -b.relevance):
            tokens = block.token_estimate
            if used + tokens > budget:
                continue
            kept.append(block)
            used += tokens
        order = {id(b): i for i, b in enumerate(blocks)}
        kept.sort(key=lambda b: order[id(b)])
        return kept

    def build_adaptive(
        self, query: str, matches: list[tuple[str, float]], *, token_budget: int = 3000
    ) -> tuple[list[ContextBlock], QueryType]:
        qtype = classify_query_type(query)
        if qtype is QueryType.COMPARISON:
            blocks = self.build_comparison(matches)
        elif qtype in (QueryType.ANALYTICAL, QueryType.DEFINITION):
            blocks = self.build_hierarchy(matches)
        else:
            blocks = self.build_simple(matches)
        return self.apply_token_budget(blocks, token_budget), qtype


def format_blocks(blocks: list[ContextBlock]) -> str:
    """LLM-ready text: each block under a ``[title (role)]`` header."""
    out = []
    for b in blocks:
        tag = "" if b.role == "primary" else f" ({b.role})"
        out.append(f"[{b.title}{tag}]\n{b.text}")
    return "\n\n".join(out)
