"""Deterministic offline generation: the extractive fake LLM (port of
``intool_rag_tpu/providers/fake.py``).

Given a RAG prompt (``query/prompts.py``), it answers with the context's
sentences that share the most terms with the question, or a fixed string
when none does. No network and no device; service tests assert on it.
"""

from __future__ import annotations

import re

from ..index.analyzer import tokenize
from ..llm.base import BaseLLM

_SENT_SPLIT = re.compile(r"(?<=[.!?。！？])\s+")
_NOTHING = "I could not find relevant information in the context."


class FakeLLM(BaseLLM):
    def __init__(self, max_sentences: int = 3) -> None:
        self.max_sentences = max_sentences

    def generate(self, prompt: str, **kwargs) -> str:
        question, context = _split_prompt(prompt)
        q_terms = set(tokenize(question))
        # context block headers ("[Page N | ...]") are not answers
        context = re.sub(r"(?m)^\[[^\]\n]{0,160}\]\s*", "", context)
        if not q_terms or not context:
            return _NOTHING
        scored: list[tuple[int, str]] = []
        for sent in _SENT_SPLIT.split(context):
            overlap = len(q_terms & set(tokenize(sent)))
            if overlap:
                scored.append((overlap, sent.strip()))
        scored.sort(key=lambda t: -t[0])  # stable: ties keep the context's order
        if not scored:
            return _NOTHING
        return " ".join(s for _, s in scored[: self.max_sentences])

    def is_ready(self) -> bool:
        return True

    def get_info(self) -> dict:
        return {"provider": "fake", "mode": "extractive"}


def _split_prompt(prompt: str) -> tuple[str, str]:
    """Question and context of the standard RAG prompt; the whole prompt
    is the context when the layout differs."""
    q_match = re.search(r"(?is)question:\s*(.+?)(?:\n\n|answer:|$)", prompt)
    c_match = re.search(r"(?is)context:\s*(.+?)(?:\n\nquestion:|$)", prompt)
    question = q_match.group(1).strip() if q_match else prompt[-500:]
    context = c_match.group(1).strip() if c_match else prompt
    return question, context
