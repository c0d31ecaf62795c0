"""The agent's 11 steps in order (port of
``intool_rag_tpu/agent/orchestrator.py``): normalize, classify, search
(load and group), select, gate, assemble, generate, validate, format."""

from __future__ import annotations

from ..index.registry import CorpusRegistry, get_registry
from ..llm.base import BaseLLM
from ..llm.factory import get_llm
from ..query.retriever import PageLevelRetriever
from .state import INTENT_CONFIG, AgentState
from .steps import (
    AnswerGenerator, ContextAssembler, Formatter, IntentClassifier, PageSelector, QueryNormalizer, Searcher,
    Validator,
)

_NO_ANSWER = "I could not find sufficiently relevant pages to answer this question."


class PageAwareAgent:
    """``registry`` defaults to the process's, ``llm`` and ``provider`` to
    the factories'. The retriever gets no reranker, as in the JAX package:
    the agent path does not rerank, whatever ``RERANKER_ENABLED`` says."""

    def __init__(self, registry: CorpusRegistry | None = None, llm: BaseLLM | None = None, provider=None) -> None:
        registry = registry or get_registry()
        if provider is None:
            from ..llm.embeddings.factory import get_embedding_provider

            provider = get_embedding_provider(registry.device)
        retriever = PageLevelRetriever(registry, provider)
        self.normalizer = QueryNormalizer()
        self.classifier = IntentClassifier()
        self.searcher = Searcher(retriever)
        self.selector = PageSelector()
        self.assembler = ContextAssembler(registry=retriever.registry)
        self.generator = AnswerGenerator(llm or get_llm(registry.device))
        self.validator = Validator()
        self.formatter = Formatter()

    def query(self, question: str, *, project: str | None = None) -> dict:
        state = AgentState(raw_query=question)

        state.normalized_query = self.normalizer.normalize(question)
        state.log_step("normalize")

        state.intent = self.classifier.classify(state.normalized_query)
        state.retrieval_config = dict(INTENT_CONFIG[state.intent])
        state.log_step(f"intent:{state.intent.value}")

        self.searcher.run(state, project)
        state.log_step("search+load+group")

        self.selector.run(state)
        state.log_step("select")

        if not state.is_valid_to_answer():
            state.answer = _NO_ANSWER
            state.answer_confidence = "low"
            state.log_step("gate:rejected")
            return self.formatter.run(state)

        self.assembler.run(state)
        state.log_step("assemble")

        self.generator.run(state)
        state.log_step("generate")

        self.validator.run(state)
        state.log_step("validate")

        return self.formatter.run(state)
