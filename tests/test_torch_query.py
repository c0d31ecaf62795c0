"""The ``/query`` host modules against the JAX package's on the same
inputs: the context builder (strategies and token budget), the prompt
templates, context assembly and citations (``build_rag_prompt``,
``create_page_aware_response``, the confidence), the extractive fake LLM,
the two disk caches and the dependency container. All host code: results
must be equal, not close."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from intool_rag_tpu.ingest import schemas as jschemas
from intool_rag_tpu.query import context as jcontext
from intool_rag_tpu.query import prompts as jprompts
from intool_rag_tpu.query import response as jresponse
from intool_rag_tpu.query import retriever as jretriever
from intool_rag_tpu_torch.ingest import schemas as tschemas
from intool_rag_tpu_torch.query import context as tcontext
from intool_rag_tpu_torch.query import prompts as tprompts
from intool_rag_tpu_torch.query import response as tresponse
from intool_rag_tpu_torch.query import retriever as tretriever

NODES = [  # (id, title, level, page, parent, children)
    ("n_000", "Doc", "document", 0, None, ["n_001", "n_005"]),
    ("n_001", "Policies", "chapter", 0, "n_000", ["n_002", "n_003", "n_004"]),
    ("n_002", "Warranty", "section", 0, "n_001", []),
    ("n_003", "Returns", "section", 1, "n_001", []),
    ("n_004", "Repairs", "section", 1, "n_001", []),
    ("n_005", "Appendix", "chapter", 2, "n_000", []),
]
TEXTS = {
    "n_001": "Policies chapter text " * 40,
    "n_002": "Warranty is 24 months on parts. " * 30,
    "n_003": "Returns within 30 days with receipt. " * 30,
    "n_004": "Repairs are free in the first year. " * 30,
    "n_005": "Appendix content " * 20,
}
QUESTIONS = ["compare warranty versus returns", "what is the warranty?", "how do repairs work",
             "warranty period", "define returns"]
MATCHES = [[("n_002", 0.9)], [("n_003", 0.7), ("n_002", 0.95)], [("n_004", 0.5), ("n_005", 0.4)],
           [("n_002", 0.9), ("n_003", 0.8), ("n_004", 0.6)]]


def _tree(pkg):
    nodes = [pkg.SemanticNode(i, t, pkg.NodeLevel(lv), p, parent_id=par, children=list(ch),
                              summary=f"summary of {t}") for i, t, lv, p, par, ch in NODES]
    return pkg.PageIndex(doc_id="d", source_file="d.pdf", page_count=3, nodes=nodes)


def _blocks(blocks):
    return [dataclasses.astuple(b) for b in blocks]


@pytest.mark.parametrize("question", QUESTIONS)
@pytest.mark.parametrize("budget", [80, 3000])
def test_context_builder_matches_jax(question, budget):
    assert tcontext.classify_query_type(question).value == jcontext.classify_query_type(question).value
    jb = jcontext.ContextBuilder(_tree(jschemas), TEXTS)
    tb = tcontext.ContextBuilder(_tree(tschemas), TEXTS)
    for matches in MATCHES:
        want, wtype = jb.build_adaptive(question, matches, token_budget=budget)
        got, gtype = tb.build_adaptive(question, matches, token_budget=budget)
        assert gtype.value == wtype.value
        assert _blocks(got) == _blocks(want)
        assert tcontext.format_blocks(got) == jcontext.format_blocks(want)
        for strategy in ("build_simple", "build_hierarchy", "build_comparison"):
            assert _blocks(getattr(tb, strategy)(matches)) == _blocks(getattr(jb, strategy)(matches))


def test_token_budget_keeps_primary_and_parent():
    tb = tcontext.ContextBuilder(_tree(tschemas), TEXTS)
    blocks = tb.build_hierarchy([("n_002", 0.9), ("n_003", 0.8)])
    kept = tcontext.ContextBuilder.apply_token_budget(blocks, 10)
    assert {b.role for b in kept} == {"primary", "parent"}
    assert [b.node_id for b in kept] == [b.node_id for b in blocks if b.role != "sibling"]
    assert len(tcontext.ContextBuilder.apply_token_budget(blocks, 10_000)) == len(blocks)


def test_prompt_templates_equal():
    for name in ("RAG_CONTEXT_TEMPLATE", "SUMMARIZATION_TEMPLATE", "INTENT_CLASSIFICATION_TEMPLATE",
                 "ANSWER_GENERATION_TEMPLATE", "PAGE_AWARE_ANSWER_TEMPLATE"):
        assert getattr(tprompts, name) == getattr(jprompts, name)
    assert tprompts.get_rag_prompt("q?", "ctx") == jprompts.get_rag_prompt("q?", "ctx")
    assert tprompts.get_page_aware_prompt("q?", "ctx") == jprompts.get_page_aware_prompt("q?", "ctx")
    assert tprompts.get_intent_prompt("q?") == jprompts.get_intent_prompt("q?")
    assert tprompts.get_summarization_prompt("t", 2) == jprompts.get_summarization_prompt("t", 2)


def _rankings(pkg, scores):
    """Pages with chunks (out of chunk-id order), citations, one without a
    title, one whose section repeats its title."""
    rng = np.random.default_rng(len(scores))
    out = []
    for i, score in enumerate(scores):
        chunks = [pkg.RetrievedChunk("d", f"c_{i:03d}_{j:03d}", i,
                                     f"Sentence {j} of page {i} about the warranty. " * int(rng.integers(3, 30)),
                                     float(score)) for j in (2, 0, 1)]
        out.append(pkg.PageRanking("d", i, float(score), chunks, source_file="d.pdf" if i % 2 else "",
                                   chapter="Policies", section=None if i == 2 else f"Section {i}",
                                   subsection="Sub" if i == 1 else None,
                                   title=None if i == 3 else (f"Section {i}" if i == 1 else f"Title {i}")))
    return out


@pytest.mark.parametrize("scores", [[0.95, 0.9, 0.85], [0.7, 0.65, 0.6, 0.55], [0.3, 0.2], [0.61]])
@pytest.mark.parametrize("max_len", [None, 600, 1500, 100_000])
def test_prompt_and_response_match_jax(monkeypatch, scores, max_len):
    want_pages, got_pages = _rankings(jretriever, scores), _rankings(tretriever, scores)
    assert [p.context_text for p in got_pages] == [p.context_text for p in want_pages]
    assert tresponse.build_rag_prompt("How long?", got_pages, max_len) == \
        jresponse.build_rag_prompt("How long?", want_pages, max_len)
    answer = "It is two years."
    want = jresponse.create_page_aware_response(answer, want_pages)
    got = tresponse.create_page_aware_response(answer, got_pages)
    assert got == want
    assert tresponse.estimate_confidence(got_pages) == jresponse.estimate_confidence(want_pages)
    assert tresponse.estimate_confidence([]) == "low"


def test_fake_llm_matches_jax():
    from intool_rag_tpu.providers.fake import FakeLLM as JFake
    from intool_rag_tpu_torch.providers.fake import FakeLLM

    pages = _rankings(tretriever, [0.9, 0.8])
    prompts = [tresponse.build_rag_prompt(q, pages) for q in ("warranty page", "sentence 2?", "zebra")]
    prompts += ["no layout here. just text about the warranty.", ""]
    for prompt in prompts:
        assert FakeLLM().generate(prompt) == JFake().generate(prompt)
    assert FakeLLM(max_sentences=1).generate(prompts[0]) == JFake(max_sentences=1).generate(prompts[0])


def test_embedding_cache_and_caching_provider_match_jax(tmp_path, monkeypatch):
    from intool_rag_tpu.storage.cache import CachingEmbeddingProvider as JCaching
    from intool_rag_tpu.storage.cache import EmbeddingCache as JEmbeddingCache
    from intool_rag_tpu_torch import config
    from intool_rag_tpu_torch.providers.hash_embed import HashEmbeddingProvider
    from intool_rag_tpu_torch.storage.cache import CachingEmbeddingProvider, EmbeddingCache

    monkeypatch.setenv("EMBEDDING_QUERY_INSTRUCTION", "q: ")
    config.reset_config()
    calls = []

    class Counting(HashEmbeddingProvider):
        def embed_batch(self, texts, *, is_query=False):
            calls.append(list(texts))
            return super().embed_batch(texts, is_query=is_query)

    inner = Counting(dimension=32)
    cache = EmbeddingCache(tmp_path / "c")
    provider = CachingEmbeddingProvider(inner, cache)
    first = provider.embed_batch(["a", "b", "c"])
    again = provider.embed_batch(["b", "d", "a"])
    assert calls == [["a", "b", "c"], ["d"]] and (cache.hits, cache.misses) == (2, 4)
    np.testing.assert_array_equal(again[[0, 2]], first[[1, 0]])
    np.testing.assert_array_equal(provider.embed_batch(["a"], is_query=True), inner.embed_batch(["a"], is_query=True))
    assert len(calls) == 4  # a query is another key
    # the same file names as the JAX cache: a JAX cache directory is read as is
    jprov = JCaching(inner, JEmbeddingCache(tmp_path / "c"))
    np.testing.assert_array_equal(jprov.embed_batch(["a", "b", "c", "d"]), provider.embed_batch(["a", "b", "c", "d"]))
    assert len(calls) == 4 and provider.dimension == 32 and provider.model_name == inner.model_name
    (next(cache.dir.glob("*.npy"))).write_bytes(b"")  # a torn file is embedded again
    assert provider.embed_batch(["a", "b", "c", "d"]).shape == (4, 32) and len(calls) == 5
    assert cache.clear() == 5
    config.reset_config()


def test_query_result_cache_keys_match_jax(tmp_path):
    from intool_rag_tpu.storage.cache import QueryResultCache as JCache
    from intool_rag_tpu_torch.storage.cache import QueryResultCache

    cache, jcache = QueryResultCache(tmp_path), JCache(tmp_path)
    result = {"answer": "ünïcode €", "sources": [{"page": 1}], "confidence": "low"}
    cache.put("q", "p", "5|8000", 3, result)
    assert jcache.get("q", "p", "5|8000", 3) == result == cache.get("q", "p", "5|8000", 3)
    for key in (("q", "p", "5|8000", 4), ("q", "", "5|8000", 3), ("q", "p", "3|8000", 3), ("Q", "p", "5|8000", 3)):
        assert cache.get(*key) is None
    assert (cache.hits, cache.misses) == (1, 4)
    next(cache.dir.glob("*.json")).write_text("{torn")
    assert cache.get("q", "p", "5|8000", 3) is None and not list(cache.dir.glob("*.json"))
    assert cache.clear() == 0


def test_container_builds_lazily_once_and_shuts_down(tmp_path, monkeypatch):
    from intool_rag_tpu_torch import config
    from intool_rag_tpu_torch.core import get_container, reset_container
    from intool_rag_tpu_torch.index import registry
    from intool_rag_tpu_torch.llm import factory
    from intool_rag_tpu_torch.llm.embeddings import factory as efactory
    from intool_rag_tpu_torch.providers import http_utils
    from intool_rag_tpu_torch.providers.fake import FakeLLM
    from intool_rag_tpu_torch.providers.hash_embed import HashEmbeddingProvider

    monkeypatch.setenv("LLM_PROVIDER", "fake")
    monkeypatch.setenv("EMBEDDING_PROVIDER", "hash")
    monkeypatch.setenv("STORAGE_DIR", str(tmp_path))
    config.reset_config()
    for reset in (factory.reset_llm, efactory.reset_embedding_provider, registry.reset_registry, reset_container):
        reset()
    try:
        c = get_container("cpu")
        assert c is get_container() and c._llm is None and c._registry is None
        assert isinstance(c.get_llm_provider(), FakeLLM) and c.get_llm_provider() is c.get_llm_provider()
        assert isinstance(c.get_embedding_provider(), HashEmbeddingProvider)
        reg = c.get_registry()
        assert reg is c.get_registry() and reg.device.type == "cpu" and reg.stats()["documents"] == 0
        assert c.get_http_client() is http_utils
        reset_container()
        assert c._llm is None and c._registry is None and get_container() is not c
    finally:
        for reset in (factory.reset_llm, efactory.reset_embedding_provider, registry.reset_registry,
                      reset_container):
            reset()
        config.reset_config()
