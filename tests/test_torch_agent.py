"""The port's page-aware agent against the JAX package's.

The normalizer, the intent classifier, the intent table and the page-score
gate give the JAX answers on the same inputs. Then both packages' services
ingest the same seeded documents (hash embeddings, equal in both packages;
an f32 store) and ``PageAwareAgent.query`` with the extractive fake LLM
answers each question alike: the same answer, intent, confidence,
validation, state dump and pages, relevance scores to 2e-4 (the retrieval
tolerance of the query slice). The agent's retriever gets no reranker, as
in the JAX package, even when the service reranks ``/query``."""

from __future__ import annotations

import pytest
import torch

from test_torch_ingest import _document, _multipart

torch.set_num_threads(2)

UPLOADS = [("doc-a", "alpha", 11, 4), ("doc-b", "alpha", 12, 3), ("doc-c", "beta", 13, 3)]  # id, project, seed, pages
SCORE_TOL = 2e-4
QUERIES = [
    "Could you please tell me the warranty period?",
    "  can you   summarize the gist of the report  ",
    "compare plan A versus plan B",
    "what is the difference between revenue and balance",
    "how does the supplier contract work?",
    "why is the shipping late",
    "what does balance mean for the account",
    "tl;dr of the quarter",
    "warranty period",
    "",
]


@pytest.mark.parametrize("query", QUERIES)
def test_normalizer_and_intent_equal_jax(query):
    from intool_rag_tpu.agent import steps as jsteps
    from intool_rag_tpu_torch.agent import steps as tsteps

    want = jsteps.QueryNormalizer().normalize(query)
    assert tsteps.QueryNormalizer().normalize(query) == want
    assert tsteps.IntentClassifier().classify(want).value == jsteps.IntentClassifier().classify(want).value


def test_intent_table_and_gate_equal_jax():
    from intool_rag_tpu.agent import state as jstate
    from intool_rag_tpu_torch.agent import state as tstate
    from intool_rag_tpu_torch.query.retriever import PageRanking

    assert {k.value: v for k, v in tstate.INTENT_CONFIG.items()} == \
        {k.value: v for k, v in jstate.INTENT_CONFIG.items()}
    assert [i.value for i in tstate.QueryIntent] == [i.value for i in jstate.QueryIntent]
    assert tstate.MIN_PAGE_SCORE == jstate.MIN_PAGE_SCORE == 0.3
    for scores in ([], [0.1], [0.29999, 0.2], [0.3], [0.1, 0.7]):
        tst, jst = tstate.AgentState(raw_query="q"), jstate.AgentState(raw_query="q")
        tst.selected_pages = [PageRanking(doc_id="d", page=0, score=s, chunks=[]) for s in scores]
        jst.selected_pages = tst.selected_pages
        assert tst.is_valid_to_answer() == jst.is_valid_to_answer() == any(s >= 0.3 for s in scores)
    assert set(tstate.AgentState(raw_query="q").dump()) == set(jstate.AgentState(raw_query="q").dump())


class _Reverser:
    """A stand-in cross-encoder that reverses the hits and counts its calls."""

    def __init__(self):
        self.calls = 0

    def rerank(self, query, hits, top_k=None):
        self.calls += 1
        out = [dict(h, rerank_score=float(i)) for i, h in enumerate(hits)]
        return out[: top_k or len(out)]


@pytest.fixture(scope="module")
def services(tmp_path_factory):
    """(JAX service, the port's service, the port's reranker) over the same uploads."""
    from intool_rag_tpu import config as jconfig
    from intool_rag_tpu.index.registry import CorpusRegistry as JRegistry
    from intool_rag_tpu.llm.semantic import factory as jfactory
    from intool_rag_tpu.providers.fake import FakeLLM as JFake
    from intool_rag_tpu.providers.hash_embed import HashEmbeddingProvider as JHash
    from intool_rag_tpu.service.app import RAGService as JService
    from intool_rag_tpu_torch import config as tconfig
    from intool_rag_tpu_torch.llm.semantic import factory as tfactory
    from intool_rag_tpu_torch.providers.fake import FakeLLM
    from intool_rag_tpu_torch.providers.hash_embed import HashEmbeddingProvider
    from intool_rag_tpu_torch.service.app import RAGService as TService

    mp = pytest.MonkeyPatch()
    jdir, tdir = tmp_path_factory.mktemp("jax_agent"), tmp_path_factory.mktemp("torch_agent")
    for key, val in {"LLM_PROVIDER": "fake", "RERANKER_ENABLED": "0", "OCR_ENABLED": "0",
                     "INDEX_DTYPE": "float32", "SHARDED_SEARCH": "off", "CHUNK_MAX_CHARS": "400",
                     "CHUNK_TARGET_CHARS": "250", "CHUNK_MIN_CHARS": "50"}.items():
        mp.setenv(key, val)
    reranker = _Reverser()
    try:
        mp.setenv("STORAGE_DIR", str(jdir))
        mp.setenv("CACHE_DIR", str(jdir / "cache"))
        jconfig.reset_config()
        jfactory.reset_semantic_analyzer()
        jservice = JService(registry=JRegistry(), llm=JFake(), provider=JHash(64))
        mp.setenv("STORAGE_DIR", str(tdir))
        mp.setenv("CACHE_DIR", str(tdir / "cache"))
        tconfig.reset_config()
        tfactory.reset_semantic_analyzer()
        tservice = TService(HashEmbeddingProvider(64), device="cpu", llm=FakeLLM(), reranker=reranker)
        for service in (jservice, tservice):
            for doc_id, project, seed, pages in UPLOADS:
                body, ctype = _multipart([("file", f"{doc_id}.txt", "\f".join(_document(seed, pages)).encode())])
                status, out = service.handle("POST", f"/ingest?project={project}&doc_id={doc_id}", body, ctype)
                assert status == 200 and out["success"], out
        yield jservice, tservice, reranker
    finally:
        mp.undo()
        jconfig.reset_config()
        tconfig.reset_config()
        jfactory.reset_semantic_analyzer()
        tfactory.reset_semantic_analyzer()


def same_agent_answer(got: dict, want: dict) -> None:
    """Equal agent bodies but for the time taken; relevance scores to SCORE_TOL."""
    assert set(got) == set(want)
    for key in set(want) - {"execution_time_ms", "source", "all_sources"}:
        assert got[key] == want[key], key
    assert (got["source"] is None) == (want["source"] is None)
    pairs = list(zip(got["all_sources"], want["all_sources"]))
    assert len(got["all_sources"]) == len(want["all_sources"])
    if want["source"] is not None:
        pairs.append((got["source"], want["source"]))
    for g, w in pairs:
        assert {k: v for k, v in g.items() if k != "relevance_score"} == \
            {k: v for k, v in w.items() if k != "relevance_score"}
        assert g["relevance_score"] == pytest.approx(w["relevance_score"], abs=SCORE_TOL)


def agent_questions() -> list[tuple[str, str | None]]:
    """A quoted sentence of each document (lookup), questions of each other
    intent, and one filtered by project."""
    out = [(_document(seed, pages)[1].split("\n")[4].split(".")[0], None) for _, _, seed, pages in UPLOADS]
    out += [("how does the supplier contract work", None), ("summarize the revenue and quarter", None),
            ("compare shipping versus delivery terms", None), ("invoice total amount", "beta")]
    return out


def test_agent_query_equals_jax(services, monkeypatch):
    from intool_rag_tpu.agent import PageAwareAgent as JAgent
    from intool_rag_tpu.providers.fake import FakeLLM as JFake
    from intool_rag_tpu.providers.hash_embed import HashEmbeddingProvider as JHash
    from intool_rag_tpu_torch import config as tconfig
    from intool_rag_tpu_torch.agent import PageAwareAgent
    from intool_rag_tpu_torch.providers.fake import FakeLLM
    from intool_rag_tpu_torch.providers.hash_embed import HashEmbeddingProvider

    jservice, tservice, reranker = services
    jagent = JAgent(jservice.registry, llm=JFake(), provider=JHash(64))
    tagent = PageAwareAgent(tservice.registry, llm=FakeLLM(), provider=HashEmbeddingProvider(64))
    monkeypatch.setenv("RERANKER_ENABLED", "1")  # the service would rerank /query; the agent does not
    tconfig.reset_config()
    try:
        calls = reranker.calls
        intents = set()
        for question, project in agent_questions():
            want = jagent.query(question, project=project)
            got = tagent.query(question, project=project)
            same_agent_answer(got, want)
            intents.add(got["intent"])
            assert got["state"]["steps"][-1] == "validate" and got["answer"]
        assert intents == {"lookup", "explain", "summarize", "compare"}
        assert reranker.calls == calls and tagent.searcher.retriever._reranker is None
        first = agent_questions()[0][0]
        got = tagent.query(first)
        assert first in got["answer"] and got["source"]["source_file"] == "doc-a.txt"
    finally:
        tconfig.reset_config()


def test_agent_route_builds_one_unreranked_agent(services, monkeypatch):
    from intool_rag_tpu_torch import config as tconfig

    _, tservice, reranker = services
    monkeypatch.setenv("RERANKER_ENABLED", "1")
    tconfig.reset_config()
    try:
        calls = reranker.calls
        status, body = tservice.handle("POST", "/agent/query", b'{"question": "warranty payment terms"}')
        assert status == 200 and body["state"]["steps"][0] == "normalize"
        agent = tservice._agent
        assert tservice.handle("POST", "/agent/query", b'{"question": "payment"}')[0] == 200
        assert tservice._agent is agent and reranker.calls == calls
        assert tservice.handle("POST", "/agent/query", b'{"top_pages": 2}')[0] == 400
        assert tservice.handle("GET", "/agent/health") == (200, {"status": "ok", "pipeline": "page-aware-agent"})
    finally:
        tconfig.reset_config()


def test_agent_gate_on_an_empty_corpus_equals_jax(tmp_path, monkeypatch):
    from intool_rag_tpu import config as jconfig
    from intool_rag_tpu.agent import PageAwareAgent as JAgent
    from intool_rag_tpu.index.registry import CorpusRegistry as JRegistry
    from intool_rag_tpu.providers.fake import FakeLLM as JFake
    from intool_rag_tpu.providers.hash_embed import HashEmbeddingProvider as JHash
    from intool_rag_tpu_torch import config as tconfig
    from intool_rag_tpu_torch.agent import PageAwareAgent
    from intool_rag_tpu_torch.index.registry import CorpusRegistry
    from intool_rag_tpu_torch.providers.fake import FakeLLM
    from intool_rag_tpu_torch.providers.hash_embed import HashEmbeddingProvider

    monkeypatch.setenv("STORAGE_DIR", str(tmp_path))
    jconfig.reset_config()
    tconfig.reset_config()
    try:
        want = JAgent(JRegistry(), llm=JFake(), provider=JHash(32)).query("anything?")
        got = PageAwareAgent(CorpusRegistry(device="cpu"), llm=FakeLLM(), provider=HashEmbeddingProvider(32)) \
            .query("anything?")
        same_agent_answer(got, want)
        assert "gate:rejected" in got["state"]["steps"] and got["confidence"] == "low"
    finally:
        jconfig.reset_config()
        tconfig.reset_config()
