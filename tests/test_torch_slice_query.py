"""The ``/query`` slice as a whole: the port's service against the JAX
package's on one corpus. Both ingest the same uploads through
``POST /ingest`` with the same tiny f32 encoder weights (carried across
as in ``test_torch_slice_ingest.py``), each into its own ``STORAGE_DIR``
and ``CACHE_DIR``, then answer the same ``POST /query`` requests:

- with the extractive fake LLM: equal ``answer``, equal ``sources``
  (relevance scores to 2e-4, the slice's retrieval tolerance) and equal
  ``confidence``; a repeated request is a cache hit with an equal body;
- ``stream: true``: the same server-sent event sequence (``sources``,
  ``token``…, ``done``), also over HTTP from the port's server;
- with the tiny decoder carried across (f32, temperature 0): equal answers;
- on an empty corpus: the same "could not find" answer.
"""

from __future__ import annotations

import dataclasses
import json
import urllib.request

import jax
import numpy as np
import pytest
import torch

from test_torch_ingest import _document, _multipart

torch.set_num_threads(2)

UPLOADS = [("doc-a", "alpha", 1, 4), ("doc-b", "alpha", 2, 3), ("doc-c", "beta", 3, 3)]  # id, project, seed, pages
SCORE_TOL = 2e-4


def _pages(seed: int, pages: int) -> list[str]:
    return _document(seed, pages)


@pytest.fixture(scope="module")
def services(tmp_path_factory):
    """(JAX service, the port's service), same encoder weights, fake LLMs."""
    from intool_rag_tpu import config as jconfig
    from intool_rag_tpu.index.registry import CorpusRegistry as JRegistry
    from intool_rag_tpu.llm.semantic import factory as jfactory
    from intool_rag_tpu.models import encoder as jenc
    from intool_rag_tpu.providers.fake import FakeLLM as JFake
    from intool_rag_tpu.providers.tpu_embed import TPUEmbeddingProvider
    from intool_rag_tpu.service.app import RAGService as JService
    from intool_rag_tpu_torch import config as tconfig
    from intool_rag_tpu_torch.llm.semantic import factory as tfactory
    from intool_rag_tpu_torch.models import encoder as tenc
    from intool_rag_tpu_torch.providers.cuda_embed import CudaEmbeddingProvider
    from intool_rag_tpu_torch.providers.fake import FakeLLM
    from intool_rag_tpu_torch.service.app import RAGService as TService

    mp = pytest.MonkeyPatch()
    jdir, tdir = tmp_path_factory.mktemp("jax_query"), tmp_path_factory.mktemp("torch_query")
    for key, val in {"LLM_PROVIDER": "fake", "RERANKER_ENABLED": "0", "OCR_ENABLED": "0",
                     "INDEX_DTYPE": "float32", "SHARDED_SEARCH": "off", "EMBED_PACKED": "0",
                     "EMBEDDING_QUERY_INSTRUCTION": "", "CHUNK_MAX_CHARS": "400", "CHUNK_TARGET_CHARS": "250",
                     "CHUNK_MIN_CHARS": "50", "BM25_WEIGHT": "0.7", "VECTOR_WEIGHT": "0.3",
                     "EMBEDDING_MODEL": "tiny-test", "HF_HUB_OFFLINE": "1", "TRANSFORMERS_OFFLINE": "1"}.items():
        mp.setenv(key, val)
    cfg = jenc.EncoderConfig.tiny()
    params = jenc.init_params(cfg, seed=4)
    model = tenc.TextEncoder(tenc.EncoderConfig.tiny(), device="cpu")
    model.load_state_dict(tenc.params_from_jax(jax.tree.map(np.asarray, params)))
    try:
        mp.setenv("STORAGE_DIR", str(jdir))
        mp.setenv("CACHE_DIR", str(jdir / "cache"))
        jconfig.reset_config()
        jfactory.reset_semantic_analyzer()
        jservice = JService(registry=JRegistry(), llm=JFake(),
                            provider=TPUEmbeddingProvider(config=cfg, params=params, model_name="tiny-test"))
        mp.setenv("STORAGE_DIR", str(tdir))
        mp.setenv("CACHE_DIR", str(tdir / "cache"))
        tconfig.reset_config()
        tfactory.reset_semantic_analyzer()
        tservice = TService(CudaEmbeddingProvider(model, model_name="tiny-test"), device="cpu", llm=FakeLLM())
        for service in (jservice, tservice):
            for doc_id, project, seed, pages in UPLOADS:
                body, ctype = _multipart([("file", f"{doc_id}.txt", "\f".join(_pages(seed, pages)).encode())])
                status, out = service.handle("POST", f"/ingest?project={project}&doc_id={doc_id}", body, ctype)
                assert status == 200 and out["success"], out
        yield jservice, tservice
    finally:
        mp.undo()
        jconfig.reset_config()
        tconfig.reset_config()
        jfactory.reset_semantic_analyzer()
        tfactory.reset_semantic_analyzer()


def _questions() -> list[dict]:
    """A sentence quoted from each document, a keyword question, one
    filtered by project and one with other page and context limits."""
    out = []
    for doc_id, project, seed, pages in UPLOADS:
        sentence = _pages(seed, pages)[1].split("\n")[4].split(".")[0]
        out.append({"question": sentence})
    out.append({"question": "warranty payment terms"})
    out.append({"question": "supplier contract delivery", "project": "beta"})
    out.append({"question": "invoice total amount", "top_pages": 2, "max_context_length": 900})
    return out


def _query(service, request: dict):
    status, out = service.handle("POST", "/query", json.dumps(request).encode(), "application/json")
    assert status == 200, out
    return out


def _same_answer(got: dict, want: dict) -> None:
    assert set(got) == set(want) == {"answer", "sources", "confidence"}
    assert got["answer"] == want["answer"]
    assert got["confidence"] == want["confidence"]
    assert len(got["sources"]) == len(want["sources"])
    for g, w in zip(got["sources"], want["sources"]):
        assert {k: v for k, v in g.items() if k != "relevance_score"} == \
            {k: v for k, v in w.items() if k != "relevance_score"}
        assert g["relevance_score"] == pytest.approx(w["relevance_score"], abs=SCORE_TOL)


def test_query_with_fake_llm_matches_jax(services):
    jservice, tservice = services
    for request in _questions():
        want, got = _query(jservice, request), _query(tservice, request)
        _same_answer(got, want)
        assert got["sources"] and got["answer"]
    # a quoted sentence comes back in the answer, its document first among the sources
    first = _questions()[0]["question"]
    got = _query(tservice, {"question": first})
    assert first in got["answer"] and got["sources"][0]["source_file"] == "doc-a.txt"


def test_repeated_query_is_a_cache_hit(services):
    _, tservice = services
    from intool_rag_tpu_torch.observability import collect_spans

    request = {"question": "shipping balance account"}
    with collect_spans() as answered:
        first = _query(tservice, request)
    hits = tservice.query_cache.hits
    with collect_spans() as cached:
        assert _query(tservice, request) == first
    assert tservice.query_cache.hits == hits + 1 and not [s for s in cached if s.name.startswith("query.")]
    phases = {s.name: s.trace for s in answered if s.name.startswith("query.")}
    assert set(phases) == {"query.retrieve", "query.generate"} and len(set(phases.values())) == 1


def _events(stream) -> list[tuple[str, object]]:
    out = []
    for raw in stream:
        for block in raw.strip().split("\n\n"):
            name, data = block.split("\n")
            out.append((name.removeprefix("event: "), json.loads(data.removeprefix("data: "))))
    return out


def test_streamed_query_matches_jax_and_is_served_as_sse(services):
    from intool_rag_tpu_torch.service.http import ServiceServer

    jservice, tservice = services
    request = {"question": _questions()[1]["question"], "stream": True}
    want = _events(_query(jservice, request)["__stream__"])
    got = _events(_query(tservice, request)["__stream__"])
    assert [n for n, _ in got] == [n for n, _ in want] and got[0][0] == "sources" and got[-1][0] == "done"
    assert sum(n == "token" for n, _ in got) >= 1
    _same_answer({"answer": "", "sources": got[0][1], "confidence": ""},
                 {"answer": "", "sources": want[0][1], "confidence": ""})
    assert got[1:] == want[1:]
    server = ServiceServer(tservice, host="127.0.0.1", port=0)
    server.start_background()
    try:
        req = urllib.request.Request(f"http://127.0.0.1:{server.port}/query", data=json.dumps(request).encode(),
                                     headers={"Content-Type": "application/json"}, method="POST")
        with urllib.request.urlopen(req, timeout=60) as resp:
            assert resp.headers["Content-Type"].startswith("text/event-stream")
            over_http = _events([resp.read().decode()])
        req = urllib.request.Request(f"http://127.0.0.1:{server.port}/query",
                                     data=json.dumps({"question": request["question"]}).encode(),
                                     headers={"Content-Type": "application/json"}, method="POST")
        with urllib.request.urlopen(req, timeout=60) as resp:
            plain = json.loads(resp.read())
    finally:
        server.shutdown()
    assert over_http == got
    assert "".join(d["text"] for n, d in got if n == "token") == plain["answer"]


def test_streamed_llm_failure_is_an_error_event(services):
    from intool_rag_tpu_torch.llm.base import BaseLLM

    class Broken(BaseLLM):
        def generate(self, prompt, **kwargs):
            raise RuntimeError("the card fell over")

        def is_ready(self):
            return True

    _, tservice = services
    fake, tservice._llm = tservice._llm, Broken()
    try:
        events = _events(_query(tservice, {"question": "payment terms", "stream": True})["__stream__"])
    finally:
        tservice._llm = fake
    assert [n for n, _ in events] == ["sources", "error"] and "fell over" in events[1][1]["detail"]


def test_query_with_the_tiny_decoder_matches_jax(services):
    from intool_rag_tpu.models import decoder as jdec
    from intool_rag_tpu.providers.tpu_llm import TPULLM
    from intool_rag_tpu_torch.models import decoder as tdec
    from intool_rag_tpu_torch.providers.cuda_llm import CudaLLM

    jservice, tservice = services
    jcfg = dataclasses.replace(jdec.DecoderConfig.tiny(), vocab_size=260, max_position=256)
    tcfg = dataclasses.replace(tdec.DecoderConfig.tiny(), vocab_size=260, max_position=256)
    params = jdec.init_decoder_params(jcfg, seed=2)
    jllm = TPULLM(config=jcfg, params=params, max_new_tokens=16, temperature=0.0)
    tllm = CudaLLM(config=tcfg, params=tdec.decoder_state_from_flax(jax.tree.map(np.asarray, params)),
                   max_new_tokens=16, temperature=0.0, device="cpu")
    jfake, tfake = jservice._llm, tservice._llm
    jservice._llm, tservice._llm = jllm, tllm
    try:
        for request in _questions()[:3]:
            request = {**request, "top_pages": 3}  # another cache key than the fake LLM's answers
            want, got = _query(jservice, request), _query(tservice, request)
            _same_answer(got, want)
            assert got["answer"]
    finally:
        jservice._llm, tservice._llm = jfake, tfake


def test_empty_corpus_answers_could_not_find(tmp_path, monkeypatch):
    from intool_rag_tpu import config as jconfig
    from intool_rag_tpu.index.registry import CorpusRegistry as JRegistry
    from intool_rag_tpu.providers.fake import FakeLLM as JFake
    from intool_rag_tpu.providers.hash_embed import HashEmbeddingProvider as JHash
    from intool_rag_tpu.service.app import RAGService as JService
    from intool_rag_tpu_torch import config
    from intool_rag_tpu_torch.providers.fake import FakeLLM
    from intool_rag_tpu_torch.providers.hash_embed import HashEmbeddingProvider
    from intool_rag_tpu_torch.service.app import RAGService

    monkeypatch.setenv("STORAGE_DIR", str(tmp_path))
    monkeypatch.setenv("CACHE_DIR", str(tmp_path / "cache"))
    config.reset_config()
    jconfig.reset_config()
    try:
        service = RAGService(HashEmbeddingProvider(dimension=32), device="cpu", llm=FakeLLM())
        jservice = JService(registry=JRegistry(), llm=JFake(), provider=JHash(dimension=32))
        want = _query(jservice, {"question": "anything at all?"})
        assert want == {"answer": "I could not find relevant information to answer your question.",
                        "sources": [], "confidence": "low"}
        assert _query(service, {"question": "anything at all?"}) == want
        assert service.handle("POST", "/query", b"not json")[0] == 400
        assert service.handle("POST", "/query", b'{"top_pages": 3}')[0] == 400
    finally:
        config.reset_config()
        jconfig.reset_config()
