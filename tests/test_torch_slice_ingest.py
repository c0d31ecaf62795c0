"""The ingest slice as a whole: the port's service against the JAX
package's, with the same tiny encoder weights and the same uploads through
``handle("POST", "/ingest?project=…")``. Chunk and tree files must be equal,
vectors agree to 1e-4 (f32, 2 layers), ``/search`` must name the same chunks
on a two-project store before and after a ``DELETE``, and the async job
must reach ``done``. The text uploads carry symbols (``€uro``, ``5€``,
``c++``), which both packages' native analyzers keep inside their words.
With ``LLM_PROVIDER`` unset, no Gemini key and no Ollama, both ingest
through the heuristic analyzer. Each service has its own ``STORAGE_DIR``."""

from __future__ import annotations

import json
import time

import jax
import numpy as np
import pytest
import torch

from test_torch_ingest import _document, _multipart, build_pdf

torch.set_num_threads(2)

UPLOADS = [  # (doc_id, project, file name, mode)
    ("doc-txt", "alpha", "report.txt", "sync"),
    ("doc-pdf", "alpha", "invoice.pdf", "async"),
    ("doc-md", "beta", "notes.md", "sync"),
]


def _payload(name: str) -> bytes:
    if name.endswith(".txt"):
        return "\f".join(_document(1, 4, symbols=True)).encode()
    if name.endswith(".pdf"):
        return build_pdf(_document(2, 3, accents=True), xref_stream=True, tounicode=True)
    return "\n\n".join(_document(3, 3, symbols=True)).encode()


@pytest.fixture(scope="module")
def services(tmp_path_factory):
    """(JAX service, the port's service), same encoder weights, fresh stores."""
    from intool_rag_tpu import config as jconfig
    from intool_rag_tpu.index.registry import CorpusRegistry as JRegistry
    from intool_rag_tpu.llm.semantic import factory as jfactory
    from intool_rag_tpu.models import encoder as jenc
    from intool_rag_tpu.providers.tpu_embed import TPUEmbeddingProvider
    from intool_rag_tpu.service.app import RAGService as JService
    from intool_rag_tpu_torch import config as tconfig
    from intool_rag_tpu_torch.llm.semantic import factory as tfactory
    from intool_rag_tpu_torch.models import encoder as tenc
    from intool_rag_tpu_torch.providers.cuda_embed import CudaEmbeddingProvider
    from intool_rag_tpu_torch.service.app import RAGService as TService

    mp = pytest.MonkeyPatch()
    jdir, tdir = tmp_path_factory.mktemp("jax_store"), tmp_path_factory.mktemp("torch_store")
    for key, val in {"LLM_PROVIDER": "heuristic", "RERANKER_ENABLED": "0", "OCR_ENABLED": "0",
                     "INDEX_DTYPE": "float32", "SHARDED_SEARCH": "off", "EMBED_PACKED": "1",
                     "EMBEDDING_QUERY_INSTRUCTION": "", "CHUNK_MAX_CHARS": "400",
                     "CHUNK_TARGET_CHARS": "250", "CHUNK_MIN_CHARS": "50"}.items():
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
        jservice = JService(registry=JRegistry(), llm=object(),
                            provider=TPUEmbeddingProvider(config=cfg, params=params, model_name="tiny-test"))
        mp.setenv("STORAGE_DIR", str(tdir))
        tconfig.reset_config()
        tfactory.reset_semantic_analyzer()
        tservice = TService(CudaEmbeddingProvider(model, model_name="tiny-test"), device="cpu")
        assert jservice.pipeline.provider.packed and tservice.pipeline.provider.packed
        yield jservice, tservice
    finally:
        mp.undo()
        jconfig.reset_config()
        tconfig.reset_config()
        jfactory.reset_semantic_analyzer()
        tfactory.reset_semantic_analyzer()


def _ingest(service, doc_id, project, name, mode) -> dict:
    body, ctype = _multipart([("file", name, _payload(name))])
    path = f"/ingest?project={project}&doc_id={doc_id}" + ("&mode=async" if mode == "async" else "")
    status, out = service.handle("POST", path, body, ctype)
    assert status == 200, out
    if mode != "async":
        return out
    assert out["status"] in ("pending", "running") and out["doc_id"] == doc_id
    deadline = time.time() + 120
    while time.time() < deadline:
        status, job = service.handle("GET", f"/jobs/{out['job_id']}")
        assert status == 200
        if job["status"] in ("done", "failed"):
            break
        time.sleep(0.05)
    assert job["status"] == "done", job
    assert any(j["job_id"] == out["job_id"] for j in service.handle("GET", "/jobs")[1]["jobs"])
    return job["result"]


def _search(service, question: str, project: str | None = None) -> list[dict]:
    body = {"question": question, **({"project": project} if project else {})}
    status, out = service.handle("POST", "/search", json.dumps(body).encode())
    assert status == 200, out
    return out["hits"]


def _same_hits(got: list[dict], want: list[dict]) -> None:
    """The same chunks with the same scores; two chunks whose scores lie
    within 2e-4 of each other may swap places."""
    assert len(got) == len(want) > 0
    assert {(h["doc_id"], h["chunk_id"]) for h in got} == {(h["doc_id"], h["chunk_id"]) for h in want}
    for g, w in zip(got, want):
        assert g["score"] == pytest.approx(w["score"], abs=2e-4)
        if (g["doc_id"], g["chunk_id"]) == (w["doc_id"], w["chunk_id"]):
            assert (g["page"], g["text"]) == (w["page"], w["text"])


def test_ingest_then_search_matches_jax(services):
    jservice, tservice = services
    for doc_id, project, name, mode in UPLOADS:
        want = _ingest(jservice, doc_id, project, name, mode)
        got = _ingest(tservice, doc_id, project, name, mode)
        if mode == "sync":
            for key in ("success", "doc_id", "source_file", "project", "total_pages", "total_chunks",
                        "vectors_indexed"):
                assert got[key] == want[key], key
            assert got["success"] and got["total_chunks"] == got["vectors_indexed"] >= 3
        else:
            assert got["chunk_count"] == want["chunk_count"] >= 3

    chunk_texts = {}
    for doc_id, project, name, _ in UPLOADS:  # the artifacts on disk
        jst, tst = jservice.registry.storage, tservice.registry.storage
        assert tst.load_chunks(doc_id).to_dict() == jst.load_chunks(doc_id).to_dict()
        assert tst.load_page_index(doc_id).to_dict() == jst.load_page_index(doc_id).to_dict()
        (tvec, tmeta), (jvec, jmeta) = tst.load_vectors(doc_id), jst.load_vectors(doc_id)
        assert tmeta.to_dict() == jmeta.to_dict() and tmeta.model == "tiny-test"
        np.testing.assert_allclose(tvec, jvec, atol=1e-4, rtol=0)
        status, detail = tservice.handle("GET", f"/documents/{doc_id}")
        assert status == 200 and detail == jservice.handle("GET", f"/documents/{doc_id}")[1]
        assert detail["project"] == project and detail["source_file"] == name and detail["nodes"]
        chunk_texts[doc_id] = [c.text for c in tst.load_chunks(doc_id)]
    assert tservice.handle("GET", "/health")[1]["chunks"] == jservice.handle("GET", "/health")[1]["chunks"]
    assert tservice.registry.stats() == jservice.registry.stats()
    assert tservice.handle("GET", "/documents")[1] == jservice.handle("GET", "/documents")[1]

    questions = [(chunk_texts[d][i], p) for d, p in (("doc-txt", None), ("doc-pdf", "alpha"), ("doc-md", "beta"),
                                                      ("doc-md", None)) for i in (0, 2)]
    questions.append(("payment terms for the supplier contract", None))

    def compare():
        for question, project in questions:
            _same_hits(_search(tservice, question, project), _search(jservice, question, project))

    compare()
    assert _search(tservice, chunk_texts["doc-pdf"][0])[0]["doc_id"] == "doc-pdf"
    assert all(h["doc_id"] == "doc-md" for h in _search(tservice, chunk_texts["doc-txt"][0], "beta"))

    for service in services:
        status, out = service.handle("DELETE", "/documents/doc-pdf")
        assert (status, out) == (200, {"deleted": "doc-pdf"})
    questions = [q for q in questions if q[0] not in chunk_texts["doc-pdf"]]
    compare()
    assert all(h["doc_id"] != "doc-pdf" for h in _search(tservice, chunk_texts["doc-pdf"][0]))
    assert tservice.registry.stats() == jservice.registry.stats()
    assert tservice.handle("DELETE", "/documents/doc-pdf")[0] == 404
    assert tservice.handle("GET", "/documents/doc-pdf")[0] == 404
    assert tservice.handle("GET", "/jobs/no-such-job")[0] == 404


@pytest.mark.parametrize("path,ctype,status", [
    ("/ingest", "multipart/form-data; boundary=----b0undary", 400),  # no project
    ("/ingest?project=p", "application/json", 400),  # not multipart
    ("/ingest?project=p", "multipart/form-data", 400),  # no boundary
    ("/ingest?project=p&doc_id=../escape", "multipart/form-data; boundary=----b0undary", 400),
    ("/ingest?project=p&doc_id=bad-format", "multipart/form-data; boundary=----b0undary", 400),
], ids=["no-project", "not-multipart", "no-boundary", "doc-id-with-a-path", "unsupported-format"])
def test_ingest_refuses_bad_requests(services, path, ctype, status):
    _, tservice = services
    name = "file.docx" if "bad-format" in path else "file.txt"
    body, _ = _multipart([("file", name, b"some text that is long enough to be a page of a document")])
    got, out = tservice.handle("POST", path, body, ctype)
    assert got == status and "detail" in out
    empty, ctype2 = _multipart([("note", None, b"no file here")])
    assert tservice.handle("POST", "/ingest?project=p", empty, ctype2)[0] == 400


def test_ingest_with_llm_provider_unset(services, monkeypatch):
    """The default configuration: ``LLM_PROVIDER`` unset, no Gemini key,
    Ollama unreachable. Both analyzer factories fall to the heuristic
    analyzer, and the port ingests what the JAX service ingests."""
    from intool_rag_tpu import config as jconfig
    from intool_rag_tpu.llm.semantic import factory as jfactory
    from intool_rag_tpu.providers.ollama import OllamaLLM as JOllama
    from intool_rag_tpu_torch import config as tconfig
    from intool_rag_tpu_torch.exceptions import ProviderConnectionError
    from intool_rag_tpu_torch.llm.semantic import factory as tfactory
    from intool_rag_tpu_torch.providers import http_utils

    def refused(method, url, body=None, *, timeout=None):
        raise ProviderConnectionError(f"{url}: connection refused")

    monkeypatch.setattr(JOllama, "is_ready", lambda self: False)
    monkeypatch.setattr(http_utils, "transport", refused)
    for cfg in (jconfig.get_config(), tconfig.get_config()):  # each keeps its own STORAGE_DIR
        monkeypatch.setattr(cfg, "LLM_PROVIDER", "")
        monkeypatch.setattr(cfg, "GEMINI_API_KEY", "")
    try:
        for f in (jfactory, tfactory):
            f.reset_semantic_analyzer()
        jservice, tservice = services
        want = _ingest(jservice, "doc-default", "gamma", "default.txt", "sync")
        got = _ingest(tservice, "doc-default", "gamma", "default.txt", "sync")
        assert type(tfactory.get_semantic_analyzer()).__name__ == "HeuristicSemanticAnalyzer"
        assert type(jfactory.get_semantic_analyzer()).__name__ == "HeuristicSemanticAnalyzer"
        assert got["success"] and got["total_chunks"] == want["total_chunks"] >= 3
        jst, tst = jservice.registry.storage, tservice.registry.storage
        assert tst.load_chunks("doc-default").to_dict() == jst.load_chunks("doc-default").to_dict()
        assert tst.load_page_index("doc-default").to_dict() == jst.load_page_index("doc-default").to_dict()
        np.testing.assert_allclose(tst.load_vectors("doc-default")[0], jst.load_vectors("doc-default")[0],
                                   atol=1e-4, rtol=0)
        question = tst.load_chunks("doc-default").chunks[0].text
        _same_hits(_search(tservice, question, "gamma"), _search(jservice, question, "gamma"))
    finally:
        for f in (jfactory, tfactory):
            f.reset_semantic_analyzer()
