"""End-to-end /search slice: the PyTorch port against the JAX package.

A STORAGE_DIR of 3 documents / 600 chunks with known embeddings is written
by the JAX package's FileStorageManager. Both packages load it through
their CorpusRegistry and run PageLevelRetriever.retrieve_chunks_batch and
rank_pages. The JAX side takes its accelerator branch: the flat index is
told it runs on a TPU and its Pallas kernels run in interpret mode. The
port runs with device="cpu", where its fused-kernel wrappers take their
plain versions.
"""

from __future__ import annotations

import json

import jax
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

N_DOCS, CHUNKS_PER_DOC, DIM, PAGES = 3, 200, 128, 10


def _words(rng, n):
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    return ["".join(rng.choice(letters, size=rng.integers(4, 9))) for _ in range(n)]


class _FixedProvider:
    """Query embeddings from a table, identical for both packages."""

    def __init__(self, table: dict[str, np.ndarray]) -> None:
        self.table = table
        self.dimension = DIM

    def embed_batch(self, texts, *, is_query=False):
        return np.stack([self.table[t] for t in texts]).astype(np.float32)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    from intool_rag_tpu.ingest.schemas import (
        Chunk, ChunksIndex, NodeLevel, PageIndex, SemanticNode, VectorMeta, make_chunk_id,
    )
    from intool_rag_tpu.storage.artifacts import FileStorageManager

    rng = np.random.default_rng(7)
    vocab = _words(rng, 400)
    storage_dir = tmp_path_factory.mktemp("slice_storage")
    fsm = FileStorageManager(storage_dir)
    all_texts, all_emb = [], []
    for d in range(N_DOCS):
        doc_id = f"doc{d}"
        nodes = [SemanticNode("n_000", f"Chapter {d}", NodeLevel.CHAPTER, 0, children=["n_001"])]
        nodes.append(SemanticNode("n_001", f"Section {d}.1", NodeLevel.SECTION, 0, parent_id="n_000"))
        page_index = PageIndex(doc_id, source_file=f"{doc_id}.pdf", project=f"p{d % 2}",
                               page_count=PAGES, nodes=nodes)
        chunks, chunk_ids, pages, texts = [], [], [], []
        for i in range(CHUNKS_PER_DOC):
            page = i * PAGES // CHUNKS_PER_DOC
            cid = make_chunk_id(page, i)
            text = " ".join(rng.choice(vocab, size=rng.integers(10, 25)))
            chunks.append(Chunk(cid, "n_001", page, text))
            chunk_ids.append(cid)
            pages.append(page)
            texts.append(text)
        emb = rng.standard_normal((CHUNKS_PER_DOC, DIM)).astype(np.float32)
        emb /= np.linalg.norm(emb, axis=1, keepdims=True)
        fsm.save_page_index(page_index)
        fsm.save_chunks(ChunksIndex(doc_id, chunks))
        fsm.save_vectors(doc_id, emb, VectorMeta(doc_id, "fixed", DIM, CHUNKS_PER_DOC, chunk_ids, pages))
        all_texts += texts
        all_emb.append(emb)
    all_emb = np.concatenate(all_emb)
    queries, table = [], {}
    for j, row in enumerate(rng.choice(len(all_texts), size=8, replace=False)):
        # half quote a chunk, half are short keyword queries near a chunk
        text = all_texts[row] if j % 2 == 0 else " ".join(all_texts[row].split()[:3])
        vec = all_emb[row] + 0.3 * rng.standard_normal(DIM).astype(np.float32)
        table[text] = vec / np.linalg.norm(vec)
        queries.append(text)
    return storage_dir, queries, table


@pytest.fixture(autouse=True)
def _fresh_configs():
    """Both packages re-read the (restored) environment after each test."""
    yield
    from intool_rag_tpu import config as jax_config
    from intool_rag_tpu_torch import config as torch_config

    jax_config.reset_config()
    torch_config.reset_config()


def _set_env(monkeypatch, storage_dir, int8r: bool, dtype: str = "bfloat16"):
    monkeypatch.setenv("STORAGE_DIR", str(storage_dir))
    monkeypatch.setenv("INDEX_DTYPE", dtype)
    monkeypatch.setenv("CACHE_DIR", str(storage_dir / "cache"))
    monkeypatch.setenv("SHARDED_SEARCH", "off")
    monkeypatch.setenv("DENSE_INT8", "1" if int8r else "0")
    monkeypatch.setenv("DENSE_INT8_RESIDUAL", "1" if int8r else "0")
    from intool_rag_tpu import config as jax_config
    from intool_rag_tpu_torch import config as torch_config

    jax_config.reset_config()
    torch_config.reset_config()


def _jax_results(monkeypatch, storage_dir, queries, provider):
    import intool_rag_tpu.index.flat_index as flat_index
    import intool_rag_tpu.ops.flat_pallas as flat_pallas
    from intool_rag_tpu.index.registry import CorpusRegistry
    from intool_rag_tpu.query.retriever import PageLevelRetriever

    real_bf16, real_int8 = flat_pallas.flat_topk_pallas, flat_pallas.flat_topk_pallas_int8
    calls = []

    def interpreted(fn):
        def run(*args, **kwargs):
            calls.append(fn.__name__)
            return fn(*args, interpret=True, **kwargs)
        return run

    monkeypatch.setattr(flat_index, "_on_tpu", lambda: True)
    monkeypatch.setattr(flat_index, "flat_topk_pallas", interpreted(real_bf16))
    monkeypatch.setattr(flat_pallas, "flat_topk_pallas_int8", interpreted(real_int8))
    jax.clear_caches()
    try:
        registry = CorpusRegistry(storage_dir)
        registry.load_all()
        retriever = PageLevelRetriever(registry, provider=provider, reranker=None)
        chunks = retriever.retrieve_chunks_batch(queries, [None] * len(queries))
        pages = [retriever.rank_pages(c) for c in chunks]
    finally:
        jax.clear_caches()
    return chunks, pages, calls


@pytest.mark.parametrize("store", ["bf16", "int8r", "f16"])
def test_slice_matches_jax(monkeypatch, corpus, store):
    """``f16``: an INDEX_DTYPE=float16 store, which both packages serve with
    the fused kernel (no split-query pass) and an exact rescore."""
    from intool_rag_tpu_torch.index.registry import CorpusRegistry
    from intool_rag_tpu_torch.query.retriever import PageLevelRetriever

    storage_dir, queries, table = corpus
    provider = _FixedProvider(table)
    int8r = store == "int8r"
    _set_env(monkeypatch, storage_dir, int8r, "float16" if store == "f16" else "bfloat16")
    want_chunks, want_pages, calls = _jax_results(monkeypatch, storage_dir, queries, provider)
    assert calls == ["flat_topk_pallas_int8" if int8r else "flat_topk_pallas"]

    registry = CorpusRegistry(storage_dir, device="cpu")
    assert registry.load_all() == N_DOCS
    assert registry.store.embeddings.dtype == (torch.float16 if store == "f16" else torch.bfloat16)
    retriever = PageLevelRetriever(registry, provider)
    _, plan = registry.engine.dense.flat_plan(50)
    assert plan["kind"] == ("fused_int8" if int8r else "fused")
    assert plan.get("rescore", False) == (store == "f16")
    assert plan.get("precise", True) == (store == "bf16" or int8r)
    got_chunks = retriever.retrieve_chunks_batch(queries, [None] * len(queries))
    got_pages = [retriever.rank_pages(c) for c in got_chunks]

    same, total = 0, 0
    for want, got in zip(want_chunks, got_chunks):
        assert len(want) == len(got) > 0
        for w, g in zip(want, got):
            total += 1
            if (w.doc_id, w.chunk_id, w.page) == (g.doc_id, g.chunk_id, g.page):
                same += 1
                assert g.score == pytest.approx(w.score, abs=1e-4)
    assert same >= 0.99 * total
    for want, got in zip(want_pages, got_pages):
        for w, g in zip(want, got):
            assert (g.doc_id, g.page, g.chapter, g.section, g.source_file) == (
                w.doc_id, w.page, w.chapter, w.section, w.source_file)
            assert g.score == pytest.approx(w.score, abs=1e-4)
    # a query that quotes a chunk finds it first
    assert got_chunks[0][0].text == queries[0]


def test_service_search_on_cpu(monkeypatch, corpus):
    from intool_rag_tpu_torch.service.app import RAGService

    storage_dir, queries, table = corpus
    _set_env(monkeypatch, storage_dir, False)
    service = RAGService(_FixedProvider(table), device="cpu")
    status, body = service.handle("POST", "/search", json.dumps({"question": queries[0]}).encode())
    assert status == 200
    assert body["total"] == len(body["hits"]) > 0
    assert body["hits"][0]["text"] == queries[0]
    status, body = service.handle("GET", "/health")
    assert status == 200 and body["chunks"] == N_DOCS * CHUNKS_PER_DOC
    status, body = service.handle("GET", "/documents")
    assert status == 200 and body["total"] == N_DOCS
    status, _ = service.handle("POST", "/search", b'{"top_pages": 3}')
    assert status == 400
