"""Incremental corpus mutation in the port against a fresh build and
against the JAX package: ``BM25Index.append``, ``ChunkStore.without_doc``,
``save``/``load`` each way across the packages, and the registry's
``add_document``/``remove_document``."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from intool_rag_tpu.index.bm25_index import BM25Index as JBM25
from intool_rag_tpu.index.chunk_store import ChunkStore as JStore
from intool_rag_tpu_torch.index.bm25_index import BM25Index as TBM25
from intool_rag_tpu_torch.index.chunk_store import ChunkStore as TStore

torch.set_num_threads(2)

ARRAYS = ("term_start", "term_len", "post_docs", "post_w", "idf")


def _texts(seed: int, n: int, vocab_from: int = 0) -> list[str]:
    rng = np.random.default_rng(seed)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    vocab = ["".join(rng.choice(letters, size=rng.integers(4, 9))) for _ in range(300)]
    vocab = vocab[vocab_from:] + ["straße", "café", "東京"]
    return [" ".join(rng.choice(vocab, size=rng.integers(0 if i % 17 == 5 else 5, 30))) for i in range(n)]


def _same_index(a, b) -> None:
    assert a.vocab == b.vocab and a.n_docs == b.n_docs and a.avgdl == b.avgdl
    for name in ARRAYS:
        np.testing.assert_array_equal(np.asarray(getattr(a, name)), np.asarray(getattr(b, name)), err_msg=name)


def _pairs_per_doc(counted) -> list[dict[int, int]]:
    _, _, indptr, terms, counts, _ = counted
    return [dict(zip(terms[indptr[d]:indptr[d + 1]].tolist(), counts[indptr[d]:indptr[d + 1]].tolist()))
            for d in range(len(indptr) - 1)]


@pytest.mark.parametrize("splits", [(120, 40), (1, 90), (60, 1, 25, 50)], ids=["two", "from-one-doc", "four"])
def test_bm25_append_equals_build_and_jax(splits):
    parts = [_texts(10 + i, n, vocab_from=40 * i) for i, n in enumerate(splits)]
    tidx, jidx = TBM25.build(parts[0], device="cpu"), JBM25.build(parts[0])
    for part in parts[1:]:
        grown = tidx.append(part)
        assert grown is not tidx and tidx.n_docs < grown.n_docs  # the old index stays valid
        tidx, jidx = grown, jidx.append(part)
    union = [t for part in parts for t in part]
    fresh = TBM25.build(union, device="cpu")
    _same_index(tidx, fresh)
    _same_index(tidx, jidx)
    # the counts: vocabulary, df, doc_indptr and doc_len equal; each
    # document's (term, count) pairs equal as a set, since the native corpus
    # build lists a document's pairs in its hash map's order
    for i in (0, 1, 2, 5):
        np.testing.assert_array_equal(np.asarray(tidx._counted[i]), np.asarray(fresh._counted[i]))
    assert _pairs_per_doc(tidx._counted) == _pairs_per_doc(fresh._counted)
    queries = [union[3], " ".join(union[-1].split()[:4]), "straße café", "absent words only"]
    got_v, got_r = tidx.topk(queries, 10)
    want_v, want_r = jidx.topk(queries, 10)
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), atol=1e-5, rtol=0)
    hit = np.isfinite(got_v.numpy()) & (got_v.numpy() > 0)
    assert hit[0].any() and (got_r.numpy()[hit] == np.asarray(want_r)[hit]).mean() >= 0.99
    assert tidx.append([]) is tidx


@pytest.mark.parametrize("direction", ["port-to-jax", "jax-to-port"])
def test_bm25_save_load_across_packages(tmp_path, direction):
    texts = _texts(3, 80)
    if direction == "port-to-jax":
        src = TBM25.build(texts, device="cpu")
        src.save(tmp_path / "bm25")
        dst = JBM25.load(tmp_path / "bm25")
    else:
        src = JBM25.build(texts)
        src.save(tmp_path / "bm25")
        dst = TBM25.load(tmp_path / "bm25", device="cpu")
    _same_index(src, dst)
    assert (dst.params.k1, dst.params.b, dst.params.p_max) == (src.params.k1, src.params.b, src.params.p_max)
    v1, r1 = src.topk([texts[5]], 5)
    v2, r2 = dst.topk([texts[5]], 5)
    np.testing.assert_allclose(np.asarray(v1), np.asarray(v2), atol=1e-6)
    np.testing.assert_array_equal(np.asarray(r1), np.asarray(r2))
    if direction == "jax-to-port":
        with pytest.raises(ValueError, match="without counts"):
            dst.append(["more text"])


def _fill(store, seed: int = 0):
    rng = np.random.default_rng(seed)
    for d, n in enumerate((7, 1, 12, 5)):
        emb = rng.standard_normal((n, 48)).astype(np.float32)
        emb /= np.linalg.norm(emb, axis=1, keepdims=True)
        store.append(emb, doc_id=f"doc{d}", chunk_ids=[f"c_{d:03d}_{i:03d}" for i in range(n)],
                     pages=list(range(n)), texts=[f"text {d} {i}" for i in range(n)])
    return store


def _same_store(t, j) -> None:
    assert (t.valid_n, t.dim, t.dim_pad, t.n_pad) == (j.valid_n, j.dim, j.dim_pad, j.n_pad)
    assert (t.doc_ids, t.chunk_ids, t.texts) == (j.doc_ids, j.chunk_ids, j.texts)
    np.testing.assert_array_equal(t.pages, j.pages)
    np.testing.assert_array_equal(t.embeddings.float().numpy(), np.asarray(j.embeddings, np.float32))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_without_doc_is_copy_on_write_and_equals_jax(dtype):
    t, j = _fill(TStore(48, dtype, device="cpu")), _fill(JStore(48, dtype))
    assert t.rows_for_doc("doc2") == j.rows_for_doc("doc2") == list(range(8, 20))
    before = t.embeddings.clone()
    for victim in ("doc2", "doc0"):
        t2, removed_t = t.without_doc(victim)
        j2, removed_j = j.without_doc(victim)
        assert removed_t == removed_j > 0 and t2 is not t
        assert t2.mutation_count == t.mutation_count + 1
        _same_store(t2, j2)
        assert victim not in t2.doc_ids and t2.rows_for_doc(victim) == []
        t, j = t2, j2
    assert torch.equal(before[:25], _fill(TStore(48, dtype, device="cpu")).embeddings[:25])  # untouched original
    same, removed = t.without_doc("no-such-doc")
    assert same is t and removed == 0
    for victim in ("doc1", "doc3"):  # down to an empty store
        t, _ = t.without_doc(victim)
    assert len(t) == 0 and t.n_pad == 4096 and not t.embeddings.any()


@pytest.mark.parametrize("direction", ["port-to-jax", "jax-to-port"])
def test_chunk_store_save_load_across_packages(tmp_path, direction):
    if direction == "port-to-jax":
        src = _fill(TStore(48, "bfloat16", device="cpu"))
        src.save(tmp_path / "store")
        _same_store(src, JStore.load(tmp_path / "store"))
    else:
        src = _fill(JStore(48, "bfloat16"))
        src.save(tmp_path / "store")
        dst = TStore.load(tmp_path / "store", device="cpu")
        _same_store(dst, src)
        dst.append(np.eye(48, dtype=np.float32)[:2], "doc9", ["a", "b"], [0, 1], ["x", "y"])
        assert len(dst) == 27 and dst.ref(26).doc_id == "doc9"
    empty = TStore(48, "float32", device="cpu")
    empty.save(tmp_path / "empty")
    assert len(TStore.load(tmp_path / "empty", device="cpu")) == 0 and len(JStore.load(tmp_path / "empty")) == 0


def test_registry_appends_bm25_and_removes_documents(tmp_path, monkeypatch):
    from intool_rag_tpu_torch import config as tconfig
    from intool_rag_tpu_torch.index.registry import CorpusRegistry
    from intool_rag_tpu_torch.ingest.schemas import Chunk, ChunksIndex, PageIndex, VectorMeta, make_chunk_id
    from intool_rag_tpu_torch.storage.artifacts import FileStorageManager

    monkeypatch.setenv("STORAGE_DIR", str(tmp_path))
    monkeypatch.setenv("INDEX_DTYPE", "float32")
    tconfig.reset_config()
    fsm = FileStorageManager(tmp_path)
    rng = np.random.default_rng(0)
    docs = {}
    for d in range(3):
        texts = _texts(20 + d, 30, vocab_from=50 * d)
        texts = [t or "filler words here" for t in texts]
        emb = rng.standard_normal((30, 32)).astype(np.float32)
        emb /= np.linalg.norm(emb, axis=1, keepdims=True)
        docs[f"doc{d}"] = (texts, emb)

    def persist(doc_id):
        texts, emb = docs[doc_id]
        ids = [make_chunk_id(0, i) for i in range(30)]
        fsm.save_page_index(PageIndex(doc_id, source_file=f"{doc_id}.txt", project="p", page_count=1))
        fsm.save_chunks(ChunksIndex(doc_id, [Chunk(c, "n_000", 0, t) for c, t in zip(ids, texts)]))
        fsm.save_vectors(doc_id, emb, VectorMeta(doc_id, "fixed", 32, 30, ids, [0] * 30))

    try:
        persist("doc0")
        registry = CorpusRegistry(tmp_path, device="cpu")
        assert registry.load_all() == 1
        dense = registry.engine.dense
        for doc_id in ("doc1", "doc2"):
            persist(doc_id)
            assert registry.add_document(doc_id) == 30
            assert registry.engine.dense is dense  # the same store keeps its dense index
        union = [t for d in ("doc0", "doc1", "doc2") for t in docs[d][0]]
        fresh = TBM25.build(union, device="cpu")
        _same_index(registry.bm25, fresh)
        assert registry.stats() == {"documents": 3, "chunks": 90, "bm25_vocab": len(fresh.vocab)}

        def search(doc_id, row):
            q = torch.from_numpy(docs[doc_id][1][row : row + 1])
            return registry.search([docs[doc_id][0][row]], q, 5)[0]

        assert search("doc1", 4)[0]["doc_id"] == "doc1"
        version, old_store = registry.version, registry.store
        assert registry.remove_document("doc1") is True
        assert registry.version == version + 1 and registry.store is not old_store and len(old_store) == 90
        assert registry.engine.dense is not dense and registry.engine.dense.store is registry.store
        assert all(h["doc_id"] != "doc1" for h in search("doc1", 4))
        assert search("doc2", 7)[0] == {**search("doc2", 7)[0], "doc_id": "doc2", "chunk_id": make_chunk_id(0, 7)}
        _same_index(registry.bm25, TBM25.build(docs["doc0"][0] + docs["doc2"][0], device="cpu"))
        assert "doc1" not in registry.doc_projects and not any(k[0] == "doc1" for k in registry.chunk_nodes)
        assert registry.remove_document("doc1") is False
        assert fsm.list_documents() == ["doc0", "doc2"]
        persist("doc1")  # and back in: appended again after the rebuild
        assert registry.add_document("doc1") == 30 and search("doc1", 4)[0]["doc_id"] == "doc1"
    finally:
        monkeypatch.undo()
        tconfig.reset_config()
