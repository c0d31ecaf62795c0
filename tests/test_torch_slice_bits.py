"""The INDEX_KIND=bits slice as a whole: the PyTorch port against the JAX
package. One STORAGE_DIR of 6 documents / 6,000 chunks (above the 4,096-row
floor of the capacity tier) is loaded by both packages' registries.
``kmeans`` is replaced IN THIS TEST, in both bits_index modules, by a
function that returns the same seeded centroids, since the two PRNG
streams cannot be shared. The JAX scan runs in interpret mode (its CPU
path); the port runs with device="cpu" (plain scan).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

N_DOCS, CHUNKS_PER_DOC, DIM, PAGES, NLIST = 6, 1000, 128, 10, 8


def _words(rng, n):
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    return ["".join(rng.choice(letters, size=rng.integers(4, 9))) for _ in range(n)]


def _clustered(rng, n, centers, noise=0.05):
    radius = noise * np.exp(rng.uniform(np.log(0.2), np.log(2.0), (n, 1))).astype(np.float32)
    x = centers[rng.integers(0, len(centers), n)] + radius * rng.standard_normal(
        (n, centers.shape[1])).astype(np.float32)
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


class _FixedProvider:
    """Query embeddings from a table, identical for both packages."""

    def __init__(self, table):
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

    rng = np.random.default_rng(11)
    centers = rng.standard_normal((NLIST, DIM)).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    vocab = _words(rng, 600)
    storage_dir = tmp_path_factory.mktemp("slice_bits_storage")
    fsm = FileStorageManager(storage_dir)
    all_texts, all_emb = [], []
    for d in range(N_DOCS):
        doc_id = f"doc{d}"
        nodes = [SemanticNode("n_000", f"Chapter {d}", NodeLevel.CHAPTER, 0, children=["n_001"]),
                 SemanticNode("n_001", f"Section {d}.1", NodeLevel.SECTION, 0, parent_id="n_000")]
        chunks, chunk_ids, pages, texts = [], [], [], []
        for i in range(CHUNKS_PER_DOC):
            page = i * PAGES // CHUNKS_PER_DOC
            cid = make_chunk_id(page, i)
            text = " ".join(rng.choice(vocab, size=rng.integers(10, 20)))
            chunks.append(Chunk(cid, "n_001", page, text))
            chunk_ids.append(cid)
            pages.append(page)
            texts.append(text)
        emb = _clustered(rng, CHUNKS_PER_DOC, centers)
        fsm.save_page_index(PageIndex(doc_id, source_file=f"{doc_id}.pdf", project=f"p{d % 2}",
                                      page_count=PAGES, nodes=nodes))
        fsm.save_chunks(ChunksIndex(doc_id, chunks))
        fsm.save_vectors(doc_id, emb, VectorMeta(doc_id, "fixed", DIM, CHUNKS_PER_DOC, chunk_ids, pages))
        all_texts += texts
        all_emb.append(emb)
    all_emb = np.concatenate(all_emb)
    queries, table = [], {}
    for j, row in enumerate(rng.choice(len(all_texts), size=8, replace=False)):
        text = all_texts[row] if j % 2 == 0 else " ".join(all_texts[row].split()[:3])
        vec = all_emb[row] + 0.02 * rng.standard_normal(DIM).astype(np.float32)
        table[text] = vec / np.linalg.norm(vec)
        queries.append(text)
    return storage_dir, queries, table, centers


@pytest.fixture(autouse=True)
def _fresh_configs():
    yield
    from intool_rag_tpu import config as jax_config
    from intool_rag_tpu_torch import config as torch_config

    jax_config.reset_config()
    torch_config.reset_config()


def _set_env(monkeypatch, storage_dir=None, **env):
    base = {"INDEX_KIND": "bits", "IVF_NLIST": str(NLIST), "IVF_NPROBE": "4", "IVF_REFINE_K": "64",
            "SHARDED_SEARCH": "off", "INDEX_DTYPE": "float32"}
    if storage_dir is not None:
        base.update(STORAGE_DIR=str(storage_dir), CACHE_DIR=str(storage_dir / "cache"))
    for name, value in {**base, **env}.items():
        monkeypatch.setenv(name, value)
    from intool_rag_tpu import config as jax_config
    from intool_rag_tpu_torch import config as torch_config

    jax_config.reset_config()
    torch_config.reset_config()


def _same_centroids(monkeypatch, centers):
    """Both packages' IVFBitsIndex.train get these centroids from 'kmeans'."""
    import intool_rag_tpu.index.bits_index as jbi
    import intool_rag_tpu_torch.index.bits_index as tbi

    calls = {"jax": 0, "torch": 0}

    def jax_kmeans(sample, k, **kw):
        calls["jax"] += 1
        return jnp.asarray(centers[:k]), None

    def torch_kmeans(sample, k, **kw):
        calls["torch"] += 1
        return torch.from_numpy(centers[:k].copy()).to(sample.device), None

    monkeypatch.setattr(jbi, "kmeans", jax_kmeans)
    monkeypatch.setattr(tbi, "kmeans", torch_kmeans)
    return calls


def _registries(storage_dir):
    from intool_rag_tpu.index.registry import CorpusRegistry as JaxRegistry
    from intool_rag_tpu_torch.index.registry import CorpusRegistry as TorchRegistry

    jreg, treg = JaxRegistry(storage_dir), TorchRegistry(storage_dir, device="cpu")
    assert jreg.load_all() == treg.load_all() == N_DOCS
    return jreg, treg


@pytest.mark.parametrize("dtype,refine_k", [("float32", 64), ("float32", 0), ("bfloat16", 0)])
@pytest.mark.parametrize("hybrid", [True, False], ids=["hybrid", "dense_only"])
def test_hybrid_engine_bits_matches_jax(monkeypatch, corpus, hybrid, dtype, refine_k):
    """HybridEngine.search through the capacity tier: ids identical, scores
    within 1e-4 (f32 sums in another order), hybrid and dense-only, with
    and without the host refine tier. (The bf16 store runs without it: the
    JAX side quantizes the tier under jit, where x/127 becomes x·(1/127);
    bf16 rows sit on int8 rounding ties often enough that this 1-ulp scale
    flips a code, which moves a refined score by one int8 step.)"""
    from intool_rag_tpu.index.bits_index import IVFBitsIndex as JaxBits
    from intool_rag_tpu_torch.index.bits_index import IVFBitsIndex as TorchBits
    from intool_rag_tpu_torch.ops.bits_scan import bits_scan

    storage_dir, queries, table, centers = corpus
    _set_env(monkeypatch, storage_dir, INDEX_DTYPE=dtype, IVF_REFINE_K=str(refine_k))
    calls = _same_centroids(monkeypatch, centers)
    jreg, treg = _registries(storage_dir)
    emb = _FixedProvider(table).embed_batch(queries)
    assert not treg.engine.dense.routes_flat() and not jreg.engine.dense.routes_flat()
    jv, jr = jreg.engine.search(queries, jnp.asarray(emb), 10, hybrid=hybrid)
    tv, tr = treg.engine.search(queries, torch.from_numpy(emb), 10, hybrid=hybrid)
    assert isinstance(jreg.engine.dense._ivf, JaxBits) and isinstance(treg.engine.dense._ivf, TorchBits)
    assert calls == {"jax": 1, "torch": 1}
    assert treg.engine.dense._ivf.total_rows == N_DOCS * CHUNKS_PER_DOC
    assert bool(treg.engine.dense._ivf.host_int8) == (refine_k > 0)  # the host tier
    assert bits_scan.launches.count == 0  # the CPU takes the plain scan, no kernel launch
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-4)
    assert (tr[:, 0] >= 0).all()


def test_registry_search_and_incremental_add(monkeypatch, corpus, tmp_path):
    """A registry preloaded with INDEX_KIND=bits builds the tier on the first
    search; add_document then appends to the SAME index object."""
    import shutil

    from intool_rag_tpu_torch.index.registry import CorpusRegistry

    storage_dir, queries, table, centers = corpus
    partial = tmp_path / "partial"
    shutil.copytree(storage_dir, partial)
    moved = tmp_path / "held_back"
    moved.mkdir()
    held = [p for p in partial.rglob("*") if p.name.startswith("doc5")]
    assert held
    for p in held:
        shutil.move(str(p), str(moved / p.name))
    _set_env(monkeypatch, partial)
    calls = _same_centroids(monkeypatch, centers)
    reg = CorpusRegistry(partial, device="cpu")
    assert reg.load_all() == N_DOCS - 1
    emb = torch.from_numpy(_FixedProvider(table).embed_batch(queries))
    assert reg.engine.dense._ivf is None
    first = reg.search(queries, emb, 5)
    built = reg.engine.dense._ivf
    assert built is not None and built.total_rows == (N_DOCS - 1) * CHUNKS_PER_DOC
    for p in held:
        shutil.move(str(moved / p.name), str(p))
    assert reg.add_document("doc5") == CHUNKS_PER_DOC
    second = reg.search(queries, emb, 5)
    assert reg.engine.dense._ivf is built and built.total_rows == N_DOCS * CHUNKS_PER_DOC
    assert calls["torch"] == 1  # no retrain
    assert all(len(h) == 5 for h in first) and all(len(h) == 5 for h in second)
    assert any(h["doc_id"] == "doc5" for hits in second for h in hits)


def test_dense_index_incremental_append_matches_jax(monkeypatch):
    """tests/test_bits_index.py's routing case on both packages: the tier
    builds at 4,096 rows, a store append grows the same object, and both
    packages return the same rows."""
    from intool_rag_tpu.index.chunk_store import ChunkStore as JaxStore
    from intool_rag_tpu.index.flat_index import DenseFlatIndex as JaxDense
    from intool_rag_tpu_torch.index.chunk_store import ChunkStore as TorchStore
    from intool_rag_tpu_torch.index.flat_index import DenseFlatIndex as TorchDense

    rng = np.random.default_rng(0)
    centers = rng.standard_normal((NLIST, DIM)).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    x = _clustered(rng, 8192, centers)
    _set_env(monkeypatch, IVF_NPROBE="8")
    _same_centroids(monkeypatch, centers)
    jstore, tstore = JaxStore(dim=DIM, dtype="float32"), TorchStore(dim=DIM, dtype="float32", device="cpu")
    jidx, tidx = JaxDense(jstore), TorchDense(tstore)

    def add(lo, hi, doc):
        for store in (jstore, tstore):
            store.append(x[lo:hi], doc, [f"c{i}" for i in range(lo, hi)], list(range(hi - lo)),
                         [f"t{i}" for i in range(lo, hi)])

    add(0, 4096, "doc0")
    q = x[:16]
    jv, jr = jidx.search(jnp.asarray(q), 5)
    tv, tr = tidx.search(torch.from_numpy(q), 5)
    built = tidx._ivf
    assert built.total_rows == 4096
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    add(4096, 8192, "doc1")
    jv, jr = jidx.search(jnp.asarray(q), 5)
    tv, tr = tidx.search(torch.from_numpy(q), 5)
    assert tidx._ivf is built and built.total_rows == 8192  # grown, not rebuilt
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-4)
    assert (tr.numpy()[:, 0] == np.arange(16)).mean() >= 0.9
    assert float(tv.max()) <= 1.0 and float(tv.min()) >= 0.0  # the cosine clamp
    # exact=True bypasses the tier in both packages
    assert tidx.routes_flat(exact=True) and jidx.routes_flat(exact=True)


@pytest.mark.parametrize("kind", ["bits", "ivf", "ivf_residual", "segmented"])
@pytest.mark.parametrize("rows", [4095, 4096])
def test_routing_threshold(monkeypatch, kind, rows):
    """Below 4,096 rows every IVF kind searches flat, as in the JAX package;
    from 4,096 on, bits routes to the tier and the unported kinds raise."""
    from intool_rag_tpu.index.chunk_store import ChunkStore as JaxStore
    from intool_rag_tpu.index.flat_index import DenseFlatIndex as JaxDense
    from intool_rag_tpu_torch.config import get_config
    from intool_rag_tpu_torch.index.chunk_store import ChunkStore as TorchStore
    from intool_rag_tpu_torch.index.flat_index import DenseFlatIndex as TorchDense

    _set_env(monkeypatch, INDEX_KIND=kind, USE_PALLAS="0")
    rng = np.random.default_rng(1)
    x = rng.standard_normal((rows, 32)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    ids = [f"c{i}" for i in range(rows)]
    jstore, tstore = JaxStore(dim=32, dtype="float32"), TorchStore(dim=32, dtype="float32", device="cpu")
    for store in (jstore, tstore):
        store.append(x, "doc", ids, [0] * rows, ids)
    jidx, tidx = JaxDense(jstore), TorchDense(tstore)
    assert tidx._routes_ivf(get_config(), None) == jidx._routes_ivf(get_config(), None) == (rows >= 4096)
    if rows < 4096:
        assert tidx.routes_flat() and jidx.routes_flat()
        tv, tr = tidx.search(torch.from_numpy(x[:4]), 3)
        jv, jr = jidx.search(jnp.asarray(x[:4]), 3)
        assert tidx._ivf is None
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-5)
    elif kind == "bits":
        assert not tidx.routes_flat() and not jidx.routes_flat()
    else:
        with pytest.raises(NotImplementedError, match=kind):
            tidx.routes_flat()
        with pytest.raises(NotImplementedError, match=kind):
            tidx.search(torch.from_numpy(x[:4]), 3)


@pytest.mark.parametrize("project", ["p0", "p1", None])
def test_single_query_project_filter_matches_jax(monkeypatch, corpus, project):
    """retrieve_chunks(project=...) over a store that holds two projects:
    the registry filters inside its over-fetched pool in both packages, so
    the returned chunk ids agree."""
    from intool_rag_tpu.query.retriever import PageLevelRetriever as JaxRetriever
    from intool_rag_tpu_torch.query.retriever import PageLevelRetriever as TorchRetriever

    storage_dir, queries, table, centers = corpus
    _set_env(monkeypatch, storage_dir)
    _same_centroids(monkeypatch, centers)
    jreg, treg = _registries(storage_dir)
    provider = _FixedProvider(table)
    jret = JaxRetriever(jreg, provider=provider, reranker=None)
    tret = TorchRetriever(treg, provider)
    seen_projects = set()
    for query in queries:
        want = jret.retrieve_chunks(query, project=project, limit=20)
        got = tret.retrieve_chunks(query, project=project, limit=20)
        assert [(c.doc_id, c.chunk_id, c.page) for c in got] == [
            (c.doc_id, c.chunk_id, c.page) for c in want]
        assert len(got) > 0
        for g, w in zip(got, want):
            assert g.score == pytest.approx(w.score, abs=1e-4)
        seen_projects |= {treg.doc_projects[c.doc_id] for c in got}
    assert seen_projects == ({project} if project else {"p0", "p1"})
