"""The capacity tiers as a slice: ``INDEX_KIND`` = ``ivf``,
``ivf_residual`` (int4 and sign codes, with and without ``IVF_REFINE_K``)
and ``segmented`` through the hybrid engine and the registry of the
PyTorch port against the JAX package's, over one STORAGE_DIR of 6,000
chunks (above the 4,096-row floor of the tiers).

k-means cannot share seeds across the packages, so ``kmeans`` is replaced
IN THIS TEST, in both packages' tier modules, by one function that returns
the JAX package's k-means of the points it is given. The port runs with
device="cpu".
"""

from __future__ import annotations

import hashlib
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_ivf_residual import assert_topk_equal
from test_torch_slice_bits import CHUNKS_PER_DOC, N_DOCS, NLIST, _FixedProvider, _registries, _set_env
from test_torch_slice_bits import corpus  # noqa: F401  (the shared STORAGE_DIR fixture)

torch.set_num_threads(2)

KINDS = {
    "ivf": dict(INDEX_KIND="ivf", IVF_REFINE_K="0"),
    "ivf-bf16": dict(INDEX_KIND="ivf", INDEX_DTYPE="bfloat16", IVF_REFINE_K="0"),
    "ivf_residual-int4": dict(INDEX_KIND="ivf_residual", IVF_RESIDUAL_BITS="4", IVF_REFINE_K="0"),
    "ivf_residual-int4-refine": dict(INDEX_KIND="ivf_residual", IVF_RESIDUAL_BITS="4", IVF_REFINE_K="64"),
    "ivf_residual-int1-refine": dict(INDEX_KIND="ivf_residual", IVF_RESIDUAL_BITS="1", IVF_REFINE_K="64"),
    "segmented-int4": dict(INDEX_KIND="segmented", IVF_RESIDUAL_BITS="4", IVF_REFINE_K="0"),
    "segmented-int1-refine": dict(INDEX_KIND="segmented", IVF_RESIDUAL_BITS="1", IVF_REFINE_K="64"),
}


def _same_kmeans(monkeypatch):
    """Every tier module of both packages gets the JAX k-means of its
    points, computed once per distinct point set."""
    import intool_rag_tpu.index.ivf_index as jivf
    import intool_rag_tpu.index.ivf_residual as jres
    import intool_rag_tpu.index.segmented_residual as jseg
    import intool_rag_tpu_torch.index.ivf_index as tivf
    import intool_rag_tpu_torch.index.ivf_residual as tres
    import intool_rag_tpu_torch.index.segmented_residual as tseg
    from intool_rag_tpu.ops.kmeans import kmeans

    cache: dict = {}
    calls = {"jax": 0, "torch": 0}

    def shared(points: np.ndarray, k: int, iters: int, seed: int):
        key = (hashlib.sha1(points.tobytes()).hexdigest(), points.shape, k, iters, seed)
        if key not in cache:
            c, a = kmeans(jnp.asarray(points), k, iters=iters, seed=seed)
            cache[key] = (np.asarray(c), np.asarray(a))
        return cache[key]

    def fake_jax(points, k, *, iters=10, seed=0, **kw):
        calls["jax"] += 1
        c, a = shared(np.asarray(points.astype(jnp.float32)), k, iters, seed)
        return jnp.asarray(c), jnp.asarray(a)

    def fake_torch(points, k, *, iters=10, seed=0, **kw):
        calls["torch"] += 1
        c, a = shared(points.float().cpu().numpy(), k, iters, seed)
        return torch.from_numpy(c.copy()), torch.from_numpy(a.copy())

    for module in (jivf, jres, jseg):
        monkeypatch.setattr(module, "kmeans", fake_jax)
    for module in (tivf, tres, tseg):
        monkeypatch.setattr(module, "kmeans", fake_torch)
    return calls


def _tier_types(kind: str):
    from intool_rag_tpu_torch.index.ivf_index import IVFFlatIndex
    from intool_rag_tpu_torch.index.ivf_residual import IVFResidualIndex
    from intool_rag_tpu_torch.index.segmented_residual import SegmentedResidualIndex

    return {"ivf": IVFFlatIndex, "ivf_residual": IVFResidualIndex, "segmented": SegmentedResidualIndex}[kind]


@pytest.mark.parametrize("name", list(KINDS))
@pytest.mark.parametrize("hybrid", [True, False], ids=["hybrid", "dense_only"])
def test_hybrid_engine_matches_jax(monkeypatch, corpus, name, hybrid):  # noqa: F811
    """HybridEngine.search through each tier: rows equal (as sets where
    scores tie), scores within 1e-5."""
    storage_dir, queries, table, _ = corpus
    env = KINDS[name]
    _set_env(monkeypatch, storage_dir, **env)
    calls = _same_kmeans(monkeypatch)
    jreg, treg = _registries(storage_dir)
    emb = _FixedProvider(table).embed_batch(queries)
    assert not treg.engine.dense.routes_flat() and not jreg.engine.dense.routes_flat()
    jv, jr = jreg.engine.search(queries, jnp.asarray(emb), 10, hybrid=hybrid)
    tv, tr = treg.engine.search(queries, torch.from_numpy(emb), 10, hybrid=hybrid)
    tier = treg.engine.dense._ivf
    assert isinstance(tier, _tier_types(env["INDEX_KIND"])) and tier.device.type == "cpu"
    assert type(jreg.engine.dense._ivf).__name__ == type(tier).__name__
    assert calls == {"jax": 1, "torch": 1}
    if env["INDEX_KIND"] == "segmented":
        assert tier.n_segments == 2 and tier.total_rows == N_DOCS * CHUNKS_PER_DOC  # 4,096 + 1,904
    if "IVF_RESIDUAL_BITS" in env:
        assert tier.bits == int(env["IVF_RESIDUAL_BITS"])
        assert bool(len(tier.host_int8) if isinstance(tier.host_int8, list) else tier.host_int8 is not None) == (
            env["IVF_REFINE_K"] != "0")
        assert tier.bytes_host == jreg.engine.dense._ivf.bytes_host
        assert tier.bytes_resident == jreg.engine.dense._ivf.bytes_resident
    assert_topk_equal(tv.numpy(), tr.numpy(), np.asarray(jv), np.asarray(jr))
    assert (tr[:, 0] >= 0).all()


def _same_hits(got, want):
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            assert a["score"] == pytest.approx(b["score"], abs=1e-5)
        assert {(h["doc_id"], h["chunk_id"]) for h in g} == {(h["doc_id"], h["chunk_id"]) for h in w}


@pytest.mark.parametrize("name", ["ivf", "ivf_residual-int4-refine", "segmented-int1-refine"])
def test_registry_add_and_delete_match_jax(monkeypatch, corpus, tmp_path, name):  # noqa: F811
    """Both registries: search, add a document (segmented appends to the
    SAME index object, one segment more; ivf / ivf_residual rebuild), then
    delete one (a new store object: every tier rebuilds)."""
    from intool_rag_tpu.index.registry import CorpusRegistry as JaxRegistry
    from intool_rag_tpu_torch.index.registry import CorpusRegistry as TorchRegistry

    storage_dir, queries, table, _ = corpus
    dirs, held = {}, []
    for pkg in ("jax", "torch"):  # each registry deletes from its own copy
        dirs[pkg] = tmp_path / pkg
        shutil.copytree(storage_dir, dirs[pkg])
        (tmp_path / f"{pkg}_held").mkdir()
        for p in [p for p in dirs[pkg].rglob("*") if p.name.startswith("doc5")]:
            held.append((p, tmp_path / f"{pkg}_held" / p.name))
            shutil.move(str(p), str(held[-1][1]))
    env = KINDS[name]
    _set_env(monkeypatch, dirs["torch"], **env)
    _same_kmeans(monkeypatch)
    jreg, treg = JaxRegistry(dirs["jax"]), TorchRegistry(dirs["torch"], device="cpu")
    assert jreg.load_all() == treg.load_all() == N_DOCS - 1
    emb = _FixedProvider(table).embed_batch(queries)

    def both(k=5):
        return (treg.search(queries, torch.from_numpy(emb), k), jreg.search(queries, jnp.asarray(emb), k))

    got, want = both()
    _same_hits(got, want)
    first = treg.engine.dense._ivf
    segments = getattr(first, "n_segments", None)
    for original, moved in held:
        shutil.move(str(moved), str(original))
    assert treg.add_document("doc5") == jreg.add_document("doc5") == CHUNKS_PER_DOC
    got, want = both()
    _same_hits(got, want)
    assert any(h["doc_id"] == "doc5" for hits in got for h in hits)
    after_add = treg.engine.dense._ivf
    if env["INDEX_KIND"] == "segmented":
        assert after_add is first and after_add.n_segments == segments + 1  # appended, not rebuilt
    else:
        assert after_add is not first
    assert treg.remove_document("doc1") and jreg.remove_document("doc1")
    got, want = both()
    _same_hits(got, want)
    assert not any(h["doc_id"] == "doc1" for hits in got for h in hits)
    assert treg.engine.dense._ivf is not after_add


@pytest.mark.parametrize("kind", ["ivf", "ivf_residual", "segmented", "bits"])
def test_sharded_search_on_still_raises(monkeypatch, kind):
    """The only route the port lacks: SHARDED_SEARCH=on (multi-device)."""
    from intool_rag_tpu_torch.index.chunk_store import ChunkStore
    from intool_rag_tpu_torch.index.flat_index import DenseFlatIndex

    _set_env(monkeypatch, INDEX_KIND=kind, SHARDED_SEARCH="on")
    store = ChunkStore(dim=32, dtype="float32", device="cpu")
    store.append(np.eye(4, 32, dtype=np.float32), "doc", list("abcd"), [0] * 4, list("abcd"))
    with pytest.raises(NotImplementedError, match="SHARDED_SEARCH"):
        DenseFlatIndex(store).routes_flat()
