"""The port's two-level (dcn, ici) mesh against the JAX package's on the
CPU: twins of ``test_dcn.py`` and ``test_dcn_hybrid.py`` (2 groups of 4;
JAX over its 8 virtual CPU devices, the port over 8 ``cpu`` entries).

Tolerances: f32 scores 1e-5 relative to the largest (summation order),
rows equal or equal as sets within ties of that width; k-means centroids
1e-4 from the same initial centroids (JAX seeds with ``jax.random``, so its
``_kmeans_pp_init`` is given the port's pick), assignments equal. The DCN
hybrid equals the port's 1-D engine exactly: the same kernels, the same
ids, only the merge order of the same candidates differs.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_dcn_hybrid import _make_corpus
from test_torch_parallel import assert_topk_equal, port_mesh

from intool_rag_tpu.index.bm25_index import BM25Params as JaxParams
from intool_rag_tpu.parallel import dcn as jdcn
from intool_rag_tpu_torch.index.bm25_index import BM25Params
from intool_rag_tpu_torch.parallel import dcn as tdcn
from intool_rag_tpu_torch.parallel.sharded_hybrid import ShardedHybrid

pytestmark = pytest.mark.multichip


def _meshes():
    return jdcn.dcn_mesh(n_dcn=2), tdcn.dcn_mesh(["cpu"] * 8, n_dcn=2)


def _both_topk(corpus, queries, k, block_n):
    jm, tm = _meshes()
    assert tm.shape == jm.shape == {"dcn": 2, "ici": 4}
    jv, jr = jdcn.hierarchical_flat_topk(jnp.asarray(queries), jdcn.shard_corpus_dcn(jnp.asarray(corpus), jm), k,
                                         jm, valid_n=len(corpus), block_n=block_n)
    tv, tr = tdcn.hierarchical_flat_topk(torch.from_numpy(queries), tdcn.shard_corpus_dcn(torch.from_numpy(corpus), tm),
                                         k, tm, valid_n=len(corpus), block_n=block_n)
    assert_topk_equal(tv.numpy(), tr.numpy(), np.asarray(jv), np.asarray(jr))
    return tv.numpy(), tr.numpy()


def test_hierarchical_topk_exact(rng):
    """``test_hierarchical_topk_exact``: 1,000 rows, k 17, the two-stage merge
    equal to the JAX one and to the exact top-k."""
    corpus = rng.standard_normal((1000, 32)).astype(np.float32)
    queries = rng.standard_normal((6, 32)).astype(np.float32)
    tv, tr = _both_topk(corpus, queries, 17, 128)
    exact = queries @ corpus.T
    want = np.sort(exact, axis=1)[:, ::-1][:, :17]
    np.testing.assert_allclose(tv, want, rtol=1e-5, atol=1e-5)


def test_hierarchical_topk_k_exceeds_shard(rng):
    """``test_hierarchical_topk_k_exceeds_shard``: 8 rows a shard, k 20."""
    corpus = rng.standard_normal((64, 8)).astype(np.float32)
    corpus /= np.linalg.norm(corpus, axis=1, keepdims=True)
    tv, tr = _both_topk(corpus, corpus[:2], 20, 8)
    assert tv.shape == (2, 20) and tr[:, 0].tolist() == [0, 1]


def test_hierarchical_kmeans_matches_jax_and_1d(rng, monkeypatch):
    """``test_hierarchical_kmeans_matches_clusters``: from the same initial
    centroids, the JAX two-level Lloyd's centroids and assignments; the
    port's 1-D sharded k-means over the same shards agrees (only the sums'
    order differs)."""
    import intool_rag_tpu.ops.kmeans as jkm
    from intool_rag_tpu_torch.parallel.sharded_kmeans import initial_centroids, sharded_kmeans

    centers = rng.standard_normal((8, 16)).astype(np.float32) * 5
    pts = np.concatenate([c + rng.standard_normal((96, 16)).astype(np.float32) for c in centers])
    jm, tm = _meshes()
    t_sharded = tdcn.shard_corpus_dcn(torch.from_numpy(pts), tm)
    init = initial_centroids(t_sharded, 8, len(pts), seed=0)
    monkeypatch.setattr(jkm, "_kmeans_pp_init", lambda sample, k, key: jnp.asarray(init.numpy()))
    jc, ja = jdcn.hierarchical_kmeans(jdcn.shard_corpus_dcn(jnp.asarray(pts), jm), 8, jm, valid_n=len(pts), iters=10)
    tc, ta = tdcn.hierarchical_kmeans(t_sharded, 8, tm, valid_n=len(pts), iters=10, init=init)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-4, rtol=0)
    np.testing.assert_array_equal(ta.gather().numpy(), np.asarray(ja))
    fc, fa = sharded_kmeans(t_sharded, 8, port_mesh(), valid_n=len(pts), iters=10, init=init)
    np.testing.assert_allclose(fc.numpy(), tc.numpy(), atol=1e-4, rtol=0)
    assert torch.equal(fa.gather(), ta.gather())
    dists = np.linalg.norm(centers[:, None, :] - tc.numpy()[None], axis=2)
    assert (dists.min(axis=1) < 1.0).all()


def _engines(dim, cap, p_max=64, quant="none"):
    kw = dict(k1=1.5, b=0.75, p_max=p_max)
    jm, tm = _meshes()
    j_kw = dict(interpret=True) if quant != "none" else {}
    j = jdcn.DCNHybrid(dim, jm, capacity_per_shard=cap, params=JaxParams(**kw), quant=quant, **j_kw)
    t = tdcn.DCNHybrid(dim, tm, capacity_per_shard=cap, params=BM25Params(**kw), quant=quant)
    flat = ShardedHybrid(dim, port_mesh(), capacity_per_shard=cap, params=BM25Params(**kw), quant=quant)
    return j, t, flat


@pytest.mark.parametrize("hybrid", [True, False])
def test_dcn_hybrid_matches_flat_sharded(rng, hybrid):
    """``test_dcn_hybrid_matches_flat_sharded``: the same placement as the
    1-D engine; results equal to the port's 1-D engine and to the JAX DCN
    engine."""
    texts, emb = _make_corpus(rng, 96, 64)
    j, t, flat = _engines(64, 32)
    g = t.append(texts, emb)
    np.testing.assert_array_equal(g, flat.append(texts, emb))
    np.testing.assert_array_equal(g, j.append(texts, emb))
    tv, tr = t.search(texts[:4], torch.from_numpy(emb[:4]), 5, hybrid=hybrid)
    fv, fr = flat.search(texts[:4], torch.from_numpy(emb[:4]), 5, hybrid=hybrid)
    assert torch.equal(tv, fv) and torch.equal(tr, fr)
    jv, jr = j.search(texts[:4], jnp.asarray(emb[:4]), 5, hybrid=hybrid)
    assert_topk_equal(tv.numpy(), tr.numpy(), np.asarray(jv), np.asarray(jr))


def test_dcn_hybrid_streaming_append(rng):
    """``test_dcn_hybrid_streaming_append``: 40 + 24 rows over 8 shards of 8;
    each row finds itself through the fusion."""
    texts, emb = _make_corpus(rng, 64, 64)
    j, t, _ = _engines(64, 8)
    gids = np.concatenate([t.append(texts[:40], emb[:40]), t.append(texts[40:], emb[40:])])
    j.append(texts[:40], emb[:40])
    j.append(texts[40:], emb[40:])
    assert t.valid_n == 64 and t.corpus.cap == j.corpus.cap
    tv, tr = t.search(texts[:3], torch.from_numpy(emb[:3]), 3, hybrid=True)
    np.testing.assert_array_equal(tr[:, 0].numpy(), gids[:3])
    jv, jr = j.search(texts[:3], jnp.asarray(emb[:3]), 3, hybrid=True)
    assert_topk_equal(tv.numpy(), tr.numpy(), np.asarray(jv), np.asarray(jr))


def test_dcn_hybrid_int8r_capacity_tier(rng):
    """``test_dcn_hybrid_int8r_capacity_tier``: int8r planes under the
    hierarchical merge (K2 per shard), hybrid and dense-only, equal to the
    JAX engine; self scores within 5e-3 of 1 (~15-bit corpus precision)."""
    texts, emb = _make_corpus(rng, 64, 64)
    j, t, _ = _engines(64, 128, quant="int8r")
    gids = t.append(texts, emb)
    j.append(texts, emb)
    for hybrid in (True, False):
        tv, tr = t.search(texts[:4], torch.from_numpy(emb[:4]), 5, hybrid=hybrid, group_l=1, tail="exact")
        np.testing.assert_array_equal(tr[:, 0].numpy(), gids[:4])
        jv, jr = j.search(texts[:4], jnp.asarray(emb[:4]), 5, hybrid=hybrid, group_l=1, tail="exact")
        assert_topk_equal(tv.numpy(), tr.numpy(), np.asarray(jv), np.asarray(jr))
    np.testing.assert_allclose(tv[:, 0].numpy(), 1.0, atol=5e-3)
    assert len(jax.devices()) == 8
