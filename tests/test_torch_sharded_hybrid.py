"""The port's ``ShardedHybrid`` (dense + BM25 + fusion over the mesh)
against the JAX package's on the CPU: twins of ``test_sharded_hybrid.py``
(8 shards; JAX over its 8 virtual CPU devices), and the checkpoint interop
between the two packages.

Tolerances: placement (global row ids) and the counted postings equal;
BM25 scores 1e-5 relative (the packed path's integer totals are equal, the
exact rescore sums f32 in gather order); dense f32 scores 1e-5 (product
summation order); fused scores 1e-5, and bit-equal where both packages'
fusion gets the same candidate lists; rows equal, or equal as sets within
ties of that width. A reloaded engine gives bit-equal results.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_sharded_hybrid import _WORDS, _make_corpus
from test_torch_parallel import assert_topk_equal, jax_mesh, port_mesh

from intool_rag_tpu.index.bm25_index import BM25Params as JaxParams
from intool_rag_tpu.parallel.sharded_hybrid import ShardedHybrid as JaxHybrid
from intool_rag_tpu_torch.index.bm25_index import BM25Params
from intool_rag_tpu_torch.parallel.sharded_hybrid import ShardedHybrid

pytestmark = pytest.mark.multichip


@pytest.fixture(autouse=True)
def _fresh_configs():
    yield
    from intool_rag_tpu import config as jcfg
    from intool_rag_tpu_torch import config as tcfg

    jcfg.reset_config()
    tcfg.reset_config()


def _set_env(monkeypatch, **env):
    from intool_rag_tpu import config as jcfg
    from intool_rag_tpu_torch import config as tcfg

    for key, value in env.items():
        monkeypatch.setenv(key, value)
    jcfg.reset_config()
    tcfg.reset_config()


def _pair(dim, n_dev=8, *, cap, p_max=512, quant="none"):
    kw = dict(k1=1.5, b=0.75, p_max=p_max)
    t = ShardedHybrid(dim, port_mesh(n_dev), capacity_per_shard=cap, params=BM25Params(**kw), quant=quant)
    j_kw = dict(interpret=True) if quant != "none" else {}
    j = JaxHybrid(dim, jax_mesh(n_dev), capacity_per_shard=cap, params=JaxParams(**kw), quant=quant, **j_kw)
    return t, j


def _append_both(t, j, texts, emb):
    gt, gj = t.append(texts, emb), j.append(texts, emb)
    np.testing.assert_array_equal(gt, gj)
    assert t.bm25.vocab == j.bm25.vocab and t.bm25.n_docs == j.bm25.n_docs
    assert t.bm25.total_len == j.bm25.total_len
    np.testing.assert_array_equal(t.bm25.df, j.bm25.df)
    for ts, js in zip(t.bm25.shards, j.bm25.shards):
        np.testing.assert_array_equal(ts.slots, js.slots)
        np.testing.assert_array_equal(ts.lens, js.lens)
        np.testing.assert_array_equal(ts.indptr, js.indptr)
        for d in range(len(ts.lens)):  # a document's pairs, in any order
            a, b = slice(ts.indptr[d], ts.indptr[d + 1]), slice(js.indptr[d], js.indptr[d + 1])
            assert sorted(zip(ts.terms[a], ts.counts[a])) == sorted(zip(js.terms[b], js.counts[b]))
    return gt


def _queries(rng, n, dim, words=5):
    texts = [" ".join(rng.choice(_WORDS, size=words)) for _ in range(n)]
    emb = rng.standard_normal((n, dim)).astype(np.float32)
    return texts, emb / np.linalg.norm(emb, axis=1, keepdims=True)


def _same(t_out, j_out):
    (tv, tr), (jv, jr) = t_out, j_out
    assert_topk_equal(tv.numpy(), tr.numpy(), np.asarray(jv), np.asarray(jr))


@pytest.mark.parametrize("mode", ["weighted", "rrf"])
def test_sharded_hybrid_matches_jax(rng, monkeypatch, mode):
    """``test_sharded_hybrid_matches_single_device``: 300 documents (CJK
    words among them) over 8 shards of 64; each retriever's merged list and
    the fused top-10 equal the JAX engine's, and the port's fusion of the
    JAX engine's own lists gives its fused scores bit for bit."""
    from intool_rag_tpu_torch.config import get_config
    from intool_rag_tpu_torch.index.hybrid import _fuse

    _set_env(monkeypatch, FUSION_MODE=mode)
    dim, kc, k = 32, 50, 10
    texts, emb = _make_corpus(rng, 300, dim)
    t, j = _pair(dim, cap=64)
    _append_both(t, j, texts, emb)
    q_texts, q_emb = _queries(rng, 8, dim)
    _same(t.bm25.topk(q_texts, kc), j.bm25.topk(q_texts, kc))
    _same(t.corpus.search(torch.from_numpy(q_emb), kc), j.corpus.search(jnp.asarray(q_emb), kc))
    _same(t.search(q_texts, torch.from_numpy(q_emb), k, candidates=kc),
          j.search(q_texts, jnp.asarray(q_emb), k, candidates=kc))
    jd_v, jd_r = (np.asarray(a) for a in j.corpus.search(jnp.asarray(q_emb), kc))
    js_v, js_r = (np.asarray(a) for a in j.bm25.topk(q_texts, kc))
    jd_r = np.where(np.isfinite(jd_v), jd_r, -1)
    cfg = get_config()
    fv, fr = _fuse(*(torch.from_numpy(np.array(a)) for a in (jd_v, jd_r, js_v, js_r)), k, fusion_mode=cfg.FUSION_MODE,
                   rrf_k=cfg.RRF_K, w_dense=cfg.VECTOR_WEIGHT, w_sparse=cfg.BM25_WEIGHT)
    wv, wr = j.search(q_texts, jnp.asarray(q_emb), k, candidates=kc)
    np.testing.assert_array_equal(fv.numpy(), np.asarray(wv))
    np.testing.assert_array_equal(fr.numpy(), np.asarray(wr))


def test_sharded_hybrid_streaming_append_parity(rng):
    """``test_sharded_hybrid_streaming_append_parity``: batches of 40 / 20 /
    80 over 8 shards of 8 (the third regrows); after each, the same fused
    results as the JAX engine, ids never reused."""
    dim, kc, k = 16, 30, 8
    t, j = _pair(dim, cap=8)
    q_texts, q_emb = _queries(rng, 4, dim)
    gids = []
    for size in (40, 20, 80):
        texts, emb = _make_corpus(rng, size, dim)
        gids.append(_append_both(t, j, texts, emb))
        _same(t.search(q_texts, torch.from_numpy(q_emb), k, candidates=kc),
              j.search(q_texts, jnp.asarray(q_emb), k, candidates=kc))
    all_gids = np.concatenate(gids)
    assert len(set(all_gids.tolist())) == len(all_gids) == 140 and t.corpus.cap > 8


def test_sharded_hybrid_dense_only_mode(rng):
    """``test_sharded_hybrid_dense_only_mode``: ``hybrid=False`` returns the
    dense top-k; each row finds itself."""
    dim = 16
    t, j = _pair(dim, cap=16)
    texts, emb = _make_corpus(rng, 64, dim)
    gids = _append_both(t, j, texts, emb)
    tv, tr = t.search(texts[:3], torch.from_numpy(emb[:3]), 5, hybrid=False)
    _same((tv, tr), j.search(texts[:3], jnp.asarray(emb[:3]), 5, hybrid=False))
    np.testing.assert_array_equal(tr[:, 0].numpy(), gids[:3])


@pytest.mark.parametrize("quant", ["none", "int8r"])
def test_sharded_hybrid_checkpoint_roundtrip(rng, tmp_path, quant):
    """``test_sharded_hybrid_checkpoint_roundtrip`` and its quantized twin:
    ``save`` then ``load`` gives bit-equal planes and results, and streaming
    appends go on after the restore (with the JAX engine beside)."""
    dim, cap = (16, 16) if quant == "none" else (128, 128)
    t, j = _pair(dim, cap=cap, p_max=256, quant=quant)
    texts, emb = _make_corpus(rng, 80, dim)
    _append_both(t, j, texts, emb)
    q_texts, q_emb = _queries(rng, 4, dim, words=4)
    before = t.search(q_texts, torch.from_numpy(q_emb), 8)
    t.save(tmp_path / "ckpt")
    restored = ShardedHybrid.load(tmp_path / "ckpt", port_mesh())
    assert restored.corpus.quant == quant
    for name in ("data",) if quant == "none" else ("codes", "scales", "res"):
        assert torch.equal(getattr(restored.corpus, name).gather(), getattr(t.corpus, name).gather())
    after = restored.search(q_texts, torch.from_numpy(q_emb), 8)
    assert torch.equal(before[0], after[0]) and torch.equal(before[1], after[1])
    more_t, more_e = _make_corpus(rng, 24, dim)
    gids = restored.append(more_t, more_e)
    j.append(more_t, more_e)
    assert restored.valid_n == 104 and len(set(gids.tolist())) == 24
    _same(restored.search(q_texts, torch.from_numpy(q_emb), 8), j.search(q_texts, jnp.asarray(q_emb), 8))
    with pytest.raises(ValueError, match="sharded"):
        ShardedHybrid.load(tmp_path / "ckpt", port_mesh(4))


@pytest.mark.parametrize("quant", ["none", "int8r"])
def test_checkpoint_interop_with_jax(rng, tmp_path, quant):
    """A ``ShardedHybrid`` the JAX package saved loads in the port with the
    same results as the JAX engine, and the port's files load in the JAX
    package (the dense planes bit-equal both ways)."""
    dim, cap = (32, 32) if quant == "none" else (128, 128)
    t, j = _pair(dim, cap=cap, p_max=256, quant=quant)
    texts, emb = _make_corpus(rng, 120, dim)
    _append_both(t, j, texts, emb)
    q_texts, q_emb = _queries(rng, 6, dim, words=4)
    want = j.search(q_texts, jnp.asarray(q_emb), 8)
    j.save(tmp_path / "from_jax")
    t.save(tmp_path / "from_port")
    mine = ShardedHybrid.load(tmp_path / "from_jax", port_mesh())
    _same(mine.search(q_texts, torch.from_numpy(q_emb), 8), want)
    theirs = JaxHybrid.load(tmp_path / "from_port", jax_mesh())
    if quant != "none":
        theirs.corpus.interpret = True  # the JAX engine's Pallas kernel on the CPU
    for name in ("data",) if quant == "none" else ("codes", "scales", "res"):
        np.testing.assert_array_equal(np.asarray(getattr(theirs.corpus, name)), getattr(t.corpus, name).gather().numpy())
    _same(t.search(q_texts, torch.from_numpy(q_emb), 8), theirs.search(q_texts, jnp.asarray(q_emb), 8))
