"""The port's BM25 ops, BM25 index, analyzer and fusion ops against the JAX
package (same numpy inputs from a seed on both sides)."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from intool_rag_tpu.ops import bm25 as jbm25
from intool_rag_tpu.ops import fusion as jfusion
from intool_rag_tpu_torch.ops import bm25 as tbm25
from intool_rag_tpu_torch.ops import fusion as tfusion

torch.set_num_threads(2)

N_DOCS, VOCAB, P_MAX, T = 3000, 800, 256, 12


def _postings(rng):
    """Zipf postings in the index layout (the benchmark's make_sparse at a
    small size): impact-ordered per term, capped at P_MAX."""
    terms = (rng.zipf(1.3, size=(N_DOCS, 24)) - 1) % VOCAB
    w = rng.random((N_DOCS, 24)).astype(np.float32) + 0.5
    order = np.argsort(terms, axis=1, kind="stable")
    st = np.take_along_axis(terms, order, 1)
    keep = ~np.concatenate([np.zeros((N_DOCS, 1), bool), st[:, 1:] == st[:, :-1]], 1).ravel()
    ft, fd = st.ravel()[keep], np.repeat(np.arange(N_DOCS, dtype=np.int32), 24)[keep]
    fw = np.take_along_axis(w, order, 1).ravel()[keep]
    o = np.lexsort((-fw, ft))
    ft, fd, fw = ft[o], fd[o], fw[o]
    df = np.bincount(ft, minlength=VOCAB)
    lens = np.minimum(df, P_MAX)
    starts_full = np.concatenate([[0], np.cumsum(df)[:-1]])
    k = (np.arange(len(ft)) - starts_full[ft]) < P_MAX
    term_start = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int32)
    post_docs = np.concatenate([fd[k], np.full(P_MAX, N_DOCS, np.int32)]).astype(np.int32)
    post_w = np.concatenate([fw[k], np.zeros(P_MAX, np.float32)]).astype(np.float32)
    idf = np.log(1.0 + (N_DOCS - df + 0.5) / (df + 0.5)).astype(np.float32)
    qterms = np.full((6, T), -1, np.int32)
    for i in range(6):
        ids = np.unique((rng.zipf(1.3, size=3 + i) - 1) % VOCAB)[:T]
        qterms[i, : len(ids)] = ids
    qterms[5] = -1  # a query with no known term
    qtf = np.where(qterms >= 0, rng.integers(1, 3, size=qterms.shape), 0).astype(np.float32)
    return term_start, lens.astype(np.int32), post_docs, post_w, idf, qterms, qtf


@pytest.fixture(scope="module")
def sparse():
    return _postings(np.random.default_rng(0))


def _layouts(sparse):
    ts, tl, pd, pw, _, _, _ = sparse
    j = jbm25.build_row_layout(
        jnp.asarray(ts), jnp.asarray(tl), jnp.asarray(pd), jnp.asarray(pw), n_docs=N_DOCS, p_max=P_MAX
    )
    t = tbm25.build_row_layout(
        torch.from_numpy(ts), torch.from_numpy(tl), torch.from_numpy(pd), torch.from_numpy(pw),
        n_docs=N_DOCS, p_max=P_MAX,
    )
    return j, t


def _exact_scores(sparse):
    """float64 BM25 totals over the capped postings: the exact answer."""
    ts, tl, pd, pw, idf, qterms, qtf = sparse
    out = np.zeros((qterms.shape[0], N_DOCS + 1))
    for q in range(qterms.shape[0]):
        for term, tf in zip(qterms[q], qtf[q]):
            if term >= 0:
                sl = slice(ts[term], ts[term] + tl[term])
                np.add.at(out[q], pd[sl], pw[sl].astype(np.float64) * float(idf[term]) * float(tf))
    return out


def _check_exact(got, sparse):
    vals, ids = got[0].numpy(), got[1].numpy()
    exact = _exact_scores(sparse)
    rows, cols = np.nonzero(vals > 0)
    np.testing.assert_allclose(vals[rows, cols], exact[rows, ids[rows, cols]], rtol=1e-6)


# The JAX exact aggregation takes segment totals as differences of f32
# prefix sums over M ≈ 4k slots, which drift up to ~1.4e-5 relative from
# the exact totals here; the port sums in float64 (within 1e-6 of exact,
# checked by _check_exact). Against JAX the exact paths therefore hold
# rtol 5e-5; the packed path, whose aggregation is integer, holds 1e-5.
EXACT_VS_JAX_RTOL = 5e-5


def test_build_row_layout_equal(sparse):
    j, t = _layouts(sparse)
    assert set(j) == set(t)
    for key in j:
        want = np.asarray(j[key])
        got = t[key] if isinstance(t[key], np.ndarray) else t[key].numpy()
        np.testing.assert_array_equal(got, want, err_msg=key)


def _same_rows_and_scores(got, want, rtol):
    (gv, gi), (wv, wi) = got, want
    gv, gi, wv, wi = gv.numpy(), gi.numpy(), np.asarray(wv), np.asarray(wi)
    for q in range(gv.shape[0]):
        good_g, good_w = gv[q] > 0, wv[q] > 0
        assert set(gi[q][good_g]) == set(wi[q][good_w]), q
    np.testing.assert_allclose(np.sort(gv, axis=1), np.sort(wv, axis=1), rtol=rtol, atol=1e-6)


@pytest.mark.parametrize("hot_first", [False, True])
def test_bm25_topk_rows_packed_matches_jax(sparse, hot_first):
    _, _, _, _, idf, qterms, qtf = sparse
    j, t = _layouts(sparse)
    hot_cap = None
    if hot_first:
        is_hot = (qterms >= 0) & j["term_hot_np"][np.maximum(qterms, 0)]
        assert is_hot.sum(1).max() <= T // 2
        order = np.argsort(~is_hot, axis=1, kind="stable")
        qterms, qtf = np.take_along_axis(qterms, order, 1), np.take_along_axis(qtf, order, 1)
        hot_cap = T // 2
    names = ("term_row", "term_hot", "hot_docs", "hot_w", "cold_docs", "cold_w")
    want = jbm25.bm25_topk_rows_packed(
        jnp.asarray(qterms), jnp.asarray(qtf), *(j[n] for n in names), jnp.asarray(idf), 40,
        n_docs=N_DOCS, term_wmax=j["term_wmax"], hot_cap=hot_cap,
    )
    got = tbm25.bm25_topk_rows_packed(
        torch.from_numpy(qterms), torch.from_numpy(qtf), *(t[n] for n in names),
        torch.from_numpy(idf), 40, n_docs=N_DOCS, term_wmax=t["term_wmax"], hot_cap=hot_cap,
    )
    _same_rows_and_scores(got, want, rtol=1e-5)
    got_rows = tbm25.bm25_topk_rows(
        torch.from_numpy(qterms), torch.from_numpy(qtf), *(t[n] for n in names),
        torch.from_numpy(idf), 40, n_docs=N_DOCS,
    )
    want_rows = jbm25.bm25_topk_rows(
        jnp.asarray(qterms), jnp.asarray(qtf), *(j[n] for n in names), jnp.asarray(idf), 40,
        n_docs=N_DOCS,
    )
    _same_rows_and_scores(got_rows, want_rows, rtol=EXACT_VS_JAX_RTOL)
    if not hot_first:
        _check_exact(got_rows, sparse)


def test_bm25_sorted_and_scores_match_jax(sparse):
    ts, tl, pd, pw, idf, qterms, qtf = sparse
    jargs = [jnp.asarray(x) for x in (qterms, qtf, ts, tl, pd, pw, idf)]
    targs = [torch.from_numpy(x) for x in (qterms, qtf, ts, tl, pd, pw, idf)]
    want = jbm25.bm25_topk_sorted(*jargs, 40, n_docs=N_DOCS, p_max=P_MAX)
    got = tbm25.bm25_topk_sorted(*targs, 40, n_docs=N_DOCS, p_max=P_MAX)
    _same_rows_and_scores(got, want, rtol=EXACT_VS_JAX_RTOL)
    _check_exact(got, sparse)
    np.testing.assert_allclose(
        tbm25.bm25_scores(*targs, n_docs=N_DOCS, p_max=P_MAX).numpy(),
        np.asarray(jbm25.bm25_scores(*jargs, n_docs=N_DOCS, p_max=P_MAX)),
        rtol=1e-5, atol=1e-6,
    )


def test_bm25_index_build_and_plan_match_jax():
    from intool_rag_tpu.index.bm25_index import BM25Index as JIndex
    from intool_rag_tpu_torch.index.bm25_index import BM25Index as TIndex

    rng = np.random.default_rng(5)
    words = ["alpha", "beta", "gamma", "delta", "epsilon", "zeta", "eta", "theta", "the", "a",
             "Ünïcode", "naïve", "東京都", "データ", "2024", "x", "İstanbul"]
    texts = [" ".join(rng.choice(words, size=rng.integers(3, 12))) for _ in range(300)]
    j, t = JIndex.build(texts), TIndex.build(texts, device="cpu")
    assert t.vocab == j.vocab
    for name in ("term_start", "term_len", "post_docs", "post_w", "idf"):
        np.testing.assert_array_equal(getattr(t, name).numpy(), np.asarray(getattr(j, name)), err_msg=name)
    queries = ["alpha beta gamma", "東京 データ", "nothing here", "the zeta 2024 naïve"]
    jq, jf, _, jst = j.topk_plan(queries)
    tq, tf, _, tst = t.topk_plan(queries)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    assert tst == jst
    jv, ji = j.topk(queries, 20)
    tv, ti = t.topk(queries, 20)
    _same_rows_and_scores((tv, ti), (jv, ji), rtol=1e-5)


def test_analyzer_token_stream_matches_jax():
    from intool_rag_tpu.index.analyzer import tokenize as jtok
    from intool_rag_tpu.index.analyzer import tokenize_py
    from intool_rag_tpu_torch.index.analyzer import tokenize as ttok

    texts = ["The quick brown fox, 42 times!", "東京都のデータ分析 and ŞİŞLİ", "a b c de_f x9 ÀÉÎ",
             "ＦＵＬＬＷＩＤＴＨ ﬁ ligature", "mixed東京text 한국어 문장", ""]
    for text in texts:
        assert ttok(text) == tokenize_py(text) == jtok(text), text


def _fusion_inputs(rng):
    q, kd, ks = 4, 12, 10
    d_idx = np.stack([rng.choice(40, kd, replace=False) for _ in range(q)]).astype(np.int32)
    s_idx = np.stack([rng.choice(40, ks, replace=False) for _ in range(q)]).astype(np.int32)
    d_idx[0, -3:] = -1
    s_idx[1, :] = -1  # one query with no sparse candidates
    d_val = rng.random((q, kd)).astype(np.float32)
    s_val = rng.random((q, ks)).astype(np.float32) * 9
    return d_idx, d_val, s_idx, s_val


@pytest.mark.parametrize("k", [5, 22, 30])
def test_fusion_exactly_equal(k):
    d_idx, d_val, s_idx, s_val = _fusion_inputs(np.random.default_rng(k))
    j_norm = jfusion.normalize_minmax(jnp.asarray(s_val))
    t_norm = tfusion.normalize_minmax(torch.from_numpy(s_val))
    np.testing.assert_array_equal(t_norm.numpy(), np.asarray(j_norm))
    want = jfusion.weighted_fusion(
        jnp.asarray(d_idx), jnp.asarray(d_val), jnp.asarray(s_idx), j_norm, k, w_dense=0.7, w_sparse=0.3
    )
    got = tfusion.weighted_fusion(
        torch.from_numpy(d_idx), torch.from_numpy(d_val), torch.from_numpy(s_idx), t_norm, k,
        w_dense=0.7, w_sparse=0.3,
    )
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    want = jfusion.rrf_fusion(jnp.asarray(d_idx), jnp.asarray(s_idx), k, rrf_k=60)
    got = tfusion.rrf_fusion(torch.from_numpy(d_idx), torch.from_numpy(s_idx), k, rrf_k=60)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # query 1 has 9 valid candidates: past them its rows are -1
    assert ((got[1].numpy()[1] == -1).sum() > 0) == (k > 9)
