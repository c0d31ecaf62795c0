"""The device postings generator against a frozen copy of ``bench.py``'s
numpy ``make_sparse``: the same layout, and the same statistics."""

from __future__ import annotations

import numpy as np
import torch

from portbench import data

N, VOCAB, T, P_MAX = 20_000, 3_000, 64, 64


def make_sparse_numpy(rng, n, vocab, p_max, terms_per_chunk):
    """Frozen copy of bench.py's make_sparse (without its query terms)."""
    chunk_terms = (rng.zipf(1.2, size=(n, terms_per_chunk)) - 1) % vocab
    weights = rng.random((n, terms_per_chunk)).astype(np.float32) + 0.5
    sort_idx = np.argsort(chunk_terms, axis=1, kind="stable")
    st = np.take_along_axis(chunk_terms, sort_idx, axis=1)
    dup = np.concatenate([np.zeros((n, 1), bool), st[:, 1:] == st[:, :-1]], axis=1)
    keep = ~dup.ravel()
    flat_terms = st.ravel()[keep]
    flat_docs = np.repeat(np.arange(n, dtype=np.int32), terms_per_chunk)[keep]
    flat_w = np.take_along_axis(weights, sort_idx, axis=1).ravel()[keep]
    order = np.lexsort((-flat_w, flat_terms))
    flat_terms, flat_docs, flat_w = flat_terms[order], flat_docs[order], flat_w[order]
    df = np.bincount(flat_terms, minlength=vocab)
    counts = np.minimum(df, p_max)
    starts64 = np.zeros(vocab, np.int64)
    starts64[1:] = np.cumsum(df)[:-1]
    rank = np.arange(len(flat_terms), dtype=np.int64) - starts64[flat_terms]
    keep2 = rank < p_max
    docs_out, w_out = flat_docs[keep2], flat_w[keep2]
    term_start = np.zeros(vocab, np.int32)
    term_start[1:] = np.cumsum(counts[:-1]).astype(np.int32)
    post_docs = np.concatenate([docs_out, np.full(p_max, n, np.int32)])
    post_w = np.concatenate([w_out, np.zeros(p_max, np.float32)]).astype(np.float32)
    idf = np.log(1.0 + (n - df + 0.5) / (df + 0.5)).astype(np.float32)
    return term_start, counts.astype(np.int32), post_docs, post_w, idf, df


def _torch():
    return {k: v.numpy() if isinstance(v, torch.Tensor) else v for k, v in data.make_postings(
        4, N, vocab=VOCAB, terms_per_chunk=T, p_max=P_MAX, zipf_s=1.2, device="cpu", block=7000).items()}


def _chunk_terms():
    """Each chunk's drawn terms, drawn again in the generator's order (per
    block: the terms, then the weights)."""
    gen = data.device_generator(4, data.POSTINGS, "cpu")
    out = []
    for start in range(0, N, 7000):
        rows = min(7000, N - start)
        out.append(data.zipf_terms(gen, (rows, T), 1.2, VOCAB, "cpu").numpy())
        torch.rand((rows, T), generator=gen)
    return np.concatenate(out)


def test_layout_matches_the_numpy_generator():
    p = _torch()
    ts, tl, docs, w, idf, df = p["term_start"], p["term_len"], p["post_docs"], p["post_w"], p["idf"], p["df"]
    assert ts.dtype == np.int32 and tl.dtype == np.int32 and docs.dtype == np.int32 and w.dtype == np.float32
    assert np.array_equal(ts, np.concatenate([[0], np.cumsum(tl)[:-1]]).astype(np.int32))
    assert np.array_equal(tl, np.minimum(df, P_MAX))
    assert len(docs) == tl.sum() + P_MAX and np.all(docs[-P_MAX:] == N) and np.all(w[-P_MAX:] == 0)
    np.testing.assert_allclose(idf, np.log(1.0 + (N - df + 0.5) / (df + 0.5)).astype(np.float32), rtol=1e-6)
    # each chunk's distinct terms are its postings, before the cap
    terms = _chunk_terms()
    assert np.array_equal(df, np.bincount(np.concatenate([np.unique(r) for r in terms]), minlength=VOCAB))
    for t in np.flatnonzero(tl)[:200]:
        seg_w = w[ts[t]: ts[t] + tl[t]]
        seg_d = docs[ts[t]: ts[t] + tl[t]]
        assert np.all(np.diff(seg_w) <= 0), "impact order within a term"
        assert len(np.unique(seg_d)) == len(seg_d)
        assert all(t in terms[d] for d in seg_d[:5])
        assert np.all((seg_w >= 0.5) & (seg_w < 1.5))


def test_statistics_match_the_numpy_generator():
    p = _torch()
    ref = make_sparse_numpy(np.random.default_rng(0), N, VOCAB, P_MAX, T)
    df_t, df_n = p["df"], ref[5]
    share_t, share_n = df_t / df_t.sum(), df_n / df_n.sum()
    for top in (1, 10, 100, 1000):  # the head of the Zipf law, document frequencies
        a, b = np.sort(share_t)[::-1][:top].sum(), np.sort(share_n)[::-1][:top].sum()
        assert abs(a - b) < 0.02 + 0.05 * b, (top, a, b)
    assert abs(p["term_len"].sum() / ref[1].sum() - 1) < 0.02
    assert abs(df_t.sum() / df_n.sum() - 1) < 0.02  # distinct terms a chunk
    assert abs(p["post_w"][:-P_MAX].mean() - ref[3][:-P_MAX].mean()) < 0.02


def test_folded_zipf_matches_numpy():
    pmf = data.zipf_folded_pmf(1.2, VOCAB)
    draws = data.zipf_terms_host(np.random.default_rng(1), 400_000, 1.2, VOCAB)
    emp = np.bincount(draws, minlength=VOCAB) / len(draws)
    assert np.abs(emp[:20] - pmf[:20]).max() < 3e-3
    assert abs(emp[1000:].sum() - pmf[1000:].sum()) < 3e-3
