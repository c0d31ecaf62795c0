"""BM25 scoring over impact-ordered postings (port of
``intool_rag_tpu/ops/bm25.py``).

Postings layout (built by :mod:`intool_rag_tpu_torch.index.bm25_index`):
``post_docs``/``post_w`` flat, grouped by term, impact-ordered within a
term, tail-padded by ``p_max``; ``term_start``/``term_len`` per-term
slice bounds; ``idf`` per term. The main path gathers each query term's
row of the two-tier row layout (:func:`build_row_layout`) and aggregates
duplicate doc ids with a sort plus a segmented sum, as the JAX version
does. Doc-id keys stay int32 throughout; sorts and ``cummax`` on int32
are exact.
"""

from __future__ import annotations

import numpy as np
import torch

from .topk import NEG_INF, blocked_topk, top_k

_I32_MAX = torch.iinfo(torch.int32).max


def _gather_postings(qterms, qtf, term_start, term_len, post_docs, post_w, idf, n_docs, p_max):
    """1-D layout gather: ``(docs [Q, T·p_max] i32, contrib f32 ≥ 0)``,
    padding slots set to the ``n_docs`` sentinel."""
    q, t = qterms.shape
    valid = qterms >= 0
    t_safe = qterms.clamp_min(0).long()
    start = term_start[t_safe].long()  # [Q, T]
    length = term_len[t_safe].clamp(max=p_max)
    pos = torch.arange(p_max, device=qterms.device)
    flat = (start[:, :, None] + pos).clamp(max=post_docs.shape[0] - 1)
    mask = (pos < length[:, :, None]) & valid[:, :, None]
    docs = post_docs[flat]
    w = post_w[flat]
    contrib = torch.where(mask, w * (idf[t_safe] * qtf)[:, :, None], 0.0).clamp_min(0.0)
    docs = torch.where(mask, docs, n_docs).to(torch.int32)
    return docs.reshape(q, t * p_max), contrib.reshape(q, t * p_max)


def bm25_scores(qterms, qtf, term_start, term_len, post_docs, post_w, idf, *, n_docs, p_max):
    """Exact BM25 scores ``[Q, n_docs] f32`` (up to impact pruning)."""
    docs, contrib = _gather_postings(
        qterms, qtf, term_start, term_len, post_docs, post_w, idf, n_docs, p_max
    )
    scores = torch.zeros((docs.shape[0], n_docs + 1), dtype=torch.float32, device=docs.device)
    scores.scatter_add_(1, docs.long(), contrib)
    return scores[:, :n_docs]


def _segment_totals(docs_s, vals_s, n_docs, neg):
    """Segmented sum over sorted doc ids (cumsum minus the cummax-carried
    exclusive prefix at each segment start; valid because values are ≥ 0).
    Returns per-slot totals at segment ends, ``neg`` elsewhere."""
    q = docs_s.shape[0]
    cs = torch.cumsum(vals_s, dim=1)
    excl = cs - vals_s
    prev = torch.cat([torch.full((q, 1), -1, dtype=docs_s.dtype, device=docs_s.device), docs_s[:, :-1]], 1)
    nxt = torch.cat([docs_s[:, 1:], torch.full((q, 1), _I32_MAX, dtype=docs_s.dtype, device=docs_s.device)], 1)
    is_start = docs_s != prev
    is_end = docs_s != nxt
    base = torch.cummax(torch.where(is_start, excl, torch.full_like(excl, -1)), dim=1).values
    totals = cs - base
    return torch.where(is_end & (docs_s < n_docs), totals, neg)


def _aggregate_topk(docs, contrib, k, n_docs):
    """Exact f32 aggregation: sort by doc id, segmented sum, blocked top-k.
    Empty slots come back as (0.0, id 0)."""
    docs_s, order = torch.sort(docs, dim=1, stable=True)
    # float64 prefix sums: a segment total is a difference of two prefix
    # sums over up to M slots, which in f32 carries ~M·2^-24 of the row's
    # whole mass as noise (the JAX version's f32 totals differ from exact
    # by up to ~2e-5 relative at M ≈ 4k)
    contrib_s = torch.gather(contrib, 1, order).double()
    slot = _segment_totals(docs_s, contrib_s, n_docs, torch.tensor(NEG_INF, device=docs.device)).float()
    vals, pos = blocked_topk(slot, min(k, slot.shape[1]), block=1024)
    ids = torch.gather(docs_s, 1, pos)
    finite = torch.isfinite(vals)
    return torch.where(finite, vals, 0.0), torch.where(finite, ids, 0)


def bm25_topk_sorted(
    qterms, qtf, term_start, term_len, post_docs, post_w, idf, k, *, n_docs, p_max
):
    """Scatter-free exact BM25 top-k over the 1-D postings (the oracle).
    Returns ``(scores [Q, k], ids [Q, k])``, empty slots (0.0, 0)."""
    docs, contrib = _gather_postings(
        qterms, qtf, term_start, term_len, post_docs, post_w, idf, n_docs, p_max
    )
    return _aggregate_topk(docs, contrib, k, n_docs)


def build_row_layout(term_start, term_len, post_docs, post_w, *, n_docs, p_max, cold_width=64):
    """Two-tier row layout plus ``term_wmax`` (first posting per term is its
    max, by impact order), built on the device of ``post_docs`` from the
    1-D postings. Returns the argument set of :func:`bm25_topk_rows` /
    :func:`bm25_topk_rows_packed` and a host copy ``term_hot_np``."""
    dev = post_docs.device
    lens = np.minimum(term_len.cpu().numpy(), p_max)
    hot = lens > cold_width
    term_row = np.zeros(len(lens), np.int32)
    term_row[hot] = np.arange(int(hot.sum()), dtype=np.int32)
    term_row[~hot] = np.arange(len(lens) - int(hot.sum()), dtype=np.int32)
    hot_terms = np.flatnonzero(hot)
    cold_terms = np.flatnonzero(~hot)
    if len(hot_terms) == 0:
        hot_terms = np.zeros(1, np.int64)
    if len(cold_terms) == 0:
        cold_terms = np.zeros(1, np.int64)

    def tier(terms, width):
        terms = torch.as_tensor(terms, device=dev)
        starts = term_start[terms].long()
        tl = term_len[terms].clamp(max=width)
        ar = torch.arange(width, device=dev)
        idx = (starts[:, None] + ar).clamp(0, post_docs.shape[0] - 1)
        valid = ar[None, :] < tl[:, None]
        docs = torch.where(valid, post_docs[idx], n_docs).to(torch.int32)
        w = torch.where(valid, post_w[idx], 0.0).float()
        return docs, w

    hd, hw = tier(hot_terms, p_max)
    cd, cw = tier(cold_terms, cold_width)
    wmax = torch.where(
        term_len > 0, post_w[term_start.long().clamp(0, post_w.shape[0] - 1)], 0.0
    ).float()
    return {
        "term_row": torch.as_tensor(term_row, device=dev),
        "term_hot": torch.as_tensor(hot, device=dev),
        "hot_docs": hd, "hot_w": hw,
        "cold_docs": cd, "cold_w": cw,
        "term_wmax": wmax,
        "term_hot_np": hot,
    }


def _gather_rows(qterms, qtf, term_row, term_hot, hot_docs, hot_w, cold_docs, cold_w, idf,
                 n_docs, hot_cap=None):
    """Two-tier row gather: flat ``(docs [Q, M] i32, contrib [Q, M] f32)``.
    With ``hot_cap`` the caller guarantees hot terms come first and number
    at most ``hot_cap`` per query, so the wide gather covers only the
    first ``hot_cap`` term slots."""
    q, t = qterms.shape
    p_max = hot_docs.shape[1]
    cold_width = cold_docs.shape[1]
    t_safe = qterms.clamp_min(0).long()
    row = term_row[t_safe].long()
    present = qterms >= 0
    is_hot = term_hot[t_safe] & present
    is_cold = ~term_hot[t_safe] & present
    scale = (idf[t_safe] * qtf)[:, :, None]

    th = t if hot_cap is None else min(hot_cap, t)
    is_hot_c = is_hot[:, :th]
    row_h = torch.where(is_hot_c, row[:, :th], 0)
    hd = hot_docs[row_h]  # [Q, th, p_max]
    hw = hot_w[row_h]
    h_contrib = torch.where(is_hot_c[:, :, None], hw * scale[:, :th], 0.0).clamp_min(0.0)
    hd = torch.where(is_hot_c[:, :, None], hd, n_docs)

    row_c = torch.where(is_cold, row, 0)
    cd = cold_docs[row_c]  # [Q, T, cold_width]
    cw = cold_w[row_c]
    c_contrib = torch.where(is_cold[:, :, None], cw * scale, 0.0).clamp_min(0.0)
    cd = torch.where(is_cold[:, :, None], cd, n_docs)

    docs = torch.cat([hd.reshape(q, th * p_max), cd.reshape(q, t * cold_width)], 1).to(torch.int32)
    contrib = torch.cat([h_contrib.reshape(q, th * p_max), c_contrib.reshape(q, t * cold_width)], 1)
    return docs, contrib


def bm25_topk_rows(qterms, qtf, term_row, term_hot, hot_docs, hot_w, cold_docs, cold_w, idf, k,
                   *, n_docs):
    """Row-layout BM25 top-k with exact f32 aggregation."""
    docs, contrib = _gather_rows(
        qterms, qtf, term_row, term_hot, hot_docs, hot_w, cold_docs, cold_w, idf, n_docs
    )
    return _aggregate_topk(docs, contrib, k, n_docs)


def _aggregate_topk_packed(docs, contrib, k, n_docs, qbits, scale=None):
    """Packed-key aggregation: each contribution quantizes to ``qbits``
    levels (floor at level 1 for any real contribution), ``doc·2^qbits +
    level`` packs into one int32 key, one sort, exact int32 segmented
    sum. ``scale`` upper-bounds contribution/levels."""
    levels = (1 << qbits) - 1
    if scale is None:
        scale = contrib.amax(dim=1, keepdim=True).clamp_min(1e-30) / levels
    lev = torch.where(
        contrib > 0, torch.round(contrib / scale).clamp(1, levels), 0.0
    ).to(torch.int32)
    key = docs * (levels + 1) + lev
    key_s, _ = torch.sort(key, dim=1)
    doc_s = key_s >> qbits
    lev_s = key_s & levels
    slot = _segment_totals(doc_s, lev_s, n_docs, torch.tensor(-1, dtype=torch.int32, device=docs.device))
    slot = slot.float()
    vals, pos = blocked_topk(slot, min(k, slot.shape[1]), block=1024)
    ids = torch.gather(doc_s, 1, pos)
    good = vals > 0
    return torch.where(good, vals * scale, 0.0), torch.where(good, ids, 0)


def _rescore_candidates_exact(docs, contrib, vals, ids):
    """Exact f32 rescore of the packed pool: each candidate's score is one
    masked sum over the gathered postings, blocked over K (16 candidates
    at a time) to bound the ``[Q, 16, M]`` transient."""
    k_eff = ids.shape[1]
    kb = 16
    outs = []
    for j0 in range(0, k_eff, kb):
        cand = ids[:, j0 : j0 + kb]
        match = docs[:, None, :] == cand[:, :, None]
        outs.append(torch.where(match, contrib[:, None, :], 0.0).sum(dim=-1))
    exact = torch.cat(outs, dim=1)
    exact = torch.where(vals > 0.0, exact, 0.0)
    vals2, pos = top_k(exact, k_eff)
    return vals2, torch.gather(ids, 1, pos)


def bm25_topk_rows_packed(
    qterms, qtf, term_row, term_hot, hot_docs, hot_w, cold_docs, cold_w, idf, k,
    *, n_docs, qbits=11, term_wmax=None, hot_cap=None, rescore=True,
):
    """The main-path BM25 top-k: row gather + packed single-key
    aggregation, then an exact f32 rescore of the pool. Needs
    ``n_docs < 2^(31 - qbits)``. With ``term_wmax`` the quantization grid
    is ``max_t q_tf·idf_t·wmax_t / levels`` (query and corpus statistics
    only)."""
    if n_docs >= 1 << (31 - qbits):
        raise ValueError(f"n_docs={n_docs} overflows packed keys with qbits={qbits}")
    docs, contrib = _gather_rows(
        qterms, qtf, term_row, term_hot, hot_docs, hot_w, cold_docs, cold_w, idf, n_docs, hot_cap
    )
    scale = None
    if term_wmax is not None:
        t_safe = qterms.clamp_min(0).long()
        cbound = torch.where(qterms >= 0, qtf * idf[t_safe] * term_wmax[t_safe], 0.0)
        scale = cbound.amax(dim=1, keepdim=True).clamp_min(1e-30) / ((1 << qbits) - 1)
    vals, ids = _aggregate_topk_packed(docs, contrib, k, n_docs, qbits, scale)
    if rescore:
        vals, ids = _rescore_candidates_exact(docs, contrib, vals, ids)
    return vals, ids
