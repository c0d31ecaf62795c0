"""Exact hybrid search, plain PyTorch: dense scores over the stored (bf16)
corpus rows in float32 products then float64, clamped into [0, 1] as the
cosine score space; BM25 as the sum over a question's terms of
count × idf × posting weight, in float64, over the postings as drawn; and
the weighted fusion of two candidate pools. The control computes each in
the precision below the configuration's: dense operands rounded to
``control_bits``-bit integers (per row and per query), bf16 BM25 sums,
bf16 fusion.
"""

from __future__ import annotations

import numpy as np
import torch

from .encoder import exact_f32, int_rows


def _clamp(x: torch.Tensor) -> torch.Tensor:
    return x.clamp(0.0, 1.0)


def dense_topk(queries: torch.Tensor, corpus: torch.Tensor, valid_n: int, k: int, *, control_bits: int = 0,
               block: int = 131072) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k of the clamped scores over the first ``valid_n`` rows:
    ``(values f64 [Q, k] descending, rows i64)``; with ``control_bits`` of
    the rounded operands' scores."""
    d = queries.shape[1]
    q = queries.float()
    control = bool(control_bits)
    if control:
        q = int_rows(q, control_bits)
    best_v = torch.full((q.shape[0], k), float("-inf"), device=q.device)
    best_i = torch.full((q.shape[0], k), -1, dtype=torch.long, device=q.device)
    with exact_f32(), torch.no_grad():
        for start in range(0, valid_n, block):
            rows = corpus[start : min(start + block, valid_n), :d].float()
            if control:
                rows = int_rows(rows, control_bits)
            v, i = torch.topk(q @ rows.T, min(k, rows.shape[0]), dim=1)
            mv, mi = torch.cat([best_v, v], 1), torch.cat([best_i, i + start], 1)
            best_v, pos = torch.topk(mv, k, dim=1)
            best_i = torch.gather(mi, 1, pos)
    if control:
        return _clamp(best_v.double()), best_i
    vals = dense_scores(queries, corpus, valid_n, best_i)
    vals, order = torch.sort(vals, dim=1, descending=True, stable=True)
    return vals, torch.gather(best_i, 1, order)


def dense_scores(queries: torch.Tensor, corpus: torch.Tensor, valid_n: int, rows: torch.Tensor) -> torch.Tensor:
    """Clamped float64 scores of ``rows [Q, K]``; a row outside
    [0, valid_n) scores NaN."""
    d = queries.shape[1]
    rows = rows.long()
    ok = (rows >= 0) & (rows < valid_n)
    vecs = corpus[rows.clamp(0, valid_n - 1), :d].double()
    vals = _clamp(torch.einsum("qkd,qd->qk", vecs, queries.double()))
    return torch.where(ok, vals, torch.nan)


def _triples(query_terms: list[list[tuple[int, int]]], device):
    qi, tid, tf = [], [], []
    for i, terms in enumerate(query_terms):
        for t, c in terms:
            qi.append(i)
            tid.append(t)
            tf.append(c)
    as_t = lambda x, dt: torch.tensor(x, dtype=dt, device=device)
    return as_t(qi, torch.long), as_t(tid, torch.long), as_t(tf, torch.float64)


def bm25_dense(query_terms: list[list[tuple[int, int]]], postings: dict, n_docs: int, *,
               control: bool = False) -> torch.Tensor:
    """Every document's score, ``[Q, n_docs]`` (f64; bf16 sums with ``control``)."""
    dev = postings["post_docs"].device
    qi, tid, tf = _triples(query_terms, dev)
    lens = postings["term_len"][tid].long()
    starts = postings["term_start"][tid].long()
    idx = torch.repeat_interleave(torch.arange(tid.numel(), device=dev), lens)
    offs = torch.arange(idx.numel(), device=dev) - (torch.cumsum(lens, 0) - lens)[idx]
    pos = starts[idx] + offs
    docs = postings["post_docs"][pos].long()
    w = postings["post_w"][pos].double()
    contrib = tf[idx] * postings["idf"][tid[idx]].double() * w
    dtype = torch.bfloat16 if control else torch.float64
    scores = torch.zeros((len(query_terms), n_docs + 1), dtype=dtype, device=dev)
    scores.index_put_((qi[idx], docs), contrib.to(dtype), accumulate=True)
    return scores[:, :n_docs]


def bm25_grid(query_terms, postings: dict, bits: int) -> torch.Tensor:
    """``[Q]``: how far a pool chosen on a grid of ``2^bits − 1`` levels of
    each term's contribution may misorder two documents: every contribution
    rounds to a level of ``max_t count × idf × largest weight / (2^bits − 1)``
    (a level at least, so by one level at most), two documents each by one
    level a term. Zero where ``bits`` is 0 (exact sums choose the pool)."""
    dev = postings["post_docs"].device
    out = torch.zeros(len(query_terms), dtype=torch.float64, device=dev)
    if not bits:
        return out
    for i, terms in enumerate(query_terms):
        if terms:
            tid = torch.tensor([t for t, _ in terms], dtype=torch.long, device=dev)
            tf = torch.tensor([c for _, c in terms], dtype=torch.float64, device=dev)
            wmax = postings["post_w"][postings["term_start"][tid].long()].double()  # impact order: the first is the largest
            wmax = torch.where(postings["term_len"][tid] > 0, wmax, 0.0)
            top = (tf * postings["idf"][tid].double() * wmax).max()
            out[i] = 2 * len(terms) * top / ((1 << bits) - 1)
    return out


def bm25_topk(query_terms, postings: dict, n_docs: int, k: int, *, control: bool = False,
              block: int = 64) -> tuple[torch.Tensor, torch.Tensor]:
    """``(values f64 [Q, k] descending, rows i64)``; past the matching
    documents the values are 0."""
    vals, rows = [], []
    for start in range(0, len(query_terms), block):
        scores = bm25_dense(query_terms[start : start + block], postings, n_docs, control=control)
        v, r = torch.topk(scores.double(), k, dim=1)
        vals.append(v)
        rows.append(r)
    return torch.cat(vals), torch.cat(rows)


def bm25_scores(query_terms, postings: dict, n_docs: int, rows: torch.Tensor, block: int = 64) -> torch.Tensor:
    """Exact f64 scores of ``rows [Q, K]``; a row outside [0, n_docs) scores NaN."""
    out = []
    rows = rows.long()
    for start in range(0, len(query_terms), block):
        scores = bm25_dense(query_terms[start : start + block], postings, n_docs)
        r = rows[start : start + block]
        ok = (r >= 0) & (r < n_docs)
        out.append(torch.where(ok, torch.gather(scores, 1, r.clamp(0, n_docs - 1)), torch.nan))
    return torch.cat(out)


def fuse(d_vals: np.ndarray, d_rows: np.ndarray, s_vals: np.ndarray, s_rows: np.ndarray, k: int,
         w_dense: float, w_sparse: float, *, control: bool = False) -> list[tuple[list, dict]]:
    """Weighted fusion of one batch's pools, per query: ``(top-k [(row,
    value)] descending, {row: fused value})``. A dense candidate with a
    non-finite score and a BM25 candidate with score ≤ 0 are no candidate;
    BM25 scores are min-max normalised over the whole pool as given; a row
    missing from one pool scores 0 there."""
    rnd = (lambda x: float(torch.tensor(x, dtype=torch.float64).bfloat16())) if control else float
    out = []
    for dv, dr, sv, sr in zip(d_vals, d_rows, s_vals, s_rows):
        lo, hi = float(np.min(sv)), float(np.max(sv))
        span = max(hi - lo, 1e-9)
        dense: dict[int, float] = {}
        for v, r in zip(dv, dr):
            if np.isfinite(v) and r >= 0 and int(r) not in dense:
                dense[int(r)] = rnd(float(v))
        sparse: dict[int, float] = {}
        for v, r in zip(sv, sr):
            if v > 0 and r >= 0 and int(r) not in sparse:
                sparse[int(r)] = rnd((float(v) - lo) / span)
        fused = {r: rnd(w_dense * dense.get(r, 0.0) + w_sparse * sparse.get(r, 0.0))
                 for r in dense.keys() | sparse.keys()}
        top = sorted(fused.items(), key=lambda kv: (-kv[1], kv[0]))[:k]
        out.append((top, fused))
    return out


# ---------------------------------------------------------------- the capacity tier
#
# The bits tier's lists come from a k-means over a sample that the program
# draws itself, so its centroids and the placement of rows in lists are the
# program's state: the reference takes them as given, checks the placement
# against the centroids on its own (:func:`misplaced`), and judges the
# probes, the scan and the refine that follow from them.

N_PLANES = 8


def row_lists(gid: torch.Tensor, cap_l: int, valid_n: int) -> tuple[torch.Tensor, torch.Tensor, bool]:
    """``(list of each row [valid_n] i64, its slot, −1 where unstored;
    whether every row is stored exactly once)`` from the slot → row table
    ``gid`` (list ``l`` owns slots ``[l·cap_l, (l+1)·cap_l)``)."""
    gid = gid.long()
    slots = torch.nonzero(gid >= 0).squeeze(1)
    rows = gid[slots]
    inside = (rows >= 0) & (rows < valid_n)
    counts = torch.bincount(rows[inside], minlength=valid_n)
    once = bool(inside.all()) and bool((counts == 1).all())
    slot_of_row = torch.full((valid_n,), -1, dtype=torch.long, device=gid.device)
    slot_of_row[rows[inside]] = slots[inside]
    return torch.where(slot_of_row >= 0, slot_of_row // cap_l, -1), slot_of_row, once


def misplaced(corpus: torch.Tensor, valid_n: int, centroids: torch.Tensor, lists: torch.Tensor, *,
              choices: int = 4, block: int = 65536) -> float:
    """The share of rows whose list is not among their ``choices`` nearest
    centroids by float64 dot product (the tier places a row in its nearest
    list with room, trying ``choices`` of them)."""
    d = centroids.shape[1]
    c = centroids.double()
    bad = 0
    for start in range(0, valid_n, block):
        x = corpus[start : min(start + block, valid_n), :d].double()
        near = torch.topk(x @ c.T, choices, dim=1).indices
        bad += int((near != lists[start : start + x.shape[0], None]).all(dim=1).sum())
    return bad / max(valid_n, 1)


def probe_table(queries: torch.Tensor, centroids: torch.Tensor, nprobe: int, *,
                dtype=torch.float64) -> tuple[torch.Tensor, torch.Tensor]:
    """The tier's probe choice: queries sorted (stably) by nearest centroid
    into tiles of 8 (the last padded with the last query); each tile probes
    every member's nearest list and, in the remaining slots, the lists of
    largest summed dot product over its members. ``(order [Qp], probes
    [Qp/8, nprobe])``; the dots in ``dtype``."""
    q = queries.shape[0]
    dots = (queries.to(dtype) @ centroids[:, : queries.shape[1]].to(dtype).T).double()
    order = torch.argsort(dots.argmax(dim=1), stable=True)
    q_pad = -(-q // 8) * 8
    order = torch.cat([order, order[-1:].expand(q_pad - q)])
    tiles = dots[order].reshape(q_pad // 8, 8, -1)
    sums = tiles.sum(dim=1).to(dtype).double()
    sums.scatter_(1, tiles.argmax(dim=2), float("inf"))
    return order, torch.topk(sums, nprobe, dim=1).indices


def probe_gap(queries: torch.Tensor, centroids: torch.Tensor, order: torch.Tensor, probes: torch.Tensor, *,
              tie: float = 1e-5) -> float:
    """The program's probe table against the rule of :func:`probe_table` in
    float64, over the program's own tiles: 1 where ``order`` does not hold
    every query or a tile probes a list twice; else the widest of (a
    member's largest dot − its largest dot among the tile's probes) and,
    over the lists a tile chooses beyond its members' nearest, (the j-th
    largest member-mean dot among the lists it may choose − that of its
    j-th chosen one). A list within ``tie`` of a member's largest dot counts
    as that member's nearest, so float32 near-ties choose either."""
    q = queries.shape[0]
    order, probes = order.long(), probes.long()
    if sorted(order[:q].tolist()) != list(range(q)) or order.numel() != 8 * probes.shape[0]:
        return 1.0
    dots = queries.double() @ centroids[:, : queries.shape[1]].double().T  # the padded width holds zeros
    tiles = dots[order].reshape(probes.shape[0], 8, -1)
    worst = 0.0
    for t in range(probes.shape[0]):
        chosen = probes[t]
        if torch.unique(chosen).numel() != chosen.numel():
            return 1.0
        top = tiles[t].max(dim=1, keepdim=True).values  # [8, 1]
        worst = max(worst, float((top[:, 0] - tiles[t][:, chosen].max(dim=1).values).max()))
        nearest = (tiles[t] >= top - tie).any(dim=0)  # every list that may count as a member's nearest
        mean = tiles[t].mean(dim=0)
        picked = mean[chosen[~nearest[chosen]]].sort(descending=True).values
        best = mean[~nearest].sort(descending=True).values[: picked.numel()]
        if picked.numel():
            worst = max(worst, float((best - picked).max()))
    return worst


def tile_of(order: torch.Tensor, q: int) -> torch.Tensor:
    """``[q]``: each query's tile of 8 in the scan's query order."""
    tile = torch.empty(q, dtype=torch.long, device=order.device)
    tile[order.long()[:q]] = torch.arange(q, device=order.device) // 8
    return tile


def probed(order: torch.Tensor, probes: torch.Tensor, q: int, n_lists: int) -> torch.Tensor:
    """``[q, n_lists]`` bool: the lists each query's tile probes."""
    member = torch.zeros((q, n_lists), dtype=torch.bool, device=order.device)
    member.scatter_(1, probes.long()[tile_of(order, q)], True)
    return member


def scan_groups(rows: torch.Tensor, lists: torch.Tensor, slot_of_row: torch.Tensor, probes: torch.Tensor,
                layout: dict, k: int) -> torch.Tensor:
    """``[Q, K]``: the candidate group of each row in the scan's grouped top-k
    tail, for its query's probe list ``probes [Q, nprobe]`` (−1 where the row
    is not scanned). The scan's documented candidate layout: probe ``p``'s
    block ``bi`` fills columns ``(p·blocks_per_list + bi)·lw + lane`` (``lw =
    block_n / group_l``) with the largest of its ``group_l`` slots of that
    lane, and where the columns number at least ``8·k`` the two halves of the
    columns fold onto each other. Two rows of one group never both reach
    the top-k, so a row the scan drops for a better row of its group is no
    fault of the scan."""
    block_n, bpl, group_l = layout["block_n"], layout["blocks_per_list"], layout["group_l"]
    lw = block_n // group_l
    rows = rows.long()
    lst = lists[rows.clamp_min(0)]
    pos = (probes.long()[:, :, None] == lst[:, None, :]).int().argmax(dim=1)  # [Q, K]: which probe scans it
    scanned = (probes.long()[:, :, None] == lst[:, None, :]).any(dim=1) & (rows >= 0)
    offset = slot_of_row[rows.clamp_min(0)] - lst * layout["cap_l"]
    col = (pos * bpl + offset // block_n) * lw + offset % block_n % lw
    n_cand = probes.shape[1] * bpl * lw
    if n_cand >= 8 * min(k, n_cand):
        half = n_cand // 2
        scanned &= col < 2 * half
        col = col % half
    return torch.where(scanned, col, -1)


def bits_topk(queries: torch.Tensor, corpus: torch.Tensor, valid_n: int, centroids: torch.Tensor,
              lists: torch.Tensor, member: torch.Tensor, k: int, *, query_dtype=torch.float32, query_bits: int = 0,
              block: int = 65536) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k of the tier's scan over each query's probed lists: a row in
    list ``l`` scores ``q·c_l + q·r̂``, ``r̂`` the sign of each of the 8
    planes of ``r = x − c_l`` times that plane's mean ``|r|``, in float32
    products with TF32 off. The query operand of ``q·r̂`` is rounded to
    ``query_dtype`` (the scan's stated operand) or, with ``query_bits``, to
    that many bits per query. ``(values [Q, k], rows i64)``."""
    d = centroids.shape[1]  # the store's padded width, which the planes divide
    q = torch.nn.functional.pad(queries.float(), (0, d - queries.shape[1]))
    qr = int_rows(q, query_bits) if query_bits else q.to(query_dtype).float()
    c = centroids.float()
    best_v = torch.full((q.shape[0], k), float("-inf"), device=q.device)
    best_i = torch.full((q.shape[0], k), -1, dtype=torch.long, device=q.device)
    with exact_f32(), torch.no_grad():
        qc = q @ c.T
        for start in range(0, valid_n, block):
            stop = min(start + block, valid_n)
            lst = lists[start:stop]
            ok = lst >= 0
            li = lst.clamp_min(0)
            r = (corpus[start:stop, :d].float() - c[li]).reshape(stop - start, N_PLANES, d // N_PLANES)
            gain = r.abs().mean(dim=2, keepdim=True)
            rhat = torch.where(r >= 0, gain, -gain).reshape(stop - start, d)
            scores = qc[:, li] + qr @ rhat.T
            scores = scores.masked_fill(~(member[:, li] & ok), float("-inf"))
            v, i = torch.topk(scores, min(k, stop - start), dim=1)
            mv, mi = torch.cat([best_v, v], 1), torch.cat([best_i, i + start], 1)
            best_v, pos = torch.topk(mv, k, dim=1)
            best_i = torch.gather(mi, 1, pos)
    return best_v, torch.where(torch.isfinite(best_v), best_i, -1)


def int_scores(queries: torch.Tensor, corpus: torch.Tensor, rows: torch.Tensor, bits: int, *,
               query_too: bool = True) -> torch.Tensor:
    """Clamped scores of ``rows [Q, K]`` (−1 empty: −inf) with each row, and
    with ``query_too`` each query, rounded to ``bits``-bit integers."""
    d = queries.shape[1]
    safe = rows.long().clamp_min(0)
    q = queries.float()
    with exact_f32():
        vecs = int_rows(corpus[safe, :d].float(), bits)
        vals = torch.einsum("qkd,qd->qk", vecs, int_rows(q, bits) if query_too else q).double()
    return torch.where(rows >= 0, _clamp(vals), float("-inf"))
