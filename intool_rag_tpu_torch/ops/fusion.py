"""Hybrid fusion: weighted score combination and reciprocal-rank fusion
(port of ``intool_rag_tpu/ops/fusion.py``).

The id join is sort-based: candidates sort by id, equal ids become
adjacent, and each candidate's contributions combine across its (at most
two, one per retriever) occurrences by looking one slot left and right.
Invalid ids (< 0) sort last as a sentinel and come back as -1.
"""

from __future__ import annotations

import torch

from .topk import NEG_INF, top_k

_SENTINEL = torch.iinfo(torch.int32).max


def _sorted_join(ids: torch.Tensor, parts: list[torch.Tensor]):
    """Sort candidates by id. Returns (sorted_ids, sorted_parts,
    same_prev, same_next) where same_prev/next flag adjacent equal ids."""
    clean = torch.where(ids < 0, _SENTINEL, ids)
    sid, order = torch.sort(clean, dim=1, stable=True)
    sparts = [torch.gather(p, 1, order) for p in parts]
    zeros = torch.zeros_like(sid[:, :1], dtype=torch.bool)
    same_prev = torch.cat([zeros, sid[:, 1:] == sid[:, :-1]], dim=1)
    same_next = torch.cat([sid[:, :-1] == sid[:, 1:], zeros], dim=1)
    return sid, sparts, same_prev, same_next


def _combine_neighbors(x, same_prev, same_next):
    """x[i] + x[i-1]·same_prev + x[i+1]·same_next (exact pairwise join)."""
    left = torch.nn.functional.pad(x[:, :-1], (1, 0))
    right = torch.nn.functional.pad(x[:, 1:], (0, 1))
    return x + torch.where(same_prev, left, 0.0) + torch.where(same_next, right, 0.0)


def _select_topk(sid, fused, same_prev, k):
    """Mask duplicates and sentinels, take top-k, map sentinel ids to -1."""
    valid = (sid != _SENTINEL) & ~same_prev
    fused = torch.where(valid, fused, NEG_INF)
    k = min(k, sid.shape[1])
    vals, pos = top_k(fused, k)
    out_ids = torch.gather(sid, 1, pos)
    out_ids = torch.where(torch.isfinite(vals), out_ids, -1)
    return vals, out_ids


def weighted_fusion(
    dense_idx: torch.Tensor,  # [Q, Kd] i32
    dense_scores: torch.Tensor,  # [Q, Kd] f32 in [0, 1]
    sparse_idx: torch.Tensor,  # [Q, Ks] i32
    sparse_scores: torch.Tensor,  # [Q, Ks] f32 in [0, 1]
    k: int,
    *,
    w_dense: float = 0.7,
    w_sparse: float = 0.3,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Weighted-sum fusion over the union of two candidate lists; a
    candidate missing from one list scores 0 there. Returns top-k
    ``(scores [Q, k], ids [Q, k])``."""
    ids = torch.cat([dense_idx, sparse_idx], dim=1)
    d_part = torch.cat([dense_scores, torch.zeros_like(sparse_scores)], dim=1)
    s_part = torch.cat([torch.zeros_like(dense_scores), sparse_scores], dim=1)
    sid, (d_s, s_s), same_prev, same_next = _sorted_join(ids, [d_part, s_part])
    d_full = _combine_neighbors(d_s, same_prev, same_next)
    s_full = _combine_neighbors(s_s, same_prev, same_next)
    # one rounding for w_dense·d + (w_sparse·s), as XLA's fused multiply-add
    # computes it: the f32·f32 product is exact in float64
    w_d = torch.tensor(w_dense, dtype=torch.float32).double()
    fused = (w_d * d_full.double() + (w_sparse * s_full).double()).float()
    return _select_topk(sid, fused, same_prev, k)


def rrf_fusion(
    dense_idx: torch.Tensor,
    sparse_idx: torch.Tensor,
    k: int,
    *,
    rrf_k: int = 60,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Reciprocal-rank fusion: score(c) = Σ_lists 1/(rrf_k + rank(c)) with
    1-based ranks. Returns top-k ``(fused_scores [Q,k], ids [Q,k])``."""
    q, kd = dense_idx.shape
    ks = sparse_idx.shape[1]
    dev = dense_idx.device
    ids = torch.cat([dense_idx, sparse_idx], dim=1)
    rank_d = 1.0 / (rrf_k + 1.0 + torch.arange(kd, dtype=torch.float32, device=dev))
    rank_s = 1.0 / (rrf_k + 1.0 + torch.arange(ks, dtype=torch.float32, device=dev))
    contrib = torch.cat([rank_d.expand(q, kd), rank_s.expand(q, ks)], dim=1)
    sid, (c_s,), same_prev, same_next = _sorted_join(ids, [contrib])
    fused = _combine_neighbors(c_s, same_prev, same_next)
    return _select_topk(sid, fused, same_prev, k)


def normalize_minmax(scores: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Min-max normalize candidate scores into [0, 1] per query."""
    lo = scores.amin(dim=axis, keepdim=True)
    hi = scores.amax(dim=axis, keepdim=True)
    return (scores - lo) / (hi - lo).clamp_min(1e-9)
