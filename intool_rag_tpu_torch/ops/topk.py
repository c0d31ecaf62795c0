"""Exact blockwise dense search and top-k helpers (port of
``intool_rag_tpu/ops/topk.py``).

Plain PyTorch; these are the oracles the fused kernels are held against
and the dense path when the hand-written kernels are off (``USE_PALLAS=0``).

Metrics:
- ``ip``      inner product (MIPS).
- ``cosine``  inner product over unit vectors, clamped into [0, 1] (the
  reference service's ``1 - d/2`` score space).
- ``l2``      ranking by ``2·q·e - |e|²`` (query norm is rank-invariant).

Ties: :func:`top_k` orders equal values by ascending position, as
``jax.lax.top_k`` does, so selections are identical to the JAX package's.
"""

from __future__ import annotations

import torch

NEG_INF = float("-inf")


def top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last axis, sorted descending, ties by lower index
    (a stable sort; ``torch.topk`` leaves tie order unspecified)."""
    vals, pos = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], pos[..., :k]


def merge_topk(
    values_a: torch.Tensor,
    indices_a: torch.Tensor,
    values_b: torch.Tensor,
    indices_b: torch.Tensor,
    k: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Merge two (values, indices) top-k sets along the last axis."""
    values = torch.cat([values_a, values_b], dim=-1)
    indices = torch.cat([indices_a, indices_b], dim=-1)
    top_vals, top_pos = top_k(values, k)
    return top_vals, torch.gather(indices, -1, top_pos)


def _block_scores(queries, block, block_norms_sq, metric):
    scores = queries.float() @ block.float().T
    if metric == "l2":
        scores = 2.0 * scores - block_norms_sq[None, :]
    return scores


def clamp_cosine(vals: torch.Tensor) -> torch.Tensor:
    """Reference score space: finite scores clamp into [0, 1]; -inf of
    masked rows stays so padding can never outrank a real row."""
    return torch.where(torch.isfinite(vals), vals.clamp(0.0, 1.0), vals)


def flat_topk(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    k: int,
    *,
    metric: str = "cosine",
    block_n: int = 16384,
    valid_n: int | None = None,
    corpus_norms_sq: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k of ``queries [Q, D]`` against ``corpus [N, D]`` in corpus
    blocks of ``block_n`` rows (the [Q, N] scores are never whole).

    Returns ``(scores [Q, k] f32, rows [Q, k] i32)`` sorted descending.
    Queries take the corpus dtype before the product, products accumulate
    in f32 (as the JAX version's ``preferred_element_type``)."""
    n, _ = corpus.shape
    q = queries.shape[0]
    if valid_n is None:
        valid_n = n
    k = min(k, n)
    if metric == "l2" and corpus_norms_sq is None:
        corpus_norms_sq = (corpus.float() ** 2).sum(dim=1)
    block_n = min(block_n, n)
    queries = queries.to(corpus.dtype)
    best_vals = torch.full((q, k), NEG_INF, dtype=torch.float32, device=corpus.device)
    best_idx = torch.full((q, k), -1, dtype=torch.int32, device=corpus.device)
    for start in range(0, n, block_n):
        block = corpus[start : start + block_n]
        bnorms = corpus_norms_sq[start : start + block_n] if metric == "l2" else None
        scores = _block_scores(queries, block, bnorms, metric)
        ids = torch.arange(start, start + block.shape[0], device=corpus.device, dtype=torch.int32)
        scores = torch.where(ids[None, :] < valid_n, scores, NEG_INF)
        block_vals, block_pos = top_k(scores, min(k, block.shape[0]))
        best_vals, best_idx = merge_topk(best_vals, best_idx, block_vals, ids[block_pos], k)
    if metric == "cosine":
        best_vals = clamp_cosine(best_vals)
    return best_vals, best_idx


def rescore_candidates(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    rows: torch.Tensor,
    *,
    metric: str = "cosine",
) -> torch.Tensor:
    """Exact f32 scores of a small candidate set ``rows [Q, K]`` (-1
    allowed). Returns [Q, K] f32 with -inf where ``rows < 0``."""
    safe = rows.clamp_min(0).long()
    cand = corpus[safe].float()  # [Q, K, D]
    scores = torch.einsum("qd,qkd->qk", queries.float(), cand)
    if metric == "l2":
        scores = 2.0 * scores - (cand * cand).sum(dim=-1)
    elif metric == "cosine":
        scores = scores.clamp(0.0, 1.0)
    return torch.where(rows >= 0, scores, NEG_INF)


def blocked_topk(
    scores: torch.Tensor, k: int, *, block: int = 1024
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k over the last axis in two stages: top-k within each
    ``block``-wide slice, then over the survivors (a block holds at most
    k of the global top-k, so this is exact). Positions are int64."""
    q, m = scores.shape
    k = min(k, m)
    if m <= block or m <= 2 * k:
        return top_k(scores, k)
    num_blocks = -(-m // block)
    padded = num_blocks * block
    if padded != m:
        scores = torch.nn.functional.pad(scores, (0, padded - m), value=NEG_INF)
    blocked = scores.reshape(q, num_blocks, block)
    kb = min(k, block)
    b_vals, b_pos = top_k(blocked, kb)
    base = (torch.arange(num_blocks, device=scores.device) * block)[None, :, None]
    b_idx = (b_pos + base).reshape(q, num_blocks * kb)
    vals, pos = top_k(b_vals.reshape(q, num_blocks * kb), k)
    return vals, torch.gather(b_idx, 1, pos)


def exact_scores(
    queries: torch.Tensor, corpus: torch.Tensor, metric: str = "cosine"
) -> torch.Tensor:
    """Full [Q, N] scores: small corpora and tests only."""
    scores = queries.to(corpus.dtype).float() @ corpus.float().T
    if metric == "l2":
        scores = 2.0 * scores - (corpus.float() ** 2).sum(dim=1)[None, :]
    elif metric == "cosine":
        scores = scores.clamp(0.0, 1.0)
    return scores
