"""Ranking metrics: Recall@K, MRR, NDCG@K."""

from __future__ import annotations

import math
from typing import Sequence


def recall_at_k(ranked: Sequence, relevant: set, k: int) -> float:
    """|top-k ∩ relevant| / |relevant|."""
    if not relevant:
        return 0.0
    return len(set(ranked[:k]) & relevant) / len(relevant)


def mrr(ranked: Sequence, relevant: set) -> float:
    """Reciprocal rank of the first relevant item (0 if none)."""
    for i, item in enumerate(ranked):
        if item in relevant:
            return 1.0 / (i + 1)
    return 0.0


def ndcg_at_k(
    ranked: Sequence, relevant: set, k: int, gains: dict | None = None
) -> float:
    """NDCG@K — binary gains by default; pass ``gains`` (item → gain,
    linear-gain convention) for graded relevance (the harder eval
    family, eval/synthetic.make_relevance_task_graded). Items absent
    from ``gains`` score 0."""
    if gains is None:
        dcg = sum(
            1.0 / math.log2(i + 2)
            for i, item in enumerate(ranked[:k])
            if item in relevant
        )
        ideal = sum(1.0 / math.log2(i + 2) for i in range(min(len(relevant), k)))
        return dcg / ideal if ideal else 0.0
    dcg = sum(
        gains.get(item, 0.0) / math.log2(i + 2)
        for i, item in enumerate(ranked[:k])
    )
    top = sorted(gains.values(), reverse=True)[:k]
    ideal = sum(g / math.log2(i + 2) for i, g in enumerate(top))
    return dcg / ideal if ideal else 0.0
