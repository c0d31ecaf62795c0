"""Evaluation harness over a HybridEngine: run queries with known
relevance judgments, report Recall@K / MRR / NDCG per retrieval mode
(dense-only, sparse-only, hybrid, rerank) so fusion and reranking gains
are measurable (port of ``intool_rag_tpu/eval/harness.py``)."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..index.bm25_index import BM25Index
from ..index.chunk_store import ChunkStore
from ..index.hybrid import HybridEngine
from .metrics import mrr, ndcg_at_k, recall_at_k


@dataclasses.dataclass
class EvalExample:
    query: str
    relevant_rows: set  # corpus row indices judged (fully) relevant
    # graded judgments (row → linear gain) for NDCG; when present,
    # recall/MRR stay binary on relevant_rows (the full-credit set) and
    # NDCG uses the gains: the TREC convention for graded pools
    gains: dict | None = None


def evaluate_engine(
    engine: HybridEngine,
    provider,
    examples: list[EvalExample],
    *,
    k: int = 10,
    modes: tuple[str, ...] = ("dense", "sparse", "hybrid"),
    reranker=None,
    rerank_candidates: int = 50,
) -> dict[str, dict[str, float]]:
    """Returns mode → {recall@k, mrr, ndcg@k} averaged over examples.

    Mode ``"rerank"`` (requires ``reranker``) retrieves
    ``rerank_candidates`` hybrid hits and reorders them with the
    cross-encoder before cutting to k (retrieve-N → rerank-k)."""
    queries = [e.query for e in examples]
    emb = torch.as_tensor(provider.embed_batch(queries, is_query=True), device=engine.store.device)
    results: dict[str, dict[str, float]] = {}
    for mode in modes:
        if mode == "dense":
            _, rows = engine.search(queries, emb, k, hybrid=False)
            ranked_lists = rows.cpu().numpy()
        elif mode == "sparse":
            if engine.bm25 is None:
                raise ValueError("sparse mode needs an engine with a BM25 index")
            vals, rows = engine.bm25.topk(queries, k)
            ranked_lists = torch.where(vals > 0, rows, -1).cpu().numpy()
        elif mode == "rerank":
            if reranker is None:
                raise ValueError("rerank mode needs a reranker")
            _, rows = engine.search(queries, emb, rerank_candidates, candidates=rerank_candidates, hybrid=True)
            rows = rows.cpu().numpy()
            # score every (query, candidate) pair in one bucketed pass
            flat_q, flat_p, owner = [], [], []
            for qi, (query, cand) in enumerate(zip(queries, rows)):
                for r in cand:
                    if r >= 0:
                        flat_q.append(query)
                        flat_p.append(engine.store.texts[int(r)])
                        owner.append((qi, int(r)))
            scores = reranker.score_pairs(flat_q, flat_p)
            per_q: list[list[tuple[float, int]]] = [[] for _ in queries]
            for (qi, r), s in zip(owner, scores):
                per_q[qi].append((float(s), r))
            ranked_lists = np.full((len(queries), k), -1, np.int64)
            for qi, cand in enumerate(per_q):
                cand.sort(key=lambda t: -t[0])
                for j, (_, r) in enumerate(cand[:k]):
                    ranked_lists[qi, j] = r
        else:
            _, rows = engine.search(queries, emb, k, hybrid=True)
            ranked_lists = rows.cpu().numpy()
        agg = {"recall@k": 0.0, "mrr": 0.0, "ndcg@k": 0.0}
        for example, ranked in zip(examples, ranked_lists):
            ranked = [int(r) for r in ranked if r >= 0]
            agg["recall@k"] += recall_at_k(ranked, example.relevant_rows, k)
            agg["mrr"] += mrr(ranked, example.relevant_rows)
            agg["ndcg@k"] += ndcg_at_k(ranked, example.relevant_rows, k, gains=example.gains)
        n = max(len(examples), 1)
        results[mode] = {name: round(v / n, 4) for name, v in agg.items()}
    return results


def build_engine_from_texts(
    texts: list[str], provider, *, dtype: str = "float32", device: str | torch.device | None = None
) -> HybridEngine:
    """Convenience: embed + index a text corpus into a HybridEngine."""
    emb = provider.embed_batch(texts)
    store = ChunkStore(dim=emb.shape[1], dtype=dtype, device=device)
    store.append(
        np.asarray(emb, np.float32),
        doc_id="eval",
        chunk_ids=[f"c_{i:06d}" for i in range(len(texts))],
        pages=[0] * len(texts),
        texts=texts,
    )
    return HybridEngine(store, BM25Index.build(texts, device=store.device))
