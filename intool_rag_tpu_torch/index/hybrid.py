"""Hybrid retrieval engine: dense + BM25 + fusion (port of
``intool_rag_tpu/index/hybrid.py``).

Dense candidates come from the flat index (the fused kernels on the
card) or, with ``INDEX_KIND=bits``, from the capacity tier; sparse
candidates from the BM25 postings ops; fusion is weighted
(``VECTOR_WEIGHT``/``BM25_WEIGHT``) or RRF per ``FUSION_MODE``. Flat routes
run as one function over device tensors (:func:`_fused_hybrid_search`); the
capacity tier takes the staged path (dense search, then BM25, then fusion),
since it manages its own host refine step.

Spans: ``hybrid.search`` (the whole call); on the flat route
``hybrid.fused`` (the enqueue of dense, BM25 and fusion), on the staged
route ``dense.search``, ``bm25.topk`` and ``hybrid.fuse``.
"""

from __future__ import annotations

import torch

from ..config import get_config
from ..observability import trace_phase
from ..ops.fusion import normalize_minmax, rrf_fusion, weighted_fusion
from .bm25_index import BM25Index, bm25_dispatch
from .chunk_store import ChunkStore
from .flat_index import DenseFlatIndex, dense_dispatch


def _fuse(d_vals, d_rows, s_vals, s_rows, k, *, fusion_mode, rrf_k, w_dense, w_sparse):
    """Sanitize (padding rows with a -inf dense score and no-match BM25 rows
    with score 0 become id -1, which fusion masks) and fuse."""
    d_rows = torch.where(torch.isfinite(d_vals), d_rows, -1)
    s_rows = torch.where(s_vals > 0.0, s_rows, -1)
    if fusion_mode == "rrf":
        return rrf_fusion(d_rows, s_rows, k, rrf_k=rrf_k)
    s_norm = normalize_minmax(s_vals)
    d_vals = torch.where(d_rows >= 0, d_vals, 0.0)
    s_norm = torch.where(s_rows >= 0, s_norm, 0.0)
    return weighted_fusion(d_rows, d_vals, s_rows, s_norm, k, w_dense=w_dense, w_sparse=w_sparse)


def _fused_hybrid_search(
    q_emb,
    dense_arrays,
    qt,
    qf,
    bm25_arrays,
    w_dense,
    w_sparse,
    *,
    k: int,
    kc: int,
    fusion_mode: str,
    rrf_k: int,
    kind: str,
    metric: str,
    valid_n: int,
    group_l: int = 32,
    precise: bool = True,
    block_n: int = 0,
    rescore: bool = False,
    packed: bool = True,
    hot_cap: int | None = None,
    n_docs: int = 0,
):
    """Dense top-kc + BM25 top-kc + sanitizing + fusion to top-k, as one
    function over device tensors (the JAX version compiles this into one
    program). Returns ``(scores [Q, k], rows [Q, k])``."""
    dim_pad = dense_arrays[0].shape[1]
    if q_emb.shape[1] < dim_pad:
        q_emb = torch.nn.functional.pad(q_emb, (0, dim_pad - q_emb.shape[1]))
    d_vals, d_rows = dense_dispatch(
        q_emb, dense_arrays, kind=kind, k=kc, metric=metric, valid_n=valid_n,
        group_l=group_l, precise=precise, block_n=block_n, rescore=rescore,
    )
    s_vals, s_rows = bm25_dispatch(
        qt, qf, bm25_arrays, k=kc, packed=packed, n_docs=n_docs, hot_cap=hot_cap
    )
    return _fuse(
        d_vals, d_rows, s_vals, s_rows, k, fusion_mode=fusion_mode, rrf_k=rrf_k,
        w_dense=w_dense, w_sparse=w_sparse,
    )


class HybridEngine:
    """Corpus-wide hybrid search over a ChunkStore (+ optional BM25)."""

    def __init__(
        self,
        store: ChunkStore,
        bm25: BM25Index | None = None,
        metric: str = "cosine",
        dense: DenseFlatIndex | None = None,
    ) -> None:
        self.store = store
        self.bm25 = bm25
        if dense is not None and dense.store is store and dense.metric == metric:
            self.dense = dense
        else:
            self.dense = DenseFlatIndex(store, metric=metric)

    def search(
        self,
        query_texts: list[str],
        query_embeddings: torch.Tensor,
        k: int,
        *,
        candidates: int | None = None,
        hybrid: bool | None = None,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Returns fused (scores [Q, k], corpus rows [Q, k]). ``candidates``
        is the per-retriever pool before fusion (default
        max(k, RETRIEVAL_CANDIDATES))."""
        with trace_phase("hybrid.search"):
            return self._search(query_texts, query_embeddings, k, candidates=candidates, hybrid=hybrid)

    def _search(self, query_texts, query_embeddings, k, *, candidates, hybrid):
        cfg = get_config()
        dev = self.store.device
        if self.store.valid_n == 0:
            q = len(query_texts)
            return (
                torch.zeros((q, 0), dtype=torch.float32, device=dev),
                torch.zeros((q, 0), dtype=torch.int32, device=dev),
            )
        kc = min(candidates or max(k, cfg.RETRIEVAL_CANDIDATES), self.store.valid_n)
        k = min(k, kc)
        use_hybrid = (cfg.HYBRID_SEARCH_ENABLED if hybrid is None else hybrid) and self.bm25 is not None
        query_embeddings = query_embeddings.to(dev)
        if use_hybrid and self.dense.routes_flat(cfg):
            if query_embeddings.shape[1] not in (self.store.dim, self.store.dim_pad):
                raise ValueError(
                    f"query dim {query_embeddings.shape[1]} != store dim {self.store.dim}"
                )
            arrays, statics = self.dense.flat_plan(kc)
            statics.pop("k")
            qt, qf, b_arrays, b_statics = self.bm25.topk_plan(query_texts)
            with trace_phase("hybrid.fused"):
                return _fused_hybrid_search(
                    query_embeddings, arrays, qt, qf, b_arrays, cfg.VECTOR_WEIGHT, cfg.BM25_WEIGHT,
                    k=k, kc=kc, fusion_mode=cfg.FUSION_MODE, rrf_k=cfg.RRF_K, **statics, **b_statics,
                )
        # staged: dense-only searches and the capacity tier
        with trace_phase("dense.search"):
            d_vals, d_rows = self.dense.search(query_embeddings, kc)
        if not use_hybrid:
            d_rows = torch.where(torch.isfinite(d_vals), d_rows, -1)
            return d_vals[:, :k], d_rows[:, :k]
        with trace_phase("bm25.topk"):
            s_vals, s_rows = self.bm25.topk(query_texts, kc)
        with trace_phase("hybrid.fuse"):
            return _fuse(
                d_vals, d_rows, s_vals, s_rows, k, fusion_mode=cfg.FUSION_MODE, rrf_k=cfg.RRF_K,
                w_dense=cfg.VECTOR_WEIGHT, w_sparse=cfg.BM25_WEIGHT,
            )
