"""Sharded hybrid engine: dense + BM25 + fusion over a device mesh (port of
``intool_rag_tpu/parallel/sharded_hybrid.py``).

Streaming appends land dense rows through :class:`.sharded_corpus.ShardedCorpus`
and postings through :class:`.sharded_bm25.ShardedBM25` at the same
(shard, slot), so both agree on every interleaved global row id
(``slot · S + shard``). A query runs the sharded dense search (K1 / K2 per
shard), the sharded BM25, then the single-device fusion
(``ops/fusion.py``) over the merged candidate lists: the merges are exact,
so the fused ranking is the single-device engine's over the union corpus
(up to float summation order, and ``p_max`` pruning, which per-shard
capping only loosens).

``save`` / ``load`` read and write the JAX package's files.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from ..config import get_config
from ..index.bm25_index import BM25Params
from ..index.hybrid import _fuse
from .mesh import Mesh
from .sharded_bm25 import ShardedBM25, _ShardCounts
from .sharded_corpus import ShardedCorpus


class ShardedHybrid:
    """Row-sharded hybrid (dense + BM25) corpus with streaming append."""

    def __init__(
        self,
        dim: int,
        mesh: Mesh,
        *,
        capacity_per_shard: int = 1024,
        dtype: torch.dtype = torch.float32,
        params: BM25Params | None = None,
        quant: str = "none",
    ) -> None:
        self.mesh = mesh
        self.corpus = ShardedCorpus(dim, mesh, capacity_per_shard=capacity_per_shard, dtype=dtype, quant=quant)
        self.bm25 = ShardedBM25(mesh, params=params)

    @property
    def valid_n(self) -> int:
        return self.corpus.valid_n

    def append(self, texts: list[str], embeddings) -> np.ndarray:
        """Append aligned ``texts[i]`` / ``embeddings[i]``; returns the global
        row ids. The dense placement decides; the postings follow it."""
        if len(texts) != embeddings.shape[0]:
            raise ValueError(f"texts ({len(texts)}) and embeddings ({embeddings.shape[0]}) must align")
        gids = self.corpus.append(embeddings)
        n = self.corpus.n_shards
        self.bm25.append(texts, dest_shard=(gids % n).astype(np.int32), dest_slot=(gids // n).astype(np.int32),
                         cap=self.corpus.cap)
        return gids

    # ---------------- checkpoint / restore ----------------

    def save(self, path) -> None:
        """The dense planes through :func:`..storage.sharded.save_sharded`,
        the counted postings and global statistics beside them. Row ids are
        interleaved by the shard count, so a checkpoint binds to its mesh
        size."""
        from ..storage.sharded import save_sharded

        path = Path(path)
        path.mkdir(parents=True, exist_ok=True)
        c = self.corpus
        meta = {"counts": c.counts.tolist(), "cap": c.cap, "dim": c.dim, "n_shards": c.n_shards, "quant": c.quant}
        if c.quant == "none":
            save_sharded(c.data, path / "dense", meta=meta)
        else:
            save_sharded(c.codes, path / "dense", meta=meta)
            save_sharded(c.scales, path / "dense_scales")
            if c.res is not None:
                save_sharded(c.res, path / "dense_res")
        bm = self.bm25
        arrays = {"df": bm.df}
        for i, sc in enumerate(bm.shards):
            for field in ("slots", "indptr", "terms", "counts", "lens"):
                arrays[f"s{i}_{field}"] = getattr(sc, field)
        np.savez_compressed(path / "sparse.npz", **arrays)
        (path / "sparse.meta.json").write_text(
            json.dumps({
                "vocab": list(bm.vocab.keys()), "n_docs": bm.n_docs, "total_len": bm.total_len, "cap": bm._cap,
                "k1": bm.params.k1, "b": bm.params.b, "p_max": bm.params.p_max, "n_shards": bm.n_shards,
            }, ensure_ascii=False),
            encoding="utf-8",
        )

    @classmethod
    def load(cls, path, mesh: Mesh) -> "ShardedHybrid":
        from ..storage.sharded import load_sharded

        path = Path(path)
        meta = json.loads((path / "sparse.meta.json").read_text(encoding="utf-8"))
        if mesh.size != meta["n_shards"]:
            raise ValueError(
                f"checkpoint was sharded {meta['n_shards']}-way; mesh has {mesh.size} shards "
                "(interleaved row ids bind to the shard count)"
            )
        data, dmeta = load_sharded(path / "dense", mesh)
        quant = dmeta.get("quant", "none")
        engine = cls(dmeta["dim"], mesh, capacity_per_shard=dmeta["cap"], dtype=data.dtype,
                     params=BM25Params(k1=meta["k1"], b=meta["b"], p_max=meta["p_max"]), quant=quant)
        c = engine.corpus
        c.cap = dmeta["cap"]
        c.counts = np.asarray(dmeta["counts"], np.int32)
        if quant == "none":
            c.data = data
        else:
            c.codes = data
            c.scales, _ = load_sharded(path / "dense_scales", mesh)
            if quant == "int8r":
                c.res, _ = load_sharded(path / "dense_res", mesh)
        bm = engine.bm25
        with np.load(path / "sparse.npz") as arrays:
            bm.df = arrays["df"]
            bm.shards = [
                _ShardCounts(**{f: arrays[f"s{i}_{f}"] for f in ("slots", "indptr", "terms", "counts", "lens")})
                for i in range(mesh.size)
            ]
        bm.vocab = {t: i for i, t in enumerate(meta["vocab"])}
        bm.n_docs = meta["n_docs"]
        bm.total_len = meta["total_len"]
        bm._cap = meta["cap"]
        return engine

    # ---------------- query ----------------

    def _dense(self, queries: torch.Tensor, kc: int, **kernel):
        return self.corpus.search(queries, kc, **kernel)

    def _sparse(self, texts: list[str], kc: int):
        return self.bm25.topk(texts, kc)

    def search(
        self,
        query_texts: list[str],
        query_embeddings: torch.Tensor,
        k: int,
        *,
        candidates: int | None = None,
        hybrid: bool | None = None,
        group_l: int | None = None,
        tail: str = "fold",
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Fused ``(scores [Q, k], global row ids [Q, k])``: the sharded
        counterpart of ``HybridEngine.search`` (same settings, same fusion
        modes). ``group_l`` / ``tail`` reach the dense kernels."""
        cfg = get_config()
        if self.valid_n == 0:
            q = len(query_texts)
            dev = self.mesh.out_device
            return torch.zeros((q, 0), device=dev), torch.zeros((q, 0), dtype=torch.int32, device=dev)
        kc = min(candidates or max(k, cfg.RETRIEVAL_CANDIDATES), self.valid_n)
        k = min(k, kc)
        use_hybrid = cfg.HYBRID_SEARCH_ENABLED if hybrid is None else hybrid
        d_vals, d_rows = self._dense(torch.as_tensor(query_embeddings), kc, group_l=group_l, tail=tail)
        if not use_hybrid:
            return d_vals[:, :k], torch.where(torch.isfinite(d_vals), d_rows, -1)[:, :k]
        s_vals, s_rows = self._sparse(query_texts, kc)
        return _fuse(d_vals, d_rows, s_vals, s_rows, k, fusion_mode=cfg.FUSION_MODE, rrf_k=cfg.RRF_K,
                     w_dense=cfg.VECTOR_WEIGHT, w_sparse=cfg.BM25_WEIGHT)
