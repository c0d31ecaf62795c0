"""IVF (inverted-file) dense index: k-means partitioning + probe search
(port of ``intool_rag_tpu/index/ivf_index.py``).

Corpus rows are permuted so that each list is contiguous in one padded
matrix on the index's device; probing list ``l`` reads ``cap`` rows from
its start, masked by the list's length. Lists longer than ``cap`` spill
into a shared overflow tail that every query also scans, so no row is
ever lost. Search: queries → centroid scores → top-nprobe lists → one
gather of the ``[Qc, nprobe·cap]`` candidate rows → one batched product →
one top-k, in query chunks that bound the gathered rows
(``ivf_residual.bounded_chunk``); the overflow tail is scored once for
every query.

Plain PyTorch on the index's device: the JAX package has no Pallas kernel
here.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..ops.kmeans import kmeans
from ..ops.topk import NEG_INF
from .ivf_residual import _BLK, bounded_chunk, fold_topk, list_layout, probe_lists, probe_offsets


class IVFFlatIndex:
    def __init__(
        self,
        centroids: torch.Tensor,  # [L, D] f32
        permuted: torch.Tensor,  # [M_pad, D] corpus rows grouped by list
        row_map: torch.Tensor,  # [M_pad] i32: permuted row -> original row (-1 pad)
        list_start: torch.Tensor,  # [L] i32 into permuted
        list_len: torch.Tensor,  # [L] i32
        overflow_start: int,
        overflow_len: int,
        cap: int,
    ) -> None:
        self.centroids = centroids
        self.permuted = permuted
        self.row_map = row_map
        self.list_start = list_start
        self.list_len = list_len
        self.overflow_start = overflow_start
        self.overflow_len = overflow_len
        self.cap = cap

    @property
    def device(self) -> torch.device:
        return self.permuted.device

    @property
    def nlist(self) -> int:
        return self.centroids.shape[0]

    @classmethod
    def build(
        cls,
        embeddings: torch.Tensor,  # [N, D] (valid rows only)
        nlist: int,
        *,
        iters: int = 10,
        cap_quantile: float = 0.98,
        seed: int = 0,
        dtype: torch.dtype | None = None,
        device: str | torch.device | None = None,
    ) -> "IVFFlatIndex":
        """k-means on ``device`` (default CUDA), the capped list layout,
        then the rows permuted in ``dtype`` (default: the embeddings')."""
        dev = resolve_device(device)
        emb = torch.as_tensor(embeddings).to(dev)
        n, d = emb.shape
        nlist = min(nlist, max(1, n // 4))
        centroids, assign = kmeans(emb, nlist, iters=iters, seed=seed)
        perm, list_start, list_len, o_start, o_len, cap, m_pad = list_layout(
            assign.cpu().numpy().astype(np.int64), nlist, cap_quantile
        )
        m = len(perm)
        permuted = torch.zeros((m_pad, d), dtype=dtype or emb.dtype, device=dev)
        perm_dev = torch.as_tensor(perm, device=dev)
        for start in range(0, m, _BLK):
            stop = min(start + _BLK, m)
            permuted[start:stop] = emb[perm_dev[start:stop]].to(permuted.dtype)
        row_map = np.full(m_pad, -1, np.int32)
        row_map[:m] = perm
        return cls(
            centroids=centroids.to(dev, torch.float32), permuted=permuted,
            row_map=torch.as_tensor(row_map, device=dev),
            list_start=torch.as_tensor(list_start, device=dev), list_len=torch.as_tensor(list_len, device=dev),
            overflow_start=o_start, overflow_len=o_len, cap=cap,
        )

    def search(
        self, queries: torch.Tensor, k: int, *, nprobe: int = 8, query_chunk: int = 32
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """``(scores [Q, k] f32, original rows [Q, k] i32)``, MIPS."""
        nprobe = min(nprobe, self.nlist)
        q = torch.as_tensor(queries).to(self.device)
        return _ivf_search(
            q, self.centroids, self.permuted, self.row_map, self.list_start, self.list_len,
            k=k, nprobe=nprobe, cap=self.cap, overflow_start=self.overflow_start,
            overflow_len=self.overflow_len, query_chunk=min(query_chunk, q.shape[0]),
        )


def _ivf_search(
    queries, centroids, permuted, row_map, list_start, list_len,
    *, k, nprobe, cap, overflow_start, overflow_len, query_chunk,
):
    # the candidates meet the queries in the store's dtype, then in f32 (the
    # JAX search casts the queries to the permuted rows' dtype first)
    qf = queries.to(permuted.dtype).float()
    c_scores, probes = probe_lists(queries.float(), centroids, nprobe)
    over_pad = -(-max(overflow_len, 1) // 8) * 8 if overflow_len else 0
    if over_pad:  # the shared overflow tail: scored once for every query
        oids = row_map[overflow_start : overflow_start + over_pad]
        opos = torch.arange(oids.shape[0], device=oids.device)
        ovalid = (opos < overflow_len) & (oids >= 0)
        oblock = permuted[overflow_start : overflow_start + over_pad].float()
        oscores = torch.where(ovalid[None, :], qf @ oblock.T, NEG_INF)
        del oblock
    chunk = bounded_chunk(query_chunk, nprobe * cap, qf.shape[1])
    out_v, out_r = [], []
    for start in range(0, qf.shape[0], chunk):
        chunk_q = qf[start : start + chunk]
        qc = chunk_q.shape[0]
        offs, in_len = probe_offsets(probes[start : start + chunk], list_start, list_len, cap)
        cand = permuted[offs.reshape(-1)].float().view(qc, -1, qf.shape[1])
        ids = row_map[offs]
        scores = torch.bmm(cand, chunk_q[:, :, None])[:, :, 0]
        del cand
        scores = torch.where(in_len & (ids >= 0), scores, NEG_INF)
        if over_pad:
            scores = torch.cat([scores, oscores[start : start + chunk]], dim=1)
            ids = torch.cat([ids, oids.expand(qc, -1)], dim=1)
        vals, rows = fold_topk(scores, ids, k)
        out_v.append(vals)
        out_r.append(rows)
    return torch.cat(out_v), torch.cat(out_r)
