"""Document-sharded BM25 (port of
``intool_rag_tpu/parallel/sharded_bm25.py``): the postings partitioned over
the mesh by document row.

Each shard owns the postings of the documents whose dense rows live on it
(the interleaved ids of :mod:`.sharded_corpus`: ``slot · S + shard``). A
query runs the single-device row-layout BM25 (``ops/bm25.py``: the two-tier
hot / cold rows of :func:`..ops.bm25.build_row_layout`, packed
aggregation) on every shard, maps slots to global ids and merges the
candidates, as dense sharded search does.

Statistics (idf, avgdl) are corpus-global, computed over all shards, so a
document scores as in a single-device index over the union corpus (exactly
when ``p_max`` prunes nothing). The packed path quantizes on a grid set by
the corpus-global ``term_wmax``, so every shard's integer totals are the
single-device kernel's.

The vocabulary is append-only (term ids in first-seen order, as in the JAX
package), so appends never remap ids. The host keeps each shard's counted
documents; each shard's postings are weighted, sorted and laid out on its
own device (the JAX package builds them on the host), again after every
append, since avgdl moves.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..index.bm25_index import BM25Params
from ..ops.bm25 import bm25_topk_rows, bm25_topk_rows_packed, build_row_layout
from .collectives import merge_topk
from .mesh import Mesh


@dataclasses.dataclass
class _ShardCounts:
    """Host-side counted representation of one shard's documents."""

    slots: np.ndarray  # [n_docs] i32 — slot of each doc within the shard
    indptr: np.ndarray  # [n_docs + 1] i64 — into terms / counts
    terms: np.ndarray  # [nnz] i32 — global term ids
    counts: np.ndarray  # [nnz] i32 — term frequency in the doc
    lens: np.ndarray  # [n_docs] i32 — token count of the doc

    @classmethod
    def empty(cls) -> "_ShardCounts":
        return cls(
            slots=np.zeros(0, np.int32), indptr=np.zeros(1, np.int64), terms=np.zeros(0, np.int32),
            counts=np.zeros(0, np.int32), lens=np.zeros(0, np.int32),
        )

    def extend(self, other: "_ShardCounts") -> "_ShardCounts":
        return _ShardCounts(
            slots=np.concatenate([self.slots, other.slots]),
            indptr=np.concatenate([self.indptr, other.indptr[1:] + self.indptr[-1]]),
            terms=np.concatenate([self.terms, other.terms]),
            counts=np.concatenate([self.counts, other.counts]),
            lens=np.concatenate([self.lens, other.lens]),
        )

    def select(self, docs: np.ndarray, slots: np.ndarray) -> "_ShardCounts":
        """The documents ``docs`` of this batch, at ``slots``."""
        sizes = np.diff(self.indptr)[docs]
        pairs = np.repeat(self.indptr[docs] - np.concatenate([[0], np.cumsum(sizes)[:-1]]), sizes) + np.arange(
            int(sizes.sum()))
        return _ShardCounts(
            slots=slots, indptr=np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64),
            terms=self.terms[pairs], counts=self.counts[pairs], lens=self.lens[docs],
        )


def shard_postings(sc: _ShardCounts, n_terms: int, params: BM25Params, avgdl: float, cap: int, device) -> dict:
    """One shard's row layout (:func:`..ops.bm25.build_row_layout`) on
    ``device``: weights ``tf·(k1+1) / (tf + k1·(1 − b + b·|d|/avgdl))`` with
    the length norm in f64 rounded to f32 (as the JAX package's numpy),
    postings sorted by term then weight (stable), each term capped at
    ``p_max``; slot ``cap`` is the no-document sentinel."""
    k1, b, p_max = params.k1, params.b, params.p_max
    terms = torch.as_tensor(sc.terms, device=device).long()
    sizes = torch.as_tensor(np.diff(sc.indptr), device=device)
    doc_of_pair = torch.repeat_interleave(torch.arange(len(sc.lens), device=device), sizes)
    lens = torch.as_tensor(sc.lens, device=device).double()[doc_of_pair]
    tf = torch.as_tensor(sc.counts, device=device).float()
    # a tensor divisor: torch on CUDA divides by a Python scalar through its reciprocal
    norm = (k1 * (1.0 - b + b * lens / torch.tensor(avgdl, dtype=torch.float64, device=device))).float()
    w = tf * (k1 + 1.0) / (tf + norm)
    by_w = torch.argsort(-w, stable=True)
    order = by_w[torch.argsort(terms[by_w], stable=True)]  # np.lexsort((-w, terms))
    sorted_terms = terms[order]
    counts_per_term = torch.bincount(sorted_terms, minlength=n_terms)
    capped = counts_per_term.clamp(max=p_max)
    term_start = torch.zeros(n_terms, dtype=torch.int64, device=device)
    term_start[1:] = torch.cumsum(capped[:-1], 0)
    starts_full = torch.zeros(n_terms, dtype=torch.int64, device=device)
    starts_full[1:] = torch.cumsum(counts_per_term[:-1], 0)
    keep = torch.arange(len(order), device=device) - starts_full[sorted_terms] < p_max
    slots = torch.as_tensor(sc.slots, device=device)[doc_of_pair[order]].to(torch.int32)
    # a p_max tail of sentinels, as BM25Index keeps: the row gathers never read past the end
    post_docs = torch.cat([slots[keep], torch.full((p_max,), cap, dtype=torch.int32, device=device)])
    post_w = torch.cat([w[order][keep], torch.zeros(p_max, device=device)])
    return build_row_layout(term_start.to(torch.int32), capped.to(torch.int32), post_docs, post_w,
                            n_docs=cap, p_max=p_max)


class ShardedBM25:
    """BM25 postings sharded by document row over the mesh's shards."""

    def __init__(self, mesh: Mesh, params: BM25Params | None = None) -> None:
        self.mesh = mesh
        self.n_shards = mesh.size
        self.params = params or BM25Params.from_config()
        self.vocab: dict[str, int] = {}
        self.df = np.zeros(0, np.int64)
        self.total_len = 0
        self.n_docs = 0
        self.shards = [_ShardCounts.empty() for _ in range(self.n_shards)]
        self._device = None  # per shard: its row layout; then idf and the global term_wmax
        self._cap = 0  # slot-space size, the local no-document sentinel

    # ---------------- build / append ----------------

    def _tokenize_batch(self, texts: list[str]) -> _ShardCounts:
        """Count the new documents' terms against the append-only vocabulary
        (new terms take ids in the order the texts meet them); natively
        where the analyzer library builds."""
        from ..native import build_corpus_native

        native = build_corpus_native(texts, first_seen=True)
        if native is not None:
            words, _, indptr, pair_terms, pair_counts, lens, first_seen = native
            to_global = np.zeros(len(words), np.int32)
            for r in np.argsort(first_seen, kind="stable"):
                to_global[r] = self.vocab.setdefault(words[r], len(self.vocab))
            return _ShardCounts(slots=np.zeros(len(texts), np.int32), indptr=indptr.astype(np.int64),
                                terms=to_global[pair_terms], counts=pair_counts, lens=lens)
        from ..index.analyzer import tokenize

        indptr, terms, counts, lens = [0], [], [], []
        for text in texts:
            doc: dict[int, int] = {}
            toks = tokenize(text)
            lens.append(len(toks))
            for t in toks:
                tid = self.vocab.setdefault(t, len(self.vocab))
                doc[tid] = doc.get(tid, 0) + 1
            terms.extend(doc.keys())
            counts.extend(doc.values())
            indptr.append(len(terms))
        return _ShardCounts(
            slots=np.zeros(len(texts), np.int32), indptr=np.asarray(indptr, np.int64),
            terms=np.asarray(terms, np.int32), counts=np.asarray(counts, np.int32),
            lens=np.asarray(lens, np.int32),
        )

    def append(self, texts: list[str], dest_shard: np.ndarray, dest_slot: np.ndarray, *, cap: int) -> None:
        """Add ``texts[i]`` as the document at ``(dest_shard[i],
        dest_slot[i])``, the dense corpus's placement, so sparse and dense
        agree on every global row id. ``cap`` is the corpus's per-shard
        slot capacity (the no-document sentinel)."""
        self._cap = cap
        if not texts:
            return
        new = self._tokenize_batch(texts)
        if len(self.vocab) > len(self.df):
            self.df = np.concatenate([self.df, np.zeros(len(self.vocab) - len(self.df), np.int64)])
        np.add.at(self.df, new.terms, 1)
        self.total_len += int(new.lens.sum())
        self.n_docs += len(texts)
        dest_shard = np.asarray(dest_shard, np.int32)
        dest_slot = np.asarray(dest_slot, np.int32)
        for s in range(self.n_shards):
            docs = np.flatnonzero(dest_shard == s)
            if len(docs):
                self.shards[s] = self.shards[s].extend(new.select(docs, dest_slot[docs]))
        self._device = None  # rebuilt on the next query

    # ---------------- device postings ----------------

    @property
    def avgdl(self) -> float:
        return max(self.total_len / max(self.n_docs, 1), 1e-6)

    def device_arrays(self):
        """``(per-shard row layouts, idf per shard, term_wmax per shard)``,
        built on first use after a change. ``term_wmax`` is the max over
        every shard (it fixes the packed kernel's grid)."""
        if self._device is None:
            v = max(len(self.vocab), 1)  # an empty vocabulary still gives gatherable tables
            devices = self.mesh.flat_devices
            layouts = [shard_postings(sc, v, self.params, self.avgdl, self._cap, d)
                       for sc, d in zip(self.shards, devices)]
            wmax = layouts[0]["term_wmax"].to(self.mesh.out_device)
            for lay in layouts[1:]:
                wmax = torch.maximum(wmax, lay["term_wmax"].to(wmax.device))
            df = np.zeros(v)
            df[: len(self.df)] = self.df
            idf = np.log(1.0 + (self.n_docs - df + 0.5) / (df + 0.5)).astype(np.float32)
            self._device = (layouts, [torch.as_tensor(idf, device=d) for d in devices],
                            [wmax.to(d) for d in devices])
        return self._device

    # ---------------- query ----------------

    def encode_queries(self, queries: list[str], max_terms: int | None = None) -> tuple[np.ndarray, np.ndarray]:
        """``(qterms [Q, T] i32, qtf [Q, T] f32)`` on the host, -1 / 0
        padded, terms in ascending id (BM25Index's encoding)."""
        from ..config import get_config
        from ..index.analyzer import tokenize

        t_max = max_terms or get_config().BM25_MAX_QUERY_TERMS
        qterms = np.full((len(queries), t_max), -1, np.int32)
        qtf = np.zeros((len(queries), t_max), np.float32)
        for i, text in enumerate(queries):
            counts: dict[int, int] = {}
            for term in tokenize(text):
                tid = self.vocab.get(term)
                if tid is not None:
                    counts[tid] = counts.get(tid, 0) + 1
            for j, (tid, tf) in enumerate(sorted(counts.items())[:t_max]):
                qterms[i, j] = tid
                qtf[i, j] = tf
        return qterms, qtf

    def local_topk(self, qterms: np.ndarray, qtf: np.ndarray, k: int) -> tuple[list, list]:
        """Every shard's top-k as global ids (no match: ``-inf`` / -1),
        all shards launched; the merge is the caller's."""
        layouts, idfs, wmaxes = self.device_arrays()
        cap = self._cap
        vals, rows = [], []
        for s, dev in enumerate(self.mesh.flat_devices):
            lay = layouts[s]
            qt = torch.as_tensor(qterms, device=dev)
            qf = torch.as_tensor(qtf, device=dev)
            args = (qt, qf, lay["term_row"], lay["term_hot"], lay["hot_docs"], lay["hot_w"], lay["cold_docs"],
                    lay["cold_w"], idfs[s], k)
            # packed keys while the slot space fits them (31 - qbits(11) bits)
            if cap < 1 << 20:
                v, slots = bm25_topk_rows_packed(*args, n_docs=cap, term_wmax=wmaxes[s])
            else:
                v, slots = bm25_topk_rows(*args, n_docs=cap)
            invalid = v <= 0.0  # no match comes back as (0.0, slot 0)
            rows.append(torch.where(invalid, -1, slots * self.n_shards + s).to(torch.int32))
            vals.append(torch.where(invalid, float("-inf"), v))
        return vals, rows

    def topk(self, queries: list[str], k: int, *, merge=None):
        """Global sparse top-k: ``(scores [Q, k], global row ids [Q, k])``;
        no-match slots come back as ``(0.0, -1)``. ``merge(vals, rows, k)``
        defaults to :func:`.collectives.merge_topk` on the mesh's first
        device."""
        qterms, qtf = self.encode_queries(queries)
        vals, rows = self.local_topk(qterms, qtf, k)
        if merge is None:
            top_vals, top_rows = merge_topk(vals, rows, k, self.mesh.out_device)
        else:
            top_vals, top_rows = merge(vals, rows, k)
        finite = torch.isfinite(top_vals)
        return torch.where(finite, top_vals, 0.0), torch.where(finite, top_rows, -1)
