"""BM25 sparse index: vocabulary, postings build, device residency (port
of ``intool_rag_tpu/index/bm25_index.py``).

Build is host-side (string processing, vectorized numpy); the scoring
arrays live on the index's device and feed :mod:`..ops.bm25`. Lucene
BM25:

    idf(t)   = ln(1 + (N - df + 0.5) / (df + 0.5))
    w(t, d)  = tf·(k1+1) / (tf + k1·(1 - b + b·|d|/avgdl))
    score    = Σ_t q_tf(t) · idf(t) · w(t, d)

Postings are impact-ordered (descending weight) per term, capped at
``p_max``.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np
import torch

from ..config import get_config
from ..device import resolve_device
from ..observability import trace_phase
from .analyzer import tokenize


def bm25_dispatch(qt, qf, arrays: tuple, *, k: int, packed: bool, n_docs: int, hot_cap: int | None):
    """BM25 top-k from a :meth:`BM25Index.topk_plan`."""
    from ..ops.bm25 import bm25_topk_rows, bm25_topk_rows_packed

    term_row, term_hot, hot_docs, hot_w, cold_docs, cold_w, idf, wmax = arrays
    args = (qt, qf, term_row, term_hot, hot_docs, hot_w, cold_docs, cold_w, idf, k)
    if packed:
        return bm25_topk_rows_packed(*args, n_docs=n_docs, term_wmax=wmax, hot_cap=hot_cap)
    return bm25_topk_rows(*args, n_docs=n_docs)


@dataclasses.dataclass
class BM25Params:
    k1: float = 1.5
    b: float = 0.75
    p_max: int = 4096  # max postings per term kept on device

    @classmethod
    def from_config(cls) -> "BM25Params":
        cfg = get_config()
        return cls(k1=cfg.BM25_K1, b=cfg.BM25_B)


class BM25Index:
    """Sparse keyword index over a chunk corpus."""

    _counted = None  # counted-term representation (lets append() extend the index)

    def __init__(
        self,
        vocab: dict[str, int],
        term_start: np.ndarray,
        term_len: np.ndarray,
        post_docs: np.ndarray,
        post_w: np.ndarray,
        idf: np.ndarray,
        n_docs: int,
        params: BM25Params,
        avgdl: float,
        device: str | torch.device | None = None,
    ) -> None:
        self.vocab = vocab
        self.n_docs = n_docs
        self.params = params
        self.avgdl = avgdl
        self.device = resolve_device(device)
        self.term_start = torch.as_tensor(term_start, device=self.device)
        self.term_len = torch.as_tensor(term_len, device=self.device)
        self.post_docs = torch.as_tensor(post_docs, device=self.device)
        self.post_w = torch.as_tensor(post_w, device=self.device)
        self.idf = torch.as_tensor(idf, device=self.device)
        self._rows = None

    def _row_layout(self, cold_width: int = 64):
        if self._rows is None:
            from ..ops.bm25 import build_row_layout

            self._rows = build_row_layout(
                self.term_start, self.term_len, self.post_docs, self.post_w,
                n_docs=self.n_docs, p_max=self.params.p_max, cold_width=cold_width,
            )
        return self._rows

    @classmethod
    def build(
        cls, texts: list[str], params: BM25Params | None = None, device: str | torch.device | None = None
    ) -> "BM25Index":
        params = params or BM25Params.from_config()
        counted = cls._count_terms(texts)
        index = cls._from_counts(counted, len(texts), params, device)
        index._counted = counted  # kept for incremental append
        return index

    def append(self, texts: list[str]) -> "BM25Index":
        """Incremental extension: tokenize only the NEW texts, merge the
        counted representations, and rebuild the postings vectorized; idf and
        avgdl are recomputed exactly over the union. Returns a new index on
        the same device (the old one stays valid)."""
        if not texts:
            return self
        if self._counted is None:
            raise ValueError("index was loaded without counts; rebuild instead")
        old_vocab, old_df, old_indptr, old_terms, old_counts, old_len = self._counted
        new_vocab, new_df, new_indptr, new_terms, new_counts, new_len = self._count_terms(texts)
        # merge the vocabularies (both sorted) and remap both term-id spaces
        merged = sorted(set(old_vocab) | set(new_vocab))
        merged_pos = {t: i for i, t in enumerate(merged)}
        old_map = np.asarray([merged_pos[t] for t in old_vocab], np.int32)
        new_map = np.asarray([merged_pos[t] for t in new_vocab], np.int32)
        pair_terms = np.concatenate([
            old_map[old_terms] if len(old_terms) else old_terms,
            new_map[new_terms] if len(new_terms) else new_terms,
        ])
        df = np.zeros(len(merged), np.int32)
        df[old_map] += old_df  # each map is injective, so plain indexing adds once per term
        df[new_map] += new_df
        counted = (
            merged, df, np.concatenate([old_indptr, new_indptr[1:] + old_indptr[-1]]), pair_terms,
            np.concatenate([old_counts, new_counts]), np.concatenate([old_len, new_len]),
        )
        index = self._from_counts(counted, len(old_len) + len(new_len), self.params, self.device)
        index._counted = counted
        return index

    @staticmethod
    def _count_terms(texts: list[str]):
        """→ (vocab list sorted, df [V], doc_indptr [n+1], pair_terms [nnz],
        pair_counts [nnz], doc_len [n]); natively where the analyzer library
        builds, else in Python over :func:`tokenize`."""
        from ..native import build_corpus_native

        native = build_corpus_native(texts)
        if native is not None:
            return native
        vocab_map: dict[str, int] = {}
        terms_list: list[str] = []
        pair_terms: list[int] = []
        pair_counts: list[int] = []
        doc_indptr = [0]
        doc_len = []
        for text in texts:
            counts: dict[int, int] = {}
            toks = tokenize(text)
            doc_len.append(len(toks))
            for t in toks:
                tid = vocab_map.get(t)
                if tid is None:
                    tid = len(terms_list)
                    vocab_map[t] = tid
                    terms_list.append(t)
                counts[tid] = counts.get(tid, 0) + 1
            pair_terms.extend(counts.keys())
            pair_counts.extend(counts.values())
            doc_indptr.append(len(pair_terms))
        order = sorted(range(len(terms_list)), key=lambda i: terms_list[i])
        remap = np.zeros(len(terms_list), np.int32)
        remap[np.asarray(order, np.int64)] = np.arange(len(order), dtype=np.int32)
        pair_terms_arr = remap[np.asarray(pair_terms, np.int64)] if pair_terms else np.zeros(0, np.int32)
        vocab = [terms_list[i] for i in order]
        df = np.bincount(pair_terms_arr, minlength=len(vocab)).astype(np.int32)
        return (
            vocab, df, np.asarray(doc_indptr, np.int64), pair_terms_arr,
            np.asarray(pair_counts, np.int32), np.asarray(doc_len, np.int32),
        )

    @classmethod
    def _from_counts(cls, counted, n_docs: int, params: BM25Params, device) -> "BM25Index":
        vocab_list, df, doc_indptr, pair_terms, pair_counts, doc_len = counted
        v = len(vocab_list)
        vocab = {t: i for i, t in enumerate(vocab_list)}
        avgdl = max(float(doc_len.mean()) if n_docs else 1.0, 1e-6)
        df_f = np.maximum(df.astype(np.float64), 0)
        idf = np.log(1.0 + (n_docs - df_f + 0.5) / (df_f + 0.5)).astype(np.float32)

        k1, b = params.k1, params.b
        nnz = len(pair_terms)
        doc_of_pair = np.repeat(np.arange(n_docs, dtype=np.int64), np.diff(doc_indptr))
        tf = pair_counts.astype(np.float32)
        norm = (k1 * (1.0 - b + b * doc_len[doc_of_pair] / avgdl)).astype(np.float32)
        w = tf * (k1 + 1.0) / (tf + norm)

        order = np.lexsort((-w, pair_terms)) if nnz else np.zeros(0, np.int64)
        sorted_terms = pair_terms[order]
        sorted_docs = doc_of_pair[order].astype(np.int32)
        sorted_w = w[order]
        counts_per_term = np.bincount(sorted_terms, minlength=v)
        capped = np.minimum(counts_per_term, params.p_max)
        term_len = capped.astype(np.int32)
        term_start = np.zeros(v, np.int32)
        term_start[1:] = np.cumsum(capped[:-1]).astype(np.int32)
        starts_full = np.zeros(v, np.int64)
        starts_full[1:] = np.cumsum(counts_per_term[:-1])
        rank_in_term = np.arange(nnz, dtype=np.int64) - starts_full[sorted_terms]
        keep = rank_in_term < params.p_max
        pad = params.p_max
        post_docs = np.concatenate([sorted_docs[keep], np.full(pad, n_docs, np.int32)])
        post_w = np.concatenate([sorted_w[keep], np.zeros(pad, np.float32)]).astype(np.float32)
        return cls(vocab, term_start, term_len, post_docs, post_w, idf, n_docs, params, avgdl, device)

    def _encode_queries_np(self, queries: list[str], max_terms: int | None = None):
        """Host-side ``(qterms [Q,T] i32, qtf [Q,T] f32)``, -1/0 padded,
        terms in ascending vocab id."""
        t_max = max_terms or get_config().BM25_MAX_QUERY_TERMS
        q = len(queries)
        qterms = np.full((q, t_max), -1, np.int32)
        qtf = np.zeros((q, t_max), np.float32)
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

    def topk(self, queries: list[str], k: int):
        qt, qf, arrays, statics = self.topk_plan(queries)
        return bm25_dispatch(qt, qf, arrays, k=k, **statics)

    def topk_plan(self, queries: list[str]):
        """Host-side query prep for :func:`bm25_dispatch`: encodes queries
        and, when every query's hot-term count fits T/2, reorders terms
        hot-first so the wide gather covers half the term slots. Returns
        ``(qt, qf, device_arrays, statics)``. Span ``bm25.prep``."""
        with trace_phase("bm25.prep"):
            qt_np, qf_np = self._encode_queries_np(queries)
            rows = self._row_layout()
            packed = self.n_docs < 1 << 20  # 31 − qbits(11)
            hot_cap = None
            if packed:
                hot_np = rows["term_hot_np"]
                is_hot = (qt_np >= 0) & hot_np[np.maximum(qt_np, 0)]
                cap = qt_np.shape[1] // 2
                if cap >= 1 and int(is_hot.sum(axis=1).max(initial=0)) <= cap:
                    order = np.argsort(~is_hot, axis=1, kind="stable")
                    qt_np = np.take_along_axis(qt_np, order, 1)
                    qf_np = np.take_along_axis(qf_np, order, 1)
                    hot_cap = cap
            arrays = (
                rows["term_row"], rows["term_hot"], rows["hot_docs"], rows["hot_w"],
                rows["cold_docs"], rows["cold_w"], self.idf, rows["term_wmax"],
            )
            statics = dict(packed=packed, n_docs=self.n_docs, hot_cap=hot_cap)
            qt = torch.as_tensor(qt_np, device=self.device)
            qf = torch.as_tensor(qf_np, device=self.device)
            return qt, qf, arrays, statics

    # ---------------- persistence (the JAX package's files) ----------------

    def save(self, path: Path | str) -> None:
        """``<path>.npz`` (arrays) + ``<path>.meta.json``, as the JAX
        package's ``BM25Index.save`` writes them."""
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        np.savez_compressed(
            path,
            term_start=self.term_start.cpu().numpy(), term_len=self.term_len.cpu().numpy(),
            post_docs=self.post_docs.cpu().numpy(), post_w=self.post_w.cpu().numpy(),
            idf=self.idf.cpu().numpy(),
        )
        meta = {
            "n_docs": self.n_docs, "avgdl": self.avgdl, "k1": self.params.k1, "b": self.params.b,
            "p_max": self.params.p_max, "vocab": self.vocab,
        }
        Path(str(path) + ".meta.json").write_text(json.dumps(meta, ensure_ascii=False), encoding="utf-8")

    @classmethod
    def load(cls, path: Path | str, device: str | torch.device | None = None) -> "BM25Index":
        """An index either package saved. It comes without counts, so it
        searches but cannot :meth:`append`."""
        path = Path(path)
        meta = json.loads(Path(str(path) + ".meta.json").read_text(encoding="utf-8"))
        with np.load(f"{path}.npz") as arrays:
            return cls(
                vocab=meta["vocab"], term_start=arrays["term_start"], term_len=arrays["term_len"],
                post_docs=arrays["post_docs"], post_w=arrays["post_w"], idf=arrays["idf"],
                n_docs=meta["n_docs"],
                params=BM25Params(k1=meta["k1"], b=meta["b"], p_max=meta["p_max"]),
                avgdl=meta["avgdl"], device=device,
            )
