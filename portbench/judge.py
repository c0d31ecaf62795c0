"""The comparison that decides ``correct``.

A checked batch of the timed path (a "side") holds what the program
produced: the question texts, the query embeddings, the dense and BM25
candidate pools that fusion received, the fused rows and scores and, on the
capacity tier, the query tiles and probe table of the scan. The reference
judges each stage by what it says:

- ``emb_dist``: the widest L2 distance between a query's embedding and the
  reference encoder's (float32) embedding of the same text;
- ``dense_err``: the widest |score − exact score| of a dense candidate, the
  exact score taken for the program's own query embedding;
- ``dense_miss``: the share of the reference's dense top-kc (for the
  program's own embedding) that the program's dense pool lacks, averaged
  over a batch's queries: over the whole corpus for the flat store, over
  the lists each query's tile probes for the capacity tier (whose scan
  scores the sign-quantised residuals with the query operand in the
  configuration's ``precision.scan_query``: see ``reference/search.py``);
- ``bm25_err``: the same as ``dense_err`` for a BM25 candidate against the
  exact float64 sum, as a share of the best exact score among the
  question's candidates;
- ``bm25_miss``: the share of the exact BM25 top-kc (documents that match)
  that the program's BM25 pool lacks, averaged over a batch's queries;
  where the configuration chooses the pool on a grid of contribution levels
  (``bm25.select_bits``, the packed keys), a missing row counts only if it
  beats the pool's lowest row by more than the grid's error bound;
- ``fused_gap``: over the fused top-k, the widest of (the j-th best fused
  score − the fused score of the j-th row) and |its score − that fused
  score|, against the reference fusion of the program's own two pools;
- capacity tier only: ``probe_gap``, the probe table against the probe rule
  over the program's tiles (``reference.search.probe_gap``), and
  ``placement``, the share of rows stored in a list that is none of their
  four nearest (1 when a row is missing or stored twice), an exact
  comparison with the limit 0.

A row outside the corpus or a row that appears twice in one list reads 1.
Each stage is judged from the state the program handed it (its own
embeddings and pools), so one stage's rounding does not move the next
stage's number; the encoder is judged by ``emb_dist`` alone. The tier's
centroids and row placement are the program's state (a k-means over a
sample it draws), taken as given once ``placement`` has checked them.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import data
from .reference import encoder as ref_encoder
from .reference import search as ref_search
from .reference.text import query_terms, token_ids

NUMBERS = ("emb_dist", "dense_err", "dense_miss", "bm25_err", "bm25_miss", "fused_gap", "probe_gap", "placement")


def _miss(ref_rows: np.ndarray, ref_ok: np.ndarray, rows: np.ndarray, *, ref_vals: np.ndarray | None = None,
          kept_vals: np.ndarray | None = None, tol: np.ndarray | None = None) -> float:
    """The mean over queries of the share of the reference's rows (where
    ``ref_ok``) missing from the program's ``rows`` (−1 empty); queries with
    no reference row count nothing. With ``tol``, a missing row counts only
    where its exact value (``ref_vals``) beats the lowest exact value among
    the program's rows (``kept_vals``) by more than the query's ``tol``,
    unless the program kept fewer rows than the reference has."""
    shares = []
    for i, (want, ok, got) in enumerate(zip(ref_rows, ref_ok, rows)):
        if not ok.any():
            continue
        kept = got >= 0
        missing = ok & ~np.isin(want, got[kept])
        if tol is not None and kept.sum() >= ok.sum():
            missing &= ref_vals[i] > kept_vals[i][kept].min() + tol[i]
        shares.append(missing.sum() / ok.sum())
    return float(np.mean(shares)) if shares else 0.0


def _value_err(exact: np.ndarray, claimed: np.ndarray, rows: np.ndarray, scale: np.ndarray | None = None) -> float:
    """max |claimed - exact| (over ``scale`` per query); NaN exact (a row
    outside the corpus) or a repeated row reads 1."""
    worst = 0.0
    for i, (e, c, r) in enumerate(zip(exact, claimed, rows)):
        valid = r[r >= 0]
        if len(np.unique(valid)) != len(valid) or np.isnan(e).any():
            return 1.0
        err = float(np.max(np.abs(c - e), initial=0.0))
        worst = max(worst, err / scale[i] if scale is not None else err)
    return worst


class Reference:
    """The reference for one run: the inputs regenerated from the seed, the
    settings of the configuration, and (capacity tier) the program's tier
    layout as ``Search.collect`` (``portbench/systems/search.py``) took it."""

    def __init__(self, config: dict, seed: int, device, tier: dict | None = None) -> None:
        self.config = config
        self.model = config["model"]
        self.device = torch.device(device)
        port = config["port_config"]
        self.prefix = port["EMBEDDING_QUERY_INSTRUCTION"]
        self.max_terms = int(port["BM25_MAX_QUERY_TERMS"])
        self.w_dense, self.w_sparse = float(port["VECTOR_WEIGHT"]), float(port["BM25_WEIGHT"])
        self.weights = data.encoder_weights(seed, self.model, self.device)
        self.corpus = data.corpus(seed, config["corpus"], self.device)
        self.valid_n = config["corpus"]["rows"]
        bm = config["bm25"]
        self.postings = data.make_postings(seed, self.valid_n, vocab=bm["vocab"], terms_per_chunk=bm["terms_per_chunk"],
                                           p_max=bm["p_max"], zipf_s=bm["zipf_s"], device=self.device)
        self.vocab = {w: i for i, w in enumerate(data.vocabulary(seed, bm["vocab"]))}
        self.tier = None
        if port["INDEX_KIND"] == "bits":
            if tier is None:
                raise ValueError("a capacity-tier cell needs the program's tier layout")
            centroids = torch.as_tensor(tier["centroids"], device=self.device)
            lists, slots, once = ref_search.row_lists(torch.as_tensor(tier["gid"], device=self.device),
                                                      tier["cap_l"], self.valid_n)
            placement = (ref_search.misplaced(self.corpus, self.valid_n, centroids, lists) if once else 1.0)
            self.tier = {"centroids": centroids, "lists": lists, "slots": slots, "placement": placement,
                         "layout": {"cap_l": tier["cap_l"], "block_n": tier["block_n"],
                                    "blocks_per_list": tier["cap_l"] // tier["block_n"],
                                    "group_l": int(config["precision"]["scan_group"])},
                         "nprobe": int(port["IVF_NPROBE"]), "refine_k": int(port["IVF_REFINE_K"]),
                         "scan_query": getattr(torch, config["precision"]["scan_query"])}

    def embed(self, texts: list[str], *, control: bool = False) -> torch.Tensor:
        max_len = min(self.model["max_position_embeddings"] - 2, 8192)
        ids = [token_ids(self.prefix + t, self.model["vocab_size"], max_len) for t in texts]
        return ref_encoder.encode(self.weights, self.model, ids, control=control)

    def terms(self, texts: list[str]):
        return [query_terms(t, self.vocab, self.max_terms) for t in texts]

    def _dense_top(self, emb: torch.Tensor, kc: int, member: torch.Tensor | None, query_bits: int = 0,
                   refine_bits: int = 0):
        """The dense pool: the top-kc over the corpus; on the capacity tier,
        the scan's top ``max(kc, refine_k)`` over the probed lists, of which
        the refine keeps the ``kc`` of largest scores over int8 rows (the
        control: ``refine_bits`` rows and queries)."""
        if self.tier is None:
            return ref_search.dense_topk(emb, self.corpus, self.valid_n, kc, control_bits=query_bits)
        pool = max(kc, self.tier["refine_k"])
        vals, rows = ref_search.bits_topk(emb, self.corpus, self.valid_n, self.tier["centroids"], self.tier["lists"],
                                          member, pool, query_dtype=self.tier["scan_query"], query_bits=query_bits)
        if pool == kc:
            return vals, rows
        if refine_bits:
            vals = ref_search.int_scores(emb, self.corpus, rows, refine_bits)
        else:  # the refine's stated precision: int8 rows from the host tier
            vals = ref_search.int_scores(emb, self.corpus, rows, 8, query_too=False)
        vals, pos = torch.topk(vals, kc, dim=1)
        return vals, torch.gather(rows, 1, pos)

    def control_side(self, side: dict) -> dict:
        """The reference in the program's place, one precision down (the
        configuration's ``control``), on the questions of ``side``."""
        control, texts = self.config["control"], side["texts"]
        kc, k = self.config["search"]["candidates"], self.config["search"]["k"]
        emb = self.embed(texts, control=True)
        side = {"texts": texts, "emb": emb}
        if self.tier is None:
            d_vals, d_rows = self._dense_top(emb, kc, None, int(control["dense_bits"]))
        else:
            order, probes = ref_search.probe_table(emb, self.tier["centroids"], self.tier["nprobe"],
                                                   dtype=getattr(torch, control["probes"]))
            member = ref_search.probed(order, probes, len(texts), self.tier["centroids"].shape[0])
            _, d_rows = self._dense_top(emb, kc, member, int(control["scan_bits"]), int(control["dense_bits"]))
            d_vals = ref_search.int_scores(emb, self.corpus, d_rows, int(control["dense_bits"]))
            side.update(order=order, probes=probes)
        s_vals, s_rows = ref_search.bm25_topk(self.terms(texts), self.postings, self.valid_n, kc, control=True)
        side.update(d_vals=d_vals.float(), d_rows=d_rows, s_vals=s_vals.float(), s_rows=s_rows)
        fused = ref_search.fuse(*(_np(side[key]) for key in ("d_vals", "d_rows", "s_vals", "s_rows")), k,
                                self.w_dense, self.w_sparse, control=True)
        side["f_vals"] = np.array([[v for _, v in top] + [-np.inf] * (k - len(top)) for top, _ in fused])
        side["f_rows"] = np.array([[r for r, _ in top] + [-1] * (k - len(top)) for top, _ in fused])
        return side

    def numbers(self, side: dict) -> dict[str, float]:
        """The numbers of one checked batch."""
        texts = side["texts"]
        emb = torch.as_tensor(_np(side["emb"]), dtype=torch.float32, device=self.device)
        ref = self.embed(texts)
        out = {"emb_dist": float((emb - ref).norm(dim=1).max())}

        d_vals = _np(side["d_vals"]).astype(np.float64)
        d_rows = torch.as_tensor(_np(side["d_rows"]), dtype=torch.long, device=self.device)
        exact = ref_search.dense_scores(emb, self.corpus, self.valid_n, d_rows)
        out["dense_err"] = _value_err(_np(exact), d_vals, _np(d_rows))
        kc = d_rows.shape[1]
        member = None
        if self.tier is not None:
            if "order" not in side:
                return {**out, "probe_gap": 1.0}  # the tier's scan never ran
            order = torch.as_tensor(_np(side["order"]), device=self.device)
            probes = torch.as_tensor(_np(side["probes"]), device=self.device)
            out["probe_gap"] = ref_search.probe_gap(emb, self.tier["centroids"], order, probes)
            out["placement"] = self.tier["placement"]
            member = ref_search.probed(order, probes, len(texts), self.tier["centroids"].shape[0])
        ref_v, ref_r = self._dense_top(emb, kc, member)
        pool = np.where(np.isfinite(d_vals), _np(d_rows), -1)
        want = np.isfinite(_np(ref_v)) & (_np(ref_r) >= 0)
        if self.tier is not None:  # a row dropped for a better row of its scan group is no miss
            table = probes.long()[ref_search.tile_of(order, len(texts))]
            k_scan = max(kc, self.tier["refine_k"])
            ref_g = _np(ref_search.scan_groups(ref_r, self.tier["lists"], self.tier["slots"], table,
                                               self.tier["layout"], k_scan))
            kept_g = _np(ref_search.scan_groups(torch.as_tensor(pool, device=self.device), self.tier["lists"],
                                                self.tier["slots"], table, self.tier["layout"], k_scan))
            want &= ~np.array([np.isin(g, kg[kg >= 0]) & ~np.isin(r, p) for g, kg, r, p
                               in zip(ref_g, kept_g, _np(ref_r), pool)])
        out["dense_miss"] = _miss(_np(ref_r), want, pool)

        s_vals = _np(side["s_vals"]).astype(np.float64)
        s_rows = _np(side["s_rows"]).astype(np.int64)
        empty = s_vals <= 0.0  # no candidate: the port pads with (0.0, row 0)
        s_rows_j = np.where(empty, -1, s_rows)
        terms = self.terms(texts)
        exact_b = _np(ref_search.bm25_scores(terms, self.postings, self.valid_n,
                                             torch.as_tensor(np.maximum(s_rows_j, 0), device=self.device)))
        exact_b = np.where(empty, 0.0, exact_b)
        top = np.maximum(np.nan_to_num(exact_b, nan=0.0).max(axis=1), 1e-12)
        out["bm25_err"] = _value_err(exact_b, s_vals, s_rows_j, top)
        ref_bv, ref_br = (_np(x) for x in ref_search.bm25_topk(terms, self.postings, self.valid_n, s_rows.shape[1]))
        grid = _np(ref_search.bm25_grid(terms, self.postings, int(self.config["bm25"]["select_bits"])))
        out["bm25_miss"] = _miss(ref_br, ref_bv > 0.0, s_rows_j, ref_vals=ref_bv, kept_vals=exact_b, tol=grid)

        f_vals, f_rows = _np(side["f_vals"]).astype(np.float64), _np(side["f_rows"]).astype(np.int64)
        fused = ref_search.fuse(_np(side["d_vals"]), _np(side["d_rows"]), _np(side["s_vals"]), s_rows, f_vals.shape[1],
                                self.w_dense, self.w_sparse)
        out["fused_gap"] = max(_list_gap(list(zip(r, v)), top_q, table) for r, v, (top_q, table)
                               in zip(f_rows, f_vals, fused))
        return out


def _list_gap(ranked: list[tuple[int, float]], top: list[tuple[int, float]], table: dict) -> float:
    rows = [r for r, _ in ranked if r >= 0]
    if len(set(rows)) != len(rows):
        return 1.0
    worst = 0.0
    for j, (r, v) in enumerate(ranked):
        want = top[j][1] if j < len(top) else None
        if r < 0:
            if want is not None:
                return 1.0
            continue
        if r not in table or want is None:
            return 1.0
        worst = max(worst, want - table[r], abs(float(v) - table[r]))
    return worst


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def verdict(numbers: list[dict[str, float]], limits: dict[str, float]) -> tuple[bool, dict]:
    """The worst reading of each number over the checked batches, beside
    its limit, in the order of the limits; correct when each is finite and
    within its limit. A number without a limit raises ``KeyError``."""
    checks, ok = {}, True
    for name in dict.fromkeys([*limits, *(name for n in numbers for name in n)]):
        readings = [n[name] for n in numbers if name in n]
        if not readings:
            continue
        worst = float(max(readings))
        limit = limits[name]
        ok = ok and math.isfinite(worst) and worst <= limit
        checks[name] = {"value": worst, "limit": limit}
    return ok and bool(checks), checks
