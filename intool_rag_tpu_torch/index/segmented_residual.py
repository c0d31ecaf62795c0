"""Streaming segmented residual index: the append-only capacity path
(port of ``intool_rag_tpu/index/segmented_residual.py``).

:class:`~.ivf_residual.IVFResidualIndex` needs the whole corpus up front.
This index appends fixed-shape encoded SEGMENTS that share one trained
centroid set instead:

- ``train()`` runs k-means once on a sample; appends never retrain.
- ``append(embeddings)`` encodes one segment on the index's device: assign
  to centroids, sort by list, cap each list at ``cap`` rows with the spill
  in a per-segment overflow region right after the compacted lists, and
  quantize the residuals (int4 or sign codes). Every segment has the same
  shapes, so they stack on a leading axis whose capacity doubles.
- ``search()`` probes the same lists in every segment and folds the
  segments into a running top-k.

Scoring is ``q·c_list + q·r̂`` as in :mod:`.ivf_residual`; the optional
host int8 tier rescores the candidate pool exactly. ``save`` / ``load``
write and read the JAX package's files (``.npz`` + ``.meta.json``), so
either package loads the other's index.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from ..device import resolve_device
from ..ops.kmeans import kmeans
from ..ops.topk import NEG_INF
from .ivf_residual import (
    _BLK, bounded_chunk, check_width, codec, fold_topk, host_int8_tier, probe_lists, probe_offsets,
    residual_scores, shared_residual_scores,
)

_STORE = ("codes", "scales", "row_list", "row_map", "list_start", "list_len", "over_len")


def _pow2_at_least(x: int) -> int:
    p = 1
    while p < x:
        p *= 2
    return p


class SegmentedResidualIndex:
    """Append-only capacity index over shared-centroid encoded segments."""

    def __init__(
        self,
        centroids: torch.Tensor,  # [L, D] f32, from train()
        *,
        seg_rows: int = 500_000,
        cap: int | None = None,
        bits: int = 4,
        refine: bool = False,
        device: str | torch.device | None = None,
    ) -> None:
        l, d = centroids.shape
        check_width(bits, d)
        self.device = resolve_device(device)
        self.centroids = torch.as_tensor(centroids).to(self.device, torch.float32)
        self.seg_rows = int(seg_rows)
        self.bits = bits
        self.refine = refine
        # static per-list probe width: 4x the balanced load; the overflow
        # region catches the rest, so no row is ever dropped
        self.cap = int(cap) if cap else max(8, 4 * -(-seg_rows // l))
        self.cap = -(-self.cap // 8) * 8
        self._w = d // 2 if bits == 4 else d // 8
        self._g = max(d // 128, 1)
        # the compacted lists plus the overflow never pass seg_rows; the
        # last of the 8 slack slots takes the padding rows of a short chunk
        self._s_pad = self.seg_rows + 8
        self.max_overflow = 0  # widest per-segment overflow seen: the search's tail width
        self.n_segments = 0
        self.total_rows = 0
        self._store: tuple[torch.Tensor, ...] | None = None  # stacked, capacity-doubled
        self.host_int8: list[np.ndarray] = []
        self.host_scale8: list[np.ndarray] = []
        self._host_cat = None  # cached concat of the refine tier

    # ---------------- train ----------------

    @classmethod
    def train(
        cls,
        sample: torch.Tensor,  # [S, D] representative sample
        nlist: int,
        *,
        iters: int = 10,
        seed: int = 0,
        device: str | torch.device | None = None,
        **kwargs,
    ) -> "SegmentedResidualIndex":
        """k-means the sample on ``device`` (default CUDA), then an empty index."""
        dev = resolve_device(device)
        nlist = min(nlist, max(1, sample.shape[0] // 4))
        centroids, _ = kmeans(torch.as_tensor(sample).to(dev), nlist, iters=iters, seed=seed)
        return cls(centroids, device=dev, **kwargs)

    # ---------------- append ----------------

    @property
    def nlist(self) -> int:
        return self.centroids.shape[0]

    @property
    def bytes_resident(self) -> int:
        if self._store is None:
            return int(self.centroids.numel() * 4)
        codes, scales, row_list, row_map, list_start, list_len, _ = self._store
        return int(
            codes.numel() + scales.numel() * 4 + row_list.numel() * 4 + row_map.numel() * 4
            + list_start.numel() * 4 + list_len.numel() * 4 + self.centroids.numel() * 4
        )

    @property
    def bytes_host(self) -> int:
        return int(sum(a.nbytes for a in self.host_int8) + sum(a.nbytes for a in self.host_scale8))

    def _alloc(self, n_seg_cap: int) -> tuple[torch.Tensor, ...]:
        l, s, dev = self.nlist, self._s_pad, self.device
        return (
            torch.zeros((n_seg_cap, s, self._w), dtype=torch.uint8, device=dev),
            torch.zeros((n_seg_cap, s, self._g), dtype=torch.float32, device=dev),
            torch.zeros((n_seg_cap, s), dtype=torch.int32, device=dev),
            torch.full((n_seg_cap, s), -1, dtype=torch.int32, device=dev),
            torch.zeros((n_seg_cap, l), dtype=torch.int32, device=dev),
            torch.zeros((n_seg_cap, l), dtype=torch.int32, device=dev),
            torch.zeros((n_seg_cap,), dtype=torch.int32, device=dev),
        )

    def _grow_to(self, n_seg_cap: int) -> None:
        new = self._alloc(n_seg_cap)
        if self._store is not None:
            for buf, old in zip(new, self._store):
                buf[: old.shape[0]] = old
        self._store = new

    def append(self, embeddings: torch.Tensor) -> np.ndarray:
        """Encode one segment of up to ``seg_rows`` rows; returns the global
        row ids assigned (``total_rows_before + arange(n)``)."""
        n, d = embeddings.shape
        if n > self.seg_rows:
            raise ValueError(f"chunk of {n} rows exceeds seg_rows={self.seg_rows}; split it")
        cap_now = self._store[0].shape[0] if self._store is not None else 0
        if self.n_segments + 1 > cap_now:
            self._grow_to(_pow2_at_least(self.n_segments + 1))
        base = self.total_rows
        emb = torch.as_tensor(embeddings).to(self.device)
        seg = _encode_segment(emb, self.centroids, seg_rows=self.seg_rows, s_pad=self._s_pad,
                              cap=self.cap, bits=self.bits, base_gid=base)
        self.max_overflow = max(self.max_overflow, int(seg[-1]))
        for buf, new in zip(self._store, seg):
            buf[self.n_segments] = new
        self.n_segments += 1
        self.total_rows += n
        if self.refine:
            codes8, scales8 = host_int8_tier(emb)
            self.host_int8.append(codes8)
            self.host_scale8.append(scales8)
            self._host_cat = None  # invalidate the cached concat
        return np.arange(base, base + n, dtype=np.int64)

    # ---------------- search ----------------

    def search(
        self,
        queries: torch.Tensor,
        k: int,
        *,
        nprobe: int = 8,
        query_chunk: int = 32,
        refine_k: int | None = None,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """``(scores [Q, k] f32, global row ids [Q, k] i32, −1 empty)``, MIPS."""
        from .bits_index import refine_from_host

        qf = torch.as_tensor(queries).to(self.device, torch.float32)
        q = qf.shape[0]
        if self.n_segments == 0:
            return (torch.full((q, k), NEG_INF, dtype=torch.float32, device=self.device),
                    torch.full((q, k), -1, dtype=torch.int32, device=self.device))
        nprobe = min(nprobe, self.nlist)
        do_refine = bool(refine_k) and bool(self.host_int8)
        k_dev = max(k, refine_k) if do_refine else k
        tail_w = min(_pow2_at_least(max(self.max_overflow, 8)), self._s_pad)
        vals, rows = _segmented_search(
            qf, self.centroids, self._store, k=k_dev, nprobe=nprobe, cap=self.cap,
            n_segments=self.n_segments, tail_w=tail_w, bits=self.bits,
            query_chunk=min(query_chunk, q),
        )
        if not do_refine:
            return vals, rows
        # the tier's concat stays valid until the next append
        if self._host_cat is None:
            self._host_cat = (np.concatenate(self.host_int8), np.concatenate(self.host_scale8))
        return refine_from_host(qf, rows, k, *self._host_cat)

    # ---------------- persistence ----------------

    def save(self, path) -> None:
        """``path`` (``.npz``, live segments only) and ``path.meta.json``."""
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        n = self.n_segments
        arrays = {"centroids": self.centroids.cpu().numpy()}
        if n:
            for name, buf in zip(_STORE, self._store):
                arrays[name] = buf[:n].cpu().numpy()
        for i, a in enumerate(self.host_int8):
            arrays[f"host_int8_{i}"] = a
            arrays[f"host_scale8_{i}"] = self.host_scale8[i]
        np.savez(path, **arrays)
        meta = {
            "seg_rows": self.seg_rows, "cap": self.cap, "bits": self.bits, "refine": self.refine,
            "n_segments": n, "total_rows": self.total_rows, "max_overflow": self.max_overflow,
            "n_host": len(self.host_int8),
        }
        Path(str(path) + ".meta.json").write_text(json.dumps(meta), encoding="utf-8")

    @classmethod
    def load(cls, path, device: str | torch.device | None = None) -> "SegmentedResidualIndex":
        """An index either package saved, on ``device`` (default CUDA),
        holding exactly its live segments."""
        path = Path(path)
        meta = json.loads(Path(str(path) + ".meta.json").read_text(encoding="utf-8"))
        with np.load(str(path) if str(path).endswith(".npz") else f"{path}.npz") as arrays:
            index = cls(torch.from_numpy(arrays["centroids"]), seg_rows=meta["seg_rows"], cap=meta["cap"],
                        bits=meta["bits"], refine=meta["refine"], device=device)
            if meta["n_segments"]:
                index._store = tuple(torch.from_numpy(arrays[k]).to(index.device) for k in _STORE)
            index.host_int8 = [arrays[f"host_int8_{i}"] for i in range(meta["n_host"])]
            index.host_scale8 = [arrays[f"host_scale8_{i}"] for i in range(meta["n_host"])]
        index.n_segments = meta["n_segments"]
        index.total_rows = meta["total_rows"]
        index.max_overflow = meta["max_overflow"]
        return index


def _encode_segment(emb, centroids, *, seg_rows, s_pad, cap, bits, base_gid):
    """Assign → sort by list → cap with the overflow region → encode.
    Returns the segment's arrays shaped for the stacked store, and its
    overflow length (a 0-d tensor)."""
    n, _ = emb.shape
    l = centroids.shape[0]
    dev = emb.device
    encode, _ = codec(bits)
    assign = torch.empty(n, dtype=torch.int64, device=dev)
    for start in range(0, n, _BLK):  # blockwise: the [n, L] scores are never whole
        assign[start : start + _BLK] = (emb[start : start + _BLK].float() @ centroids.T).argmax(dim=1)

    # the padding rows of a short chunk take list id L: they sort last
    pad = seg_rows - n
    assign_p = torch.cat([assign, torch.full((pad,), l, dtype=torch.int64, device=dev)])
    order = torch.argsort(assign_p, stable=True)
    sorted_list = assign_p[order]
    list_start_all = torch.searchsorted(sorted_list, torch.arange(l + 1, device=dev), side="left")
    list_len = torch.clamp(torch.diff(list_start_all), max=cap)
    lst = sorted_list.clamp(max=l - 1)
    rank = torch.arange(seg_rows, device=dev) - list_start_all[lst]
    is_pad = sorted_list >= l
    in_main = (rank < cap) & ~is_pad
    main_start = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev), torch.cumsum(list_len, 0)])
    spill = ~in_main & ~is_pad
    # overflow rows follow the compacted lists in arrival order: no drops
    pos = torch.where(in_main, main_start[lst] + rank,
                      torch.where(is_pad, s_pad - 1, main_start[-1] + torch.cumsum(spill.long(), 0) - 1))
    pos = pos.clamp(0, s_pad - 1)

    w = centroids.shape[1] // 2 if bits == 4 else centroids.shape[1] // 8
    g = max(centroids.shape[1] // 128, 1)
    seg_codes = torch.zeros((s_pad, w), dtype=torch.uint8, device=dev)
    seg_scales = torch.zeros((s_pad, g), dtype=torch.float32, device=dev)
    seg_list = torch.zeros((s_pad,), dtype=torch.int32, device=dev)
    seg_gid = torch.full((s_pad,), -1, dtype=torch.int32, device=dev)
    # the real rows are the first n in sorted order; encode them blockwise
    for start in range(0, n, _BLK):
        stop = min(start + _BLK, n)
        resid = emb[order[start:stop]].float() - centroids[lst[start:stop]]
        seg_codes[pos[start:stop]], seg_scales[pos[start:stop]] = encode(resid)
    seg_list[pos[:n]] = lst[:n].to(torch.int32)
    seg_gid[pos[:n]] = (base_gid + order[:n]).to(torch.int32)
    if pad:
        # every padding row lands in the last slack slot, as in the JAX
        # encoder: code 0, list L−1, gid −1, and the scale of a zero row's
        # residual against centroid L−1
        seg_scales[s_pad - 1] = encode(-centroids[l - 1 : l])[1][0]
        seg_list[s_pad - 1] = l - 1
    return (seg_codes, seg_scales, seg_list, seg_gid, main_start[:-1].to(torch.int32),
            list_len.to(torch.int32), spill.sum().to(torch.int32))


def _segmented_search(qf, centroids, store, *, k, nprobe, cap, n_segments, tail_w, bits, query_chunk):
    """Every segment's probed lists and its overflow region, folded
    segment by segment into each query's running top-k. The JAX search
    scans a power-of-two count of segments with the unwritten ones masked
    to −inf; they add nothing, so only the written segments are scanned
    here. A segment's overflow region is decoded and scored once for every
    query; its lists in query chunks (``bounded_chunk``)."""
    _, dequant = codec(bits)
    codes, scales, row_list, row_map, list_start, list_len, over_len = store
    c_scores, probes = probe_lists(qf, centroids, nprobe)
    s_pad = codes.shape[1]
    q, dev = qf.shape[0], qf.device
    tail = torch.arange(tail_w, dtype=torch.int64, device=dev)
    over_start = list_len[:n_segments].sum(dim=1, dtype=torch.int64)
    chunk = bounded_chunk(query_chunk, nprobe * cap, qf.shape[1])
    best_v = torch.full((q, k), NEG_INF, dtype=torch.float32, device=dev)
    best_r = torch.full((q, k), -1, dtype=torch.int32, device=dev)
    for c in range(n_segments):
        ooffs = (over_start[c] + tail).clamp(0, s_pad - 1)
        ogids = row_map[c][ooffs]
        ovalid = (tail < over_len[c]) & (ogids >= 0)
        osc = shared_residual_scores(qf, c_scores, codes[c], scales[c], row_list[c], ooffs, ovalid, dequant)
        for start in range(0, q, chunk):
            rows = slice(start, start + chunk)
            offs, in_len = probe_offsets(probes[rows], list_start[c], list_len[c], cap)
            offs = offs.clamp(0, s_pad - 1)
            gids = row_map[c][offs]
            sc = residual_scores(qf[rows], c_scores[rows], codes[c], scales[c], row_list[c], offs,
                                 in_len & (gids >= 0), dequant)
            best_v[rows], best_r[rows] = fold_topk(
                torch.cat([best_v[rows], sc, osc[rows]], dim=1),
                torch.cat([best_r[rows], gids, ogids.expand(gids.shape[0], -1)], dim=1), k,
            )
        del osc
    return best_v, best_r
