"""IVF with packed residual codes: the capacity index (port of
``intool_rag_tpu/index/ivf_residual.py``).

k-means removes most of each vector's energy, so the residual
``r = x − centroid(list(x))`` quantizes well at 4 bits (two codes a byte,
0.5 byte a dim) or as its sign alone (8 a byte, 0.125 byte a dim). Scoring
is the exact decomposition ``q·x = q·c_list + q·r̂``: the first term comes
from the centroid probe's scores, the second from the dequantized codes.

The layout is :class:`~.ivf_index.IVFFlatIndex`'s: rows permuted so that
each list is contiguous, lists capped at ``cap`` rows, the spill in one
shared overflow tail that every query scans. The optional refine tier
keeps every row as int8 in HOST memory; :meth:`IVFResidualIndex.search`
then takes ``max(k, refine_k)`` candidates from the codes and rescores
them exactly from that tier (``bits_index.refine_from_host``).

Plain PyTorch on the index's device: the JAX package has no Pallas kernel
here (its search is XLA gathers, einsums and top-k).
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..ops.kmeans import kmeans
from ..ops.topk import NEG_INF, blocked_topk, top_k

GROUP = 128  # dims per quantization group (one scale per group)
_BLK = 32_768  # rows per encode step: bounds the f32 transients of a build
# XLA compiles the JAX package's ``absmax / 7.0`` and ``absmax / 127.0`` as
# ``absmax · (1/7)`` and ``absmax · (1/127)`` (its builds run under
# ``jax.jit``): multiplying by the same f32 reciprocals gives its scales,
# and so its codes, bit for bit on any device
_INV7 = torch.tensor(1.0 / 7.0, dtype=torch.float32).item()
_INV127 = torch.tensor(1.0 / 127.0, dtype=torch.float32).item()


def encode_int4_residuals(residuals: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Group-wise symmetric int4 codes, two a byte.

    Returns ``(packed [N, D/2] u8, scales [N, D/GROUP] f32)``: codes in
    [−7, 7] offset by +8, low nibble = even dim, high nibble = odd dim."""
    n, d = residuals.shape
    g = max(d // GROUP, 1)
    r = residuals.float().reshape(n, g, -1)
    scale = r.abs().amax(dim=2).clamp_min(1e-9) * _INV7  # [N, G]
    q = (torch.round(r / scale[:, :, None]).clamp(-7, 7) + 8.0).reshape(n, d).to(torch.uint8)
    return q[:, 0::2] | (q[:, 1::2] << 4), scale


def decode_int4(packed: torch.Tensor) -> torch.Tensor:
    """``[..., D/2] u8`` → ``[..., D]`` f32 codes in [−7, 7]."""
    out = torch.empty((*packed.shape[:-1], 2 * packed.shape[-1]), dtype=torch.float32,
                      device=packed.device)
    out[..., 0::2] = (packed & 15).float() - 8.0
    out[..., 1::2] = (packed >> 4).float() - 8.0
    return out


def _scaled(codes: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    n, d = codes.shape
    return codes.view(n, scales.shape[1], -1).mul_(scales[:, :, None]).view(n, d)


def dequantize_int4(packed: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """``(packed [N, D/2], scales [N, G])`` → residuals ``[N, D]`` f32."""
    return _scaled(decode_int4(packed), scales)


_BIT_WEIGHTS = [1 << j for j in range(8)]


def encode_int1_residuals(residuals: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Sign codes, 8 a byte, with the MSE-optimal level ``mean|r|`` per
    group. Returns ``(packed [N, D/8] u8, scales [N, D/GROUP] f32)``: bit
    j of byte b is 1 where dim 8b+j is non-negative."""
    n, d = residuals.shape
    g = max(d // GROUP, 1)
    r = residuals.float()
    scale = r.reshape(n, g, -1).abs().mean(dim=2).clamp_min(1e-9)
    bits = (r.reshape(n, d // 8, 8) >= 0).to(torch.uint8)
    weights = torch.tensor(_BIT_WEIGHTS, dtype=torch.uint8, device=r.device)
    return (bits * weights).sum(dim=2, dtype=torch.uint8), scale


def decode_int1(packed: torch.Tensor) -> torch.Tensor:
    """``[..., D/8] u8`` → ``[..., D]`` f32 codes in {−1, +1}."""
    j = torch.arange(8, dtype=torch.uint8, device=packed.device)
    bits = (packed[..., None] >> j) & 1
    return (bits.float() * 2.0 - 1.0).reshape(*packed.shape[:-1], -1)


def dequantize_int1(packed: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """``(packed [N, D/8], scales [N, G])`` → ``scale · sign(r)`` ``[N, D]`` f32."""
    return _scaled(decode_int1(packed), scales)


def codec(bits: int):
    """``(encode, dequantize)`` of a code width."""
    if bits == 4:
        return encode_int4_residuals, dequantize_int4
    if bits == 1:
        return encode_int1_residuals, dequantize_int1
    raise ValueError(f"bits must be 4 or 1, got {bits}")


def check_width(bits: int, d: int) -> None:
    codec(bits)
    if bits == 4 and d % 2:
        raise ValueError("int4 packing needs even D")
    if bits == 1 and d % 8:
        raise ValueError("binary packing needs D divisible by 8")


def host_int8_tier(embeddings: torch.Tensor) -> tuple[np.ndarray, np.ndarray]:
    """Per-row int8 codes and f32 scales of ``embeddings`` in host memory
    (``ops.quant.quantize_int8`` with the scale rounded as the JAX builds
    round it), quantized a block at a time on their device."""
    codes, scales = [], []
    for start in range(0, embeddings.shape[0], _BLK):
        xf = embeddings[start : start + _BLK].float()
        s8 = xf.abs().amax(dim=1).clamp_min(1e-9) * _INV127
        codes.append(torch.round(xf / s8[:, None]).clamp(-127, 127).to(torch.int8).cpu().numpy())
        scales.append(s8.cpu().numpy())
    return np.concatenate(codes), np.concatenate(scales)


# ---------------- list layout (shared with ivf_index) ----------------


def list_layout(assign_np: np.ndarray, nlist: int, cap_quantile: float):
    """The capped, list-contiguous permutation of the JAX builds, on the
    host. Returns ``(perm [M] i64, list_start [L] i32, list_len [L] i32,
    overflow_start, overflow_len, cap, m_pad)``."""
    counts = np.bincount(assign_np, minlength=nlist)
    cap = int(np.quantile(counts, cap_quantile)) + 1
    cap = max(8, -(-cap // 8) * 8)
    main_rows, overflow_rows = [], []
    list_start = np.zeros(nlist, np.int32)
    list_len = np.zeros(nlist, np.int32)
    pos = 0
    order = np.argsort(assign_np, kind="stable")
    bounds = np.searchsorted(assign_np[order], np.arange(nlist + 1))
    for l in range(nlist):
        rows = order[bounds[l] : bounds[l + 1]]
        keep, spill = rows[:cap], rows[cap:]
        list_start[l] = pos
        list_len[l] = len(keep)
        main_rows.append(keep)
        overflow_rows.append(spill)
        pos += len(keep)
    overflow = np.concatenate(overflow_rows) if overflow_rows else np.zeros(0, np.int64)
    perm = np.concatenate(main_rows + [overflow]).astype(np.int64)
    m = len(perm)
    m_pad = max(8, -(-(m + cap) // 8) * 8)  # slack so a probe's cap rows never run past the end
    return perm, list_start, list_len, pos, int(len(overflow)), cap, m_pad


def probe_lists(qf: torch.Tensor, centroids: torch.Tensor, nprobe: int):
    """``(c_scores [Q, L] f32, probes [Q, nprobe])``: centroid dots and
    each query's best lists (ties to the lower list id, as ``lax.top_k``)."""
    c_scores = qf.float() @ centroids.T
    return c_scores, top_k(c_scores, nprobe)[1]


def probe_offsets(chunk_p, list_start, list_len, cap: int):
    """Rows of the probed lists, ``[Qc, nprobe·cap]``, and the mask of those
    inside each list's length."""
    qc = chunk_p.shape[0]
    ar = torch.arange(cap, dtype=torch.int64, device=chunk_p.device)
    offs = (list_start[chunk_p].long()[:, :, None] + ar).reshape(qc, -1)
    in_len = (ar[None, None, :] < list_len[chunk_p][:, :, None]).reshape(qc, -1)
    return offs, in_len


# bytes of f32 candidate rows that one query chunk may gather
GATHER_BUDGET = 2 << 30


def bounded_chunk(query_chunk: int, rows_per_query: int, d: int) -> int:
    """``query_chunk``, cut so that a chunk's gathered f32 rows ``[Qc,
    rows_per_query, D]`` stay within ``GATHER_BUDGET`` (one query at
    least). The JAX searches gather ``[query_chunk, nprobe·cap, D]``
    whatever ``cap`` is, and ``cap`` follows the list sizes' 98th
    percentile: a skewed k-means makes it tens of thousands of rows. A
    query's result does not depend on the chunk it is scored in."""
    return max(1, min(query_chunk, GATHER_BUDGET // max(1, rows_per_query * d * 4)))


def fold_topk(scores: torch.Tensor, ids: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k of ``scores [Qc, M]`` with their ids (−1 where not finite),
    padded with −inf / −1 when M < k."""
    vals, pos = blocked_topk(scores, k, block=1024)
    rows = torch.gather(ids, 1, pos)
    if vals.shape[1] < k:
        pad = k - vals.shape[1]
        vals = torch.nn.functional.pad(vals, (0, pad), value=NEG_INF)
        rows = torch.nn.functional.pad(rows, (0, pad), value=-1)
    return vals, torch.where(torch.isfinite(vals), rows, -1)


class IVFResidualIndex:
    """IVF + packed residual codes (capacity-oriented index)."""

    def __init__(
        self,
        centroids: torch.Tensor,  # [L, D] f32
        codes: torch.Tensor,  # [M_pad, D/2 or D/8] u8, permuted by list
        scales: torch.Tensor,  # [M_pad, G] f32
        row_list: torch.Tensor,  # [M_pad] i32: permuted row -> its list id
        row_map: torch.Tensor,  # [M_pad] i32: permuted row -> original row (-1 pad)
        list_start: torch.Tensor,
        list_len: torch.Tensor,
        overflow_start: int,
        overflow_len: int,
        cap: int,
        bits: int = 4,
    ) -> None:
        self.centroids = centroids
        self.codes = codes
        self.scales = scales
        self.row_list = row_list
        self.row_map = row_map
        self.list_start = list_start
        self.list_len = list_len
        self.overflow_start = overflow_start
        self.overflow_len = overflow_len
        self.cap = cap
        self.bits = bits
        self.host_int8: np.ndarray | None = None
        self.host_scale8: np.ndarray | None = None

    @property
    def device(self) -> torch.device:
        return self.codes.device

    @property
    def nlist(self) -> int:
        return self.centroids.shape[0]

    @property
    def bytes_resident(self) -> int:
        return int(self.codes.numel() + self.scales.numel() * 4 + self.centroids.numel() * 4
                   + self.row_map.numel() * 8)

    @property
    def bytes_host(self) -> int:
        """Host-memory footprint of the optional int8 refine tier."""
        if self.host_int8 is None:
            return 0
        return int(self.host_int8.nbytes + self.host_scale8.nbytes)

    # ---------------- build ----------------

    @classmethod
    def build(
        cls,
        embeddings: torch.Tensor,  # [N, D]
        nlist: int,
        *,
        iters: int = 10,
        cap_quantile: float = 0.98,
        seed: int = 0,
        refine: bool = False,
        bits: int = 4,
        device: str | torch.device | None = None,
    ) -> "IVFResidualIndex":
        """k-means, the capped list layout, then the residual codes, all on
        ``device`` (default CUDA), a block of rows at a time."""
        dev = resolve_device(device)
        n, d = embeddings.shape
        check_width(bits, d)
        encode, _ = codec(bits)
        emb = torch.as_tensor(embeddings).to(dev)
        nlist = min(nlist, max(1, n // 4))
        centroids, assign = kmeans(emb, nlist, iters=iters, seed=seed)
        centroids = centroids.to(dev, torch.float32)
        assign_np = assign.cpu().numpy().astype(np.int64)
        perm, list_start, list_len, o_start, o_len, cap, m_pad = list_layout(assign_np, nlist, cap_quantile)
        m = len(perm)
        width = d // 2 if bits == 4 else d // 8
        codes = torch.zeros((m_pad, width), dtype=torch.uint8, device=dev)
        scales = torch.zeros((m_pad, max(d // GROUP, 1)), dtype=torch.float32, device=dev)
        row_list = np.zeros(m_pad, np.int32)
        row_list[:m] = assign_np[perm]
        perm_dev = torch.as_tensor(perm, device=dev)
        lists_dev = torch.as_tensor(row_list[:m].astype(np.int64), device=dev)
        for start in range(0, m, _BLK):
            stop = min(start + _BLK, m)
            resid = emb[perm_dev[start:stop]].float() - centroids[lists_dev[start:stop]]
            codes[start:stop], scales[start:stop] = encode(resid)
        row_map = np.full(m_pad, -1, np.int32)
        row_map[:m] = perm
        idx = cls(
            centroids=centroids, codes=codes, scales=scales,
            row_list=torch.as_tensor(row_list, device=dev), row_map=torch.as_tensor(row_map, device=dev),
            list_start=torch.as_tensor(list_start, device=dev), list_len=torch.as_tensor(list_len, device=dev),
            overflow_start=o_start, overflow_len=o_len, cap=cap, bits=bits,
        )
        if refine:
            idx.host_int8, idx.host_scale8 = host_int8_tier(emb)
        return idx

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
        """``(scores [Q, k] f32, original rows [Q, k] i32)``, MIPS. With
        ``refine_k`` and a host int8 tier, the device pass keeps
        ``max(k, refine_k)`` candidates and the host tier rescores them."""
        from .bits_index import refine_from_host

        nprobe = min(nprobe, self.nlist)
        do_refine = bool(refine_k) and self.host_int8 is not None
        k_dev = max(k, refine_k) if do_refine else k
        qf = torch.as_tensor(queries).to(self.device, torch.float32)
        vals, rows = _ivf_residual_search(
            qf, self.centroids, self.codes, self.scales, self.row_list, self.row_map,
            self.list_start, self.list_len, k=k_dev, nprobe=nprobe, cap=self.cap,
            overflow_start=self.overflow_start, overflow_len=self.overflow_len,
            query_chunk=min(query_chunk, qf.shape[0]), bits=self.bits,
        )
        if not do_refine:
            return vals, rows
        return refine_from_host(qf, rows, k, self.host_int8, self.host_scale8)


def residual_scores(chunk_q, chunk_cs, codes, scales, row_list, offs, valid, dequant):
    """``q·c_list + q·r̂`` of the permuted rows ``offs [Qc, R]`` (−inf where
    not ``valid``): the codes gathered and dequantized, one batched product."""
    qc = chunk_q.shape[0]
    flat = offs.reshape(-1)
    r = dequant(codes[flat], scales[flat]).view(qc, -1, chunk_q.shape[1])
    res = torch.bmm(r, chunk_q[:, :, None])[:, :, 0]
    del r
    cent = torch.gather(chunk_cs, 1, row_list[offs].long())
    return torch.where(valid, cent + res, NEG_INF)


def shared_residual_scores(chunk_q, chunk_cs, codes, scales, row_list, offs, valid, dequant):
    """The same for rows every query scans (an overflow tail): decoded
    once, one product ``[Q, D] × [D, T]``."""
    r = dequant(codes[offs], scales[offs])
    cent = chunk_cs[:, row_list[offs].long()]
    return torch.where(valid[None, :], cent + chunk_q @ r.T, NEG_INF)


def _ivf_residual_search(
    qf, centroids, codes, scales, row_list, row_map, list_start, list_len,
    *, k, nprobe, cap, overflow_start, overflow_len, query_chunk, bits=4,
):
    _, dequant = codec(bits)
    c_scores, probes = probe_lists(qf, centroids, nprobe)
    over_pad = -(-max(overflow_len, 1) // 8) * 8 if overflow_len else 0
    dev = qf.device
    if over_pad:  # the shared overflow tail: decoded and scored once for every query
        ooffs = overflow_start + torch.arange(over_pad, dtype=torch.int64, device=dev)
        oids = row_map[ooffs]
        ovalid = (torch.arange(over_pad, device=dev) < overflow_len) & (oids >= 0)
        oscores = shared_residual_scores(qf, c_scores, codes, scales, row_list, ooffs, ovalid, dequant)
    chunk = bounded_chunk(query_chunk, nprobe * cap, qf.shape[1])
    out_v, out_r = [], []
    for start in range(0, qf.shape[0], chunk):
        chunk_q = qf[start : start + chunk]
        chunk_cs = c_scores[start : start + chunk]
        offs, in_len = probe_offsets(probes[start : start + chunk], list_start, list_len, cap)
        ids = row_map[offs]
        scores = residual_scores(chunk_q, chunk_cs, codes, scales, row_list, offs, in_len & (ids >= 0), dequant)
        if over_pad:
            scores = torch.cat([scores, oscores[start : start + chunk]], dim=1)
            ids = torch.cat([ids, oids.expand(chunk_q.shape[0], -1)], dim=1)
        vals, rows = fold_topk(scores, ids, k)
        out_v.append(vals)
        out_r.append(rows)
    return torch.cat(out_v), torch.cat(out_r)
