"""List-major binary-residual capacity index (port of
``intool_rag_tpu/index/bits_index.py``).

One global store on the index's device, where IVF list ``l`` owns the
contiguous, block-aligned slot range ``[l·cap_l, (l+1)·cap_l)``:

- ``codes [N_cap, D/8] u8``: planar-packed residual signs,
- ``scales [N_cap/block_n, 8, block_n] f32``: per-plane gains, block-major
  (a block's scales are contiguous); ``scales[:, 0, :] = -1`` marks an
  empty slot, which the scan scores ``-inf``,
- ``gid [N_cap] i32``: slot → global row id (−1 empty).

The layout, and the files :meth:`IVFBitsIndex.save` writes, are shared
with the JAX package: either package loads the other's index.

Streaming appends place each row in its nearest centroid's list WITH FREE
SPACE (spilling to the 2nd-4th choice under skew). Search scans whole
lists and scores by the exact decomposition ``q·x ≈ q·c_list + q·r̂``, so
a spilled row is still scored correctly; spill costs residual magnitude,
never correctness. Appends update the store tensors in place.

The optional refine tier keeps whole rows as int8 in HOST memory (capacity
on the card, precision from host DRAM): the candidate pool's rows are
gathered on the host and rescored exactly on the index's device.

The device decides the scan: an index built with ``device="cpu"`` takes
the plain version of the scan, one on the card launches the CUDA kernel.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from ..device import resolve_device
from ..observability import trace_phase
from ..ops.bits_scan import N_PLANES, encode_bits_planar, ivf_bits_topk
from ..ops.kmeans import kmeans
from ..ops.quant import quantize_int8
from ..ops.topk import NEG_INF, top_k

_BLK = 32_768  # rows per encode/assign step (bounds the [rows, L] scores)


def _round_up(x: int, m: int) -> int:
    return max(m, -(-x // m) * m)


class IVFBitsIndex:
    """Streaming binary-residual index over a list-major global store."""

    def __init__(
        self,
        centroids: torch.Tensor,  # [L, D] f32
        *,
        capacity: int,
        block_n: int = 1024,
        refine: bool = True,
        device: str | torch.device | None = None,
    ) -> None:
        l, d = centroids.shape
        if d % N_PLANES:
            raise ValueError(f"D={d} must be divisible by {N_PLANES}")
        self.device = resolve_device(device)
        self.centroids = torch.as_tensor(centroids).to(self.device, torch.float32)
        self.block_n = int(block_n)
        self.cap_l = _round_up(-(-int(capacity) // l), self.block_n)
        self.n_cap = l * self.cap_l
        self.blocks_per_list = self.cap_l // self.block_n
        self.refine = refine
        self.d = d
        self._w = d // N_PLANES
        self.codes = torch.zeros((self.n_cap, self._w), dtype=torch.uint8, device=self.device)
        self.scales = torch.full(
            (self.n_cap // self.block_n, N_PLANES, self.block_n), -1.0,
            dtype=torch.float32, device=self.device,
        )
        self.gid = torch.full((self.n_cap,), -1, dtype=torch.int32, device=self.device)
        self.fill = np.zeros(l, np.int64)  # host-side per-list cursors
        self.total_rows = 0
        self.host_int8: list[np.ndarray] = []
        self.host_scale8: list[np.ndarray] = []

    # ---------------- construction ----------------

    @classmethod
    def train(
        cls,
        sample: torch.Tensor,
        nlist: int,
        *,
        capacity: int,
        iters: int = 10,
        seed: int = 0,
        device: str | torch.device | None = None,
        **kwargs,
    ) -> "IVFBitsIndex":
        """k-means the sample on the index's device, then an empty index."""
        dev = resolve_device(device)
        nlist = min(nlist, max(1, sample.shape[0] // 4))
        centroids, _ = kmeans(torch.as_tensor(sample).to(dev), nlist, iters=iters, seed=seed)
        return cls(centroids, capacity=capacity, device=dev, **kwargs)

    @property
    def nlist(self) -> int:
        return self.centroids.shape[0]

    @property
    def bytes_resident(self) -> int:
        return int(
            self.codes.numel() + self.scales.numel() * 4 + self.gid.numel() * 4
            + self.centroids.numel() * 4
        )

    @property
    def bytes_host(self) -> int:
        return int(
            sum(a.nbytes for a in self.host_int8) + sum(a.nbytes for a in self.host_scale8)
        )

    # ---------------- append ----------------

    def _place(self, choices: np.ndarray) -> np.ndarray:
        """Host-side spill placement: nearest centroid with free space.

        ``choices [m, S]`` is each row's nearest-centroid ranking.
        Vectorized per choice level: stable-sort rows by candidate list,
        accept the first ``space`` of each list, demote the rest to their
        next choice. Rows that exhaust all S choices land in ANY list with
        space (scored exactly either way)."""
        m, s_max = choices.shape
        l = self.nlist
        space = self.cap_l - self.fill.copy()
        place = np.full(m, -1, np.int64)
        for s in range(s_max):
            un = np.flatnonzero(place < 0)
            if un.size == 0:
                break
            cand = choices[un, s].astype(np.int64)
            order = np.argsort(cand, kind="stable")
            sorted_c = cand[order]
            starts = np.searchsorted(sorted_c, np.arange(l))
            rank = np.arange(sorted_c.size) - starts[sorted_c]
            ok = rank < space[sorted_c]
            place[un[order[ok]]] = sorted_c[ok]
            taken = np.bincount(sorted_c[ok], minlength=l)
            space -= taken
        left = np.flatnonzero(place < 0)
        if left.size:
            if space.sum() < left.size:
                raise ValueError(
                    f"index full: {left.size} rows do not fit "
                    f"(capacity {self.n_cap}, stored {self.total_rows})"
                )
            free_slots = np.repeat(np.arange(l), space)
            place[left] = free_slots[: left.size]
        return place

    def append(self, embeddings: torch.Tensor) -> np.ndarray:
        """Encode + scatter one chunk; returns the assigned global row ids."""
        m, d = embeddings.shape
        if d != self.d:
            raise ValueError(f"dim {d} != index dim {self.d}")
        emb = torch.as_tensor(embeddings).to(self.device)
        choices = _assign_choices(emb, self.centroids, min(4, self.nlist)).cpu().numpy()
        place = self._place(choices)
        # slot positions: list base + current fill + arrival rank in batch
        order = np.argsort(place, kind="stable")
        sorted_l = place[order]
        starts = np.searchsorted(sorted_l, np.arange(self.nlist))
        rank = np.arange(m) - starts[sorted_l]
        pos = np.empty(m, np.int64)
        pos[order] = sorted_l * self.cap_l + self.fill[sorted_l] + rank
        gids = np.arange(self.total_rows, self.total_rows + m, dtype=np.int64)

        _encode_scatter(
            self.codes, self.scales, self.gid, emb, self.centroids,
            torch.as_tensor(place, device=self.device), torch.as_tensor(pos, device=self.device),
            torch.as_tensor(gids.astype(np.int32), device=self.device),
        )
        self.fill += np.bincount(place, minlength=self.nlist)
        self.total_rows += m
        if self.refine:
            codes8, scale8 = quantize_int8(emb)
            self.host_int8.append(codes8.cpu().numpy())
            self.host_scale8.append(scale8.cpu().numpy().astype(np.float32))
        return gids

    # ---------------- search ----------------

    def _host_tier(self) -> tuple[np.ndarray, np.ndarray]:
        """The refine tier as one array pair; the per-append chunks are
        replaced by it, so only one copy stays in host memory."""
        if len(self.host_int8) > 1:
            self.host_int8 = [np.concatenate(self.host_int8)]
            self.host_scale8 = [np.concatenate(self.host_scale8)]
        return self.host_int8[0], self.host_scale8[0]

    def search(
        self,
        queries: torch.Tensor,
        k: int,
        *,
        nprobe: int = 8,
        refine_k: int | None = None,
        group_l: int = 8,
        tail: str = "fold",
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """(scores [Q, k] f32, global row ids [Q, k] i32, −1 empty).

        Query tiles of 8 share a probe list (queries are sorted by nearest
        centroid so tiles are cluster-coherent; results come back in
        caller order). ``refine_k``: pool size exactly rescored from the
        host int8 tier before the final top-k."""
        q = queries.shape[0]
        if self.total_rows == 0:
            return (
                torch.full((q, k), NEG_INF, dtype=torch.float32, device=self.device),
                torch.full((q, k), -1, dtype=torch.int32, device=self.device),
            )
        nprobe = min(nprobe, self.nlist)
        do_refine = bool(refine_k) and bool(self.host_int8)
        k_dev = max(k, refine_k) if do_refine else k

        qf = torch.as_tensor(queries).to(self.device, torch.float32)
        vals, rows = _bits_search(
            qf, self.centroids, self.codes, self.scales, self.gid,
            k=k_dev, nprobe=nprobe, block_n=self.block_n,
            blocks_per_list=self.blocks_per_list, group_l=group_l, tail=tail,
        )
        if not do_refine:
            return vals[:, :k], rows[:, :k]
        return self._refine(qf, rows, k)

    def _refine(self, qf: torch.Tensor, rows: torch.Tensor, k: int):
        return refine_from_host(qf, rows, k, *self._host_tier())

    # ---------------- persistence ----------------

    def save(self, path) -> None:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        arrays = {
            "centroids": self.centroids.cpu().numpy(),
            "codes": self.codes.cpu().numpy(),
            "scales": self.scales.cpu().numpy(),
            "gid": self.gid.cpu().numpy(),
            "fill": self.fill,
        }
        for i, a in enumerate(self.host_int8):
            arrays[f"host_int8_{i}"] = a
            arrays[f"host_scale8_{i}"] = self.host_scale8[i]
        np.savez(path, **arrays)
        meta = {
            "capacity": self.n_cap,
            "block_n": self.block_n,
            "refine": self.refine,
            "total_rows": self.total_rows,
            "n_host": len(self.host_int8),
        }
        Path(str(path) + ".meta.json").write_text(json.dumps(meta), encoding="utf-8")

    @classmethod
    def load(cls, path, device: str | torch.device | None = None) -> "IVFBitsIndex":
        path = Path(path)
        with np.load(str(path) if str(path).endswith(".npz") else f"{path}.npz") as arrays:
            meta = json.loads(Path(str(path) + ".meta.json").read_text(encoding="utf-8"))
            return bits_state_from_jax(dict(arrays), meta, device=device)


def bits_state_from_jax(
    arrays: dict[str, np.ndarray], meta: dict, device: str | torch.device | None = None
) -> IVFBitsIndex:
    """A port index from the arrays and meta of a saved index, or of a live
    JAX ``IVFBitsIndex`` taken as numpy (``centroids``, ``codes``,
    ``scales``, ``gid``, ``fill``, ``host_int8_i``/``host_scale8_i``; meta
    as :meth:`IVFBitsIndex.save` writes it)."""
    index = IVFBitsIndex(
        torch.tensor(np.asarray(arrays["centroids"])),
        capacity=meta["capacity"], block_n=meta["block_n"], refine=meta["refine"], device=device,
    )
    dev = index.device
    index.codes = torch.tensor(np.asarray(arrays["codes"]), device=dev)
    index.scales = torch.tensor(np.asarray(arrays["scales"]), device=dev)
    index.gid = torch.tensor(np.asarray(arrays["gid"]), device=dev)
    index.fill = np.asarray(arrays["fill"]).astype(np.int64)
    index.total_rows = int(meta["total_rows"])
    index.host_int8 = [np.asarray(arrays[f"host_int8_{i}"]) for i in range(meta["n_host"])]
    index.host_scale8 = [np.asarray(arrays[f"host_scale8_{i}"]) for i in range(meta["n_host"])]
    return index


# ---------------- device helpers ----------------


def refine_from_host(qf: torch.Tensor, rows: torch.Tensor, k: int, host8: np.ndarray,
                     hscale: np.ndarray) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact rescoring of the candidate pool ``rows [Q, pool]`` (−1 empty)
    from a host int8 tier (``host8 [N, D]``, ``hscale [N]``): the rows are
    gathered on the host, the products run on the queries' device; the top
    ``k`` in stable descending order. Shared by every capacity tier. Span
    ``bits.refine``; it counts ``bits.refine_calls`` and
    ``bits.refine_bytes``, the gathered rows and scales handed to the
    queries' device."""
    with trace_phase("bits.refine") as span:
        safe = np.clip(rows.cpu().numpy(), 0, len(host8) - 1)
        cand_np, scale_np = host8[safe], hscale[safe]
        span.count({"bits.refine_calls": 1, "bits.refine_bytes": cand_np.nbytes + scale_np.nbytes})
        cand = torch.from_numpy(cand_np).to(qf.device)  # [Q, pool, D] int8
        cand_scale = torch.from_numpy(scale_np).to(qf.device)
        exact = torch.einsum("qkd,qd->qk", cand.float(), qf) * cand_scale
        exact = torch.where(rows >= 0, exact, NEG_INF)
        out_vals, order = top_k(exact, k)
        out_rows = torch.gather(rows, 1, order)
        out_rows = torch.where(torch.isfinite(out_vals), out_rows, -1)
        return out_vals, out_rows


def _assign_choices(emb: torch.Tensor, centroids: torch.Tensor, s: int) -> torch.Tensor:
    """Top-s centroid ids per row [n, s] i32, blockwise."""
    out = torch.empty((emb.shape[0], s), dtype=torch.int32, device=emb.device)
    for start in range(0, emb.shape[0], _BLK):
        rows = emb[start : start + _BLK]
        out[start : start + rows.shape[0]] = top_k(rows.float() @ centroids.T, s)[1]
    return out


def _encode_scatter(codes, scales, gid, emb, centroids, place, pos, gids) -> None:
    """Residual-encode one chunk blockwise and scatter it into the store
    tensors IN PLACE (``pos`` holds distinct slots)."""
    block_n = scales.shape[2]
    for start in range(0, emb.shape[0], _BLK):
        stop = start + _BLK
        resid = emb[start:stop].float() - centroids[place[start:stop]]
        new_codes, new_scales = encode_bits_planar(resid)
        p = pos[start:stop]
        codes[p] = new_codes
        scales[p // block_n, :, p % block_n] = new_scales
        gid[p] = gids[start:stop]


def tile_probes(queries: torch.Tensor, centroids: torch.Tensor, nprobe: int):
    """Cluster-coherent query tiling + tile-shared probe selection.
    Returns ``(order [Qp], qs [Qp, D], probes [T, nprobe] list ids, c_sel
    [Qp, nprobe])`` with Qp = Q rounded up to 8.

    Queries sort by nearest centroid so tiles of 8 are cluster-coherent.
    Every query's top-1 list is force-included in its tile's probes (+inf
    scattered into the tile-sum scores, so duplicates collapse); the other
    probe slots go to the best tile-shared lists. Sorts are stable and the
    tile sum adds its 8 members in order, so probes come out in the JAX
    package's order: the order fixes the candidate columns, hence the fold
    pairs."""
    q = queries.shape[0]
    c_scores = queries @ centroids.T  # [Q, L]
    order = torch.argsort(c_scores.argmax(dim=1), stable=True)
    q_pad = _round_up(q, 8)
    if q_pad != q:
        order = torch.cat([order, order[-1:].expand(q_pad - q)])
    qs = queries[order]
    cs = c_scores[order]
    t = q_pad // 8
    tile_cs = cs.reshape(t, 8, -1)
    tile_sum = tile_cs[:, 0]
    for i in range(1, 8):
        tile_sum = tile_sum + tile_cs[:, i]
    top1 = tile_cs.argmax(dim=2)  # [T, 8]
    boosted = tile_sum.clone()
    boosted[torch.arange(t, device=queries.device)[:, None], top1] = float("inf")
    probes = top_k(boosted, nprobe)[1]  # [T, nprobe]
    c_sel = torch.gather(cs, 1, probes.repeat_interleave(8, dim=0))  # each query's OWN dot
    return order, qs, probes, c_sel


def _bits_search(
    queries, centroids, codes, scales, gid,
    *, k, nprobe, block_n, blocks_per_list, group_l, tail,
):
    q = queries.shape[0]
    order, qs, probes, c_sel = tile_probes(queries, centroids, nprobe)
    probe_blocks = (probes * blocks_per_list).to(torch.int32)
    vals, slots = ivf_bits_topk(
        qs, codes, scales, probe_blocks, c_sel, k,
        blocks_per_list=blocks_per_list, block_n=block_n, group_l=group_l, tail=tail,
    )
    rows = torch.where(torch.isfinite(vals), gid[slots.long()], -1)
    inv = torch.argsort(order[:q], stable=True)
    return vals[inv], rows[inv]
