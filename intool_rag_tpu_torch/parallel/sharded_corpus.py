"""Incremental sharded corpus (port of
``intool_rag_tpu/parallel/sharded_corpus.py``): streaming appends over the
mesh in O(batch).

Each shard keeps spare capacity; an append places each new row on the
emptiest shard (the JAX package's vectorized water-filling, on the host)
and writes it in place into that shard's tensors on its device, so only
the batch moves. When the capacity runs out, every shard regrows by
``growth`` on its own device (the JAX package copies through the host);
existing rows keep their shard and slot.

Row identity: global row id = ``slot · S + shard`` (interleaved), which
does not depend on the capacity, so ids survive appends and regrowth.
``counts`` (per shard, on the host) is the truth of what is valid.

Quantized planes (``quant="int8"`` / ``"int8r"``): int8 codes + per-row
scales (+ the residual plane), the feature axis zero-padded to a multiple
of 128; rows quantize with the scale rule of the JAX package's jitted
encode (``absmax · (1/127)``), so codes and scales equal its bytes, and
search runs K2 per shard.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.quant import quantize_int8, quantize_int8_residual
from .mesh import Mesh, ShardedTensor
from .sharded_search import kernel_group_l, sharded_flat_topk, sharded_flat_topk_int8


def _round_up(x: int, m: int) -> int:
    return max(m, -(-x // m) * m)


def place_rows(counts: np.ndarray, cap: int, m: int) -> tuple[np.ndarray, np.ndarray]:
    """The JAX corpus's placement of ``m`` rows, water filling in O(M log M):
    the shards end with the counts of placing the rows one by one on the
    emptiest shard. Returns ``(dest_shard [m] i32, dest_slot [m] i32)``."""
    order = np.argsort(counts, kind="stable")
    sorted_counts = counts[order].astype(np.int64)
    lo, hi = int(sorted_counts[0]), cap
    while lo < hi:  # the least level L with sum(max(0, min(L, cap) - c_s)) >= m
        mid = (lo + hi) // 2
        if np.maximum(0, np.minimum(mid, cap) - sorted_counts).sum() >= m:
            hi = mid
        else:
            lo = mid + 1
    take = np.maximum(0, np.minimum(lo, cap) - sorted_counts)
    # at the final level some shards take one row less: the ones with the
    # highest starting count (the greedy rule would have reached them last)
    excess = int(take.sum() - m)
    if excess > 0:
        at_level = np.flatnonzero(take > 0)
        trim = at_level[np.argsort(-sorted_counts[at_level], kind="stable")]
        take[trim[:excess]] -= 1
    dest_shard = np.repeat(order, take).astype(np.int32)
    within = np.arange(m) - np.repeat(np.concatenate([[0], np.cumsum(take)[:-1]]), take)
    return dest_shard, (counts[dest_shard] + within).astype(np.int32)


class ShardedCorpus:
    """Row-sharded embedding corpus with incremental append.

    ``quant``: ``"none"`` stores rows at ``dtype``; ``"int8"`` int8 codes +
    f32 scales; ``"int8r"`` adds the residual int8 plane. Planes are
    :class:`.mesh.ShardedTensor` s (``data``, or ``codes`` / ``scales`` /
    ``res``)."""

    def __init__(
        self,
        dim: int,
        mesh: Mesh,
        *,
        capacity_per_shard: int = 1024,
        dtype: torch.dtype = torch.float32,
        growth: float = 2.0,
        quant: str = "none",
    ) -> None:
        if quant not in ("none", "int8", "int8r"):
            raise ValueError(f"unknown quant mode {quant!r}")
        self.dim = dim
        # K2 needs D % 128 == 0; zero columns change neither the per-row
        # absmax scale nor any inner product
        self.dim_pad = _round_up(dim, 128) if quant != "none" else dim
        self.mesh = mesh
        self.n_shards = mesh.size
        # the quantized planes round capacity to one 128-row kernel block, so
        # K2 always has a group width (1 at worst)
        self.row_align = 128 if quant != "none" else 8
        self.cap = _round_up(capacity_per_shard, self.row_align)
        self.dtype = dtype
        self.growth = growth
        self.quant = quant
        self.counts = np.zeros(self.n_shards, np.int32)
        self.data = self.codes = self.scales = self.res = None
        self._set_planes(tuple(self._zeros(shape, dt) for shape, dt in self._plane_specs()))

    # ---------------- storage planes ----------------

    def _plane_specs(self) -> list[tuple[tuple[int, ...], torch.dtype]]:
        """(row shape, dtype) of each plane."""
        if self.quant == "none":
            return [((self.dim,), self.dtype)]
        specs = [((self.dim_pad,), torch.int8), ((), torch.float32)]
        return specs + [((self.dim_pad,), torch.int8)] if self.quant == "int8r" else specs

    def _zeros(self, row_shape, dtype) -> ShardedTensor:
        return ShardedTensor(
            [torch.zeros((self.cap, *row_shape), dtype=dtype, device=d) for d in self.mesh.flat_devices],
            self.mesh,
        )

    def _planes(self) -> tuple[ShardedTensor, ...]:
        if self.quant == "none":
            return (self.data,)
        return (self.codes, self.scales) + ((self.res,) if self.quant == "int8r" else ())

    def _set_planes(self, planes: tuple[ShardedTensor, ...]) -> None:
        if self.quant == "none":
            (self.data,) = planes
        elif self.quant == "int8":
            self.codes, self.scales = planes
        else:
            self.codes, self.scales, self.res = planes

    def _encode(self, batch: torch.Tensor) -> tuple[torch.Tensor, ...]:
        """An append batch as rows of each plane (row-local)."""
        if self.quant == "none":
            return (batch.to(self.dtype),)
        if batch.shape[1] != self.dim_pad:
            batch = torch.nn.functional.pad(batch.float(), (0, self.dim_pad - batch.shape[1]))
        if self.quant == "int8":
            return quantize_int8(batch, reciprocal=True)
        q1, q2, s8 = quantize_int8_residual(batch, reciprocal=True)
        return (q1, s8, q2)

    # ---------------- info ----------------

    @property
    def valid_n(self) -> int:
        return int(self.counts.sum())

    def global_rows(self, shard: np.ndarray, slot: np.ndarray) -> np.ndarray:
        return slot.astype(np.int64) * self.n_shards + shard

    # ---------------- append ----------------

    def append(self, batch) -> np.ndarray:
        """Append ``[M, dim]`` rows (numpy or a tensor on any device).
        Returns their global row ids [M]."""
        batch = torch.as_tensor(batch)
        m = batch.shape[0]
        if m == 0:
            return np.zeros(0, np.int64)
        if self.valid_n + m > self.n_shards * self.cap:
            self._grow(self.valid_n + m)
        dest_shard, dest_slot = place_rows(self.counts, self.cap, m)
        encoded = self._encode(batch)
        for s, dev in enumerate(self.mesh.flat_devices):
            mine = np.flatnonzero(dest_shard == s)
            if mine.size == 0:
                continue
            slots = torch.as_tensor(dest_slot[mine], dtype=torch.long, device=dev)
            mine = torch.as_tensor(mine, device=batch.device)
            for plane, rows in zip(self._planes(), encoded):
                plane.shards[s][slots] = rows[mine].to(dev, non_blocking=True)
        np.add.at(self.counts, dest_shard, 1)
        return self.global_rows(dest_shard, dest_slot)

    def _grow(self, need_rows: int) -> None:
        """Amortized regrowth on each shard's device: the valid rows move to
        a larger buffer (rare, O(N) like vector doubling)."""
        new_cap = _round_up(max(int(need_rows * self.growth / self.n_shards) + 1, self.cap * 2), self.row_align)
        grown = []
        for plane in self._planes():
            shards = []
            for s, old in enumerate(plane.shards):
                new = old.new_zeros((new_cap, *old.shape[1:]))
                c = int(self.counts[s])
                new[:c] = old[:c]
                shards.append(new)
            grown.append(ShardedTensor(shards, self.mesh))
        self.cap = new_cap
        self._set_planes(tuple(grown))

    # ---------------- query ----------------

    def search(
        self,
        queries: torch.Tensor,
        k: int,
        *,
        block_n: int = 16384,
        kernel: str | None = None,
        group_l: int | None = None,
        tail: str = "fold",
    ):
        """Global top-k; returned indices are global row ids. ``kernel``
        (``quant="none"`` only): None picks K1 per shard when the shards
        lie on the card and a group width fits, else the blocked scan."""
        if self.quant != "none":
            if queries.shape[1] != self.dim_pad:
                queries = torch.nn.functional.pad(queries.float(), (0, self.dim_pad - queries.shape[1]))
            return sharded_flat_topk_int8(
                queries, self.codes, self.scales, k, self.mesh, res=self.res, valid_n=self.counts,
                group_l=group_l, tail=tail,
            )
        if kernel is None:
            on_card = all(d.type == "cuda" for d in self.mesh.flat_devices)
            kernel = "fused" if on_card and kernel_group_l(self.cap, k) is not None else "scan"
        return sharded_flat_topk(
            queries, self.data, k, self.mesh, valid_n=self.counts, block_n=min(block_n, self.cap),
            kernel=kernel, group_l=group_l, tail=tail,
        )
