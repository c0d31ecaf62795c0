"""The binary-residual capacity tier over the mesh (port of
``intool_rag_tpu/parallel/sharded_bits.py``).

Every IVF list's slot range is split equally across the shards: shard
``s`` owns, for each list ``l``, the local range ``[l·cap_ls, (l+1)·cap_ls)``
of its own list-major store (``cap_ls = cap_l / S``). So:

- the probe pre-pass (:func:`..index.bits_index.tile_probes`) runs once:
  list ``l`` starts at local block ``l·local_blocks`` on every shard, and
  the same probe blocks feed every shard's scan;
- each shard's search is the single-device scan, K3 through
  :func:`..ops.bits_scan.ivf_bits_topk`, over a store of
  ``blocks_per_list / S`` blocks a list, then one merge of k candidates a
  shard (the gid tables hold global row ids).

A row's score ``q·c_list + q·r̂`` does not depend on where it lies, so the
placement inside a list (its least-filled shard) moves load, never scores.
``save`` / ``load`` read and write the JAX package's files.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from ..index.bits_index import _assign_choices, _encode_scatter, tile_probes
from ..ops.bits_scan import N_PLANES, ivf_bits_topk
from ..ops.kmeans import kmeans
from ..ops.topk import NEG_INF
from .collectives import merge_topk
from .mesh import Mesh, ShardedTensor, on_device


def _round_up(x: int, m: int) -> int:
    return max(m, -(-x // m) * m)


class ShardedBitsIndex:
    """Streaming binary-residual index row-sharded over the mesh."""

    def __init__(self, centroids: torch.Tensor, mesh: Mesh, *, capacity: int, block_n: int = 1024) -> None:
        l, d = centroids.shape
        if d % N_PLANES:
            raise ValueError(f"D={d} must be divisible by {N_PLANES}")
        self.mesh = mesh
        self.n_shards = mesh.size
        self.centroids = torch.as_tensor(centroids).to(mesh.out_device, torch.float32)
        self._centroids_at = {d_: self.centroids.to(d_) for d_ in set(mesh.flat_devices)}
        self.block_n = int(block_n)
        self.cap_ls = _round_up(-(-int(capacity) // (l * self.n_shards)), self.block_n)  # per list, per shard
        self.cap_l = self.cap_ls * self.n_shards
        self.local_cap = l * self.cap_ls
        self.n_cap = self.local_cap * self.n_shards
        self.local_blocks = self.cap_ls // self.block_n  # blocks a list on one shard
        self.d = d
        devs = mesh.flat_devices
        self.codes = ShardedTensor(
            [torch.zeros((self.local_cap, d // N_PLANES), dtype=torch.uint8, device=x) for x in devs], mesh)
        # block-major scales (ops/bits_scan.py); -1 marks an empty slot
        self.scales = ShardedTensor(
            [torch.full((self.local_cap // self.block_n, N_PLANES, self.block_n), -1.0, device=x) for x in devs],
            mesh)
        self.gid = ShardedTensor([torch.full((self.local_cap,), -1, dtype=torch.int32, device=x) for x in devs],
                                 mesh)
        self.fill = np.zeros((l, self.n_shards), np.int64)  # host cursors
        self.total_rows = 0

    @classmethod
    def train(cls, sample: torch.Tensor, nlist: int, mesh: Mesh, *, capacity: int, iters: int = 10,
              seed: int = 0, **kwargs) -> "ShardedBitsIndex":
        """k-means of the sample on the mesh's first device, then an empty index."""
        nlist = min(nlist, max(1, sample.shape[0] // 4))
        centroids, _ = kmeans(torch.as_tensor(sample).to(mesh.out_device), nlist, iters=iters, seed=seed)
        return cls(centroids, mesh, capacity=capacity, **kwargs)

    @property
    def nlist(self) -> int:
        return self.centroids.shape[0]

    @property
    def bytes_per_shard(self) -> int:
        return (self.codes.shards[0].numel() + self.scales.shards[0].numel() * 4 + self.gid.shards[0].numel() * 4
                + self.centroids.numel() * 4)

    # ---------------- append ----------------

    def _place(self, choices: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """The nearest centroid with free space in total (spilling to later
        choices under skew, as ``IVFBitsIndex._place``), then the
        least-filled shard of that list. Returns ``(list id [m], shard [m])``."""
        m, s_max = choices.shape
        l = self.nlist
        space = self.cap_l - self.fill.sum(axis=1)
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
            space -= np.bincount(sorted_c[ok], minlength=l)
        left = np.flatnonzero(place < 0)
        if left.size:
            if space.sum() < left.size:
                raise ValueError(
                    f"index full: {left.size} rows do not fit (capacity {self.n_cap}, stored {self.total_rows})")
            place[left] = np.repeat(np.arange(l), space)[: left.size]
        # each row of a list, in row order, to the list's least-filled shard
        # (the lowest such), as the JAX package's per-row loop does: its picks
        # are the pairs (fill value, shard) in ascending order
        shard = np.empty(m, np.int64)
        by_list = np.argsort(place, kind="stable")
        bounds = np.searchsorted(place[by_list], np.arange(l + 1))
        for lid in np.flatnonzero(np.diff(bounds)):
            rows = by_list[bounds[lid] : bounds[lid + 1]]
            f = self.fill[lid]
            reps = np.maximum(f.min() + rows.size - f, 0)
            value = np.repeat(f, reps) + np.arange(reps.sum()) - np.repeat(np.cumsum(reps) - reps, reps)
            owner = np.repeat(np.arange(self.n_shards), reps)
            pick = np.lexsort((owner, value))[: rows.size]
            if value[pick].max() >= self.cap_ls:
                raise ValueError(f"list {lid} full on every shard")
            shard[rows] = owner[pick]
        return place, shard

    def append(self, embeddings) -> np.ndarray:
        """Encode + scatter one chunk; returns the assigned global row ids.
        Each shard encodes its own rows on its device."""
        m, d = embeddings.shape
        if d != self.d:
            raise ValueError(f"dim {d} != index dim {self.d}")
        emb = torch.as_tensor(embeddings).to(self.mesh.out_device)
        choices = _assign_choices(emb, self.centroids, min(4, self.nlist)).cpu().numpy()
        place, shard = self._place(choices)
        # local slot = list·cap_ls + fill[list, shard] + arrival rank in the batch
        key = shard * self.nlist + place
        order = np.argsort(key, kind="stable")
        sorted_key = key[order]
        starts = np.searchsorted(sorted_key, np.arange(self.n_shards * self.nlist))
        rank = np.arange(m) - starts[sorted_key]
        pos = np.empty(m, np.int64)
        pos[order] = place[order] * self.cap_ls + self.fill[place[order], shard[order]] + rank
        gids = np.arange(self.total_rows, self.total_rows + m, dtype=np.int64)
        for s, dev in enumerate(self.mesh.flat_devices):
            mine = np.flatnonzero(shard == s)
            if mine.size == 0:
                continue
            as_t = lambda a, dt: torch.as_tensor(a[mine].astype(dt), device=dev)  # noqa: E731
            with on_device(dev):
                _encode_scatter(
                    self.codes.shards[s], self.scales.shards[s], self.gid.shards[s],
                    emb[torch.as_tensor(mine, device=emb.device)].to(dev), self._centroids_at[dev],
                    as_t(place, np.int64), as_t(pos, np.int64), as_t(gids, np.int32),
                )
        np.add.at(self.fill, (place, shard), 1)
        self.total_rows += m
        return gids

    # ---------------- search ----------------

    def search(self, queries, k: int, *, nprobe: int = 8, group_l: int = 8, tail: str = "fold"):
        """``(scores [Q, k] f32, global row ids [Q, k] i32, -1 empty)`` on the
        mesh's first device."""
        out = self.mesh.out_device
        q = queries.shape[0]
        if self.total_rows == 0:
            return torch.full((q, k), NEG_INF, device=out), torch.full((q, k), -1, dtype=torch.int32, device=out)
        nprobe = min(nprobe, self.nlist)
        qf = torch.as_tensor(queries).to(out, torch.float32)
        order, qs, probes, c_sel = tile_probes(qf, self.centroids, nprobe)
        probe_blocks = (probes * self.local_blocks).to(torch.int32)
        vals, rows = [], []
        for s, dev in enumerate(self.mesh.flat_devices):
            with on_device(dev):
                v, slots = ivf_bits_topk(
                    qs.to(dev), self.codes.shards[s], self.scales.shards[s], probe_blocks.to(dev), c_sel.to(dev), k,
                    blocks_per_list=self.local_blocks, block_n=self.block_n, group_l=group_l, tail=tail,
                )
                invalid = ~torch.isfinite(v)
                rows.append(torch.where(invalid, -1, self.gid.shards[s][slots.long()]))
                vals.append(torch.where(invalid, NEG_INF, v))
        top_vals, top_rows = merge_topk(vals, rows, k, out)
        inv = torch.argsort(order[:q])
        return top_vals[inv], top_rows[inv]

    # ---------------- persistence (the JAX package's files) ----------------

    def save(self, path) -> None:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        np.savez(
            path, centroids=self.centroids.cpu().numpy(), codes=self.codes.gather("cpu").numpy(),
            scales=self.scales.gather("cpu").numpy(), gid=self.gid.gather("cpu").numpy(), fill=self.fill,
        )
        Path(str(path) + ".meta.json").write_text(
            json.dumps({"capacity": self.n_cap, "block_n": self.block_n, "n_shards": self.n_shards,
                        "total_rows": self.total_rows}),
            encoding="utf-8",
        )

    @classmethod
    def load(cls, path, mesh: Mesh) -> "ShardedBitsIndex":
        path = Path(path)
        meta = json.loads(Path(str(path) + ".meta.json").read_text(encoding="utf-8"))
        if mesh.size != meta["n_shards"]:
            raise ValueError(f"checkpoint was sharded {meta['n_shards']}-way, mesh has {mesh.size} shards")
        with np.load(str(path) if str(path).endswith(".npz") else f"{path}.npz") as arrays:
            index = cls(torch.from_numpy(arrays["centroids"]), mesh, capacity=meta["capacity"],
                        block_n=meta["block_n"])
            for name in ("codes", "scales", "gid"):
                parts = np.split(arrays[name], mesh.size)
                setattr(index, name, ShardedTensor(
                    [torch.from_numpy(np.ascontiguousarray(p)).to(d) for p, d in zip(parts, mesh.flat_devices)],
                    mesh))
            index.fill = arrays["fill"].astype(np.int64)
        index.total_rows = int(meta["total_rows"])
        return index
