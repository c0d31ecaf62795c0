"""Distributed flat search (port of
``intool_rag_tpu/parallel/sharded_search.py``): the corpus row-sharded
over the mesh, a local top-k per shard, one merge of the k·S candidates to
the global top-k.

Per shard, selection runs the same fused kernels as the single-device path
(``ops/flat_fused.py``): K1 over a bf16 / f16 / f32 shard (bf16 with the
split-query pass), K2 over int8 codes (+ the residual plane). The blocked
scan of :func:`..ops.topk.flat_topk` (``kernel="scan"``, the JAX package's
``kernel="xla"``) serves where no group width fits the shard. Every
shard's search is launched before the merge gathers any of them.

Two id layouts: with ``valid_n`` an int, the valid rows are a prefix of
the concatenated shards and a row's id is ``shard·shard_rows + slot``;
with per-shard counts (:class:`.sharded_corpus.ShardedCorpus`), it is
``slot·S + shard``, which does not depend on the shards' capacity.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.flat_fused import choose_group_width, flat_topk_fused, flat_topk_fused_int8
from ..ops.topk import NEG_INF, flat_topk
from .collectives import merge_topk
from .mesh import Mesh, ShardedTensor, on_device


def shard_corpus(corpus: torch.Tensor, mesh: Mesh, *, row_align: int = 1) -> ShardedTensor:
    """Row-shard ``[N, ...]`` over every mesh entry, zero-padded so each
    shard's rows are a multiple of ``row_align`` (the fused kernels need
    shard_rows % (128·group_l) == 0). A shard whose device is the corpus's
    own is a view of it."""
    n_shards = mesh.size
    n = corpus.shape[0]
    pad = -n % (n_shards * max(row_align, 1))
    if pad:
        corpus = torch.cat([corpus, corpus.new_zeros((pad, *corpus.shape[1:]))])
    rows = corpus.shape[0] // n_shards
    return ShardedTensor(
        [corpus[s * rows : (s + 1) * rows].to(dev) for s, dev in enumerate(mesh.flat_devices)], mesh
    )


def kernel_group_l(shard_rows: int, k: int, *, cap: int = 32) -> int | None:
    """Largest group width the fused kernels can use on a shard of
    ``shard_rows`` (recall-targeted by :func:`choose_group_width`, then
    halved until the 128·L block divides the shard); ``None`` when none
    does (JAX ``pallas_group_l``)."""
    g = min(cap, choose_group_width(shard_rows, k))
    while g > 1 and shard_rows % (128 * g) != 0:
        g //= 2
    if shard_rows % (128 * g) != 0:
        return None
    return g


def _local_valid(valid_n, shard: int, shard_rows: int) -> int:
    if _is_prefix(valid_n):
        return int(min(max(valid_n - shard * shard_rows, 0), shard_rows))
    return int(valid_n[shard])


def _is_prefix(valid_n) -> bool:
    return isinstance(valid_n, (int, np.integer))


def _empty(q: int, k: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    return (torch.full((q, k), NEG_INF, device=device),
            torch.full((q, k), -1, dtype=torch.int32, device=device))


def to_global(vals, rows, *, per_shard: bool, shard: int, shard_rows: int, n_shards: int):
    """Shard-local slots to global row ids; ``-inf`` slots (masked rows,
    an empty shard) carry no row and get id -1."""
    invalid = ~torch.isfinite(vals)
    gids = rows * n_shards + shard if per_shard else rows + shard * shard_rows
    return torch.where(invalid, NEG_INF, vals), torch.where(invalid, -1, gids.to(torch.int32))


def sharded_search(queries, planes: tuple, k: int, mesh: Mesh, local_topk, *, valid_n=None, merge=None):
    """The shared shape of every sharded flat search: per shard,
    ``local_topk(q, locals_, k_local, local_valid)`` gives shard-local
    ``(vals, slots)``; they become global ids and merge (``merge(vals,
    rows, k)``, default :func:`.collectives.merge_topk` on the mesh's first
    device). Shards with no valid row are not searched. ``valid_n``: an
    int (prefix layout), per-shard counts, or None (every row)."""
    n_shards = len(planes[0].shards)
    if n_shards != mesh.size:
        raise ValueError(f"corpus sharded {n_shards}-way; the mesh has {mesh.size} entries")
    shard_rows = planes[0].shard_rows
    if valid_n is None:
        valid_n = shard_rows * n_shards
    per_shard = not _is_prefix(valid_n)
    k = min(k, shard_rows * n_shards) if per_shard else min(k, int(valid_n))
    k_local = min(k, shard_rows)
    vals, rows = [], []
    for s, dev in enumerate(mesh.flat_devices):
        local_valid = _local_valid(valid_n, s, shard_rows)
        with on_device(dev):
            q = queries.to(dev)
            if local_valid == 0:
                v, r = _empty(q.shape[0], k_local, dev)
            else:
                v, r = local_topk(q, tuple(p.shards[s] if p is not None else None for p in planes), k_local,
                                  local_valid)
            v, r = to_global(v, r, per_shard=per_shard, shard=s, shard_rows=shard_rows, n_shards=n_shards)
        vals.append(v)
        rows.append(r)
    if merge is None:
        return merge_topk(vals, rows, k, mesh.out_device)
    return merge(vals, rows, k)


def sharded_flat_topk(
    queries: torch.Tensor,
    corpus: ShardedTensor,
    k: int,
    mesh: Mesh,
    *,
    valid_n=None,
    block_n: int = 16384,
    kernel: str = "scan",
    group_l: int | None = None,
    tail: str = "fold",
    merge=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Global top-k over a row-sharded float corpus: ``(scores [Q, k] f32,
    global row ids [Q, k] i32)`` on the mesh's first device.
    ``kernel="fused"`` runs K1 per shard (a bf16 shard with the split-query
    pass, so its scores are the single-device kernel's); it needs
    shard_rows % (128·group_l) == 0, and falls back to ``"scan"`` only
    where :func:`kernel_group_l` finds no width, as the JAX package does."""
    shard_rows = corpus.shard_rows
    if kernel not in ("fused", "scan"):
        raise ValueError(f"kernel must be 'fused' or 'scan', got {kernel!r}")
    if kernel == "fused" and group_l is None:
        group_l = kernel_group_l(shard_rows, k)
        if group_l is None:
            kernel = "scan"

    if kernel == "fused":
        def local_topk(q, locals_, k_local, local_valid):
            (local,) = locals_
            return flat_topk_fused(q, local, k_local, group_l=group_l, valid_n=local_valid,
                                   precise=local.dtype == torch.bfloat16, tail=tail)
    else:
        def local_topk(q, locals_, k_local, local_valid):
            return flat_topk(q, locals_[0], k_local, metric="ip", block_n=min(block_n, shard_rows),
                             valid_n=local_valid)

    return sharded_search(queries, (corpus,), k, mesh, local_topk, valid_n=valid_n, merge=merge)


def sharded_flat_topk_int8(
    queries: torch.Tensor,
    codes: ShardedTensor,
    scales: ShardedTensor,
    k: int,
    mesh: Mesh,
    *,
    res: ShardedTensor | None = None,
    valid_n=None,
    group_l: int | None = None,
    tail: str = "fold",
    merge=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Global top-k over row-sharded int8 codes (+ the residual plane
    ``res``): K2 per shard, then the same merge. Quantization is per row,
    so a shard's scores are the single-device kernel's on those rows."""
    shard_rows = codes.shard_rows
    if group_l is None:
        group_l = kernel_group_l(shard_rows, k)
        if group_l is None:
            raise ValueError(
                f"shard_rows={shard_rows} not alignable to a 128·L kernel block; "
                "pad with shard_corpus(row_align=...)"
            )

    def local_topk(q, locals_, k_local, local_valid):
        c, s, r = locals_
        return flat_topk_fused_int8(q, c, s, k_local, corpus_res=r, group_l=group_l,
                                    valid_n=local_valid, tail=tail)

    return sharded_search(queries, (codes, scales, res), k, mesh, local_topk, valid_n=valid_n, merge=merge)
