"""Two-level (dcn, ici) mesh: hierarchical merges and reductions (port of
``intool_rag_tpu/parallel/dcn.py``).

Shards in a group (``ici``, the fast links) merge their candidates to k
first, and only the groups' k survivors cross ``dcn`` (the slow axis);
k-means sums reduce the same way. Like the JAX package, this runs in one
process over the mesh's devices; a real cross-host ``dcn`` axis has no
counterpart here.

Row ids match :mod:`.sharded_corpus`: the linear shard index is
``dcn · n_ici + ici``, and a 1-D mesh and a 2-D one over the same device
order give the same ids.
"""

from __future__ import annotations

import torch

from ..ops.topk import flat_topk
from .collectives import two_level_merge, two_level_psum
from .mesh import Mesh, corpus_mesh, local_devices
from .sharded_corpus import ShardedCorpus
from .sharded_hybrid import ShardedHybrid
from .sharded_kmeans import sharded_kmeans
from .sharded_search import (
    kernel_group_l,
    shard_corpus,
    sharded_flat_topk,
    sharded_flat_topk_int8,
    sharded_search,
)


def dcn_mesh(devices=None, n_dcn: int = 2) -> Mesh:
    """(dcn, ici) mesh: ``n_dcn`` groups of ``len(devices) / n_dcn``."""
    devices = list(devices) if devices is not None else local_devices()
    n = len(devices)
    if n % n_dcn != 0:
        raise ValueError(f"{n} devices not divisible by n_dcn={n_dcn}")
    return Mesh([devices[g * (n // n_dcn) : (g + 1) * (n // n_dcn)] for g in range(n_dcn)], ("dcn", "ici"))


# a 2-D mesh's shards in the order dcn · n_ici + ici: the 1-D function serves
shard_corpus_dcn = shard_corpus


def _merge(mesh: Mesh):
    return lambda vals, rows, k: two_level_merge(vals, rows, k, mesh)


def hierarchical_flat_topk(queries, corpus, k: int, mesh: Mesh, *, valid_n: int | None = None,
                           block_n: int = 16384):
    """Exact global top-k with the two-stage merge (the blocked scan per
    shard). Returns ``(scores [Q, k], global rows)``, prefix layout."""
    shard_rows = corpus.shard_rows

    def local_topk(q, locals_, k_local, local_valid):
        return flat_topk(q, locals_[0], k_local, metric="ip", block_n=min(block_n, shard_rows),
                         valid_n=local_valid)

    valid_n = corpus.shape[0] if valid_n is None else valid_n
    return sharded_search(queries, (corpus,), k, mesh, local_topk, valid_n=valid_n, merge=_merge(mesh))


def hierarchical_kmeans(points, k: int, mesh: Mesh, *, valid_n: int | None = None, iters: int = 10,
                        seed: int = 0, init: torch.Tensor | None = None):
    """Lloyd over the two-level mesh: per-shard assignment, centroid sums
    reduced over ``ici`` then ``dcn``, so a step moves one ``[K, D]`` a
    group across ``dcn``. As :func:`.sharded_kmeans.sharded_kmeans`."""
    return sharded_kmeans(points, k, mesh, valid_n=valid_n, iters=iters, seed=seed, init=init,
                          reduce=lambda tensors, device: two_level_psum(tensors, mesh))


def hierarchical_corpus_topk(corpus: ShardedCorpus, queries, k: int, mesh: Mesh, *, group_l=None,
                             tail: str = "fold", kernel: str | None = None):
    """Dense top-k over a :class:`.sharded_corpus.ShardedCorpus`'s planes
    with the hierarchical merge: the per-shard kernels of the 1-D path (K2
    for quantized planes, K1 or the blocked scan for float ones), so the
    scores are the 1-D engine's."""
    n_shards = mesh.shape["dcn"] * mesh.shape["ici"]
    if n_shards != corpus.n_shards:
        raise ValueError(f"corpus sharded {corpus.n_shards}-way; mesh has {n_shards} shards")
    k = min(k, corpus.cap * n_shards)
    k_local = min(k, corpus.cap)
    merge = _merge(mesh)
    if corpus.quant != "none":
        if queries.shape[1] != corpus.dim_pad:
            queries = torch.nn.functional.pad(queries.float(), (0, corpus.dim_pad - queries.shape[1]))
        g = group_l if group_l is not None else kernel_group_l(corpus.cap, k_local)
        return sharded_flat_topk_int8(queries, corpus.codes, corpus.scales, k, mesh, res=corpus.res,
                                      valid_n=corpus.counts, group_l=g, tail=tail, merge=merge)
    if kernel is None:
        on_card = all(d.type == "cuda" for d in mesh.flat_devices)
        kernel = "fused" if on_card and kernel_group_l(corpus.cap, k_local) is not None else "scan"
    if kernel == "fused" and group_l is None:
        group_l = kernel_group_l(corpus.cap, k_local)
    return sharded_flat_topk(queries, corpus.data, k, mesh, valid_n=corpus.counts, block_n=min(16384, corpus.cap),
                             kernel=kernel, group_l=group_l, tail=tail, merge=merge)


def hierarchical_bm25_topk(bm25, queries: list[str], k: int, mesh: Mesh):
    """Sparse top-k over a :class:`.sharded_bm25.ShardedBM25`'s postings
    with the hierarchical merge (the same per-shard kernels and the same
    global quantization grid as the 1-D path)."""
    n_shards = mesh.shape["dcn"] * mesh.shape["ici"]
    return bm25.topk(queries, min(k, bm25._cap * n_shards), merge=_merge(mesh))


class DCNHybrid(ShardedHybrid):
    """Hybrid (dense + BM25 + fusion) corpus on a two-level mesh. Storage is
    the 1-D engine's over the flattened device order (the same placement
    and row ids); only the merges of a query change: both retrievers merge
    ``ici`` first, and fusion runs on the merged lists."""

    def __init__(self, dim: int, mesh: Mesh, **kwargs) -> None:
        super().__init__(dim, corpus_mesh(mesh.flat_devices), **kwargs)
        self.dcn = mesh

    def _dense(self, queries: torch.Tensor, kc: int, **kernel):
        return hierarchical_corpus_topk(self.corpus, queries, kc, self.dcn, **kernel)

    def _sparse(self, texts: list[str], kc: int):
        return hierarchical_bm25_topk(self.bm25, texts, kc, self.dcn)
