"""Distributed k-means (port of
``intool_rag_tpu/parallel/sharded_kmeans.py``): points row-sharded over
the mesh, each shard's Lloyd statistics (centroid sums and counts) summed
over the shards with :func:`.collectives.psum`. Used for the IVF coarse
quantizer when the corpus does not fit one device.
"""

from __future__ import annotations

import torch

from ..ops.kmeans import _kmeans_pp_init, lloyd_step_blockwise
from .collectives import psum
from .mesh import Mesh, ShardedTensor


def initial_centroids(points: ShardedTensor, k: int, valid_n: int, seed: int) -> torch.Tensor:
    """Maxmin seeding on the first ``max(4k, 4096)`` valid rows (gathered to
    the mesh's first device), from a first pick drawn on the host from
    ``seed``; the JAX package draws it with ``jax.random``."""
    sample_rows = min(valid_n, max(4 * k, 4096))
    sample = points.gather()[:sample_rows]
    first = int(torch.randint(0, sample_rows, (), generator=torch.Generator().manual_seed(seed)))
    return _kmeans_pp_init(sample, k, first)


def lloyd_step(points: ShardedTensor, centroids: torch.Tensor, valid: list[int], reduce):
    """One Lloyd iteration over the shards: each shard assigns and sums its
    valid rows on its own device (all shards launched first), then
    ``reduce(list of per-shard tensors, device)`` sums them on the
    centroids' device. Empty clusters keep their centroid; padding rows get
    assignment -1. Returns ``(centroids, per-shard assignments)``."""
    dev = centroids.device
    sums, counts, assigns = [], [], []
    for shard, n_valid in zip(points.shards, valid):
        a = torch.full((shard.shape[0],), -1, dtype=torch.int32, device=shard.device)
        if n_valid:
            a_valid, s, c = lloyd_step_blockwise(shard[:n_valid], centroids.to(shard.device))
            a[:n_valid] = a_valid
        else:
            s = torch.zeros_like(centroids, device=shard.device)
            c = torch.zeros(centroids.shape[0], device=shard.device)
        sums.append(s)
        counts.append(c)
        assigns.append(a)
    total, count = reduce(sums, dev), reduce(counts, dev)
    new = total / count[:, None].clamp_min(1.0)
    return torch.where((count < 0.5)[:, None], centroids, new), assigns


def sharded_kmeans(
    points: ShardedTensor,
    k: int,
    mesh: Mesh,
    *,
    valid_n: int | None = None,
    iters: int = 10,
    seed: int = 0,
    init: torch.Tensor | None = None,
    reduce=psum,
) -> tuple[torch.Tensor, ShardedTensor]:
    """Lloyd over a row-sharded point set whose valid rows are a prefix.
    Returns ``(centroids [K, D] f32 on the mesh's first device, assignments
    [N_pad] i32 sharded like the points; padding rows -1)``. ``init`` gives
    the initial centroids instead of the seeded maxmin pick; ``reduce``
    sums the shards' statistics (:func:`.dcn.hierarchical_kmeans` passes
    the two-level sum)."""
    shard_rows = points.shard_rows
    valid_n = points.shape[0] if valid_n is None else valid_n
    valid = [min(max(valid_n - s * shard_rows, 0), shard_rows) for s in range(len(points.shards))]
    centroids = (initial_centroids(points, k, valid_n, seed) if init is None else init).float()
    centroids = centroids.to(mesh.out_device)
    assigns = [torch.full((shard_rows,), -1, dtype=torch.int32, device=d) for d in mesh.flat_devices]
    for _ in range(iters):
        centroids, assigns = lloyd_step(points, centroids, valid, reduce)
    return centroids, ShardedTensor(assigns, mesh)
