"""The collectives of corpus sharding, for one process that drives every
shard (no JAX counterpart: the JAX package calls ``lax.all_gather`` /
``lax.psum`` inside ``shard_map``).

Every sharded function of this package first launches all shards' work,
then calls one of these: the per-shard tensors move to one device by peer
copies (``Tensor.to(device, non_blocking=True)``, over NVLink between
cards), and the reduction runs there. What crosses shards is small: k
candidates a query from each shard, or a Lloyd step's ``[K, D]`` sums.
"""

from __future__ import annotations

import torch

from ..ops.topk import top_k


def all_gather(tensors: list[torch.Tensor], device, dim: int = 1) -> torch.Tensor:
    """The per-shard tensors on ``device``, concatenated along ``dim`` in
    shard order (``lax.all_gather(..., tiled=True)``)."""
    return torch.cat([t.to(device, non_blocking=True) for t in tensors], dim=dim)


def psum(tensors: list[torch.Tensor], device) -> torch.Tensor:
    """The sum of the per-shard tensors on ``device``, added in shard order,
    so a repeat gives the same bits."""
    total = tensors[0].to(device, non_blocking=True).clone()
    for t in tensors[1:]:
        total += t.to(device, non_blocking=True)
    return total


def merge_topk(vals: list[torch.Tensor], rows: list[torch.Tensor], k: int, device):
    """Global top-k of per-shard candidate lists ``[Q, k_s]`` (values and
    global row ids): gathered in shard order, then a stable top-k, so equal
    values keep the lower position first, as ``lax.top_k`` does."""
    all_vals = all_gather(vals, device)
    all_rows = all_gather(rows, device)
    top_vals, pos = top_k(all_vals, min(k, all_vals.shape[1]))
    return top_vals, torch.gather(all_rows, 1, pos)


def two_level_merge(vals: list[torch.Tensor], rows: list[torch.Tensor], k: int, mesh):
    """Hierarchical merge over a ``(dcn, ici)`` mesh: the candidates of each
    ``ici`` group merge to k on the group's first device, then the groups'
    survivors merge across ``dcn`` on the mesh's first device, so only k a
    group cross the slow axis."""
    n_dcn, n_ici = mesh.shape["dcn"], mesh.shape["ici"]
    group_vals, group_rows = [], []
    for g in range(n_dcn):
        members = slice(g * n_ici, (g + 1) * n_ici)
        v, r = merge_topk(vals[members], rows[members], k, mesh.devices[g, 0])
        group_vals.append(v)
        group_rows.append(r)
    return merge_topk(group_vals, group_rows, k, mesh.out_device)


def two_level_psum(tensors: list[torch.Tensor], mesh) -> torch.Tensor:
    """Sum over a ``(dcn, ici)`` mesh: within each ``ici`` group on its first
    device, then the groups' sums across ``dcn`` on the mesh's first device
    (only one ``[K, D]`` a group crosses the slow axis)."""
    n_ici = mesh.shape["ici"]
    groups = [psum(tensors[g * n_ici : (g + 1) * n_ici], mesh.devices[g, 0]) for g in range(mesh.shape["dcn"])]
    return psum(groups, mesh.out_device)
