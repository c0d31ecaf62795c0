"""The collectives of the sharded modules, for one process that drives
every shard (no JAX counterpart: the JAX package calls ``lax.all_gather`` /
``lax.psum`` inside ``shard_map``, or lets GSPMD insert them).

Every sharded function of this package first launches all shards' work,
then calls one of these: the per-shard tensors move to one device by peer
copies (``Tensor.to(device, non_blocking=True)``, over NVLink between
cards), and the reduction runs there. In corpus sharding what crosses
shards is small: k candidates a query from each shard, or a Lloyd step's
``[K, D]`` sums. Model parallelism moves activations: :func:`broadcast`
and :func:`reduce` are the differentiable pair (Megatron's ``f`` and
``g``) that carry a replicated tensor to every shard and a row-parallel
product's partial sums back, forward and backward, summing in shard order.
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


class _Broadcast(torch.autograd.Function):
    """A copy of ``x`` on every device; backward: the copies' gradients
    summed in shard order on ``x``'s device."""

    @staticmethod
    def forward(ctx, x, *devices):
        ctx.device = x.device
        # an entry on x's own device is a view, not a copy (virtual meshes)
        return tuple(x.view_as(x) if y is x else y for y in (x.to(d, non_blocking=True) for d in devices))

    @staticmethod
    def backward(ctx, *grads):
        return (psum(list(grads), ctx.device), *(None,) * len(grads))


class _Reduce(torch.autograd.Function):
    """The sum of the per-shard tensors on ``device``, in shard order;
    backward: the gradient copied back to every shard's device."""

    @staticmethod
    def forward(ctx, device, *tensors):
        ctx.devices = [t.device for t in tensors]
        return psum(list(tensors), device)

    @staticmethod
    def backward(ctx, grad):
        return (None, *(grad.to(d, non_blocking=True) for d in ctx.devices))


def broadcast(x: torch.Tensor, devices) -> list[torch.Tensor]:
    """``x`` on each of ``devices`` (Megatron's ``f``: a replicated input of
    column-parallel shards, or a parameter carried to each data-parallel
    group). Its gradient is the sum of the copies' gradients, taken in
    shard order, so a repeated backward gives the same bits; without it,
    autograd would add them in whatever order the devices finish."""
    return list(_Broadcast.apply(x, *devices))


def reduce(tensors: list[torch.Tensor], device) -> torch.Tensor:
    """:func:`psum` with a gradient (Megatron's ``g``: the all-reduce after
    a row-parallel product): each input's gradient is the output's, copied
    to that input's device."""
    return _Reduce.apply(torch.device(device), *tensors)
