"""Device k-means for the IVF coarse quantizer (port of
``intool_rag_tpu/ops/kmeans.py``).

Lloyd iterations on the points' device:
- assignment: blockwise over points, one matmul per block against the
  centroid matrix (argmax of ``2·x·c − |c|²``), never more than a block of
  the [N, K] scores;
- update: one-hot matmul accumulation of per-block sums and counts (a
  deterministic segment sum, unlike an atomic scatter-add);
- empty clusters reseed from the largest cluster's centroid with a small
  perturbation.

Plain ``torch.matmul`` throughout, as the JAX package leaves these
products to XLA. Randomness comes from an explicit CPU
``torch.Generator``, so a seed gives the same centroids on any device; the
stream differs from JAX's, so the two packages agree step by step
(assignment, update, seeding from a given first pick), not seed by seed.
"""

from __future__ import annotations

import torch


def _scores(block: torch.Tensor, centroids: torch.Tensor, c_norms: torch.Tensor) -> torch.Tensor:
    return 2.0 * (block.float() @ centroids.float().T) - c_norms[None, :]


def assign_blockwise(
    points: torch.Tensor, centroids: torch.Tensor, *, block_n: int = 65_536
) -> torch.Tensor:
    """Nearest-centroid assignment [N] i32 (squared L2)."""
    n = points.shape[0]
    block_n = min(block_n, n)
    c_norms = (centroids.float() ** 2).sum(dim=1)
    out = torch.empty(n, dtype=torch.int32, device=points.device)
    for start in range(0, n, block_n):
        block = points[start : start + block_n]
        out[start : start + block.shape[0]] = _scores(block, centroids, c_norms).argmax(dim=1)
    return out


def _one_hot(assignments: torch.Tensor, k: int) -> torch.Tensor:
    return torch.nn.functional.one_hot(assignments.long(), k).float()


def update_centroids(
    points: torch.Tensor, assignments: torch.Tensor, k: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """(sums [K, D] f32, counts [K] f32) through a one-hot matmul."""
    one_hot = _one_hot(assignments, k)
    return one_hot.T @ points.float(), one_hot.sum(dim=0)


def lloyd_step_blockwise(
    points: torch.Tensor, centroids: torch.Tensor, *, block_n: int = 16_384
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One Lloyd iteration: blockwise assignment + accumulation, reading
    the points once and holding at most a [block_n, K] one-hot.
    Returns (assignments [N] i32, sums [K, D] f32, counts [K] f32)."""
    n, d = points.shape
    k = centroids.shape[0]
    block_n = min(block_n, n)
    c_norms = (centroids.float() ** 2).sum(dim=1)
    sums = torch.zeros((k, d), dtype=torch.float32, device=points.device)
    counts = torch.zeros(k, dtype=torch.float32, device=points.device)
    assigns = torch.empty(n, dtype=torch.int32, device=points.device)
    for start in range(0, n, block_n):
        block = points[start : start + block_n]
        a = _scores(block, centroids, c_norms).argmax(dim=1)
        one_hot = _one_hot(a, k)
        sums += one_hot.T @ block.float()
        counts += one_hot.sum(dim=0)
        assigns[start : start + block.shape[0]] = a
    return assigns, sums, counts


def _kmeans_pp_init(sample: torch.Tensor, k: int, first: int) -> torch.Tensor:
    """Farthest-point (maxmin) seeding: each next seed is the sample point
    farthest from the chosen set. Deterministic given the ``first`` pick;
    covers separated clusters, and Lloyd smooths any outlier seed."""
    sample_f = sample.float()
    centroids = torch.zeros((k, sample_f.shape[1]), dtype=torch.float32, device=sample.device)
    centroids[0] = sample_f[first]
    min_d = ((sample_f - sample_f[first]) ** 2).sum(dim=1)
    for i in range(1, k):
        c = sample_f[min_d.argmax()]
        centroids[i] = c
        min_d = torch.minimum(min_d, ((sample_f - c) ** 2).sum(dim=1))
    return centroids


def kmeans(
    points: torch.Tensor,
    k: int,
    *,
    iters: int = 10,
    seed: int = 0,
    generator: torch.Generator | None = None,
    block_n: int = 65_536,
    init_sample: int = 16_384,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Lloyd k-means with maxmin seeding on a subsample.
    Returns (centroids [K, D] f32, assignments [N] i32). ``generator`` (a
    CPU generator) overrides ``seed``."""
    n, d = points.shape
    if k > n:
        raise ValueError(f"k={k} > n={n}")
    gen = generator if generator is not None else torch.Generator().manual_seed(seed)
    dev = points.device
    s = min(n, max(init_sample, 4 * k))
    sample_idx = torch.randperm(n, generator=gen)[:s].to(dev)
    first = int(torch.randint(0, s, (), generator=gen))
    centroids = _kmeans_pp_init(points[sample_idx], k, first)

    for _ in range(iters):
        _, sums, counts = lloyd_step_blockwise(points, centroids, block_n=min(block_n, 16_384))
        new_centroids = sums / counts[:, None].clamp_min(1.0)
        empty = counts < 0.5
        jitter = torch.randn((k, d), generator=gen).to(dev) * 1e-3
        reseed = new_centroids[counts.argmax()][None, :] + jitter
        centroids = torch.where(empty[:, None], reseed, new_centroids)

    return centroids, assign_blockwise(points, centroids, block_n=block_n)
