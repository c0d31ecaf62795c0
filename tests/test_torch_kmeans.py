"""ops/kmeans.py of the PyTorch port against the JAX package: the
deterministic steps on the same seeded numpy points and centroids
(the two PRNG streams differ, so whole runs are compared by what they
recover, not number by number).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from intool_rag_tpu.ops import kmeans as jk
from intool_rag_tpu_torch.ops import kmeans as tk

torch.set_num_threads(2)


def _points(seed=0, n=3000, d=32, k=12):
    rng = np.random.default_rng(seed)
    centers = 3.0 * rng.standard_normal((k, d)).astype(np.float32)
    x = centers[rng.integers(0, k, n)] + 0.3 * rng.standard_normal((n, d)).astype(np.float32)
    cents = x[rng.choice(n, size=k, replace=False)].copy()
    return x, cents


@pytest.mark.parametrize("block_n", [512, 65_536])
def test_assign_blockwise_matches_jax(block_n):
    x, cents = _points()
    want = np.asarray(jk.assign_blockwise(jnp.asarray(x), jnp.asarray(cents), block_n=block_n))
    got = tk.assign_blockwise(torch.from_numpy(x), torch.from_numpy(cents), block_n=block_n)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)  # assignments equal


def test_update_centroids_matches_jax():
    x, cents = _points(1)
    assign = np.array(jk.assign_blockwise(jnp.asarray(x), jnp.asarray(cents)))
    js, jc = jk.update_centroids(jnp.asarray(x), jnp.asarray(assign), cents.shape[0])
    ts, tc = tk.update_centroids(torch.from_numpy(x), torch.from_numpy(assign), cents.shape[0])
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5, atol=1e-4)  # f32 sum order


@pytest.mark.parametrize("block_n", [700, 16_384])
def test_lloyd_step_blockwise_matches_jax(block_n):
    x, cents = _points(2)
    ja, js, jc = jk.lloyd_step_blockwise(jnp.asarray(x), jnp.asarray(cents), block_n=block_n)
    ta, ts, tc = tk.lloyd_step_blockwise(torch.from_numpy(x), torch.from_numpy(cents), block_n=block_n)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5, atol=1e-4)


def test_kmeans_pp_init_same_first_pick():
    x, _ = _points(3, n=800)
    rng = jax.random.PRNGKey(5)
    first = int(jax.random.randint(rng, (), 0, x.shape[0]))  # the pick the JAX function makes
    want = np.asarray(jk._kmeans_pp_init(jnp.asarray(x), 12, rng))
    got = tk._kmeans_pp_init(torch.from_numpy(x), 12, first)
    np.testing.assert_array_equal(got.numpy(), want)  # seeds are sample rows: exact


def test_kmeans_recovers_separated_clusters():
    rng = np.random.default_rng(4)
    k, d, per = 16, 24, 150
    centers = 5.0 * rng.standard_normal((k, d)).astype(np.float32)
    labels = np.repeat(np.arange(k), per)
    x = centers[labels] + 0.2 * rng.standard_normal((k * per, d)).astype(np.float32)
    pts = torch.from_numpy(x)
    cents, assign = tk.kmeans(pts, k, iters=6, generator=torch.Generator().manual_seed(0))
    assert cents.dtype == torch.float32 and assign.dtype == torch.int32
    counts = np.bincount(assign.numpy(), minlength=k)
    assert (counts > 0).all()  # no empty cluster
    # each found cluster is one true cluster
    for c in range(k):
        assert len(set(labels[assign.numpy() == c])) == 1
    dist = np.linalg.norm(cents.numpy()[:, None] - centers[None], axis=2).min(axis=1)
    assert dist.max() < 0.2
    # repeatable from the seed, by either way of passing it
    cents2, assign2 = tk.kmeans(pts, k, iters=6, seed=0)
    assert torch.equal(cents, cents2) and torch.equal(assign, assign2)
    with pytest.raises(ValueError, match="k=5000"):
        tk.kmeans(pts, 5000)


def test_kmeans_reseeds_empty_clusters():
    """Two identical far-away seeds leave one cluster empty after the first
    step; the reseed must fill it."""
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.standard_normal((400, 8)).astype(np.float32))
    cents, assign = tk.kmeans(x, 8, iters=8, seed=1)
    assert torch.isfinite(cents).all()
    assert len(torch.unique(assign)) == 8
