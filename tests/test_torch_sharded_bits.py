"""The port's ``ShardedBitsIndex`` (the binary-residual tier over the mesh)
against the JAX package's on the CPU: twins of ``test_sharded_bits.py``
(4 shards, block_n 64, the JAX scan in interpret mode, K3's plain version
in the port), and the index files between the two packages.

Tolerances: placement (global ids, per-list and per-shard fill), codes
and the gid tables equal; scales 1e-6 relative (``mean |r|`` sums in
another order); scores 1e-4 (the port's plain scan sums each plane exactly
and rounds once, the JAX scan sums in f32), rows equal or equal as sets
within ties of that width. Against the port's single-device index built
from the same centroids, scores are bit-equal (a row encodes and scores
the same wherever it lies).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_sharded_bits import D, L, _clustered, _queries
from test_torch_parallel import assert_topk_equal, jax_mesh, port_mesh

from intool_rag_tpu.index.bits_index import IVFBitsIndex as JaxBits
from intool_rag_tpu.parallel.sharded_bits import ShardedBitsIndex as JaxSharded
from intool_rag_tpu_torch.index.bits_index import IVFBitsIndex
from intool_rag_tpu_torch.parallel.sharded_bits import ShardedBitsIndex

pytestmark = pytest.mark.multichip

N_DEV = 4
EXACT = dict(nprobe=8, group_l=1, tail="exact")


def _same_store(t: ShardedBitsIndex, j: JaxSharded) -> None:
    np.testing.assert_array_equal(t.fill, j.fill)
    np.testing.assert_array_equal(t.codes.gather().numpy(), np.asarray(j.codes))
    np.testing.assert_array_equal(t.gid.gather().numpy(), np.asarray(j.gid))
    np.testing.assert_allclose(t.scales.gather().numpy(), np.asarray(j.scales), rtol=1e-6)


def _build(rng, n):
    """JAX k-means centroids, then the JAX sharded, the port sharded and the
    port single-device index over the same rows, appended in chunks of 1,024."""
    x = _clustered(rng, n, D, L)
    centroids = JaxBits.train(jnp.asarray(x[: n // 2]), L, capacity=2 * n, block_n=64, refine=False).centroids
    j = JaxSharded(centroids, jax_mesh(N_DEV), capacity=2 * n, block_n=64)
    c = torch.from_numpy(np.array(centroids))
    t = ShardedBitsIndex(c, port_mesh(N_DEV), capacity=2 * n, block_n=64)
    single = IVFBitsIndex(c, capacity=2 * n, block_n=64, refine=False, device="cpu")
    for i in range(0, n, 1024):
        chunk = x[i : i + 1024]
        g = t.append(torch.from_numpy(chunk))
        np.testing.assert_array_equal(g, j.append(jnp.asarray(chunk)))
        np.testing.assert_array_equal(g, single.append(torch.from_numpy(chunk)))
    return x, t, j, single


@pytest.fixture(scope="module")
def built():
    return _build(np.random.default_rng(0), 4096)


def test_sharded_bits_matches_jax_and_single_device(built):
    """``test_sharded_bits_matches_single_chip``: the same placement and
    store as the JAX sharded index, the same results as it, and the port's
    single-device index's results (per-list populations equal)."""
    x, t, j, single = built
    assert t.total_rows == 4096
    _same_store(t, j)
    np.testing.assert_array_equal(single.fill, t.fill.sum(axis=1))
    queries = _queries(np.random.default_rng(1), x)
    tv, tr = t.search(torch.from_numpy(queries), 10, **EXACT)
    jv, jr = j.search(jnp.asarray(queries), 10, interpret=True, **EXACT)
    assert_topk_equal(tv.numpy(), tr.numpy(), np.asarray(jv), np.asarray(jr), atol=1e-4)
    sv, sr = single.search(torch.from_numpy(queries), 10, **EXACT)
    assert_topk_equal(tv.numpy(), tr.numpy(), sv.numpy(), sr.numpy(), atol=0.0)


def test_sharded_bits_recall_vs_oracle(built):
    """``test_sharded_bits_recall_vs_oracle``: the pool of 100 at nprobe 8
    holds ≥ 0.9 of the exact top-10."""
    x, t, _, _ = built
    queries = _queries(np.random.default_rng(2), x)
    oracle = np.argsort(-(queries @ x.T), axis=1)[:, :10]
    _, rows = t.search(torch.from_numpy(queries), 100, **EXACT)
    hits = sum(len(set(a.tolist()) & set(b.tolist())) for a, b in zip(rows.numpy(), oracle))
    assert hits / oracle.size >= 0.9


def test_sharded_bits_spill_and_balance(rng):
    """``test_sharded_bits_spill_and_balance``: 300 rows near one of 4
    centres fill its list (4 × 64) evenly over the shards and spill the rest
    to later choices, as in the JAX index; every row is found."""
    centers = rng.standard_normal((4, D)).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    t = ShardedBitsIndex(torch.from_numpy(centers), port_mesh(N_DEV), capacity=4 * 4 * 64, block_n=64)
    j = JaxSharded(jnp.asarray(centers), jax_mesh(N_DEV), capacity=4 * 4 * 64, block_n=64)
    rows = centers[0] + 0.01 * rng.standard_normal((300, D)).astype(np.float32)
    rows /= np.linalg.norm(rows, axis=1, keepdims=True)
    np.testing.assert_array_equal(t.append(torch.from_numpy(rows)), j.append(jnp.asarray(rows)))
    _same_store(t, j)
    assert t.fill[0].tolist() == [64, 64, 64, 64] and t.fill.sum() == 300
    _, got = t.search(torch.from_numpy(rows[:8]), 10, nprobe=4, group_l=1, tail="exact")
    assert (got >= 0).all()
    with pytest.raises(ValueError, match="full"):
        t.append(torch.from_numpy(np.tile(rows, (4, 1))))


def test_shard_choice_is_the_per_row_rule(rng):
    """Each list's rows go, in row order, to its least-filled shard (the
    lowest such), as the JAX package's per-row loop: from uneven fills."""
    t = ShardedBitsIndex(torch.eye(8, 16), port_mesh(N_DEV), capacity=8 * 4 * 64, block_n=64)
    t.fill = rng.integers(0, 20, (8, N_DEV))
    choices = rng.integers(0, 8, (200, 4)).astype(np.int32)
    place, shard = t._place(choices)
    fill = t.fill.copy()
    for r in range(200):
        s = int(np.argmin(fill[place[r]]))
        assert shard[r] == s
        fill[place[r], s] += 1


@pytest.mark.parametrize("direction", ["port_to_port", "jax_to_port", "port_to_jax"])
def test_sharded_bits_save_load(built, tmp_path, direction):
    """``test_sharded_bits_save_load_roundtrip`` and the files across the
    packages: the loaded index searches as the saved one; a mesh of another
    size is refused."""
    x, t, j, _ = built
    path = tmp_path / "bits_sharded.npz"
    queries = _queries(np.random.default_rng(3), x, q=16)
    (j if direction == "jax_to_port" else t).save(path)
    if direction == "port_to_jax":
        loaded = JaxSharded.load(path, jax_mesh(N_DEV))
        _same_store(t, loaded)
        lv, lr = loaded.search(jnp.asarray(queries), 10, interpret=True, **EXACT)
    else:
        loaded = ShardedBitsIndex.load(path, port_mesh(N_DEV))
        _same_store(loaded, j)
        lv, lr = loaded.search(torch.from_numpy(queries), 10, **EXACT)
        with pytest.raises(ValueError, match="sharded"):
            ShardedBitsIndex.load(path, port_mesh(2))
    assert loaded.total_rows == t.total_rows
    if direction == "jax_to_port":  # the saved index's own results
        wv, wr = (np.asarray(a) for a in j.search(jnp.asarray(queries), 10, interpret=True, **EXACT))
    else:
        wv, wr = (a.numpy() for a in t.search(torch.from_numpy(queries), 10, **EXACT))
    assert_topk_equal(np.asarray(lv), np.asarray(lr), wv, wr, atol=0.0 if direction == "port_to_port" else 1e-4)
