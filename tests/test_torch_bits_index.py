"""index/bits_index.py of the PyTorch port against the JAX package. Both
indexes are built from the SAME centroids (the k-means seeds cannot be
shared), take the same appends and answer the same queries. The JAX scan
runs in interpret mode; the port runs with device="cpu" (plain scan).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from intool_rag_tpu.index import bits_index as jbi
from intool_rag_tpu_torch.index import bits_index as tbi

torch.set_num_threads(2)


def _clustered(rng, n, d, l, noise=0.05):
    """Clusters with per-row radius spread, as tests/test_bits_index.py."""
    centers = rng.standard_normal((l, d)).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    radius = noise * np.exp(rng.uniform(np.log(0.2), np.log(2.0), (n, 1))).astype(np.float32)
    x = centers[rng.integers(0, l, n)] + radius * rng.standard_normal((n, d)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    return x.astype(np.float32), centers


def _pair(centroids, **kw):
    j = jbi.IVFBitsIndex(jnp.asarray(centroids), **kw)
    t = tbi.IVFBitsIndex(torch.from_numpy(centroids), device="cpu", **kw)
    return j, t


def _queries(rng, x, q):
    qs = x[rng.integers(0, len(x), q)] + 0.01 * rng.standard_normal((q, x.shape[1])).astype(np.float32)
    return (qs / np.linalg.norm(qs, axis=1, keepdims=True)).astype(np.float32)


@pytest.fixture(scope="module")
def built():
    rng = np.random.default_rng(0)
    n, d, l = 2048, 128, 8
    x, centers = _clustered(rng, n, d, l)
    j, t = _pair(centers, capacity=2 * n, block_n=64, refine=True)
    for i in range(0, n, 512):
        jg = j.append(jnp.asarray(x[i : i + 512]))
        tg = t.append(torch.from_numpy(x[i : i + 512]))
        np.testing.assert_array_equal(tg, jg)
    return x, j, t, _queries(rng, x, 21)


@pytest.mark.parametrize("q,nprobe", [(8, 4), (21, 3), (5, 8)])
def test_tile_probes_match_jax(q, nprobe):
    rng = np.random.default_rng(q)
    _, centers = _clustered(rng, 8, 64, 8)
    queries = rng.standard_normal((q, 64)).astype(np.float32)
    queries[1] = queries[0]  # equal top-1 lists inside a tile: ties in the boosted scores
    want = jbi.tile_probes(jnp.asarray(queries), jnp.asarray(centers), nprobe)
    got = tbi.tile_probes(torch.from_numpy(queries), torch.from_numpy(centers), nprobe)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))  # order
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))  # sorted queries
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))  # probes, in order
    np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]), rtol=1e-6, atol=1e-6)


def test_store_arrays_equal_after_same_appends(built):
    _, j, t, _ = built
    assert (t.cap_l, t.n_cap, t.blocks_per_list, t.total_rows) == (
        j.cap_l, j.n_cap, j.blocks_per_list, j.total_rows)
    np.testing.assert_array_equal(t.codes.numpy(), np.asarray(j.codes))
    np.testing.assert_array_equal(t.gid.numpy(), np.asarray(j.gid))
    np.testing.assert_array_equal(t.fill, j.fill)
    np.testing.assert_allclose(t.scales.numpy(), np.asarray(j.scales), rtol=1e-6)
    assert t.bytes_resident == j.bytes_resident and t.bytes_host == j.bytes_host
    for a, b in zip(t.host_int8, j.host_int8):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(t.host_scale8, j.host_scale8):
        # the JAX side quantizes under jit, where x/127 compiles to x·(1/127): 1 ulp
        np.testing.assert_allclose(a, b, rtol=2e-7)


@pytest.mark.parametrize("refine_k", [None, 40])
@pytest.mark.parametrize("group_l,tail", [(1, "fold"), (8, "fold"), (8, "blocked")])
def test_search_matches_jax(built, group_l, tail, refine_k):
    """Rows equal and scores within 1e-4, with and without the refine tier."""
    _, j, t, queries = built
    jv, jr = j.search(jnp.asarray(queries), 10, nprobe=4, refine_k=refine_k, group_l=group_l,
                      tail=tail, interpret=True)
    tv, tr = t.search(torch.from_numpy(queries), 10, nprobe=4, refine_k=refine_k,
                      group_l=group_l, tail=tail)
    jv, jr = np.asarray(jv), np.asarray(jr)
    assert tr.dtype == torch.int32 and tuple(tr.shape) == jr.shape
    np.testing.assert_allclose(tv.numpy(), jv, atol=1e-4)
    # ranks may swap only between scores closer than the tolerance
    differ = tr.numpy() != jr
    if differ.any():
        gaps = np.abs(np.diff(jv, axis=1))
        near = np.zeros_like(differ)
        near[:, 1:] |= gaps < 1e-5
        near[:, :-1] |= gaps < 1e-5
        assert near[differ].all()
    assert differ.mean() < 0.01
    assert (jr[:, 0] >= 0).all()


def test_empty_index_search():
    _, t = _pair(np.eye(4, 64, dtype=np.float32), capacity=64, block_n=8, refine=False)
    vals, rows = t.search(torch.zeros(3, 64), 5)
    assert tuple(vals.shape) == (3, 5) and torch.isinf(vals).all() and (rows == -1).all()


def test_spill_and_index_full():
    """Skewed appends spill to next-nearest lists without dropping rows;
    exceeding capacity raises (tests/test_bits_index.py's case, both sides)."""
    rng = np.random.default_rng(1)
    d, l = 64, 4
    centroids = np.eye(l, d).astype(np.float32)
    j, t = _pair(centroids, capacity=64, block_n=8, refine=False)
    assert t.cap_l == j.cap_l == 16
    x = np.tile(centroids[0], (40, 1)) + 0.01 * rng.standard_normal((40, d)).astype(np.float32)
    j.append(jnp.asarray(x))
    t.append(torch.from_numpy(x))
    assert t.total_rows == 40 and t.fill[0] == 16 and t.fill.sum() == 40
    np.testing.assert_array_equal(t.fill, j.fill)
    np.testing.assert_array_equal(t.gid.numpy(), np.asarray(j.gid))
    _, rows = t.search(torch.from_numpy(x[:8]), 1, nprobe=l)
    _, jrows = j.search(jnp.asarray(x[:8]), 1, nprobe=l, interpret=True)
    assert (rows[:, 0] >= 0).all()
    np.testing.assert_array_equal(rows.numpy(), np.asarray(jrows))
    with pytest.raises(ValueError, match="full"):
        t.append(torch.from_numpy(rng.standard_normal((40, d)).astype(np.float32)))
    with pytest.raises(ValueError, match="dim"):
        t.append(torch.zeros(2, 32))
    with pytest.raises(ValueError, match="divisible"):
        tbi.IVFBitsIndex(torch.zeros(2, 12), capacity=8, device="cpu")


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_save_load_across_packages(built, tmp_path, direction):
    _, j, t, queries = built
    path = tmp_path / "bits.npz"
    want_v, want_r = t.search(torch.from_numpy(queries), 5, nprobe=4, refine_k=20)
    if direction == "jax_to_port":
        j.save(path)
        loaded = tbi.IVFBitsIndex.load(path, device="cpu")
        assert loaded.total_rows == j.total_rows and loaded.refine
        got_v, got_r = loaded.search(torch.from_numpy(queries), 5, nprobe=4, refine_k=20)
        got_v, got_r = got_v.numpy(), got_r.numpy()
    else:
        t.save(path)
        loaded = jbi.IVFBitsIndex.load(path)
        assert loaded.total_rows == t.total_rows
        got_v, got_r = loaded.search(jnp.asarray(queries), 5, nprobe=4, refine_k=20, interpret=True)
        got_v, got_r = np.asarray(got_v), np.asarray(got_r)
    np.testing.assert_array_equal(got_r, want_r.numpy())
    np.testing.assert_allclose(got_v, want_v.numpy(), atol=1e-4)
    # a loaded index keeps appending
    extra = np.asarray(queries[:4])
    gids = loaded.append(torch.from_numpy(extra) if direction == "jax_to_port" else jnp.asarray(extra))
    assert gids[0] == t.total_rows


def test_bits_state_from_jax(built):
    """A live JAX index's arrays, taken as numpy, make a port index."""
    _, j, t, queries = built
    arrays = {"centroids": np.asarray(j.centroids), "codes": np.asarray(j.codes),
              "scales": np.asarray(j.scales), "gid": np.asarray(j.gid), "fill": j.fill}
    for i, (a, s) in enumerate(zip(j.host_int8, j.host_scale8)):
        arrays[f"host_int8_{i}"], arrays[f"host_scale8_{i}"] = a, s
    meta = {"capacity": j.n_cap, "block_n": j.block_n, "refine": j.refine,
            "total_rows": j.total_rows, "n_host": len(j.host_int8)}
    port = tbi.bits_state_from_jax(arrays, meta, device="cpu")
    got = port.search(torch.from_numpy(queries), 5, nprobe=4, refine_k=20)
    want = t.search(torch.from_numpy(queries), 5, nprobe=4, refine_k=20)
    assert torch.equal(got[1], want[1])
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=1e-6)


def test_train_builds_a_searchable_index():
    rng = np.random.default_rng(2)
    x, _ = _clustered(rng, 1024, 64, 8)
    idx = tbi.IVFBitsIndex.train(torch.from_numpy(x[:512]), 8, capacity=2048, block_n=32,
                                 refine=True, device="cpu")
    assert idx.nlist == 8 and idx.device.type == "cpu"
    idx.append(torch.from_numpy(x))
    _, rows = idx.search(torch.from_numpy(x[:16]), 1, nprobe=8, refine_k=50, group_l=1)
    assert (rows[:, 0].numpy() == np.arange(16)).mean() >= 0.9
    with pytest.raises(RuntimeError):
        if torch.cuda.is_available():
            raise RuntimeError("a card is present: the default device is valid")
        tbi.IVFBitsIndex(torch.zeros(2, 16), capacity=8)  # default device is the card
