"""index/segmented_residual.py of the PyTorch port against the JAX package.
Both indexes take the same centroids in their constructor, the same
appends and the same queries; the port runs with device="cpu"."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import intool_rag_tpu.index.segmented_residual as jseg
import intool_rag_tpu_torch.index.segmented_residual as tseg
from test_torch_ivf_residual import assert_topk_equal, clustered, queries_near

torch.set_num_threads(2)

D, NLIST, SEG_ROWS = 128, 16, 1024
CHUNKS = (1024, 700, 1024, 300, 1024)  # full and short segments; store capacity 1 → 2 → 4 → 8
SKEW = np.r_[0.4, np.full(15, 0.6 / 15)]  # one list past its cap in every segment


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(9)
    x = clustered(rng, sum(CHUNKS), D, NLIST, skew=SKEW)
    cents = x[rng.choice(len(x), NLIST, replace=False)] + 0.01
    return x, queries_near(rng, x, 45), cents.astype(np.float32)


def _store_equal(t, j):
    assert (t.n_segments, t.total_rows, t.max_overflow, t.cap, t.seg_rows) == (
        j.n_segments, j.total_rows, j.max_overflow, j.cap, j.seg_rows)
    for name, a, b in zip(tseg._STORE, t._store, j._store):
        if name == "scales" and t.bits == 1:  # mean |r|: sums in another order, a few ulp
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=6e-7, atol=0, err_msg=name)
        else:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
    assert t.bytes_resident == j.bytes_resident and t.bytes_host == j.bytes_host


@pytest.fixture(scope="module", params=[(4, False), (1, True), (4, True)], ids=lambda p: f"bits{p[0]}-refine{p[1]}")
def built(request, data):
    """Appends across every doubling of the store, arrays held equal after each."""
    bits, refine = request.param
    x, _, cents = data
    j = jseg.SegmentedResidualIndex(jnp.asarray(cents), seg_rows=SEG_ROWS, bits=bits, refine=refine)
    t = tseg.SegmentedResidualIndex(torch.from_numpy(cents), seg_rows=SEG_ROWS, bits=bits, refine=refine,
                                    device="cpu")
    start, caps = 0, []
    for n in CHUNKS:
        jg = j.append(jnp.asarray(x[start : start + n]))
        tg = t.append(torch.from_numpy(x[start : start + n]))
        np.testing.assert_array_equal(tg, jg)
        _store_equal(t, j)
        caps.append(t._store[0].shape[0])
        start += n
    assert caps == [1, 2, 4, 4, 8] and t.max_overflow > 0
    return j, t


def test_store_and_refine_tier_equal(built):
    j, t = built
    _store_equal(t, j)
    for a, b in zip(t.host_int8, j.host_int8):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(t.host_scale8, j.host_scale8):
        np.testing.assert_array_equal(a, b)  # the JAX scale under jit, x·(1/127), reproduced


@pytest.mark.parametrize("nprobe,chunk,refine_k", [(2, 32, None), (4, 16, 40), (16, 7, None), (3, 45, 30)])
def test_search_matches_jax(built, data, nprobe, chunk, refine_k):
    j, t = built
    _, qs, _ = data
    jv, jr = j.search(jnp.asarray(qs), 10, nprobe=nprobe, query_chunk=chunk, refine_k=refine_k)
    tv, tr = t.search(torch.from_numpy(qs), 10, nprobe=nprobe, query_chunk=chunk, refine_k=refine_k)
    assert tr.dtype == torch.int32
    assert_topk_equal(tv.numpy(), tr.numpy(), jv, jr)
    assert (tr[:, 0] >= 0).all()


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_save_load_across_packages(built, data, tmp_path, direction):
    j, t = built
    _, qs, _ = data
    path = tmp_path / "seg.npz"
    want_v, want_r = t.search(torch.from_numpy(qs), 10, nprobe=4, refine_k=30)
    if direction == "jax_to_port":
        j.save(path)
        loaded = tseg.SegmentedResidualIndex.load(path, device="cpu")
        got_v, got_r = loaded.search(torch.from_numpy(qs), 10, nprobe=4, refine_k=30)
        # loaded exactly at its live segments: a JAX load allocates no doubling slack
        assert loaded._store[0].shape[0] == t.n_segments
    else:
        t.save(path)
        loaded = jseg.SegmentedResidualIndex.load(path)
        got_v, got_r = loaded.search(jnp.asarray(qs), 10, nprobe=4, refine_k=30)
    assert (loaded.n_segments, loaded.total_rows, loaded.max_overflow, loaded.bits) == (
        t.n_segments, t.total_rows, t.max_overflow, t.bits)
    assert loaded.bytes_host == t.bytes_host
    assert_topk_equal(np.asarray(got_v), np.asarray(got_r), want_v.numpy(), want_r.numpy())
    # a loaded index keeps appending past its exact capacity
    gids = loaded.append(torch.from_numpy(qs[:5]) if direction == "jax_to_port" else jnp.asarray(qs[:5]))
    assert gids[0] == t.total_rows and loaded.n_segments == t.n_segments + 1


def test_empty_index_and_oversized_chunk(data):
    _, qs, cents = data
    j = jseg.SegmentedResidualIndex(jnp.asarray(cents), seg_rows=SEG_ROWS)
    t = tseg.SegmentedResidualIndex(torch.from_numpy(cents), seg_rows=SEG_ROWS, device="cpu")
    assert t.bytes_resident == j.bytes_resident
    tv, tr = t.search(torch.from_numpy(qs[:3]), 4)
    jv, jr = j.search(jnp.asarray(qs[:3]), 4)
    assert tuple(tv.shape) == (3, 4) and torch.isinf(tv).all() and (tr == -1).all()
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    with pytest.raises(ValueError, match="exceeds seg_rows"):
        t.append(torch.zeros(SEG_ROWS + 1, D))
    with pytest.raises(ValueError, match="bits"):
        tseg.SegmentedResidualIndex(torch.from_numpy(cents), bits=2, device="cpu")


def test_train_builds_a_searchable_index(data):
    """The port's own k-means: near-copy queries find their row."""
    x, _, _ = data
    rng = np.random.default_rng(1)
    rows = rng.choice(len(x), 24, replace=False)
    idx = tseg.SegmentedResidualIndex.train(torch.from_numpy(x[:2048]), NLIST, seg_rows=SEG_ROWS, bits=1,
                                            refine=True, device="cpu")
    for start in range(0, len(x), SEG_ROWS):
        idx.append(torch.from_numpy(x[start : start + SEG_ROWS]))
    _, got = idx.search(torch.from_numpy(x[rows]), 5, nprobe=4, refine_k=50)
    assert (got[:, 0].numpy() == rows).mean() >= 0.9
