"""index/ivf_index.py (IVFFlatIndex) of the PyTorch port against the JAX
package, both built from the JAX package's k-means (``kmeans`` replaced
IN THESE TESTS in both modules). The port runs with device="cpu"."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import intool_rag_tpu.index.ivf_index as jivf
import intool_rag_tpu_torch.index.ivf_index as tivf
from test_torch_ivf_residual import assert_topk_equal, clustered, queries_near, same_kmeans

torch.set_num_threads(2)

N, D, NLIST = 2500, 64, 16
SKEW = np.r_[0.3, 0.15, np.full(14, 0.55 / 14)]  # one heavy list: an overflow tail


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(5)
    x = clustered(rng, N, D, NLIST, skew=SKEW)
    return x, queries_near(rng, x, 37)


@pytest.fixture(params=["float32", "bfloat16"])
def built(request, monkeypatch, data):
    x, _ = data
    calls = same_kmeans(monkeypatch, jivf, tivf, x, NLIST)
    jd, td = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}[request.param]
    j = jivf.IVFFlatIndex.build(jnp.asarray(x), NLIST, dtype=jd)
    t = tivf.IVFFlatIndex.build(torch.from_numpy(x), NLIST, dtype=td, device="cpu")
    assert calls == {"jax": 1, "torch": 1}
    return j, t


def test_build_arrays_equal(built):
    j, t = built
    assert t.overflow_len > 0, "the skewed corpus must spill into the overflow tail"
    assert (t.cap, t.overflow_start, t.overflow_len, t.nlist) == (j.cap, j.overflow_start, j.overflow_len, j.nlist)
    for name in ("centroids", "row_map", "list_start", "list_len"):
        np.testing.assert_array_equal(getattr(t, name).numpy(), np.asarray(getattr(j, name)), err_msg=name)
    np.testing.assert_array_equal(t.permuted.float().numpy(), np.asarray(j.permuted.astype(jnp.float32)))
    assert str(t.permuted.dtype).split(".")[-1] == str(j.permuted.dtype)


@pytest.mark.parametrize("nprobe,chunk", [(1, 32), (4, 16), (16, 10)])
def test_search_matches_jax(built, data, nprobe, chunk):
    """Q = 37 over chunks of 10, 16 and 32 (not a multiple); nprobe 16 is
    every list."""
    j, t = built
    _, qs = data
    jv, jr = j.search(jnp.asarray(qs), 10, nprobe=nprobe, query_chunk=chunk)
    tv, tr = t.search(torch.from_numpy(qs), 10, nprobe=nprobe, query_chunk=chunk)
    assert tr.dtype == torch.int32
    assert_topk_equal(tv.numpy(), tr.numpy(), jv, jr)


def test_all_lists_probed_equals_exact(data):
    """With every list probed the port's own index is the exact scan."""
    x, qs = data
    idx = tivf.IVFFlatIndex.build(torch.from_numpy(x), NLIST, dtype=torch.float32, device="cpu")
    vals, rows = idx.search(torch.from_numpy(qs), 5, nprobe=NLIST)
    exact = qs @ x.T
    np.testing.assert_allclose(vals.numpy(), -np.sort(-exact, axis=1)[:, :5], atol=1e-5)
    assert (rows[:, 0].numpy() == exact.argmax(axis=1)).all()


def test_fewer_candidates_than_k_pad():
    """A pool smaller than k comes back padded with −inf / −1 (the JAX
    search would fail to reshape)."""
    rng = np.random.default_rng(0)
    x = clustered(rng, 64, 16, 4)
    idx = tivf.IVFFlatIndex.build(torch.from_numpy(x), 16, device="cpu")
    vals, rows = idx.search(torch.from_numpy(x[:3]), 40, nprobe=1)
    assert tuple(rows.shape) == (3, 40)
    assert (rows[~torch.isfinite(vals)] == -1).all() and (rows[:, 0] >= 0).all()
