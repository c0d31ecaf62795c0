"""index/ivf_residual.py of the PyTorch port against the JAX package.

The codecs are held byte for byte. The builds cannot share k-means seeds,
so both packages' ``kmeans`` are replaced IN THESE TESTS by one function
that returns the JAX package's centroids and assignment; every array
after k-means must then be equal. The port runs with device="cpu".
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import intool_rag_tpu.index.ivf_residual as jres
import intool_rag_tpu_torch.index.ivf_residual as tres
from intool_rag_tpu.ops.kmeans import kmeans as jax_kmeans

torch.set_num_threads(2)


# ---------------- shared helpers (imported by the other capacity-tier tests) ----------------


def clustered(rng, n, d, l, noise=0.05, skew=None):
    """Unit rows around ``l`` centres with a per-row radius spread, as the
    JAX capacity tests draw them. ``skew`` (probabilities) makes lists
    uneven, so that an overflow tail appears."""
    centers = rng.standard_normal((l, d)).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    radius = noise * np.exp(rng.uniform(np.log(0.2), np.log(2.0), (n, 1))).astype(np.float32)
    ids = rng.choice(l, size=n, p=skew)
    x = centers[ids] + radius * rng.standard_normal((n, d)).astype(np.float32)
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def queries_near(rng, x, q, noise=0.01):
    qs = x[rng.integers(0, len(x), q)] + noise * rng.standard_normal((q, x.shape[1])).astype(np.float32)
    return (qs / np.linalg.norm(qs, axis=1, keepdims=True)).astype(np.float32)


def same_kmeans(monkeypatch, jax_module, torch_module, x, nlist, iters=6):
    """Both modules' ``kmeans`` return the JAX package's k-means of ``x``
    (the JAX function, run once here), wherever either is called with
    ``nlist`` lists; returns the call counts."""
    cents, assign = jax_kmeans(jnp.asarray(x), nlist, iters=iters, seed=0)
    cents, assign = np.asarray(cents), np.asarray(assign)
    calls = {"jax": 0, "torch": 0}

    def fake_jax(points, k, **kw):
        calls["jax"] += 1
        assert k == nlist
        return jnp.asarray(cents), jnp.asarray(assign[: points.shape[0]])

    def fake_torch(points, k, **kw):
        calls["torch"] += 1
        assert k == nlist
        return (torch.from_numpy(cents.copy()).to(points.device),
                torch.from_numpy(assign[: points.shape[0]].copy()).to(points.device))

    monkeypatch.setattr(jax_module, "kmeans", fake_jax)
    monkeypatch.setattr(torch_module, "kmeans", fake_torch)
    return calls


def assert_topk_equal(got_v, got_r, want_v, want_r, atol=1e-5):
    """Scores to ``atol``; rows equal except where scores tie within ``atol``
    (then the tied rows must be the same set)."""
    got_v, got_r = np.asarray(got_v), np.asarray(got_r)
    want_v, want_r = np.asarray(want_v), np.asarray(want_r)
    assert got_r.shape == want_r.shape and got_v.shape == want_v.shape
    np.testing.assert_allclose(got_v, want_v, atol=atol, rtol=0)
    for gv, gr, wv, wr in zip(got_v, got_r, want_v, want_r):
        differ = np.flatnonzero(gr != wr)
        for i in differ:
            tie = np.abs(wv - wv[i]) <= atol
            if tie[-1]:  # a tie group cut by k: the rows beyond it may differ
                continue
            assert set(gr[tie].tolist()) == set(wr[tie].tolist()), (gr, wr, wv)


# ---------------- codecs ----------------


@pytest.mark.parametrize("n,d", [(300, 256), (17, 64), (64, 1024)])
def test_int4_codes_byte_equal_and_scales(n, d):
    """Codes byte-equal to the JAX encoder under jit (its builds' form);
    scales bit-equal to it (x·(1/7)) and within 1 ulp of its eager form."""
    rng = np.random.default_rng(n)
    r = (rng.standard_normal((n, d)) * rng.uniform(0.01, 3, (n, 1))).astype(np.float32)
    r[0, :5] = 0.0
    wp, ws = jax.jit(jres.encode_int4_residuals)(jnp.asarray(r))
    gp, gs = tres.encode_int4_residuals(torch.from_numpy(r))
    np.testing.assert_array_equal(gp.numpy(), np.asarray(wp))
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
    ep, es = jres.encode_int4_residuals(jnp.asarray(r))  # eager: the true quotient
    np.testing.assert_allclose(gs.numpy(), np.asarray(es), rtol=1.2e-7, atol=0)
    np.testing.assert_array_equal(gp.numpy(), np.asarray(ep))
    np.testing.assert_array_equal(tres.decode_int4(gp).numpy(), np.asarray(jres.decode_int4(wp)))
    np.testing.assert_array_equal(tres.dequantize_int4(gp, gs).numpy(),
                                  np.asarray(jres.dequantize_int4(wp, ws)))


@pytest.mark.parametrize("n,d", [(300, 256), (17, 64), (64, 1024)])
def test_int1_codes_byte_equal_and_scales(n, d):
    rng = np.random.default_rng(d)
    r = rng.standard_normal((n, d)).astype(np.float32)
    r[1, :9] = 0.0  # zeros count as non-negative in both
    wp, ws = jax.jit(jres.encode_int1_residuals)(jnp.asarray(r))
    gp, gs = tres.encode_int1_residuals(torch.from_numpy(r))
    np.testing.assert_array_equal(gp.numpy(), np.asarray(wp))
    # mean |r| over a group: the two sums run in another order (1 ulp)
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), rtol=2.4e-7, atol=0)
    np.testing.assert_array_equal(tres.decode_int1(gp).numpy(), np.asarray(jres.decode_int1(wp)))
    np.testing.assert_array_equal(tres.dequantize_int1(gp, torch.from_numpy(np.array(ws))).numpy(),
                                  np.asarray(jres.dequantize_int1(wp, ws)))


def test_decode_roundtrip_and_batch_shapes():
    """Decode of [..., W] keeps leading axes; dequantize reconstructs within
    half a step (int4) and gives scale·sign (int1)."""
    rng = np.random.default_rng(3)
    r = torch.from_numpy(rng.standard_normal((12, 256)).astype(np.float32))
    p4, s4 = tres.encode_int4_residuals(r)
    assert p4.dtype == torch.uint8 and tuple(p4.shape) == (12, 128) and tuple(s4.shape) == (12, 2)
    assert tuple(tres.decode_int4(p4.view(3, 4, 128)).shape) == (3, 4, 256)
    recon = tres.dequantize_int4(p4, s4)
    step = s4.repeat_interleave(128, dim=1)
    assert (torch.abs(recon - r) <= step / 2 + 1e-6).all()
    p1, s1 = tres.encode_int1_residuals(r)
    assert tuple(p1.shape) == (12, 32)
    recon1 = tres.dequantize_int1(p1, s1)
    torch.testing.assert_close(recon1.abs(), s1.repeat_interleave(128, dim=1))
    assert ((recon1 >= 0) == (r >= 0)).all()
    with pytest.raises(ValueError, match="bits"):
        tres.check_width(2, 64)
    with pytest.raises(ValueError, match="even"):
        tres.check_width(4, 63)
    with pytest.raises(ValueError, match="divisible"):
        tres.check_width(1, 60)


# ---------------- build and search ----------------

N, D, NLIST = 3000, 128, 16
SKEW = np.r_[np.full(4, 0.16), np.full(12, 0.36 / 12)]  # four heavy lists: an overflow tail


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(7)
    x = clustered(rng, N, D, NLIST, skew=SKEW)
    return x, queries_near(rng, x, 45)


@pytest.fixture(params=[(4, False), (4, True), (1, False), (1, True)], ids=lambda p: f"bits{p[0]}-refine{p[1]}")
def built(request, monkeypatch, data):
    bits, refine = request.param
    x, _ = data
    calls = same_kmeans(monkeypatch, jres, tres, x, NLIST)
    j = jres.IVFResidualIndex.build(jnp.asarray(x), NLIST, refine=refine, bits=bits)
    t = tres.IVFResidualIndex.build(torch.from_numpy(x), NLIST, refine=refine, bits=bits, device="cpu")
    assert calls == {"jax": 1, "torch": 1}
    return j, t


def test_build_arrays_equal(built):
    j, t = built
    assert t.overflow_len > 0, "the skewed corpus must spill into the overflow tail"
    assert (t.cap, t.overflow_start, t.overflow_len, t.bits, t.nlist) == (
        j.cap, j.overflow_start, j.overflow_len, j.bits, j.nlist)
    for name in ("centroids", "codes", "row_list", "row_map", "list_start", "list_len"):
        np.testing.assert_array_equal(getattr(t, name).numpy(), np.asarray(getattr(j, name)), err_msg=name)
    if t.bits == 4:
        np.testing.assert_array_equal(t.scales.numpy(), np.asarray(j.scales))
    else:  # mean |r| of 128 values: the sums run in another order, a few ulp
        np.testing.assert_allclose(t.scales.numpy(), np.asarray(j.scales), rtol=6e-7, atol=0)
    assert t.bytes_resident == j.bytes_resident and t.bytes_host == j.bytes_host
    if j.host_int8 is not None:
        np.testing.assert_array_equal(t.host_int8, j.host_int8)
        # the JAX tier is quantized under jit, where x/127 compiles to x·(1/127): reproduced
        np.testing.assert_array_equal(t.host_scale8, j.host_scale8)


@pytest.mark.parametrize("nprobe,chunk,refine_k", [(2, 32, None), (4, 16, 40), (16, 7, 40), (3, 45, 0)])
def test_search_matches_jax(built, data, nprobe, chunk, refine_k):
    """Q = 45 is not a multiple of the query chunk; refine_k uses the host
    tier where the build has one (and is ignored where it has none)."""
    j, t = built
    _, qs = data
    jv, jr = j.search(jnp.asarray(qs), 10, nprobe=nprobe, query_chunk=chunk, refine_k=refine_k)
    tv, tr = t.search(torch.from_numpy(qs), 10, nprobe=nprobe, query_chunk=chunk, refine_k=refine_k)
    assert tr.dtype == torch.int32 and tv.dtype == torch.float32
    assert_topk_equal(tv.numpy(), tr.numpy(), jv, jr)
    assert (tr[:, 0] >= 0).all()


def test_build_and_search_default_to_the_card(data):
    x, _ = data
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        tres.IVFResidualIndex.build(torch.from_numpy(x[:64]), 4)


def test_recall_against_exact_scan(data):
    """The port's own build (its k-means) finds the exact top-1 of
    near-copy queries, refined or not."""
    x, qs = data
    exact = np.argmax(qs @ x.T, axis=1)
    for bits in (4, 1):
        idx = tres.IVFResidualIndex.build(torch.from_numpy(x), NLIST, refine=True, bits=bits, device="cpu")
        _, rows = idx.search(torch.from_numpy(qs), 10, nprobe=4, refine_k=50)
        assert (rows[:, 0].numpy() == exact).mean() >= 0.9


def test_gather_budget_cuts_the_chunk_not_the_result(built, data, monkeypatch):
    """A chunk's gathered rows are bounded (``bounded_chunk``); one query a
    chunk gives the same results as the JAX chunk of 32."""
    _, t = built
    _, qs = data
    want = t.search(torch.from_numpy(qs), 10, nprobe=4, refine_k=40)
    monkeypatch.setattr(tres, "GATHER_BUDGET", 1)
    assert tres.bounded_chunk(32, 4 * t.cap, 128) == 1
    got = t.search(torch.from_numpy(qs), 10, nprobe=4, refine_k=40)
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=1e-6)
    assert torch.equal(got[1], want[1])
