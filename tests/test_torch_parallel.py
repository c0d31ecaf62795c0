"""Corpus sharding of the PyTorch port against the JAX package on the CPU:
the JAX functions over the 8 virtual CPU devices (their own tests' setup,
Pallas kernels in interpret mode), the port's over a mesh of 8 (or 4)
``cpu`` entries, where K1 / K2 take their plain versions. Twins of the
corpus-sharding cases of ``test_parallel.py``, ``test_sharded_kernels.py``
and ``test_sharded_scale.py`` (the train-step and tensor-parallel cases
wait for the model-parallel slice), the sharded checkpoint's interop, and
the ``SHARDED_SEARCH`` route of the port's dense index.

Tolerances: f32 scores 1e-5 relative to the largest |score| (the two
packages' products sum in another order); rows equal, or equal as sets
where scores tie within that bound; k-means centroids 1e-4 from the same
initial centroids; a checkpoint's arrays bit-equal.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_ivf_residual import assert_topk_equal as _assert_topk_equal

from intool_rag_tpu.parallel import mesh as jmesh
from intool_rag_tpu.parallel import sharded_search as jss
from intool_rag_tpu_torch.parallel import mesh as tmesh
from intool_rag_tpu_torch.parallel import sharded_search as tss

pytestmark = pytest.mark.multichip

K = 10
DIM = 128


def port_mesh(n: int = 8) -> tmesh.Mesh:
    return tmesh.corpus_mesh(["cpu"] * n)


def jax_mesh(n: int = 8):
    return jmesh.corpus_mesh(jax.devices()[:n])


@pytest.fixture(autouse=True)
def _fresh_configs():
    yield
    from intool_rag_tpu import config as jcfg
    from intool_rag_tpu_torch import config as tcfg

    jcfg.reset_config()
    tcfg.reset_config()


def assert_topk_equal(got_v, got_r, want_v, want_r, atol=1e-5):
    """Scores to ``atol`` relative to the largest |score| (at least 1: the
    unit-norm cases hold it absolutely); rows equal except within ties of
    that width, where they must be the same set."""
    scale = max(1.0, float(np.abs(np.asarray(want_v)[np.isfinite(want_v)]).max(initial=0.0)))
    _assert_topk_equal(got_v, got_r, want_v, want_r, atol=atol * scale)


def _np(t) -> np.ndarray:
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def test_mesh_shapes_and_local_devices():
    """The port's meshes take the JAX package's shapes; with no CUDA device
    ``local_devices`` raises (there is no silent CPU mesh), and a CPU mesh
    is asked for by name."""
    assert len(jax.devices()) == 8
    m = port_mesh()
    assert m.shape == {"data": 8} and m.size == 8 and m.out_device == torch.device("cpu")
    t = tmesh.train_mesh(["cpu"] * 8)
    assert t.shape == jmesh.train_mesh().shape == {"data": 4, "model": 2}
    assert tmesh.train_mesh(["cpu"] * 3).shape == {"data": 3, "model": 1}
    with pytest.raises(ValueError):
        tmesh.train_mesh(["cpu"] * 6, model_parallel=4)
    assert tmesh.local_devices("cpu") == [torch.device("cpu")]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tmesh.local_devices()


def test_mesh_config_fields_take_the_jax_defaults_and_warn_that_nothing_reads_them(monkeypatch):
    """``MESH_DATA_AXIS`` / ``MESH_MODEL_AXIS`` keep the JAX config's
    defaults; nothing reads them in either package, so another value draws
    a warning instead of passing silently."""
    import warnings

    from intool_rag_tpu.config import Config as JaxConfig
    from intool_rag_tpu_torch.config import Config

    with warnings.catch_warnings():
        warnings.simplefilter("error")
        cfg = Config()
    want = JaxConfig()
    assert (cfg.MESH_DATA_AXIS, cfg.MESH_MODEL_AXIS) == (want.MESH_DATA_AXIS, want.MESH_MODEL_AXIS) == (0, 1)
    monkeypatch.setenv("MESH_MODEL_AXIS", "2")
    with pytest.warns(UserWarning, match="MESH_MODEL_AXIS=2 are ignored"):
        assert Config().MESH_MODEL_AXIS == 2


def _both_flat(queries, corpus, k, n_dev, *, valid_n, block_n, j_kw=None, t_kw=None, row_align=1):
    """The JAX and the port sharded flat search of the same inputs."""
    jm, tm = jax_mesh(n_dev), port_mesh(n_dev)
    j_sharded = jss.shard_corpus(jnp.asarray(corpus), jm, row_align=row_align)
    t_sharded = tss.shard_corpus(torch.from_numpy(corpus), tm, row_align=row_align)
    assert t_sharded.shape == j_sharded.shape
    jv, jr = jss.sharded_flat_topk(jnp.asarray(queries), j_sharded, k, jm, valid_n=valid_n, block_n=block_n,
                                   **(j_kw or {}))
    tv, tr = tss.sharded_flat_topk(torch.from_numpy(queries), t_sharded, k, tm, valid_n=valid_n, block_n=block_n,
                                   **(t_kw or {}))
    return (np.asarray(jv), np.asarray(jr)), (_np(tv), _np(tr))


def test_sharded_flat_topk_matches_single_device(rng):
    """``test_parallel.py::test_sharded_flat_topk_matches_single_device``:
    1,000 rows over 8 shards (the padding path), the blocked scan."""
    n, d, q = 1000, 64, 5
    corpus = rng.standard_normal((n, d)).astype(np.float32)
    corpus /= np.linalg.norm(corpus, axis=1, keepdims=True)
    queries = corpus[:q] + 0.05 * rng.standard_normal((q, d)).astype(np.float32)
    (jv, jr), (tv, tr) = _both_flat(queries, corpus, K, 8, valid_n=n, block_n=128)
    assert_topk_equal(tv, tr, jv, jr, atol=1e-5)
    oracle = np.argsort(-(queries @ corpus.T), axis=1)[:, :K]
    assert all(set(a) == set(b) for a, b in zip(tr.tolist(), oracle.tolist()))
    assert tr.max() < n and np.all(np.diff(tv, axis=1) <= 1e-6)


def test_sharded_topk_negative_scores_not_displaced_by_padding(rng):
    """All real scores negative under ``ip``, the last shard mostly zero
    padding: each shard's valid count masks its padding before selection."""
    n, d, q, k = 257, 32, 3, 8
    corpus = -np.abs(rng.standard_normal((n, d))).astype(np.float32)
    queries = np.abs(rng.standard_normal((q, d))).astype(np.float32)
    (jv, jr), (tv, tr) = _both_flat(queries, corpus, k, 8, valid_n=n, block_n=128)
    assert_topk_equal(tv, tr, jv, jr, atol=1e-5)
    assert tr.min() >= 0 and tr.max() < n and np.all(tv < 0)
    oracle = np.argsort(-(queries @ corpus.T), axis=1)[:, :k]
    assert all(set(a) == set(b) for a, b in zip(tr.tolist(), oracle.tolist()))


def test_sharded_fused_f32_matches_scan(rng):
    """``test_sharded_kernels.py::test_sharded_pallas_f32_matches_xla_exact``:
    K1 per shard (JAX: the Pallas kernel in interpret mode), group_l 1 and
    the exact tail, 900 valid rows of 4 shards of 256."""
    valid = 900
    corpus = rng.standard_normal((valid, DIM)).astype(np.float32)
    queries = rng.standard_normal((5, DIM)).astype(np.float32)
    (jv, jr), (tv, tr) = _both_flat(
        queries, corpus, K, 4, valid_n=valid, block_n=16384, row_align=128,
        j_kw=dict(kernel="pallas", group_l=1, tail="exact", interpret=True),
        t_kw=dict(kernel="fused", group_l=1, tail="exact"),
    )
    assert_topk_equal(tv, tr, jv, jr, atol=1e-5)
    order = np.argsort(-(queries @ corpus.T), axis=1, kind="stable")[:, :K]
    assert all(set(a) == set(b) for a, b in zip(tr.tolist(), order.tolist()))


def test_sharded_fused_bf16_precise_matches_single_device(rng):
    """``test_sharded_pallas_bf16_precise_matches_single_device``: a bf16
    corpus, K1 with the split-query pass per shard, against the JAX sharded
    kernel and against the port's single-device kernel on the whole corpus
    (row-local scores: equal bits)."""
    from intool_rag_tpu_torch.ops.flat_fused import flat_topk_fused

    n = 4 * 256
    corpus_np = rng.standard_normal((n, DIM)).astype(np.float32)
    queries = rng.standard_normal((3, DIM)).astype(np.float32)
    jm, tm = jax_mesh(4), port_mesh(4)
    j_corpus = jnp.asarray(corpus_np).astype(jnp.bfloat16)
    t_corpus = torch.from_numpy(corpus_np).bfloat16()
    jv, jr = jss.sharded_flat_topk(jnp.asarray(queries), jss.shard_corpus(j_corpus, jm, row_align=128), K, jm,
                                   valid_n=n, kernel="pallas", group_l=1, tail="exact", interpret=True)
    tv, tr = tss.sharded_flat_topk(torch.from_numpy(queries), tss.shard_corpus(t_corpus, tm, row_align=128), K,
                                   tm, valid_n=n, kernel="fused", group_l=1, tail="exact")
    assert_topk_equal(tv.numpy(), tr.numpy(), np.asarray(jv), np.asarray(jr), atol=1e-5)
    sv, sr = flat_topk_fused(torch.from_numpy(queries), t_corpus, K, group_l=1, valid_n=n, precise=True,
                             tail="exact")
    assert torch.equal(tv, sv) and torch.equal(tr, sr)


def test_kernel_group_l_alignment():
    """``test_pallas_group_l_alignment``: the port's width rule is the JAX one."""
    for rows, k in ((1 << 20, 10), (4096, 10), (256, 10), (100, 10), (12_288, 100), (128, 1)):
        assert tss.kernel_group_l(rows, k) == jss.pallas_group_l(rows, k)
    assert tss.kernel_group_l(1 << 20, 10) == 32 and tss.kernel_group_l(100, 10) is None


def test_sharded_flat_topk_int8_prefix_layout(rng):
    """``test_sharded_flat_topk_int8_prefix_layout``: int8r planes of the
    single-device mirror sharded with the prefix layout, K2 per shard.
    Codes and scales come from each package's own quantizer (bit-equal here:
    both divide), so the scores agree to 1e-5."""
    from intool_rag_tpu.ops.quant import quantize_int8_residual as jq
    from intool_rag_tpu_torch.ops.quant import quantize_int8_residual as tq

    valid = 700
    corpus = rng.standard_normal((valid, DIM)).astype(np.float32)
    queries = rng.standard_normal((3, DIM)).astype(np.float32)
    jm, tm = jax_mesh(4), port_mesh(4)
    j1, j2, js = jq(jnp.asarray(corpus))
    t1, t2, ts = tq(torch.from_numpy(corpus))
    assert np.array_equal(t1.numpy(), np.asarray(j1)) and np.array_equal(ts.numpy(), np.asarray(js))
    jv, jr = jss.sharded_flat_topk_int8(
        jnp.asarray(queries), *(jss.shard_corpus(a, jm, row_align=128) for a in (j1, js)), K, jm,
        res=jss.shard_corpus(j2, jm, row_align=128), valid_n=valid, group_l=1, tail="exact", interpret=True)
    tv, tr = tss.sharded_flat_topk_int8(
        torch.from_numpy(queries), *(tss.shard_corpus(a, tm, row_align=128) for a in (t1, ts)), K, tm,
        res=tss.shard_corpus(t2, tm, row_align=128), valid_n=valid, group_l=1, tail="exact")
    assert_topk_equal(tv.numpy(), tr.numpy(), np.asarray(jv), np.asarray(jr), atol=1e-5)
    assert tr.numpy().max() < valid


@pytest.mark.parametrize("n_dev,valid", [(4, 512 * 4), (4, 300), (8, 1)])
def test_empty_shards_and_small_k(rng, n_dev, valid):
    """Shards with no valid row are not searched and give no candidate; k
    above a shard's rows still returns min(k, valid) hits."""
    corpus = rng.standard_normal((valid, DIM)).astype(np.float32)
    queries = rng.standard_normal((2, DIM)).astype(np.float32)
    (jv, jr), (tv, tr) = _both_flat(queries, corpus, 600, n_dev, valid_n=valid, block_n=128, row_align=128,
                                    j_kw=dict(kernel="pallas", group_l=1, tail="exact", interpret=True),
                                    t_kw=dict(kernel="fused", group_l=1, tail="exact"))
    assert tv.shape == (2, min(600, valid))
    assert_topk_equal(tv, tr, jv, jr, atol=1e-5)


# ---------------- test_sharded_scale.py twins ----------------


def _clustered(rng, n_clusters=8, per=128, d=32):
    centers = rng.standard_normal((n_clusters, d)).astype(np.float32) * 5
    pts = np.concatenate([c + rng.standard_normal((per, d)).astype(np.float32) for c in centers])
    return pts, centers


def test_sharded_kmeans_matches_jax(rng, monkeypatch):
    """``test_sharded_kmeans_matches_clusters``: both packages from the same
    initial centroids (JAX's seeding draws with ``jax.random``, so its
    ``_kmeans_pp_init`` is replaced here by the port's pick), Lloyd over 8
    shards of 1,030 padded rows. Centroids to 1e-4 (f32 sums in another
    order), assignments equal, padding -1."""
    import intool_rag_tpu.parallel.sharded_kmeans as jkm
    from intool_rag_tpu_torch.parallel.sharded_kmeans import initial_centroids, sharded_kmeans

    pts, centers = _clustered(rng)
    pts = np.concatenate([pts, pts[:6] + 0.01])  # 1,030 rows: the last shard partly padding
    tm = port_mesh()
    t_sharded = tss.shard_corpus(torch.from_numpy(pts), tm)
    init = initial_centroids(t_sharded, 8, len(pts), seed=3)
    monkeypatch.setattr(jkm, "_kmeans_pp_init", lambda sample, k, key: jnp.asarray(init.numpy()))
    jc, ja = jkm.sharded_kmeans(jss.shard_corpus(jnp.asarray(pts), jax_mesh()), 8, jax_mesh(), valid_n=len(pts),
                                iters=10)
    tc, ta = sharded_kmeans(t_sharded, 8, tm, valid_n=len(pts), iters=10, init=init)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-4, rtol=0)
    np.testing.assert_array_equal(ta.gather().numpy(), np.asarray(ja))
    a = ta.gather().numpy()
    assert (a[: len(pts)] >= 0).all() and (a[len(pts):] == -1).all()
    dists = np.linalg.norm(centers[:, None, :] - tc.numpy()[None], axis=2)
    assert (dists.min(axis=1) < 1.0).all()
    # the port's own seeding is deterministic in its seed
    tc2, _ = sharded_kmeans(t_sharded, 8, tm, valid_n=len(pts), iters=10, seed=3)
    assert torch.equal(tc2, tc)


def test_sharded_checkpoint_interop(rng, tmp_path):
    """``test_sharded_checkpoint_roundtrip`` in both directions: an array the
    JAX package saves over 8 devices loads in the port re-partitioned onto
    4 entries (and 8), and the port's files load in the JAX package onto 4
    devices; floats travel through f32, so bf16 and int8 come back
    bit-equal, and the manifest's meta is kept."""
    from intool_rag_tpu.storage.sharded import load_sharded as jload
    from intool_rag_tpu.storage.sharded import save_sharded as jsave
    from intool_rag_tpu_torch.storage.sharded import load_sharded as tload
    from intool_rag_tpu_torch.storage.sharded import save_sharded as tsave

    data = rng.standard_normal((1024, 64)).astype(np.float32)
    jsave(jss.shard_corpus(jnp.asarray(data), jax_mesh()), tmp_path / "jax", meta={"valid_n": 1000})
    for n in (8, 4):
        restored, meta = tload(tmp_path / "jax", port_mesh(n))
        assert meta == {"valid_n": 1000} and len(restored.shards) == n
        np.testing.assert_array_equal(restored.gather().numpy(), data)
    bf = torch.from_numpy(data).bfloat16()
    codes = torch.from_numpy(rng.integers(-127, 128, (1024, 32)).astype(np.int8))
    for name, arr in (("bf16", bf), ("codes", codes)):
        tsave(tss.shard_corpus(arr, port_mesh()), tmp_path / name, meta={"what": name})
        back, meta = jload(tmp_path / name, jax_mesh(4))
        assert meta == {"what": name} and len(back.addressable_shards) == 4
        want = arr.float().numpy() if arr.is_floating_point() else arr.numpy()
        np.testing.assert_array_equal(np.asarray(back).astype(want.dtype), want)
        mine, _ = tload(tmp_path / name, port_mesh(4))
        assert mine.dtype == arr.dtype and torch.equal(mine.gather(), arr)


def test_streaming_reshard_and_query(rng):
    """``test_streaming_ingest_and_sharded_query``: an appended batch
    resharded with the old rows, each new vector finds itself at rank 1."""
    d = 64
    base = rng.standard_normal((500, d)).astype(np.float32)
    new = rng.standard_normal((100, d)).astype(np.float32)
    base /= np.linalg.norm(base, axis=1, keepdims=True)
    new /= np.linalg.norm(new, axis=1, keepdims=True)
    combined = np.concatenate([base, new])
    (jv, jr), (tv, tr) = _both_flat(new[:4], combined, 3, 8, valid_n=len(combined), block_n=64)
    assert_topk_equal(tv, tr, jv, jr, atol=1e-5)
    assert tr[:, 0].tolist() == [500, 501, 502, 503]


# ---------------- the dense index's SHARDED_SEARCH route ----------------


def _store_pair(rng, n, dim=64):
    from intool_rag_tpu.index.chunk_store import ChunkStore as JStore
    from intool_rag_tpu_torch.index.chunk_store import ChunkStore as TStore

    emb = rng.standard_normal((n, dim)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    ids = [f"c_{i:06d}" for i in range(n)]
    jstore = JStore(dim=dim, dtype="float32")
    jstore.append(emb, "d1", ids, [0] * n, ["t"] * n)
    tstore = TStore(dim=dim, dtype="float32", device="cpu")
    tstore.append(emb, "d1", ids, [0] * n, ["t"] * n)
    return emb, jstore, tstore


def _set_env(monkeypatch, **env):
    from intool_rag_tpu import config as jcfg
    from intool_rag_tpu_torch import config as tcfg

    for key, value in env.items():
        monkeypatch.setenv(key, value)
    jcfg.reset_config()
    tcfg.reset_config()


def eight_cpu_devices(monkeypatch):
    """The port's device count, as the CPU tests see 8 JAX devices."""
    monkeypatch.setattr(tmesh, "local_devices", lambda device_type="cuda": [torch.device("cpu")] * 8)


def test_dense_index_sharded_serving(rng, tmp_storage, monkeypatch):
    """``test_parallel.py::test_dense_index_sharded_serving``:
    ``SHARDED_SEARCH=on`` over 8 devices shards the serving index, equals
    the JAX sharded route and the exact single-device search, and a store
    mutation rebuilds the placement."""
    from intool_rag_tpu.index.flat_index import DenseFlatIndex as JIndex
    from intool_rag_tpu_torch.index.flat_index import DenseFlatIndex as TIndex

    _set_env(monkeypatch, SHARDED_SEARCH="on")
    eight_cpu_devices(monkeypatch)
    emb, jstore, tstore = _store_pair(rng, 3000)
    jindex, tindex = JIndex(jstore), TIndex(tstore)
    q = emb[:4]
    jv, jr = jindex.search(jnp.asarray(q), 5)
    tv, tr = tindex.search(torch.from_numpy(q), 5)
    assert tindex._sharded is not None and len(tindex._sharded[1][1].shards) == 8
    assert not tindex.routes_flat()
    assert_topk_equal(tv.numpy(), tr.numpy(), np.asarray(jv), np.asarray(jr), atol=1e-5)
    assert tr[:, 0].tolist() == [0, 1, 2, 3]
    ev, er = tindex.search(torch.from_numpy(q), 5, exact=True)
    assert torch.equal(er, tr)
    built = tindex._sharded_built_at
    tstore.append(emb[:2], "d2", ["x0", "x1"], [0, 0], ["t", "t"])
    tindex.search(torch.from_numpy(q), 5)
    assert tindex._sharded_built_at != built and tindex._sharded_built_at == tstore.mutation_count


@pytest.mark.parametrize("mode,min_rows,sharded", [("auto", 2000, True), ("auto", 5000, False),
                                                   ("off", 1, False), ("on", 10**9, True)])
def test_sharded_search_routing(rng, monkeypatch, mode, min_rows, sharded):
    """JAX ``_use_sharded``'s order over a 3,000-row store: ``off`` never
    shards; with 8 devices ``on`` always does and ``auto`` from
    ``SHARDED_SEARCH_MIN_ROWS`` rows. With one device nothing shards."""
    from intool_rag_tpu import config as jcfg
    from intool_rag_tpu.index.flat_index import DenseFlatIndex as JIndex
    from intool_rag_tpu_torch import config as tcfg
    from intool_rag_tpu_torch.index.flat_index import DenseFlatIndex as TIndex

    _set_env(monkeypatch, SHARDED_SEARCH=mode, SHARDED_SEARCH_MIN_ROWS=str(min_rows))
    assert tcfg.get_config().SHARDED_SEARCH_MIN_ROWS == jcfg.get_config().SHARDED_SEARCH_MIN_ROWS == min_rows
    _, jstore, tstore = _store_pair(rng, 3000, dim=32)
    jindex, tindex = JIndex(jstore), TIndex(tstore)
    assert not tindex._use_sharded(tcfg.get_config()) and tindex.routes_flat()  # one CPU device
    eight_cpu_devices(monkeypatch)
    assert tindex._use_sharded(tcfg.get_config()) == jindex._use_sharded(jcfg.get_config()) == sharded
    assert tindex.routes_flat() == jindex.routes_flat() == (not sharded)
