"""The port's ``ShardedCorpus`` against the JAX package's on the CPU: twins
of ``test_sharded_kernels.py``'s corpus cases and of
``test_sharded_scale.py::test_incremental_sharded_corpus``. Both packages
append the same batches (4 or 8 shards), so the placement (the global row
ids), the per-shard counts and the stored planes are compared before the
searches.

Tolerances: placement and int8 codes / scales byte-equal (both quantize
with ``absmax · (1/127)``, the JAX package's jitted rule); f32 and int8
scores 1e-5 relative to the largest (summation order), rows equal or equal
as sets within ties of that width.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_parallel import assert_topk_equal, jax_mesh, port_mesh

from intool_rag_tpu.parallel.sharded_corpus import ShardedCorpus as JaxCorpus
from intool_rag_tpu_torch.parallel.sharded_corpus import ShardedCorpus, place_rows

pytestmark = pytest.mark.multichip

DIM = 128
K = 10


def _planes_equal(t: ShardedCorpus, j: JaxCorpus) -> None:
    names = ("data",) if t.quant == "none" else ("codes", "scales") + (("res",) if t.quant == "int8r" else ())
    for name in names:
        got = getattr(t, name).gather().numpy()
        want = np.asarray(getattr(j, name))
        assert got.dtype == want.dtype and got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)


def _append_both(t, j, batch):
    gt = t.append(batch)
    gj = j.append(batch)
    np.testing.assert_array_equal(gt, gj)
    np.testing.assert_array_equal(t.counts, j.counts)
    assert t.cap == j.cap
    return gt


@pytest.mark.parametrize("quant", ["int8", "int8r"])
def test_sharded_corpus_quantized_parity(rng, quant):
    """``test_sharded_corpus_quantized_parity``: 64 + 32 rows over 4 shards of
    128; the planes byte-equal to the JAX corpus's and to the port's
    single-device quantizer of the union; K2 per shard (group_l 1, exact
    tail) against the JAX sharded kernel and the single-device kernel."""
    from intool_rag_tpu_torch.ops.flat_fused import flat_topk_fused_int8
    from intool_rag_tpu_torch.ops.quant import quantize_int8, quantize_int8_residual

    t = ShardedCorpus(DIM, port_mesh(4), capacity_per_shard=128, quant=quant)
    j = JaxCorpus(DIM, jax_mesh(4), capacity_per_shard=128, quant=quant, interpret=True)
    batch1 = rng.standard_normal((64, DIM)).astype(np.float32)
    batch2 = rng.standard_normal((32, DIM)).astype(np.float32)
    gids = np.concatenate([_append_both(t, j, batch1), _append_both(t, j, batch2)])
    assert t.valid_n == 96 and np.ptp(t.counts) <= 1
    _planes_equal(t, j)

    by_gid = np.zeros((t.cap * 4, DIM), np.float32)
    by_gid[gids] = np.concatenate([batch1, batch2])
    rows = torch.from_numpy(by_gid)
    if quant == "int8":
        q8, s8, res = (*quantize_int8(rows, reciprocal=True), None)
    else:
        q8, res, s8 = quantize_int8_residual(rows, reciprocal=True)
    # the valid rows are the single-device mirror's: gid g at slot g // 4 of shard g % 4
    at = torch.from_numpy((gids % 4) * t.cap + gids // 4)
    assert torch.equal(t.codes.gather()[at], q8[gids]) and torch.equal(t.scales.gather()[at], s8[gids])

    queries = rng.standard_normal((4, DIM)).astype(np.float32)
    tv, tr = t.search(torch.from_numpy(queries), K, group_l=1, tail="exact")
    jv, jr = j.search(jnp.asarray(queries), K, group_l=1, tail="exact")
    assert_topk_equal(tv.numpy(), tr.numpy(), np.asarray(jv), np.asarray(jr))
    sv, sr = flat_topk_fused_int8(torch.from_numpy(queries), q8, s8, K, corpus_res=res, group_l=1, valid_n=len(rows),
                                  tail="exact")
    assert_topk_equal(tv.numpy(), tr.numpy(), sv.numpy(), sr.numpy())


def test_sharded_corpus_int8r_regrowth_preserves_ids(rng):
    """``test_sharded_corpus_int8r_regrowth_preserves_ids``: a batch that
    overflows 4 × 128 regrows every shard (on its own device in the port);
    ids, counts and planes stay the JAX corpus's, and old and new rows find
    themselves."""
    t = ShardedCorpus(DIM, port_mesh(4), capacity_per_shard=128, quant="int8r")
    j = JaxCorpus(DIM, jax_mesh(4), capacity_per_shard=128, quant="int8r", interpret=True)
    batch1 = rng.standard_normal((4 * 128, DIM)).astype(np.float32)
    batch2 = rng.standard_normal((64, DIM)).astype(np.float32)
    gids1 = _append_both(t, j, batch1)
    cap_before = t.cap
    gids2 = _append_both(t, j, batch2)
    assert t.cap > cap_before
    _planes_equal(t, j)
    probe = np.concatenate([batch1[:3], batch2[:3]])
    tv, tr = t.search(torch.from_numpy(probe), 1, group_l=1, tail="exact")
    np.testing.assert_array_equal(tr[:, 0].numpy(), np.concatenate([gids1[:3], gids2[:3]]))
    assert torch.isfinite(tv).all()


def test_incremental_sharded_corpus(rng):
    """``test_incremental_sharded_corpus``: f32 rows over 8 shards of 32,
    batches of 100 / 50 / 7 then 300 (a regrowth); every row finds itself
    under its global id, before and after, as in the JAX corpus."""
    d = 32
    t = ShardedCorpus(d, port_mesh(8), capacity_per_shard=32)
    j = JaxCorpus(d, jax_mesh(8), capacity_per_shard=32)
    rows, vecs = [], []
    for size in (100, 50, 7):
        batch = rng.standard_normal((size, d)).astype(np.float32)
        batch /= np.linalg.norm(batch, axis=1, keepdims=True)
        rows.append(_append_both(t, j, batch))
        vecs.append(batch)
        assert len(np.unique(rows[-1])) == size
    assert t.valid_n == 157
    queries, want = np.concatenate(vecs)[::9], np.concatenate(rows)[::9]
    for _ in range(2):
        tv, tr = t.search(torch.from_numpy(queries), k=1)
        jv, jr = j.search(jnp.asarray(queries), k=1)
        assert tr[:, 0].tolist() == want.tolist() == np.asarray(jr)[:, 0].tolist()
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-5, rtol=0)
        big = rng.standard_normal((300, d)).astype(np.float32)
        big /= np.linalg.norm(big, axis=1, keepdims=True)
        if t.valid_n == 157:
            rows_big = _append_both(t, j, big)
            _, got = t.search(torch.from_numpy(big[:5]), k=1)
            assert got[:, 0].tolist() == rows_big[:5].tolist()
    assert t.valid_n == 457 and t.counts.max() - t.counts.min() <= 1
    _planes_equal(t, j)


@pytest.mark.parametrize("counts,cap,m", [([0, 0, 0, 0], 8, 5), ([3, 1, 2, 0], 8, 9), ([5, 5, 5, 6], 8, 11),
                                          ([0, 7, 2, 2, 1, 0, 3, 3], 16, 40)])
def test_placement_equals_jax(counts, cap, m):
    """The water-filling placement from uneven counts: the JAX corpus's
    (shard, slot) for every row, and the same final counts as placing the
    rows one by one on the emptiest shard."""
    counts = np.asarray(counts, np.int32)
    shard, slot = place_rows(counts, cap, m)
    j = JaxCorpus(4, jax_mesh(len(counts)), capacity_per_shard=cap)
    j.counts = counts.copy()
    np.testing.assert_array_equal(j.append(np.ones((m, 4), np.float32)), slot.astype(np.int64) * len(counts) + shard)
    c = counts.copy()
    for _ in range(m):
        c[np.argmin(c)] += 1
    assert sorted(c.tolist()) == sorted(j.counts.tolist())


def test_search_before_any_row_and_d_padding(rng):
    """Quantized planes pad D to 128 (``dim_pad``); a corpus with no row
    returns no candidate; queries of the unpadded width are accepted."""
    t = ShardedCorpus(96, port_mesh(2), capacity_per_shard=100, quant="int8")
    assert t.dim_pad == 128 and t.cap == 128
    vals, rows = t.search(torch.zeros((2, 96)), 3)
    assert (rows == -1).all() and torch.isinf(vals).all()
    batch = rng.standard_normal((10, 96)).astype(np.float32)
    gids = t.append(batch)
    _, rows = t.search(torch.from_numpy(batch[:2]), 1, group_l=1, tail="exact")
    assert rows[:, 0].tolist() == gids[:2].tolist()
    assert len(jax.devices()) == 8
