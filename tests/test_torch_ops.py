"""The port's plain top-k and quantization ops against the JAX package
(same numpy inputs from a seed on both sides)."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from intool_rag_tpu.ops import quant as jquant
from intool_rag_tpu.ops import topk as jtopk
from intool_rag_tpu_torch.ops import quant as tquant
from intool_rag_tpu_torch.ops import topk as ttopk

torch.set_num_threads(2)


def _unit(rng, shape):
    x = rng.standard_normal(shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.mark.parametrize("scale", [1.0, 1e-3, 50.0])
def test_quantize_int8_residual_bit_exact(scale):
    x = _unit(np.random.default_rng(1), (257, 384)) * scale
    x[3] = 0.0  # an all-zero row takes the 1e-9 floor
    j1, j2, js = jquant.quantize_int8_residual(jnp.asarray(x))
    t1, t2, ts = tquant.quantize_int8_residual(torch.from_numpy(x))
    np.testing.assert_array_equal(t1.numpy(), np.asarray(j1))
    np.testing.assert_array_equal(t2.numpy(), np.asarray(j2))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert np.abs(t2.numpy()).max() <= 64
    jq, jsc = jquant.quantize_int8(jnp.asarray(x))
    tq, tsc = tquant.quantize_int8(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(tsc.numpy(), np.asarray(jsc))
    np.testing.assert_array_equal(
        tquant.dequantize_int8(tq, tsc).numpy(), np.asarray(jquant.dequantize_int8(jq, jsc))
    )


@pytest.mark.parametrize("metric", ["cosine", "ip", "l2"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flat_topk_matches_jax(metric, dtype):
    rng = np.random.default_rng(2)
    corpus, queries = _unit(rng, (3000, 128)), _unit(rng, (5, 128))
    jc = jnp.asarray(corpus).astype(dtype)
    tc = torch.from_numpy(corpus).to(getattr(torch, dtype))
    jv, jr = jtopk.flat_topk(jnp.asarray(queries), jc, 20, metric=metric, block_n=1024, valid_n=2900)
    tv, tr = ttopk.flat_topk(torch.from_numpy(queries), tc, 20, metric=metric, block_n=1024, valid_n=2900)
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("m,k,block", [(5000, 10, 1024), (900, 10, 1024), (4096, 100, 256)])
def test_blocked_topk_matches_jax(m, k, block):
    rng = np.random.default_rng(3)
    scores = rng.standard_normal((4, m)).astype(np.float32)
    scores[:, ::7] = np.round(scores[:, ::7], 1)  # ties resolve by position
    scores[1, :50] = -np.inf
    jv, jp = jtopk.blocked_topk(jnp.asarray(scores), k, block=block)
    tv, tp = ttopk.blocked_topk(torch.from_numpy(scores), k, block=block)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-6)


def test_merge_rescore_and_exact_scores_match_jax():
    rng = np.random.default_rng(4)
    corpus, queries = _unit(rng, (100, 32)), _unit(rng, (3, 32))
    rows = np.array([[0, 5, -1], [7, 7, 2], [99, 1, -1]], np.int32)
    for metric in ("cosine", "ip", "l2"):
        want = np.asarray(jtopk.rescore_candidates(
            jnp.asarray(queries), jnp.asarray(corpus), jnp.asarray(rows), metric=metric))
        got = ttopk.rescore_candidates(
            torch.from_numpy(queries), torch.from_numpy(corpus), torch.from_numpy(rows), metric=metric
        ).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
        want = np.asarray(jtopk.exact_scores(jnp.asarray(queries), jnp.asarray(corpus), metric))
        got = ttopk.exact_scores(torch.from_numpy(queries), torch.from_numpy(corpus), metric).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    a_v, b_v = rng.standard_normal((2, 3, 6)).astype(np.float32)
    a_i, b_i = rng.integers(0, 100, (2, 3, 6)).astype(np.int32)
    jv, ji = jtopk.merge_topk(*(jnp.asarray(x) for x in (a_v, a_i, b_v, b_i)), 6)
    tv, ti = ttopk.merge_topk(*(torch.from_numpy(x) for x in (a_v, a_i, b_v, b_i)), 6)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
