"""The port's fused flat top-k (K1, K2) against the JAX Pallas kernels.

On the CPU the port's wrappers run the kernels' plain versions; the JAX
kernels run in Pallas interpret mode, as tests/test_topk.py runs them.
Inputs come from numpy with a seed. The card twin at the end compares the
CUDA kernels with the plain versions and skips where there is no card.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from intool_rag_tpu.ops.flat_pallas import flat_topk_pallas, flat_topk_pallas_int8
from intool_rag_tpu.ops.quant import quantize_int8, quantize_int8_residual
from intool_rag_tpu_torch.ops import flat_fused
from intool_rag_tpu_torch.ops.flat_fused import (
    choose_group_width,
    flat_topk_fused,
    flat_topk_fused_int8,
    partial_topk,
    partial_topk_int8,
    partial_topk_int8_reference,
    partial_topk_reference,
)

torch.set_num_threads(2)

N, D, Q, K = 4096, 128, 3, 10
VALID_N = N - 100  # inside the last block for every group width


def _unit(rng, shape):
    x = rng.standard_normal(shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(11)
    return _unit(rng, (N, D)), _unit(rng, (Q, D))


@pytest.mark.parametrize("tail", ["exact", "fold"])
@pytest.mark.parametrize("group_l", [1, 4, 32])
@pytest.mark.parametrize("precise", [False, True])
def test_k1_matches_pallas(data, precise, group_l, tail):
    corpus, queries = data
    cb = jnp.asarray(corpus).astype(jnp.bfloat16)
    want_v, want_r = flat_topk_pallas(
        jnp.asarray(queries), cb, K, group_l=group_l, valid_n=VALID_N, interpret=True,
        tail=tail, precise=precise,
    )
    got_v, got_r = flat_topk_fused(
        torch.from_numpy(queries), torch.from_numpy(corpus).bfloat16(), K,
        group_l=group_l, valid_n=VALID_N, tail=tail, precise=precise,
    )
    want_v, want_r = np.asarray(want_v), np.asarray(want_r)
    got_v, got_r = got_v.numpy(), got_r.numpy()
    np.testing.assert_allclose(got_v, want_v, rtol=2e-5, atol=0)
    # rows agree wherever the two rows' exact scores differ by more than 1e-5
    exact = queries @ np.asarray(cb.astype(jnp.float32)).T
    for qi, pos in zip(*np.nonzero(got_r != want_r)):
        gap = abs(exact[qi, got_r[qi, pos]] - exact[qi, want_r[qi, pos]])
        assert gap <= 1e-5, (qi, pos, gap)
    assert got_r.max() < VALID_N


@pytest.mark.parametrize("tail", ["exact", "fold"])
@pytest.mark.parametrize("group_l", [1, 4, 32])
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("precise", [False, True])
def test_k2_matches_pallas(data, precise, residual, group_l, tail):
    corpus, queries = data
    if residual:
        c1, c2, cs = quantize_int8_residual(jnp.asarray(corpus))
    else:
        (c1, cs), c2 = quantize_int8(jnp.asarray(corpus)), None
    want_v, want_r = flat_topk_pallas_int8(
        jnp.asarray(queries), c1, cs, K, corpus_res=c2, group_l=group_l, valid_n=VALID_N,
        interpret=True, tail=tail, precise=precise,
    )
    got_v, got_r = flat_topk_fused_int8(
        torch.from_numpy(queries), torch.from_numpy(np.array(c1)), torch.from_numpy(np.array(cs)),
        K, corpus_res=None if c2 is None else torch.from_numpy(np.array(c2)),
        group_l=group_l, valid_n=VALID_N, tail=tail, precise=precise,
    )
    np.testing.assert_array_equal(got_r.numpy(), np.asarray(want_r))
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), rtol=1e-6, atol=0)


def _contract_oracle(scores, group_l, valid_n):
    """The candidate contract written out with numpy loops."""
    q, n = scores.shape
    nb = n // (128 * group_l)
    vals = np.empty((q, nb * 128), np.float32)
    idx = np.empty((q, nb * 128), np.int32)
    for b in range(nb):
        for lane in range(128):
            rows = b * 128 * group_l + np.arange(group_l) * 128 + lane
            s = np.where(rows < valid_n, scores[:, rows], -np.inf)
            j = np.argmax(s, axis=1)  # first maximizing j; 0 for an all -inf group
            vals[:, b * 128 + lane] = s[np.arange(q), j]
            idx[:, b * 128 + lane] = rows[j]
    return vals, idx


@pytest.mark.parametrize("group_l", [1, 4])
def test_candidate_contract_ties_and_masked_groups(group_l):
    """Direct check of the candidate arrays: ties pick the smallest j, and a
    group that lies wholly past valid_n yields -inf with j* = 0."""
    rng = np.random.default_rng(3)
    n, d = 1024, 128
    block_n = 128 * group_l
    corpus = rng.integers(-2, 3, size=(n, d)).astype(np.float32)  # many exact ties
    corpus[n // 2 : n // 2 + 128] = corpus[n // 2 - 128 : n // 2]  # duplicated rows: tie in j
    queries = rng.integers(-2, 3, size=(2, d)).astype(np.float32)
    valid_n = n - block_n  # the last block is entirely padding
    got_v, got_i = partial_topk_reference(
        torch.from_numpy(queries), None, torch.from_numpy(corpus), group_l, valid_n
    )
    want_v, want_i = _contract_oracle(queries @ corpus.T, group_l, valid_n)
    np.testing.assert_array_equal(got_v.numpy(), want_v)
    np.testing.assert_array_equal(got_i.numpy(), want_i)
    last = slice((n // block_n - 1) * 128, None)
    assert np.isneginf(got_v.numpy()[:, last]).all()
    np.testing.assert_array_equal(got_i.numpy()[0, last], (n // block_n - 1) * block_n + np.arange(128))
    # the int8 plain version follows the same contract
    q8, c8 = queries.astype(np.int8), corpus.astype(np.int8)
    v8, i8 = partial_topk_int8_reference(
        torch.from_numpy(q8), None, torch.from_numpy(c8), None, torch.ones(n), group_l, valid_n
    )
    np.testing.assert_array_equal(v8.numpy(), want_v)
    np.testing.assert_array_equal(i8.numpy(), want_i)


def test_cpu_wrappers_take_plain_version_and_do_not_count(data):
    corpus, queries = data
    before = (partial_topk.launches.count, partial_topk_int8.launches.count)
    c = torch.from_numpy(corpus).bfloat16()
    q_hi, q_lo = flat_fused.split_query_bf16(torch.from_numpy(queries))
    got = partial_topk(q_hi, q_lo, c, 8, VALID_N)
    want = partial_topk_reference(q_hi, q_lo, c, 8, VALID_N)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert (partial_topk.launches.count, partial_topk_int8.launches.count) == before
    with pytest.raises(ValueError):
        partial_topk(q_hi, q_lo, c[:-128], 8, VALID_N)  # N not a multiple of the block
    with pytest.raises(ValueError):
        flat_topk_fused(torch.from_numpy(queries), c, K, group_l=8, tail="approx")


@pytest.mark.parametrize("n,k", [(1_000_000, 10), (4096, 10), (512, 10), (600, 50)])
def test_choose_group_width_matches_jax(n, k):
    from intool_rag_tpu.ops.flat_pallas import choose_group_width as jax_choose

    assert choose_group_width(n, k) == jax_choose(n, k)


def test_kernels_match_plain_on_card():
    """CUDA twin: each kernel against its plain version on the card (K2 bit
    for bit, K1 to 1e-4 on unit-norm data)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are CUDA-only")
    rng = np.random.default_rng(5)
    dev = torch.device("cuda")
    corpus = torch.from_numpy(_unit(rng, (8192, 256))).to(dev)
    queries = torch.from_numpy(_unit(rng, (5, 256))).to(dev)
    q_hi, q_lo = flat_fused.split_query_bf16(queries)
    cb = corpus.bfloat16().contiguous()
    for g in (8, 32):
        kv, ki = partial_topk(q_hi, q_lo, cb, g, 8000)
        pv, pi = partial_topk_reference(q_hi, q_lo, cb, g, 8000)
        finite = torch.isfinite(pv)
        assert torch.equal(finite, torch.isfinite(kv))
        assert (kv[finite] - pv[finite]).abs().max().item() <= 1e-4
        from intool_rag_tpu_torch.ops.quant import quantize_int8_residual as tq

        c1, c2, cs = tq(corpus)
        q1, q2, _ = flat_fused.split_query_int8(queries)
        kv, ki = partial_topk_int8(q1, q2, c1, c2, cs, g, 8000)
        pv, pi = partial_topk_int8_reference(q1, q2, c1, c2, cs, g, 8000)
        assert torch.equal(kv, pv) and torch.equal(ki, pi)
