"""The port's fused flat top-k (K1, K2) against the JAX Pallas kernels.

On the CPU the port's wrappers run the kernels' plain versions; the JAX
kernels run in Pallas interpret mode, as tests/test_topk.py runs them.
Inputs come from numpy with a seed. The card twin at the end compares the
CUDA kernels with the plain versions and skips where there is no card.
"""

from __future__ import annotations

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from intool_rag_tpu.ops.flat_pallas import flat_topk_pallas, flat_topk_pallas_int8
from intool_rag_tpu.ops.quant import quantize_int8, quantize_int8_residual
from intool_rag_tpu_torch.ops import flat_fused
from intool_rag_tpu_torch.ops.flat_fused import (
    TILE_WIDTHS,
    choose_group_width,
    flat_topk_fused,
    flat_topk_fused_int8,
    partial_topk,
    partial_topk_int8,
    partial_topk_int8_reference,
    partial_topk_reference,
    plan_launch,
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


@pytest.mark.parametrize("group_l", [4, 32])
def test_k1_float16_matches_pallas(data, group_l):
    """A float16 corpus: both packages take the queries in float16 and
    multiply into f32 (no split-query pass)."""
    corpus, queries = data
    ch = jnp.asarray(corpus).astype(jnp.float16)
    want_v, want_r = flat_topk_pallas(
        jnp.asarray(queries), ch, K, group_l=group_l, valid_n=VALID_N, interpret=True, precise=True,
    )
    got_v, got_r = flat_topk_fused(
        torch.from_numpy(queries), torch.from_numpy(corpus).half(), K, group_l=group_l,
        valid_n=VALID_N, precise=True,
    )
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), rtol=2e-5, atol=0)
    exact = queries.astype(np.float16).astype(np.float32) @ np.asarray(ch.astype(jnp.float32)).T
    got_r, want_r = got_r.numpy(), np.asarray(want_r)
    for qi, pos in zip(*np.nonzero(got_r != want_r)):
        assert abs(exact[qi, got_r[qi, pos]] - exact[qi, want_r[qi, pos]]) <= 1e-5
    assert got_r.max() < VALID_N


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """What a tf32 tensor-core operand keeps of an f32 value: its low 13
    mantissa bits cleared."""
    return (x.view(torch.int32) & flat_fused.TF32_HI_MASK).view(torch.float32)


def _scores_3xtf32(queries: np.ndarray, corpus: np.ndarray) -> torch.Tensor:
    """K1 f32's arithmetic emulated on the CPU with integer bit masks:
    ``c_hi·q_hi + c_hi·q_lo + c_lo·q_hi``, every operand read as tf32,
    products summed in f32."""
    q_hi, q_lo = flat_fused.split_query_tf32(torch.from_numpy(queries))
    c_hi, c_lo = flat_fused.split_query_tf32(torch.from_numpy(corpus))
    q_hi, q_lo, c_hi, c_lo = map(_tf32, (q_hi, q_lo, c_hi, c_lo))
    return q_hi @ c_hi.T + q_lo @ c_hi.T + q_hi @ c_lo.T


def test_split_query_tf32_is_exact(data):
    corpus, _ = data
    x = torch.from_numpy(corpus)
    hi, lo = flat_fused.split_query_tf32(x)
    assert torch.equal(hi + lo, x)
    assert torch.equal(_tf32(hi), hi)  # hi is a tf32 value: nothing below bit 13
    assert (lo.abs() <= x.abs() * 2.0**-10).all()


@pytest.mark.parametrize("group_l", [4, 32])
@pytest.mark.parametrize("case", ["random", "near_duplicate"])
def test_k1_f32_3xtf32_matches_pallas(data, case, group_l):
    """The 3xTF32 products of K1 f32 against the JAX f32 K1 path (Pallas,
    interpret mode, precision=HIGHEST): values within 1e-4 on unit-norm
    data, and a row differs only where its exact score lies within 2e-4 of
    the row JAX picked. Near-duplicate queries (corpus rows plus noise of
    1e-3, renormalised) score about 1, where a one-sided truncation error
    would add up."""
    corpus, queries = data
    if case == "near_duplicate":
        rng = np.random.default_rng(3)
        rows = rng.choice(VALID_N, size=8, replace=False)
        noisy = corpus[rows] + 1e-3 * rng.standard_normal((8, D)).astype(np.float32)
        queries = (noisy / np.linalg.norm(noisy, axis=1, keepdims=True)).astype(np.float32)
    want_v, want_r = flat_topk_pallas(
        jnp.asarray(queries), jnp.asarray(corpus), K, group_l=group_l, valid_n=VALID_N, interpret=True,
        tail="fold",
    )
    cand = flat_fused._grouped_max(_scores_3xtf32(queries, corpus), group_l, VALID_N)
    got_v, got_r = flat_fused._candidates_topk(*cand, K, tail="fold")
    got_v, got_r, want_v, want_r = got_v.numpy(), got_r.numpy(), np.asarray(want_v), np.asarray(want_r)
    np.testing.assert_allclose(got_v, want_v, rtol=0, atol=1e-4)
    exact = queries.astype(np.float64) @ corpus.astype(np.float64).T
    for qi, pos in zip(*np.nonzero(got_r != want_r)):
        assert abs(exact[qi, got_r[qi, pos]] - exact[qi, want_r[qi, pos]]) <= 2e-4, (qi, pos)
    if case == "near_duplicate":
        assert (got_r[:, 0] == rows).all()  # each query finds the row it was made from
    # and the emulated scores sit far inside the tolerance of the exact ones
    assert np.abs(_scores_3xtf32(queries, corpus).numpy() - exact).max() < 1e-5


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


def _split_merge_model(scores, group_l, valid_n, splits):
    """The kernel's split path written out: split ``s`` folds tiles
    ``[s·per, (s+1)·per)`` from best -inf and j its first tile, strict '>'
    keeping the first j; the last CTA to arrive walks the splits in order
    and takes a later one only where it is strictly larger."""
    q, n = scores.shape
    nb = n // (128 * group_l)
    s4 = np.where(np.arange(n) < valid_n, scores, -np.inf).astype(np.float32).reshape(q, nb, group_l, 128)
    per = group_l // splits
    parts = []
    for sp in range(splits):
        best = np.full((q, nb, 128), -np.inf, np.float32)
        bj = np.full((q, nb, 128), sp * per, np.int32)
        for j in range(sp * per, (sp + 1) * per):
            take = s4[:, :, j] > best
            best, bj = np.where(take, s4[:, :, j], best), np.where(take, j, bj)
        parts.append((best, bj))
    m, mj = parts[0]
    for best, bj in parts[1:]:
        take = best > m
        m, mj = np.where(take, best, m), np.where(take, bj, mj)
    idx = np.arange(nb)[:, None] * 128 * group_l + mj * 128 + np.arange(128)
    return m.reshape(q, nb * 128), idx.reshape(q, nb * 128).astype(np.int32)


@pytest.mark.parametrize("case", ["ties", "all_neg_inf_groups", "valid_n_inside_a_split"])
@pytest.mark.parametrize("splits", [2, 4, 8])
def test_split_merge_matches_unsplit(case, splits):
    """Splitting a block's group_l tiles across CTAs and merging the
    partials in split order gives the unsplit candidates, ids included."""
    rng = np.random.default_rng(17)
    group_l, d = 8, 128
    n = 4 * 128 * group_l
    corpus = rng.integers(-2, 3, size=(n, d)).astype(np.float32)  # small integers: many exact ties
    queries = rng.integers(-2, 3, size=(3, d)).astype(np.float32)
    valid_n = n
    if case == "ties":  # the same row in every tile of block 1: every j ties, across every split
        block = corpus[128 * group_l : 2 * 128 * group_l].reshape(group_l, 128, d)
        block[:] = block[0]
    elif case == "all_neg_inf_groups":  # blocks 2 and 3 lie wholly past valid_n
        valid_n = 2 * 128 * group_l
    else:  # the boundary falls inside tile 5 of block 3, inside a split for every split count
        valid_n = 3 * 128 * group_l + 5 * 128 + 77
    want_v, want_i = partial_topk_reference(
        torch.from_numpy(queries), None, torch.from_numpy(corpus), group_l, valid_n)
    got_v, got_i = _split_merge_model(queries @ corpus.T, group_l, valid_n, splits)
    np.testing.assert_array_equal(got_v, want_v.numpy())
    np.testing.assert_array_equal(got_i, want_i.numpy())
    if case == "ties":
        assert (got_i[:, 128:256] == 128 * group_l + np.arange(128)).all()  # the smallest j, 0
    if case == "all_neg_inf_groups":
        assert np.isneginf(got_v[:, 256:]).all()
        assert (got_i[:, 256:384] == 2 * 128 * group_l + np.arange(128)).all()


PLAN_SHAPES = [  # (Q, N, D, group_l): the phase-4 shape, the service store, chip_smoke's CHECK_SHAPES
    (256, 1_003_520, 1024, 32),
    *[(q, 53_248, 384, g) for q in (1, 8, 16) for g in (8, 16, 32)],
    *[(q, 65_536, d, g) for q in (3, 64, 256, 300) for d in (384, 1024) for g in (8, 32)],
]
VARIANTS = ["K1 bf16", "K1 bf16 precise", "K1 f16", "K1 f32", "K2 int8", "K2 int8+q2", "K2 int8+c2", "K2 int8r"]


@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plan_launch_covers_the_main_shapes(shape):
    q, n, d, group_l = shape
    source = (Path(flat_fused.__file__).parent.parent / "kernels" / "flat_partial_topk.cu").read_text()
    for variant in VARIANTS:
        width, splits = plan_launch(q, n, d, group_l, 132, variant)
        assert width in TILE_WIDTHS and f"launch<KIND, {width}>" in source
        assert width <= (64 if variant in ("K2 int8+q2", "K2 int8+c2", "K2 int8r") else 128)
        assert group_l % splits == 0
        if q <= width:
            assert width == min(w for w in TILE_WIDTHS if w >= q)  # no wider than the batch needs
        if -(-q // width) * (n // (128 * group_l)) >= 132:  # every CTA has an item: no split, no merge
            assert splits == 1
    # the two served paths at the main shapes
    assert plan_launch(256, 1_003_520, 1024, 32, 132, "K1 bf16 precise") == (128, 1)
    assert plan_launch(256, 1_003_520, 1024, 32, 132, "K2 int8r") == (64, 1)
    assert plan_launch(8, 53_248, 384, 32, 132, "K2 int8r") == (8, 8)
    # 52 items of 8 tiles: 2 splits give each of 132 CTAs at most 4 tiles, as 4 and 8 would
    assert plan_launch(16, 53_248, 384, 8, 132, "K1 bf16") == (16, 2)
    # 16 items of 32 tiles: 8 splits are the fewest that leave 4 tiles a CTA
    assert plan_launch(3, 65_536, 384, 32, 132, "K2 int8") == (8, 8)
    # Q 300 in three (five) query tiles: 192 (320) items, no split
    assert plan_launch(300, 65_536, 1024, 8, 132, "K1 bf16") == (128, 1)
    assert plan_launch(300, 65_536, 1024, 8, 132, "K2 int8r") == (64, 1)
    # K1 f32 (3xTF32) plans as the other K1 variants: 128-wide tiles at the
    # phase-4 shape, and at the service shape 13 blocks split 8 ways
    assert plan_launch(256, 1_003_520, 1024, 32, 132, "K1 f32") == (128, 1)
    assert plan_launch(16, 53_248, 384, 32, 132, "K1 f32") == (16, 8)
    assert plan_launch(8, 53_248, 384, 8, 132, "K1 f32") == (8, 2)
    # a shard of a 4-way sharded 1M-row store (62 blocks): the merge of a
    # split block grows with splits x width, so wide tiles split at most
    # 256 / width ways (32 and 16 splits ran 27 and 7.3 ms on the H100)
    assert plan_launch(256, 253_952, 1024, 32, 132, "K1 bf16 precise") == (128, 1)
    assert plan_launch(128, 253_952, 1024, 32, 132, "K1 bf16 precise") == (128, 2)
    assert plan_launch(128, 253_952, 1024, 32, 132, "K2 int8r") == (64, 1)
    assert plan_launch(64, 503_808, 1024, 32, 132, "K1 bf16 precise") == (64, 1)
    for q in (1, 8, 16, 64, 128, 256, 300):
        for variant in VARIANTS:
            width, splits = plan_launch(q, 253_952, 1024, 32, 132, variant)
            assert splits * width <= flat_fused.MAX_MERGE_ROWS


@pytest.mark.parametrize("args", [
    (8, 53_248, 384, 256, "K1 bf16"),        # group_l past one byte of j
    (8, 53_248, 384, 0, "K1 bf16"),
    (8, 53_248 - 128, 384, 32, "K1 bf16"),   # N not a multiple of the block
    (8, 53_248, 96, 8, "K1 bf16"),           # D not a multiple of 64
    (8, 53_248, 320, 8, "K2 int8"),          # D not a multiple of 128
    (0, 53_248, 384, 8, "K1 bf16"),
    (8, 53_248, 48, 8, "K1 f32"),            # D not a multiple of 32 (one 128-byte k-chunk of f32)
])
def test_plan_launch_refuses(args):
    q, n, d, group_l, variant = args
    with pytest.raises(ValueError):
        plan_launch(q, n, d, group_l, 132, variant)


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
    for bit, K1 to 1e-4 on unit-norm data); then the split merge at the
    service store's shape, on ties and valid_n boundaries, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are CUDA-only")
    _split_merge_on_card()
    rng = np.random.default_rng(5)
    dev = torch.device("cuda")
    corpus = torch.from_numpy(_unit(rng, (8192, 256))).to(dev)
    queries = torch.from_numpy(_unit(rng, (5, 256))).to(dev)
    q_hi, q_lo = flat_fused.split_query_bf16(queries)
    cb = corpus.bfloat16().contiguous()
    ch = corpus.half().contiguous()
    for g in (8, 32):
        for args in ((q_hi, q_lo, cb), (q_hi, None, cb), (queries.half().contiguous(), None, ch),
                     (queries, None, corpus)):
            kv, ki = partial_topk(*args, g, 8000)
            pv, pi = partial_topk_reference(*args, g, 8000)
            finite = torch.isfinite(pv)
            assert torch.equal(finite, torch.isfinite(kv))
            assert (kv[finite] - pv[finite]).abs().max().item() <= 1e-4
        from intool_rag_tpu_torch.ops.quant import quantize_int8_residual as tq

        c1, c2, cs = tq(corpus)
        q1, q2, _ = flat_fused.split_query_int8(queries)
        kv, ki = partial_topk_int8(q1, q2, c1, c2, cs, g, 8000)
        pv, pi = partial_topk_int8_reference(q1, q2, c1, c2, cs, g, 8000)
        assert torch.equal(kv, pv) and torch.equal(ki, pi)
        again = partial_topk_int8(q1, q2, c1, c2, cs, g, 8000)
        assert torch.equal(again[0], kv) and torch.equal(again[1], ki)


def _split_merge_on_card():
    """Q 8 over the service store's 53,248 rows at group_l 32: every block's
    32 tiles split across CTAs and merge in the kernel. Small integer
    operands make every product exact in bf16 and int8, so K1 and K2 must
    both match their plain versions bit for bit: ties across every split
    (one row repeated in all tiles of block 1), a valid_n boundary inside a
    split (tile 5 of block 12) and blocks wholly past valid_n (11 and 12)."""
    rng = np.random.default_rng(23)
    n, d, group_l = 53_248, 128, 32
    dev = torch.device("cuda")
    assert plan_launch(8, n, d, group_l, flat_fused._sm_count(dev), "K1 bf16")[1] > 1
    corpus = rng.integers(-2, 3, size=(n, d)).astype(np.float32)
    block = corpus[128 * group_l : 2 * 128 * group_l].reshape(group_l, 128, d)
    block[:] = block[0]
    queries = rng.integers(-2, 3, size=(8, d)).astype(np.float32)
    c = torch.from_numpy(corpus).to(dev)
    q = torch.from_numpy(queries).to(dev)
    cb, qb = c.bfloat16().contiguous(), q.bfloat16().contiguous()
    c8, q8 = c.to(torch.int8).contiguous(), q.to(torch.int8).contiguous()
    ones = torch.ones(n, device=dev)
    for valid_n in (n, 12 * 128 * group_l + 5 * 128 + 77, 11 * 128 * group_l):
        got = partial_topk(qb, None, cb, group_l, valid_n)
        want = partial_topk_reference(qb, None, cb, group_l, valid_n)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), valid_n
        got = partial_topk_int8(q8, None, c8, None, ones, group_l, valid_n)
        want = partial_topk_int8_reference(q8, None, c8, None, ones, group_l, valid_n)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), valid_n
        assert (got[1][:, 128:256] == 128 * group_l + torch.arange(128, device=dev)).all()  # ties: j 0
