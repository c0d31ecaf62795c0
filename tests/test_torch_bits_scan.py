"""ops/bits_scan.py of the PyTorch port against ops/bits_pallas.py of the
JAX package: the same seeded numpy inputs go through both. The Pallas
kernel runs with interpret=True; the port runs on the CPU, where the scan
wrapper takes its plain version. The card-only twin at the end launches
the CUDA kernel and skips where there is no card.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from intool_rag_tpu.ops import bits_pallas as jb
from intool_rag_tpu_torch.ops import bits_scan as tb

torch.set_num_threads(2)


def _store(rng, d, nlist, bpl, block_n, *, empty_frac=0.0, empty_lists=()):
    """A list-major store as both packages hold it: codes [N_cap, D/8] u8,
    block-major scales [N_cap/bn, 8, bn] with -1 in plane 0 of empty slots."""
    n_cap = nlist * bpl * block_n
    resid = 0.1 * rng.standard_normal((n_cap, d)).astype(np.float32)
    codes, scales = jb.encode_bits_planar(jnp.asarray(resid))
    codes, scales = np.array(codes), np.array(scales)
    empty = rng.random(n_cap) < empty_frac
    for l in empty_lists:
        empty[l * bpl * block_n : (l + 1) * bpl * block_n] = True
    scales = np.where(empty[:, None], -1.0, scales).astype(np.float32)
    sc_bm = np.ascontiguousarray(
        scales.T.reshape(8, n_cap // block_n, block_n).transpose(1, 0, 2))
    return codes, sc_bm


def _probes(rng, q, nlist, nprobe, bpl):
    probes = np.stack([rng.permutation(nlist)[:nprobe] for _ in range(q // 8)]).astype(np.int32)
    c_sel = rng.standard_normal((q, nprobe)).astype(np.float32)
    return probes * bpl, c_sel


def test_encode_decode_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((96, 256)).astype(np.float32)
    x[3, 7] = 0.0  # sign(0) packs as a set bit in both
    jc, js = jb.encode_bits_planar(jnp.asarray(x))
    tc, ts = tb.encode_bits_planar(torch.from_numpy(x))
    assert tc.dtype == torch.uint8 and tuple(tc.shape) == (96, 32)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))  # codes bit-equal
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6)  # means: sum order only
    # decode is exact given equal inputs
    jd = jb.decode_bits_planar(jc, js)
    td = tb.decode_bits_planar(torch.from_numpy(np.array(jc)), torch.from_numpy(np.array(js)))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    with pytest.raises(ValueError, match="divisible"):
        tb.encode_bits_planar(torch.zeros(2, 12))


@pytest.mark.parametrize("q", [8, 24])
@pytest.mark.parametrize("tail", ["fold", "blocked"])
@pytest.mark.parametrize("group_l", [1, 8])
def test_ivf_bits_topk_matches_pallas_interpret(group_l, tail, q):
    """Slot ids equal wherever the top-two gap exceeds 1e-5; vals rtol 2e-5
    (f32 sums of bf16 products in a different order). Empty slots are
    scattered through the store and list 2 is all empty."""
    rng = np.random.default_rng(10 * group_l + q)
    d, nlist, bpl, block_n, nprobe, k = 128, 6, 2, 64, 4, 12
    codes, sc_bm = _store(rng, d, nlist, bpl, block_n, empty_frac=0.2, empty_lists=(2,))
    queries = rng.standard_normal((q, d)).astype(np.float32)
    pb, c_sel = _probes(rng, q, nlist, nprobe, bpl)
    pb[0, 0] = 2 * bpl  # the all-empty list is probed
    jv, ji = jb.ivf_bits_topk_pallas(
        jnp.asarray(queries), jnp.asarray(codes), jnp.asarray(sc_bm), jnp.asarray(pb),
        jnp.asarray(c_sel), k, blocks_per_list=bpl, block_n=block_n, group_l=group_l,
        interpret=True, tail=tail,
    )
    tv, ti = tb.ivf_bits_topk(
        torch.from_numpy(queries), torch.from_numpy(codes), torch.from_numpy(sc_bm),
        torch.from_numpy(pb), torch.from_numpy(c_sel), k,
        blocks_per_list=bpl, block_n=block_n, group_l=group_l, tail=tail,
    )
    jv, ji, tv, ti = np.asarray(jv), np.asarray(ji), tv.numpy(), ti.numpy()
    assert tv.shape == jv.shape == (q, k) and ti.dtype == np.int32
    np.testing.assert_allclose(tv, jv, rtol=2e-5, atol=1e-5)
    gaps = np.abs(np.diff(jv, axis=1))
    clear = np.ones_like(ji, bool)
    clear[:, 1:] &= gaps > 1e-5
    clear[:, :-1] &= gaps > 1e-5
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(ti[clear], ji[clear])


def test_all_empty_probes_give_neg_inf():
    rng = np.random.default_rng(3)
    d, nlist, bpl, block_n = 128, 4, 1, 32
    codes, sc_bm = _store(rng, d, nlist, bpl, block_n, empty_lists=(0, 1, 2, 3))
    queries = rng.standard_normal((8, d)).astype(np.float32)
    pb, c_sel = _probes(rng, 8, nlist, 2, bpl)
    cv, ci = tb.bits_scan(
        torch.from_numpy(queries).bfloat16(), torch.from_numpy(codes), torch.from_numpy(sc_bm),
        torch.from_numpy(pb), torch.from_numpy(c_sel), blocks_per_list=bpl, block_n=block_n,
        group_l=4,
    )
    assert torch.isinf(cv).all() and (cv < 0).all()
    # an all -inf group reports its first slot (g = 0)
    lane = torch.arange(8, dtype=torch.int32).repeat(2)[None, :]
    base = torch.from_numpy(pb).repeat_interleave(8, dim=1) * block_n
    assert torch.equal(ci, (base + lane).expand(8, -1).to(torch.int32))


def test_candidate_layout_matches_pallas():
    """The candidate arrays themselves (the fold tail pairs column c with
    c + n_cand/2, so column order is part of the contract): recovered from
    the JAX side with k = n_cand and the exact tail."""
    rng = np.random.default_rng(4)
    d, nlist, bpl, block_n, nprobe, group_l = 256, 5, 2, 32, 3, 4
    codes, sc_bm = _store(rng, d, nlist, bpl, block_n, empty_frac=0.1)
    queries = rng.standard_normal((8, d)).astype(np.float32)
    pb, c_sel = _probes(rng, 8, nlist, nprobe, bpl)
    n_cand = nprobe * bpl * block_n // group_l
    cv, ci = tb.bits_scan(
        torch.from_numpy(queries).bfloat16(), torch.from_numpy(codes), torch.from_numpy(sc_bm),
        torch.from_numpy(pb), torch.from_numpy(c_sel), blocks_per_list=bpl, block_n=block_n,
        group_l=group_l,
    )
    assert tuple(cv.shape) == (8, n_cand)
    jv, ji = jb.ivf_bits_topk_pallas(
        jnp.asarray(queries), jnp.asarray(codes), jnp.asarray(sc_bm), jnp.asarray(pb),
        jnp.asarray(c_sel), n_cand, blocks_per_list=bpl, block_n=block_n, group_l=group_l,
        interpret=True, tail="blocked",
    )
    # every JAX candidate (slot, value) is the port's candidate for that slot
    jv, ji = np.asarray(jv), np.asarray(ji)
    for qi in range(8):
        by_slot = {int(s): float(v) for s, v in zip(ci[qi].tolist(), cv[qi].tolist())}
        finite = np.isfinite(jv[qi])
        assert finite.sum() == torch.isfinite(cv[qi]).sum()
        for s, v in zip(ji[qi][finite], jv[qi][finite]):
            assert by_slot[int(s)] == pytest.approx(float(v), rel=2e-5, abs=1e-5)
    # columns: block (p, bi) owns columns [(p·bpl + bi)·lw, +lw), ids inside that block
    lw = block_n // group_l
    blk = (torch.from_numpy(pb)[0][:, None] + torch.arange(bpl)[None, :]).reshape(-1)
    assert torch.equal(torch.div(ci[0], block_n, rounding_mode="floor").reshape(-1, lw),
                       blk[:, None].expand(-1, lw).to(torch.int32))
    assert torch.equal(ci[0] % lw, torch.arange(lw, dtype=torch.int32).repeat(nprobe * bpl))


def test_shape_and_layout_errors_raise_as_in_jax():
    d, block_n, bpl = 128, 32, 1
    rng = np.random.default_rng(5)
    codes, sc_bm = _store(rng, d, 4, bpl, block_n)
    pb, c_sel = _probes(rng, 8, 4, 2, bpl)
    good = dict(
        queries=rng.standard_normal((8, d)).astype(np.float32), codes=codes, scales=sc_bm,
        probe_blocks=pb, c_sel=c_sel,
    )

    def both(match, block_n=block_n, group_l=4, **override):
        args = {**good, **override}
        with pytest.raises(ValueError, match=match):
            jb.ivf_bits_topk_pallas(
                *(jnp.asarray(args[n]) for n in ("queries", "codes", "scales", "probe_blocks", "c_sel")),
                5, blocks_per_list=bpl, block_n=block_n, group_l=group_l, interpret=True)
        with pytest.raises(ValueError, match=match):
            tb.ivf_bits_topk(
                *(torch.from_numpy(args[n]) for n in ("queries", "codes", "scales", "probe_blocks", "c_sel")),
                5, blocks_per_list=bpl, block_n=block_n, group_l=group_l)

    both("multiple of 8", queries=good["queries"][:7], c_sel=c_sel[:7])
    both("codes width", codes=codes[:, :8])
    both("block-aligned", block_n=48)
    both("block-major", scales=sc_bm.reshape(-1, block_n))
    both("shape mismatch", c_sel=c_sel[:, :1])
    with pytest.raises(ValueError, match="multiple of group_l"):
        tb.ivf_bits_topk(*(torch.from_numpy(good[n]) for n in good), 5, blocks_per_list=bpl,
                         block_n=block_n, group_l=5)
    with pytest.raises(ValueError, match="tail"):
        tb.ivf_bits_topk(*(torch.from_numpy(good[n]) for n in good), 5, blocks_per_list=bpl,
                         block_n=block_n, group_l=4, tail="approx")


def _plan_items(groups, order, nprobe, bpl):
    """The plan's work items: (block, [(tile, probe, bi), ...])."""
    items = []
    for blk, first, count in groups.tolist():
        pairs = order[first : first + count].tolist()
        for bi in range(bpl):
            items.append((blk + bi, [(i // nprobe, i % nprobe, bi) for i in pairs]))
    return items


def _shared_probes(rng, t, nlist, nprobe, bpl, popular=1):
    """Probe table [t, nprobe] (list starts) where list ``popular`` is probed
    by every tile, so its run is longer than any group cap."""
    lists = np.stack([rng.permutation(nlist)[:nprobe] for _ in range(t)]).astype(np.int64)
    for row in lists:
        if popular not in row:
            row[rng.integers(nprobe)] = popular
    return torch.from_numpy(lists * bpl).to(torch.int32)


@pytest.mark.parametrize("group_cap", [1, 2, 4])
@pytest.mark.parametrize("t,nlist,nprobe,bpl", [(1, 6, 3, 2), (7, 12, 5, 1), (32, 40, 16, 3)])
def test_scan_plan_covers_every_pair_once_and_caps_groups(group_cap, t, nlist, nprobe, bpl):
    rng = np.random.default_rng(100 * group_cap + t)
    pb = _shared_probes(rng, t, nlist, nprobe, bpl)
    groups, order = tb.scan_plan_reference(pb, group_cap)
    assert groups.dtype == order.dtype == torch.int32
    assert sorted(order.tolist()) == list(range(t * nprobe))
    counts = groups[:, 2]
    assert (counts >= 1).all() and (counts <= group_cap).all()
    items = _plan_items(groups, order, nprobe, bpl)
    covered = [x for _, pairs in items for x in pairs]
    want = [(ti, p, bi) for ti in range(t) for p in range(nprobe) for bi in range(bpl)]
    assert sorted(covered) == want  # every (tile, probe, block) exactly once
    for blk, pairs in items:  # every pair of an item probes its block
        assert all(int(pb[ti, p]) + bi == blk for ti, p, bi in pairs)
    # runs are cut from their start: only a run's last group is short
    keys = groups[:, 0].tolist()
    for i in range(len(keys) - 1):
        if keys[i] == keys[i + 1]:
            assert int(counts[i]) == group_cap
    assert keys == sorted(keys)
    # the popular list (probed by every tile) is split into ceil(t / cap) items per block
    assert keys.count(bpl) == -(-t // group_cap)


def test_scan_plan_on_tile_probes_reads_each_distinct_block_once():
    """On probes from tile_probes (cluster-coherent tiles) the plan's blocks
    are the distinct probed blocks; with a cap above every run, each one
    appears in exactly one item."""
    from intool_rag_tpu_torch.index.bits_index import tile_probes

    rng = np.random.default_rng(11)
    nlist, d, bpl, nprobe = 64, 32, 3, 8
    cent = torch.from_numpy(rng.standard_normal((nlist, d)).astype(np.float32))
    queries = cent[torch.from_numpy(rng.integers(0, nlist, 96))] + 0.3 * torch.randn(
        96, d, generator=torch.Generator().manual_seed(0))
    _, _, probes, _ = tile_probes(queries, cent, nprobe)
    pb = (probes * bpl).to(torch.int32)
    distinct = torch.unique((pb.long()[:, :, None] + torch.arange(bpl)).reshape(-1)).tolist()
    for cap in (1, 4, pb.shape[0]):
        groups, order = tb.scan_plan_reference(pb, cap)
        blocks = [blk for blk, _ in _plan_items(groups, order, nprobe, bpl)]
        assert sorted(set(blocks)) == distinct
        if cap == pb.shape[0]:
            assert sorted(blocks) == distinct
    assert len(groups) * bpl == len(distinct) < pb.numel() * bpl  # tiles share lists


def _planned_scan(qb, codes, scales, pb, c_sel, *, blocks_per_list, block_n, group_l, group_cap):
    """A plain scan that walks the plan's items: each block once, scored for
    every query tile of its item."""
    q, d = qb.shape
    w = d // 8
    nprobe = pb.shape[1]
    lw = block_n // group_l
    codes3 = codes.reshape(-1, block_n, w)
    vals = torch.full((q, nprobe * blocks_per_list * lw), float("nan"))
    idx = torch.full(vals.shape, -7, dtype=torch.int32)
    groups, order = tb.scan_plan_reference(pb, group_cap)
    for blk, pairs in _plan_items(groups, order, nprobe, blocks_per_list):
        ci = codes3[blk].to(torch.int32)
        for tile, p, bi in pairs:
            rows = slice(8 * tile, 8 * tile + 8)
            cent = c_sel[rows, p : p + 1].expand(8, block_n)
            s = tb._slot_scores(qb[rows], cent, ci, scales[blk].float())
            col = (p * blocks_per_list + bi) * lw
            vals[rows, col : col + lw], idx[rows, col : col + lw] = tb._grouped_max(
                s[:, None, :], torch.tensor([blk]), block_n, group_l)
    return vals, idx


@pytest.mark.parametrize("group_cap", [1, 4])
@pytest.mark.parametrize("group_l", [1, 8])
def test_planned_scan_equals_reference_bit_for_bit_and_pallas(group_cap, group_l):
    """The scan restructured as the kernel walks it (items of the plan, a
    popular list split across items) gives the plain version's candidates
    bit for bit, and through the tail the JAX kernel's top-k at this file's
    tolerances."""
    rng = np.random.default_rng(20 + group_cap + group_l)
    d, nlist, bpl, block_n, nprobe, k, q = 128, 8, 2, 64, 3, 12, 48
    codes, sc_bm = _store(rng, d, nlist, bpl, block_n, empty_frac=0.2, empty_lists=(2,))
    queries = rng.standard_normal((q, d)).astype(np.float32)
    pb = _shared_probes(rng, q // 8, nlist, nprobe, bpl)
    pb[0, 0] = 2 * bpl  # the all-empty list is probed
    c_sel = rng.standard_normal((q, nprobe)).astype(np.float32)
    qb = torch.from_numpy(queries).bfloat16()
    args = (qb, torch.from_numpy(codes), torch.from_numpy(sc_bm), pb, torch.from_numpy(c_sel))
    kw = dict(blocks_per_list=bpl, block_n=block_n, group_l=group_l)
    pv, pi = tb.bits_scan_reference(*args, **kw)
    wv, wi = _planned_scan(*args, **kw, group_cap=group_cap)
    assert torch.equal(wv, pv) and torch.equal(wi, pi)
    tv, ti = tb._candidates_topk(wv, wi, k, tail="exact")
    jv, ji = jb.ivf_bits_topk_pallas(
        jnp.asarray(queries), jnp.asarray(codes), jnp.asarray(sc_bm), jnp.asarray(pb.numpy()),
        jnp.asarray(c_sel), k, blocks_per_list=bpl, block_n=block_n, group_l=group_l,
        interpret=True, tail="blocked",
    )
    jv, ji, tv, ti = np.asarray(jv), np.asarray(ji), tv.numpy(), ti.numpy()
    np.testing.assert_allclose(tv, jv, rtol=2e-5, atol=1e-5)
    gaps = np.abs(np.diff(jv, axis=1))
    clear = np.ones_like(ji, bool)
    clear[:, 1:] &= gaps > 1e-5
    clear[:, :-1] &= gaps > 1e-5
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(ti[clear], ji[clear])


def test_scan_kernel_on_card():
    """Card-only: the CUDA kernel against its plain version, a repeat bit
    for bit, and the kernel's scan plan against ``scan_plan_reference``
    (chip_smoke.py phase 2 runs the full set of shapes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the scan kernel is CUDA-only")
    rng = np.random.default_rng(6)
    d, nlist, bpl, block_n, nprobe, group_l = 384, 8, 2, 128, 4, 8
    codes, sc_bm = _store(rng, d, nlist, bpl, block_n, empty_frac=0.2, empty_lists=(1,))
    queries = rng.standard_normal((16, d)).astype(np.float32)
    pb, c_sel = _probes(rng, 16, nlist, nprobe, bpl)
    args = [torch.from_numpy(queries).bfloat16(), torch.from_numpy(codes), torch.from_numpy(sc_bm),
            torch.from_numpy(pb), torch.from_numpy(c_sel)]
    kw = dict(blocks_per_list=bpl, block_n=block_n, group_l=group_l)
    before = tb.bits_scan.launches.count
    kv, ki = tb.bits_scan(*(a.cuda() for a in args), **kw)
    assert tb.bits_scan.launches.count == before + 1
    again = tb.bits_scan(*(a.cuda() for a in args), **kw)
    assert torch.equal(again[0], kv) and torch.equal(again[1], ki)  # no atomics: repeats are bit-equal
    groups, order = tb.scan_plan(args[3].cuda())
    want_groups, want_order = tb.scan_plan_reference(args[3])
    assert torch.equal(groups.cpu(), want_groups) and torch.equal(order.cpu(), want_order)
    pv, pi = tb.bits_scan_reference(*args, **kw)
    finite = torch.isfinite(pv)
    assert torch.equal(torch.isfinite(kv.cpu()), finite)
    torch.testing.assert_close(kv.cpu()[finite], pv[finite], rtol=2e-5, atol=1e-5)
    assert (ki.cpu() == pi).float().mean() > 0.999
    with pytest.raises(ValueError, match="16-dim steps"):
        tb.bits_scan(torch.zeros(8, 64, dtype=torch.bfloat16).cuda(),
                     torch.zeros(32, 8, dtype=torch.uint8).cuda(),
                     torch.zeros(1, 8, 32).cuda(), torch.zeros(1, 1, dtype=torch.int32).cuda(),
                     torch.zeros(8, 1).cuda(), blocks_per_list=1, block_n=32, group_l=1)
