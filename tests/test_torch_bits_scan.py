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


def test_scan_kernel_on_card():
    """Card-only: the CUDA kernel against its plain version (chip_smoke.py
    phase 2 runs the full set of shapes)."""
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
