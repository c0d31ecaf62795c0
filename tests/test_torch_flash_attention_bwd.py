"""K5's backward (dkv and dq): the port's plain backward, reached through
``torch.autograd`` and the ``FlashAttentionSegments`` Function, against
``jax.grad`` of the JAX library's TPU flash-attention kernels (run in
interpret mode), against autodiff of that library's
``mha_reference_no_custom_vjp``, and against ``torch.autograd`` through the
port's plain forward, on the same seeded inputs.

On the CPU the Function's backward takes the plain version; the two CUDA
kernels are held against this same plain version on the card
(``chip_smoke.py`` phase 2 and the card-only test below).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from jax.experimental.pallas.ops.tpu import flash_attention as jflash

from intool_rag_tpu_torch.ops import flash_attention as tflash
from test_torch_flash_attention import LAYOUTS, SKIP_LAYOUTS, _inputs, _segments, _skip_layouts

torch.set_num_threads(2)

SCALE = 0.125
# f32: both sides rebuild p from l and m and sum f32 products in another order.
ATOL_F32 = 5e-6
# bf16: p, ds and each gradient are rounded to 8 bits of mantissa on both sides,
# from f32 values that differ in their last bits (the library renormalises its
# forward block by block), so a gradient may land two bf16 steps away. A step is
# at most 2^-7 of the value: two steps of the largest gradient.
REL_BF16 = 2.0 ** -6


def _do(rng: np.random.Generator, shape, dtype: str) -> np.ndarray:
    do = rng.standard_normal(shape).astype(np.float32)
    if dtype == "bfloat16":
        do = np.array(jnp.asarray(do, jnp.bfloat16).astype(jnp.float32))
    return do


def _port_grads(q, k, v, seg_q, seg_kv, do, dtype: str):
    """(dq, dk, dv) as f32 numpy through torch.autograd and the Function."""
    td = getattr(torch, dtype)
    leaves = [torch.from_numpy(x).to(td).requires_grad_() for x in (q, k, v)]
    out = tflash.flash_attention_segments(*leaves, torch.from_numpy(seg_q), torch.from_numpy(seg_kv), SCALE)
    assert out.grad_fn is not None and out.grad_fn.name().startswith("FlashAttentionSegments")
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(do).to(td))
    assert all(g.dtype == td and g.shape == x.shape for g, x in zip(grads, leaves))
    return [g.float().numpy() for g in grads]


def _library_grads(fn, q, k, v, seg_q, seg_kv, do, dtype: str):
    jd = jnp.dtype(dtype)
    ids = jflash.SegmentIds(q=jnp.asarray(seg_q), kv=jnp.asarray(seg_kv))
    do_j = jnp.asarray(do, jd)

    def scalar(q, k, v):
        return jnp.sum(fn(q, k, v, ids).astype(jnp.float32) * do_j.astype(jnp.float32))

    grads = jax.grad(scalar, argnums=(0, 1, 2))(*(jnp.asarray(x, jd) for x in (q, k, v)))
    return [np.asarray(g.astype(jnp.float32)) for g in grads]


def _kernels(q, k, v, ids):
    return jflash.flash_attention(q, k, v, segment_ids=ids, sm_scale=SCALE)


def _reference(q, k, v, ids):
    return jflash.mha_reference_no_custom_vjp(q, k, v, None, ids, sm_scale=SCALE)


def _assert_close(got, want, dtype: str):
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        atol = ATOL_F32 if dtype == "float32" else REL_BF16 * np.abs(w).max()
        np.testing.assert_allclose(g, w, atol=atol, rtol=0, err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_backward_matches_library_kernels_in_interpret_mode(layout, dtype):
    b, h, s = 1, 2, 256
    rng, q, k, v = _inputs(21, b, h, s, dtype)
    seg = _segments(rng, layout, b, s)
    do = _do(rng, q.shape, dtype)
    with pltpu.force_tpu_interpret_mode():
        want = _library_grads(_kernels, q, k, v, seg, seg, do, dtype)
    _assert_close(_port_grads(q, k, v, seg, seg, do, dtype), want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rows_no_key_matches_against_library_kernels(dtype):
    """Query ids rolled against the key ids: some rows match no key. There
    every p is 1/l and, as in the library (which adds the mask value to the
    logit), the gradient still flows through the masked logits."""
    b, h, s = 1, 2, 256
    rng, q, k, v = _inputs(22, b, h, s, dtype)
    seg_kv = _segments(rng, "packed", b, s)
    seg_q = np.roll(seg_kv, 37, axis=1).copy()
    seg_q[:, :9] = 77
    do = _do(rng, q.shape, dtype)
    with pltpu.force_tpu_interpret_mode():
        want = _library_grads(_kernels, q, k, v, seg_q, seg_kv, do, dtype)
    _assert_close(_port_grads(q, k, v, seg_q, seg_kv, do, dtype), want, dtype)


@pytest.mark.parametrize("s", [128, 512])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_backward_matches_autodiff_of_mha_reference(layout, s):
    b, h = 2, 2
    rng, q, k, v = _inputs(s + 1, b, h, s, "float32")
    seg = _segments(rng, layout, b, s)
    seg_q = np.roll(seg, 5, axis=1) if layout == "straddle" else seg  # rows no key matches too
    do = _do(rng, q.shape, "float32")
    want = _library_grads(_reference, q, k, v, seg_q, seg, do, "float32")
    _assert_close(_port_grads(q, k, v, seg_q, seg, do, "float32"), want, "float32")


@pytest.mark.parametrize("layout", LAYOUTS)
def test_backward_matches_torch_autograd_through_the_plain_forward(layout):
    """Every query finds a key here: ``masked_fill`` in the plain forward
    cuts the gradient of a masked logit, which only matters on rows no key
    matches (the test above covers those against the library)."""
    b, h, s = 2, 3, 256
    rng, q, k, v = _inputs(23, b, h, s, "float32")
    seg = torch.from_numpy(_segments(rng, layout, b, s))
    do = torch.from_numpy(_do(rng, q.shape, "float32"))
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    want = torch.autograd.grad(tflash.flash_attention_plain(*leaves, seg, seg, SCALE), leaves, do)
    got = _port_grads(q, k, v, seg.numpy(), seg.numpy(), do.numpy(), "float32")
    _assert_close(got, [w.numpy() for w in want], "float32")


@pytest.mark.parametrize("layout", ["mask", "all-pad row", "no key"])
def test_saved_residuals_match_the_librarys(layout):
    b, h, s = 2, 2, 256
    rng, q, k, v = _inputs(24, b, h, s, "float32")
    seg_kv = _segments(rng, "packed" if layout == "no key" else layout, b, s)
    seg_q = np.full_like(seg_kv, 99) if layout == "no key" else seg_kv
    ids = jflash.SegmentIds(q=jnp.asarray(seg_q), kv=jnp.asarray(seg_kv))
    blocks = jflash.BlockSizes.get_default(b, h, s, s, 64)
    with pltpu.force_tpu_interpret_mode():  # what the library's own differentiated forward saves
        _, l_want, m_want = jflash._flash_attention(
            *(jnp.asarray(x) for x in (q, k, v)), None, ids, True, False, SCALE, blocks, False
        )
    _, l, m = tflash.flash_attention_plain(
        *(torch.from_numpy(x) for x in (q, k, v)), torch.from_numpy(seg_q), torch.from_numpy(seg_kv), SCALE,
        save_residuals=True,
    )
    np.testing.assert_allclose(l.numpy(), np.asarray(l_want), rtol=2e-6)
    np.testing.assert_allclose(m.numpy(), np.asarray(m_want), rtol=1e-6, atol=1e-6)
    if layout == "no key":  # the mask value itself, and the sum counts every key
        assert (m.numpy() == np.float32(tflash.MASK_VALUE)).all() and (l.numpy() == s).all()


def test_plain_backward_returns_what_the_function_returns():
    b, h, s = 1, 2, 128
    rng, q, k, v = _inputs(25, b, h, s, "float32")
    seg = torch.from_numpy(_segments(rng, "packed", b, s))
    do = torch.from_numpy(_do(rng, q.shape, "float32"))
    q, k, v = (torch.from_numpy(x) for x in (q, k, v))
    out, l, m = tflash.flash_attention_plain(q, k, v, seg, seg, SCALE, save_residuals=True)
    direct = tflash.flash_attention_backward(q, k, v, seg, seg, out, l, m, do, SCALE)
    through = _port_grads(q.numpy(), k.numpy(), v.numpy(), seg.numpy(), seg.numpy(), do.numpy(), "float32")
    for a, b_ in zip(direct, through):
        np.testing.assert_array_equal(a.numpy(), b_)


def test_inference_call_skips_the_function():
    """No gradient wanted: the forward saves nothing and builds no graph."""
    _, q, k, v = _inputs(26, 1, 1, 128, "float32")
    seg = torch.ones((1, 128), dtype=torch.int32)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    with torch.no_grad():
        assert tflash.flash_attention_segments(*leaves, seg, seg, SCALE).grad_fn is None
    plain = [x.detach() for x in leaves]
    assert tflash.flash_attention_segments(*plain, seg, seg, SCALE).grad_fn is None


def _backward_args(**replace):
    x = torch.empty((1, 2, 128, 64), device="meta")
    stat = torch.empty((1, 2, 128), device="meta")
    seg = torch.empty((1, 128), dtype=torch.int32, device="meta")
    args = dict(q=x, k=x, v=x, seg_q=seg, seg_kv=seg, o=x, l=stat, m=stat, do=x)
    args.update(replace)
    return args


@pytest.mark.parametrize("replace", [
    dict(do=torch.empty((1, 2, 128, 64), dtype=torch.bfloat16, device="meta")),
    dict(do=torch.empty((1, 1, 128, 64), device="meta")),
    dict(o=torch.empty((1, 2, 64, 64), device="meta")),
    dict(l=torch.empty((1, 2, 64), device="meta")),
    dict(m=torch.empty((1, 2, 128), dtype=torch.float64, device="meta")),
    dict(seg_q=torch.empty((1, 128), dtype=torch.int64, device="meta")),
], ids=["do-dtype", "do-shape", "o-shape", "l-shape", "m-dtype", "seg-dtype"])
def test_backward_refuses_what_the_kernels_cannot_take(replace):
    with pytest.raises(ValueError):
        tflash.flash_attention_backward(**_backward_args(**replace), sm_scale=SCALE)


@pytest.mark.parametrize("kernel", ["flash_attention_dkv", "flash_attention_dq"])
def test_kernel_wrappers_refuse_cpu_tensors(kernel):
    """The dkv and dq wrappers launch or raise; only
    ``flash_attention_backward`` routes CPU tensors to the plain version."""
    x = torch.zeros((1, 1, 128, 64))
    stat = torch.ones((1, 1, 128))
    seg = torch.zeros((1, 128), dtype=torch.int32)
    with pytest.raises(ValueError):
        getattr(tflash, kernel)(x, x, x, seg, seg, stat, stat, x, stat, SCALE)
    assert getattr(tflash, kernel).launches.count == 0


def test_tile_counts_take_cuda_tensors_only():
    """The kernels write their tile counts on the device: a CPU buffer is
    refused before any library is loaded."""
    with pytest.raises(ValueError):
        tflash.count_tiles(torch.zeros((1, 1, 1, 3), dtype=torch.int32))


def test_cpu_route_counts_plain_calls_not_launches():
    rng, q, k, v = _inputs(27, 1, 1, 128, "float32")
    for counter in (tflash.flash_attention_plain.calls, tflash.flash_attention_backward_plain.calls,
                    tflash.flash_attention_segments.launches, tflash.flash_attention_dkv.launches,
                    tflash.flash_attention_dq.launches):
        counter.reset()
    seg = np.ones((1, 128), np.int32)
    _port_grads(q, k, v, seg, seg, _do(rng, q.shape, "float32"), "float32")
    assert tflash.flash_attention_plain.calls.count == 1
    assert tflash.flash_attention_backward_plain.calls.count == 1
    assert tflash.flash_attention_segments.launches.count == 0
    assert tflash.flash_attention_dkv.launches.count == tflash.flash_attention_dq.launches.count == 0


def _card_cases():
    """(name, S, seg_q, seg_kv) for the card test: packed rows at S 1024 and
    S 128, and the edges of the bf16 kernels' tile skip at S 1024."""
    rng = np.random.default_rng(1)
    cases = [("packed", s, seg, seg) for s in (1024, 128) for seg in [_segments(rng, "packed", 2, s)]]
    for name in ("no key in a skipped tile", "interleaved"):
        seg_q, seg_kv = _skip_layouts(rng, 2, 1024)[name]
        cases.append((name, 1024, seg_q, seg_kv))
    return cases


def test_backward_kernels_on_card():
    """The CUDA kernels against the plain backward, strided views included,
    and two runs bit-equal (needs the card; ``python3 chip_smoke.py
    --phases 1,2`` runs the full set)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU or interpret mode")
    for dtype, (name, s, seg_q, seg_kv) in ((d, c) for d in (torch.float32, torch.bfloat16) for c in _card_cases()):
        rng, q, k, v = _inputs(1, 2, 6, s, "float32")
        seg_q, seg_kv = torch.from_numpy(seg_q).cuda(), torch.from_numpy(seg_kv).cuda()
        do = _do(rng, q.shape, "float32")
        # the encoder's layout: [B, S, H*64] viewed as [B, H, S, 64]
        q, k, v, do = (torch.from_numpy(x).cuda().to(dtype).transpose(1, 2).contiguous().transpose(1, 2)
                       for x in (q, k, v, do))
        leaves = [x.requires_grad_() for x in (q, k, v)]
        for counter in (tflash.flash_attention_dkv.launches, tflash.flash_attention_dq.launches):
            counter.reset()
        out = tflash.flash_attention_segments(*leaves, seg_q, seg_kv, SCALE)
        got = torch.autograd.grad(out, leaves, do, retain_graph=True)
        again = torch.autograd.grad(out, leaves, do)
        torch.cuda.synchronize()
        assert tflash.flash_attention_dkv.launches.count == tflash.flash_attention_dq.launches.count == 2
        assert all(torch.equal(a, b) for a, b in zip(got, again)), (name, s, dtype)
        _, l, m = tflash.flash_attention_plain(q, k, v, seg_q, seg_kv, SCALE, save_residuals=True)
        want = tflash.flash_attention_backward_plain(q, k, v, seg_q, seg_kv, out.detach(), l, m, do, SCALE)
        for g, w in zip(got, want):
            atol = 5e-5 if dtype == torch.float32 else max(2.0 ** -7 * w.float().abs().max().item(), 2e-3)
            assert (g.float() - w.float()).abs().max().item() <= atol, (name, s, dtype)


# ---------------------------------------------------------------- the tile skip


def _restricted_backward(q, k, v, seg_q, seg_kv, o, l, m, do):
    """The plain backward with ``p`` and ``ds`` zeroed on every pair that
    the kernels of q's type skip (:func:`tflash.computed_tiles` at dkv's
    tiles for dk and dv, at dq's for dq; the f32 kernels have tiles of their
    own); every other step as ``flash_attention_backward_plain`` takes it."""
    def computed_pairs(what):
        tq, tk = tflash.TILES[tflash.tiles_key(what, q.dtype)]
        tiles = tflash.computed_tiles(seg_q, seg_kv, m, tq, tk)
        return tiles.repeat_interleave(tq, dim=2).repeat_interleave(tk, dim=3)

    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    logits = (qf @ kf.transpose(-1, -2)) * SCALE
    logits = logits.masked_fill(seg_q[:, None, :, None] != seg_kv[:, None, None, :], tflash.MASK_VALUE)
    p = torch.exp(logits - m[..., None]) * (1.0 / l)[..., None]
    di = (o.float() * dof).sum(dim=-1)
    ds = (dof @ vf.transpose(-1, -2) - di[..., None]) * p
    ds = (ds * SCALE).to(q.dtype).float()
    p = p.to(q.dtype).float()
    keep = computed_pairs("dkv")
    dv = (torch.where(keep, p, 0.0).transpose(-1, -2) @ dof).to(v.dtype)
    dk = (torch.where(keep, ds, 0.0).transpose(-1, -2) @ qf).to(k.dtype)
    dq = (torch.where(computed_pairs("dq"), ds, 0.0) @ kf).to(q.dtype)
    return dq, dk, dv


def _plain_residuals(q, k, v, seg_q, seg_kv, dtype: str):
    td = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(x).to(td) for x in (q, k, v))
    seg_q, seg_kv = torch.from_numpy(seg_q), torch.from_numpy(seg_kv)
    out, l, m = tflash.flash_attention_plain(q, k, v, seg_q, seg_kv, SCALE, save_residuals=True)
    return q, k, v, seg_q, seg_kv, out, l, m


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", SKIP_LAYOUTS)
def test_backward_restricted_to_computed_tiles_is_bit_equal(layout, dtype):
    """Skipping the pairs the rule rules out changes no gradient value: p
    and ds are exactly 0 there (a zero may change sign, which compares
    equal)."""
    b, h, s = 2, 2, 512
    rng, q, k, v = _inputs(31, b, h, s, dtype)
    seg_q, seg_kv = _skip_layouts(rng, b, s)[layout]
    args = _plain_residuals(q, k, v, seg_q, seg_kv, dtype)
    do = torch.from_numpy(_do(rng, q.shape, dtype)).to(args[0].dtype)
    full = tflash.flash_attention_backward_plain(*args, do, SCALE)
    restricted = _restricted_backward(*args, do)
    for name, a, r in zip(("dq", "dk", "dv"), full, restricted):
        assert torch.equal(a, r), name


@pytest.mark.parametrize("what", ["fwd", "dkv", "dq", "fwd f32", "dkv f32", "dq f32"])
def test_skip_rule_skips_nothing_on_one_segment_and_some_tiles_of_packed_rows(what):
    b, h, s = 2, 2, 1024
    tq, tk = tflash.TILES[what]
    rng = np.random.default_rng(32)
    m = torch.zeros((b, h, s))
    share = {}
    for name in ("one", "straddle", "packed"):
        seg = torch.from_numpy(_segments(rng, name, b, s))
        tiles = tflash.computed_tiles(seg, seg, m, tq, tk)
        assert tiles.shape == (b, h, s // tq, s // tk)
        share[name] = tiles.float().mean().item()
    assert share["one"] == 1.0
    assert share["straddle"] < 1.0 and share["packed"] < 1.0
    # a row no key matches keeps every key tile of its query tile
    seg = torch.from_numpy(_segments(rng, "straddle", b, s))
    m[0, 1, 70] = tflash.MASK_VALUE
    tiles = tflash.computed_tiles(seg, seg, m, tq, tk)
    assert tiles[0, 1, 70 // tq].all() and not tiles[0, 0, 70 // tq].all()


def test_skip_rule_model_on_a_hand_made_layout():
    """Query tiles of 64 against key tiles of 128 (dkv): ids 1 | 2 | 3 | 4 in
    runs of 128, so query tile t meets key tile t // 2 alone."""
    s = 512
    seg = torch.from_numpy(np.repeat(np.arange(1, 5, dtype=np.int32), 128)[None])
    m = torch.zeros((1, 1, s))
    tiles = tflash.computed_tiles(seg, seg, m, 64, 128)[0, 0]
    want = torch.zeros((8, 4), dtype=torch.bool)
    want[torch.arange(8), torch.arange(8) // 2] = True
    assert torch.equal(tiles, want)
    m[0, 0, 200] = tflash.MASK_VALUE  # query tile 3 then meets every key tile
    want[3] = True
    assert torch.equal(tflash.computed_tiles(seg, seg, m, 64, 128)[0, 0], want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_restricted_backward_matches_library_kernels_in_interpret_mode(dtype):
    b, h, s = 1, 2, 256
    rng, q, k, v = _inputs(33, b, h, s, dtype)
    seg = _segments(rng, "packed", b, s)
    do = _do(rng, q.shape, dtype)
    with pltpu.force_tpu_interpret_mode():
        want = _library_grads(_kernels, q, k, v, seg, seg, do, dtype)
    args = _plain_residuals(q, k, v, seg, seg, dtype)
    got = _restricted_backward(*args, torch.from_numpy(do).to(args[0].dtype))
    _assert_close([g.float().numpy() for g in got], want, dtype)


def test_kernels_count_the_tiles_the_rule_computes_on_card():
    """Each CTA of the backward kernels (bf16 and f32) reports the streamed
    tiles it loaded and that two of its consumers computed: every count
    equals the plain model's at the kernel's tiles (needs the card;
    ``chip_smoke.py`` phase 2 holds every layout)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU or interpret mode")
    b, h, s = 2, 2, 1024
    rng = np.random.default_rng(34)
    for dtype in (torch.bfloat16, torch.float32):
        for name, (seg_q, seg_kv) in _skip_layouts(rng, b, s).items():
            q, k, v, do = (torch.randn((b, h, s, 64), device="cuda").to(dtype) for _ in range(4))
            seg_q, seg_kv = torch.from_numpy(seg_q).cuda(), torch.from_numpy(seg_kv).cuda()
            out, l, m = tflash.flash_attention_plain(q, k, v, seg_q, seg_kv, SCALE, save_residuals=True)
            di = (out.float() * do.float()).sum(dim=-1).contiguous()
            for what, kernel in (("dkv", tflash.flash_attention_dkv), ("dq", tflash.flash_attention_dq)):
                rows = tflash.cta_rows(what, dtype)
                counts = torch.full((b, h, s // rows, 3), -1, dtype=torch.int32, device="cuda")
                tflash.count_tiles(counts)
                try:
                    kernel(q, k, v, seg_q, seg_kv, l, m, do, di, SCALE)
                    torch.cuda.synchronize()
                finally:
                    tflash.count_tiles(None)
                tiles = tflash.computed_tiles(seg_q, seg_kv, m, *tflash.TILES[tflash.tiles_key(what, dtype)])
                want = tiles.sum(2) if what == "dkv" else tiles.sum(3)  # per CTA: its keys (dkv) or queries (dq)
                assert torch.equal(counts, want.int()[..., None].expand(-1, -1, -1, 3)), (name, what, dtype)


def test_backward_takes_what_the_forward_takes_on_card():
    """k and v expanded over the heads (a zero stride) go through the
    forward, so the backward takes them too: the same gradients as their
    contiguous copies (needs the card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU or interpret mode")
    for dtype in (torch.float32, torch.bfloat16):
        q, do = (torch.randn((1, 4, 256, 64), device="cuda").to(dtype) for _ in range(2))
        kv = torch.randn((1, 1, 256, 64), device="cuda").to(dtype).expand(1, 4, 256, 64)
        seg = torch.ones((1, 256), dtype=torch.int32, device="cuda")
        grads = []
        for k in (kv, kv.contiguous()):
            leaves = [x.detach().requires_grad_() for x in (q, k, k)]
            out = tflash.flash_attention_segments(*leaves, seg, seg, SCALE)
            grads.append(torch.autograd.grad(out, leaves, do))
        assert all(torch.equal(a, b) for a, b in zip(*grads)), dtype


# ---------------------------------------------------------------- 3xTF32


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """x read as tf32 by the tensor cores: its low 13 mantissa bits cleared."""
    return (x.contiguous().view(torch.int32) & -(1 << 13)).view(torch.float32)


def _split(x: torch.Tensor):
    """The f32 kernels' split: hi = x as tf32, lo = x - hi (exact in f32)."""
    hi = _tf32(x)
    return hi, x - hi


def _mm_tf32(a: torch.Tensor, b: torch.Tensor, passes: int) -> torch.Tensor:
    """a @ b as the tensor cores take it: 3xTF32 (a_hi.b_hi + a_hi.b_lo +
    a_lo.b_hi, lo read as tf32, lo.lo dropped) or a single tf32 product;
    the products summed in f64, rounded to f32 once."""
    (a_hi, a_lo), (b_hi, b_lo) = _split(a), _split(b)
    out = a_hi.double() @ b_hi.double()
    if passes == 3:
        out = out + a_hi.double() @ _tf32(b_lo).double() + _tf32(a_lo).double() @ b_hi.double()
    return out.float()


def _tf32_backward(q, k, v, seg_q, seg_kv, o, l, m, do, passes: int):
    """``flash_attention_backward_plain`` (f32) with every product taken by
    :func:`_mm_tf32`: a model of the f32 kernels' arithmetic."""
    logits = _mm_tf32(q, k.transpose(-1, -2), passes) * SCALE
    logits = logits.masked_fill(seg_q[:, None, :, None] != seg_kv[:, None, None, :], tflash.MASK_VALUE)
    p = torch.exp(logits - m[..., None]) * (1.0 / l)[..., None]
    di = (o * do).sum(dim=-1)
    ds = (_mm_tf32(do, v.transpose(-1, -2), passes) - di[..., None]) * p * SCALE
    return (_mm_tf32(ds, k, passes), _mm_tf32(ds.transpose(-1, -2), q, passes),
            _mm_tf32(p.transpose(-1, -2), do, passes))


def test_tf32_split_is_exact():
    """hi + lo gives x back bit for bit, hi's low 13 bits are clear, and lo
    is at most 2^-10 of |x|."""
    x = torch.from_numpy(np.random.default_rng(35).standard_normal((4096,)).astype(np.float32) * 100)
    hi, lo = _split(x)
    assert torch.equal(hi + lo, x)
    assert not (hi.view(torch.int32) & ((1 << 13) - 1)).any()
    assert (lo.abs() <= x.abs() * 2.0 ** -10).all()


@pytest.mark.parametrize("layout", LAYOUTS)
def test_tf32x3_backward_model_holds_the_f32_bar_and_one_tf32_product_does_not(layout):
    """The f32 kernels' 3xTF32 arithmetic, modelled in torch, against
    ``jax.grad`` of the library's kernels in interpret mode: within the bar
    that ``chip_smoke.py`` holds the kernels to (``K5_BWD_ATOL_F32``, 5e-5).
    A single tf32 product per pair misses that bar (by 40x or more here)."""
    b, h, s = 1, 2, 512
    rng, q, k, v = _inputs(36, b, h, s, "float32")
    seg = _segments(rng, layout, b, s)
    do = _do(rng, q.shape, "float32")
    with pltpu.force_tpu_interpret_mode():
        want = _library_grads(_kernels, q, k, v, seg, seg, do, "float32")
    args = _plain_residuals(q, k, v, seg, seg, "float32")
    tdo = torch.from_numpy(do)
    got = _tf32_backward(*args, tdo, passes=3)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), w, atol=5e-5, rtol=0, err_msg=name)
    single = _tf32_backward(*args, tdo, passes=1)
    assert max(np.abs(g.numpy() - w).max() for g, w in zip(single, want)) > 5e-5


def test_f32_backward_bounds_count_three_tf32_products():
    """``chip_smoke.py``'s bound for the f32 kernels: three tf32 products a
    pair at the tf32 peak, the f32-FMA bound beside it; bf16 has no FMA
    bound. At (1, 16, 8192) with one 6,500-token chunk: 2.241 / 1.681 ms
    (dkv / dq), 5.516 / 4.137 at the f32 rate."""
    import chip_smoke as cs

    seg = (torch.arange(8192)[None] < 6500).to(torch.int32)
    for what, tf32, fma in (("dkv", 2.2411, 5.5159), ("dq", 1.6809, 4.1369)):
        bound = cs._k5_backward_bound(seg, 16, 4, what)
        assert bound["bound_by"] == "operations"
        assert bound["bound_ms"] == pytest.approx(tf32, rel=1e-3)
        assert bound["fma_bound_ms"] == pytest.approx(fma, rel=1e-3)
        assert "fma_bound_ms" not in cs._k5_backward_bound(seg, 16, 2, what)
