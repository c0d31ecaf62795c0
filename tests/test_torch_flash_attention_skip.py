"""K5 forward's tile skip: the key tiles the kernels walk
(:func:`computed_tiles` at the forward's tiles, ``TILES["fwd"]``: 128
queries x 128 keys in bf16, ``TILES["fwd f32"]``: 64 x 32 in f32, with the
forward's own row max ``m``) hold every pair that changes the result.

The plain forward restricted to those tiles, kept in this file, must equal
the full plain forward bit for bit, on the encoder's layouts and on the
skip's edges (a row no key matches inside a tile that would otherwise be
skipped; interleaved ids that differ between queries and keys). The plain
forward must also agree with the JAX library's TPU kernel (interpret mode)
on those edges, where seg_q and seg_kv differ. The kernel's own tile counts
are held against the same model on the card (``chip_smoke.py`` phase 2).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from jax.experimental.pallas.ops.tpu import flash_attention as jflash

from intool_rag_tpu_torch.ops import flash_attention as tflash
from test_torch_flash_attention import ATOL, LAYOUTS, SKIP_LAYOUTS, _inputs, _segments, _skip_layouts
from test_torch_flash_attention_bwd import _mm_tf32

torch.set_num_threads(2)

SCALE = 0.125


def _restricted_forward(q, k, v, seg_q, seg_kv, m):
    """The plain forward with every pair outside the tiles that the kernel of
    q's type computes left out of the softmax (its logit -inf, so it adds an
    exact 0 to the row's sum and never sets its max); every other step as
    ``flash_attention_plain`` takes it."""
    tq, tk = tflash.TILES[tflash.tiles_key("fwd", q.dtype)]
    keep = tflash.computed_tiles(seg_q, seg_kv, m, tq, tk).repeat_interleave(tq, dim=2).repeat_interleave(tk, dim=3)
    logits = (q.float() @ k.float().transpose(-1, -2)) * SCALE
    logits = logits.masked_fill(seg_q[:, None, :, None] != seg_kv[:, None, None, :], tflash.MASK_VALUE)
    logits = logits.masked_fill(~keep, -torch.inf)
    return torch.softmax(logits, dim=-1).to(v.dtype) @ v


def _torch_inputs(q, k, v, seg_q, seg_kv, dtype: str):
    td = getattr(torch, dtype)
    return (*(torch.from_numpy(x).to(td) for x in (q, k, v)), torch.from_numpy(seg_q), torch.from_numpy(seg_kv))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", SKIP_LAYOUTS)
def test_forward_restricted_to_computed_tiles_is_bit_equal(layout, dtype):
    b, h, s = 2, 2, 512
    rng, q, k, v = _inputs(41, b, h, s, dtype)
    args = _torch_inputs(q, k, v, *_skip_layouts(rng, b, s)[layout], dtype)
    full, _, m = tflash.flash_attention_plain(*args, SCALE, save_residuals=True)
    assert torch.equal(_restricted_forward(*args, m), full)


def test_skip_layouts_make_the_forward_walk_skipped_tiles():
    """The skip's edge layouts are what they claim at the test size: both
    hold rows no key matches, and in "no key in a skipped tile" such a row
    makes its query tile walk key tiles that the ids alone would skip, while
    other tiles are still skipped."""
    b, h, s = 2, 2, 512
    rng, q, k, v = _inputs(41, b, h, s, "float32")
    layouts = _skip_layouts(rng, b, s)
    for name in ("no key in a skipped tile", "interleaved"):
        args = _torch_inputs(q, k, v, *layouts[name], "float32")
        _, _, m = tflash.flash_attention_plain(*args, SCALE, save_residuals=True)
        assert (m == tflash.MASK_VALUE).any(), name
        if name == "no key in a skipped tile":
            by_ids = tflash.computed_tiles(args[3], args[4], torch.zeros_like(m), *tflash.TILES["fwd"])
            tiles = tflash.computed_tiles(args[3], args[4], m, *tflash.TILES["fwd"])
            assert (tiles & ~by_ids).any() and not tiles.all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", ["no key in a skipped tile", "interleaved"])
def test_plain_matches_library_kernel_on_skip_layouts(layout, dtype):
    b, h, s = 1, 2, 512
    rng, q, k, v = _inputs(42, b, h, s, dtype)
    seg_q, seg_kv = _skip_layouts(rng, b, s)[layout]
    jd = jnp.dtype(dtype)
    with pltpu.force_tpu_interpret_mode():
        want = jflash.flash_attention(
            *(jnp.asarray(x, jd) for x in (q, k, v)),
            segment_ids=jflash.SegmentIds(q=jnp.asarray(seg_q), kv=jnp.asarray(seg_kv)), sm_scale=SCALE,
        )
    got = tflash.flash_attention_segments(*_torch_inputs(q, k, v, seg_q, seg_kv, dtype), SCALE)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)), atol=ATOL[dtype], rtol=0)


def test_forward_skip_rule_on_a_hand_made_layout():
    """The forward's tiles (128 queries) against ids 1 | 2 | 3 | 4 in runs of
    128: query tile t meets the key tiles that lie in run t alone; a row no
    key matches gives its query tile every key tile."""
    s = 512
    tq, tk = tflash.TILES["fwd"]
    seg = torch.from_numpy(np.repeat(np.arange(1, 5, dtype=np.int32), 128)[None])
    m = torch.zeros((1, 1, s))
    want = (torch.arange(s // tk)[None, :] * tk // 128) == torch.arange(s // tq)[:, None]
    assert torch.equal(tflash.computed_tiles(seg, seg, m, tq, tk)[0, 0], want)
    m[0, 0, 300] = tflash.MASK_VALUE
    want[300 // tq] = True
    assert torch.equal(tflash.computed_tiles(seg, seg, m, tq, tk)[0, 0], want)


# ---------------------------------------------------------------- 3xTF32


def _tf32_forward(q, k, v, seg_q, seg_kv, passes: int):
    """``flash_attention_plain`` (f32) with q.kT and p.v taken by
    ``_mm_tf32``: a model of the f32 forward kernel's arithmetic."""
    logits = _mm_tf32(q, k.transpose(-1, -2), passes) * SCALE
    logits = logits.masked_fill(seg_q[:, None, :, None] != seg_kv[:, None, None, :], tflash.MASK_VALUE)
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    return _mm_tf32(p, v, passes) / p.sum(dim=-1, keepdim=True)


@pytest.mark.parametrize("layout", [*LAYOUTS, "no key in a skipped tile"])
def test_tf32x3_forward_model_holds_the_f32_bar_and_one_tf32_product_does_not(layout):
    """The f32 forward kernel's 3xTF32 arithmetic, modelled in torch, against
    the library's kernel in interpret mode: within the bar that
    ``chip_smoke.py`` holds the kernel to (``K5_ATOL["float32"]``, 2e-5). A
    single tf32 product per pair misses that bar."""
    b, h, s = 1, 2, 512
    rng, q, k, v = _inputs(43, b, h, s, "float32")
    if layout in LAYOUTS:
        seg_q = seg_kv = _segments(rng, layout, b, s)
    else:
        seg_q, seg_kv = _skip_layouts(rng, b, s)[layout]
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jflash.flash_attention(
            *(jnp.asarray(x) for x in (q, k, v)),
            segment_ids=jflash.SegmentIds(q=jnp.asarray(seg_q), kv=jnp.asarray(seg_kv)), sm_scale=SCALE,
        ))
    args = _torch_inputs(q, k, v, seg_q, seg_kv, "float32")
    np.testing.assert_allclose(_tf32_forward(*args, passes=3).numpy(), want, atol=2e-5, rtol=0)
    assert np.abs(_tf32_forward(*args, passes=1).numpy() - want).max() > 2e-5


def test_f32_forward_bound_counts_three_tf32_products():
    """``chip_smoke.py``'s bound for the f32 forward: three tf32 products a
    pair at the tf32 peak, the f32-FMA bound beside it; bf16 has no FMA
    bound. At (1, 16, 8192) with one 6,500-token chunk: 1.121 ms, 2.758 at
    the f32 rate."""
    import chip_smoke as cs

    seg = (torch.arange(8192)[None] < 6500).to(torch.int32)
    bound = cs._k5_bound(seg, 16, 4)
    assert bound["bound_by"] == "operations"
    assert bound["bound_ms"] == pytest.approx(1.1206, rel=1e-3)
    assert bound["fma_bound_ms"] == pytest.approx(2.7580, rel=1e-3)
    assert "fma_bound_ms" not in cs._k5_bound(seg, 16, 2)
