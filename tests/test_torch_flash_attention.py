"""K5, attention confined to equal segment ids: the port's plain version
against the JAX library's TPU flash-attention kernel (run in interpret mode)
and against that library's ``mha_reference``, on the same seeded inputs.

On the CPU the wrapper takes the plain version; the CUDA kernel itself is
held against this same plain version on the card (``chip_smoke.py`` phase 2
and the card-only test below).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from jax.experimental.pallas.ops.tpu import flash_attention as jflash

from intool_rag_tpu_torch.ops import flash_attention as tflash

torch.set_num_threads(2)

# f32: both sides sum 64 products and a softmax in f32, in another order.
# bf16: one rounding of p and of the output to 8 bits of mantissa on
# unit-variance values (|out| < 4, ulp 2^-6 = 1.6e-2).
ATOL = {"float32": 2e-6, "bfloat16": 2e-2}
LAYOUTS = ("one", "mask", "packed", "straddle", "all-pad row")


def _segments(rng: np.random.Generator, name: str, b: int, s: int) -> np.ndarray:
    """The segment layouts the encoder hands to K5 (``[b, s]`` i32): one
    segment; a 0/1 mask with a padded tail; packed rows of 1..12 segments
    with pads; 61-token segments, which straddle every 64-key tile boundary;
    the packed layout with row 0 all pads."""
    pos = np.arange(s)[None, :]
    if name == "one":
        return np.ones((b, s), np.int32)
    if name == "mask":
        return (pos < rng.integers(1, s + 1, size=(b, 1))).astype(np.int32)
    if name == "straddle":
        seg = np.broadcast_to(pos // 61 + 1, (b, s)).astype(np.int32).copy()
        seg[:, s - s // 10 :] = 0
        return seg
    seg = np.zeros((b, s), np.int32)
    for r in range(b):
        p = int(rng.integers(1, 13))
        used = int(rng.integers(max(p, s // 2), s + 1))
        cuts = np.sort(rng.choice(np.arange(1, used), size=p - 1, replace=False)) if p > 1 else []
        bounds = [0, *cuts, used]
        for i in range(p):
            seg[r, bounds[i] : bounds[i + 1]] = i + 1
    if name == "all-pad row":
        seg[0] = 0
    return seg


def _skip_layouts(rng: np.random.Generator, b: int, s: int) -> dict[str, tuple[np.ndarray, np.ndarray]]:
    """(seg_q, seg_kv) pairs for the skip rule: every ``LAYOUTS`` entry with
    seg_q = seg_kv; a query row whose id no key carries, inside a tile whose
    range no other key tile meets (ids 2, 4, 6, ... in runs of 100, row 5
    given 3); and interleaved, non-monotonic ids that differ between the
    queries and the keys (runs of 96 and 80, rows no key matches among
    them)."""
    out = {name: (seg, seg) for name in LAYOUTS for seg in [_segments(rng, name, b, s)]}
    pos = np.arange(s)[None, :]
    even = np.broadcast_to(2 * (pos // 100 + 1), (b, s)).astype(np.int32)
    odd_row = even.copy()
    odd_row[:, 5] = 3
    out["no key in a skipped tile"] = (odd_row, even.copy())
    kv_ids = np.array([5, 1, 6, 2, 7, 3, 8, 4, 9], np.int32)
    q_ids = np.array([1, 5, 2, 6, 3, 7, 4, 8, 10, 9], np.int32)
    seg_kv = np.broadcast_to(kv_ids[(pos // 96) % len(kv_ids)], (b, s)).astype(np.int32)
    seg_q = np.broadcast_to(q_ids[(pos // 80) % len(q_ids)], (b, s)).astype(np.int32)
    out["interleaved"] = (seg_q.copy(), seg_kv.copy())
    return out


SKIP_LAYOUTS = (*LAYOUTS, "no key in a skipped tile", "interleaved")


def _inputs(seed: int, b: int, h: int, s: int, dtype: str):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, h, s, 64)).astype(np.float32) for _ in range(3))
    if dtype == "bfloat16":  # both sides start from the same bf16 values
        q, k, v = (np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32)) for x in (q, k, v))
    return rng, q, k, v


def _plain(q, k, v, seg, dtype: str) -> np.ndarray:
    td = getattr(torch, dtype)
    seg_t = torch.from_numpy(seg)
    out = tflash.flash_attention_segments(
        *(torch.from_numpy(x).to(td) for x in (q, k, v)), seg_t, seg_t, 0.125
    )
    assert out.dtype == td and tuple(out.shape) == q.shape
    return out.float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_plain_matches_library_kernel_in_interpret_mode(layout, dtype):
    b, h, s = 2, 2, 256
    rng, q, k, v = _inputs(11, b, h, s, dtype)
    seg = _segments(rng, layout, b, s)
    jd = jnp.dtype(dtype)
    with pltpu.force_tpu_interpret_mode():
        want = jflash.flash_attention(
            *(jnp.asarray(x, jd) for x in (q, k, v)),
            segment_ids=jflash.SegmentIds(q=jnp.asarray(seg), kv=jnp.asarray(seg)), sm_scale=0.125,
        )
    want = np.asarray(want.astype(jnp.float32))
    np.testing.assert_allclose(_plain(q, k, v, seg, dtype), want, atol=ATOL[dtype], rtol=0)


@pytest.mark.parametrize("s", [128, 512, 1024])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_plain_matches_mha_reference(layout, s):
    b, h = (3, 2) if s < 1024 else (1, 2)
    rng, q, k, v = _inputs(s, b, h, s, "float32")
    seg = _segments(rng, layout, b, s)
    want = jflash.mha_reference(
        *(jnp.asarray(x) for x in (q, k, v)), None,
        segment_ids=jflash.SegmentIds(q=jnp.asarray(seg), kv=jnp.asarray(seg)), sm_scale=0.125,
    )
    np.testing.assert_allclose(_plain(q, k, v, seg, "float32"), np.asarray(want), atol=2e-6, rtol=0)


def test_wholly_masked_first_key_tile_and_rows_without_a_key():
    """A query whose first 64 keys all belong to another segment, and a row
    whose segment id no key carries (it averages v over every key)."""
    _, q, k, v = _inputs(3, 1, 1, 128, "float32")
    seg = np.where(np.arange(128) < 64, 1, 2).astype(np.int32)[None]
    out = _plain(q, k, v, seg, "float32")
    logits = (q[0, 0, 64:] @ k[0, 0, 64:].T) * 0.125
    p = np.exp(logits - logits.max(axis=1, keepdims=True))
    np.testing.assert_allclose(out[0, 0, 64:], (p / p.sum(axis=1, keepdims=True)) @ v[0, 0, 64:], atol=2e-6)
    seg_q = torch.full((1, 128), 7, dtype=torch.int32)
    lost = tflash.flash_attention_segments(*(torch.from_numpy(x) for x in (q, k, v)), seg_q, torch.from_numpy(seg), 0.125)
    np.testing.assert_allclose(lost[0, 0].numpy(), np.broadcast_to(v[0, 0].mean(axis=0), (128, 64)), atol=2e-6)


def test_mask_value_is_the_librarys():
    assert np.float32(tflash.MASK_VALUE) == np.float32(jflash.DEFAULT_MASK_VALUE)


@pytest.mark.parametrize("shape,seg_shape,seg_dtype,dtypes", [
    ((1, 2, 192, 64), (1, 192), torch.int32, (torch.float32,) * 3),  # S % 128
    ((1, 2, 128, 32), (1, 128), torch.int32, (torch.float32,) * 3),  # head dim
    ((1, 2, 16384, 64), (1, 16384), torch.int32, (torch.bfloat16,) * 3),  # S > 8192
    ((1, 2, 128, 64), (1, 64), torch.int32, (torch.float32,) * 3),  # segment ids of another length
    ((1, 2, 128, 64), (1, 128), torch.int64, (torch.float32,) * 3),  # segment ids not int32
    ((1, 2, 128, 64), (1, 128), torch.int32, (torch.float32, torch.bfloat16, torch.float32)),
    ((1, 2, 128, 64), (1, 128), torch.int32, (torch.float16,) * 3),
], ids=["s-not-128", "head-dim", "s-too-long", "seg-shape", "seg-dtype", "mixed-dtypes", "float16"])
def test_wrapper_refuses_what_the_kernel_cannot_take(shape, seg_shape, seg_dtype, dtypes):
    q, k, v = (torch.empty(shape, dtype=d, device="meta") for d in dtypes)
    seg = torch.empty(seg_shape, dtype=seg_dtype, device="meta")
    with pytest.raises(ValueError):
        tflash.flash_attention_segments(q, k, v, seg, seg, 0.125)


def test_wrapper_refuses_shapes_that_differ():
    q = torch.zeros((1, 2, 128, 64))
    seg = torch.zeros((1, 128), dtype=torch.int32)
    with pytest.raises(ValueError):
        tflash.flash_attention_segments(q, q[:, :1], q, seg, seg, 0.125)


def test_cpu_route_counts_plain_calls_not_launches():
    _, q, k, v = _inputs(0, 1, 1, 128, "float32")
    tflash.flash_attention_plain.calls.reset()
    tflash.flash_attention_segments.launches.reset()
    _plain(q, k, v, np.ones((1, 128), np.int32), "float32")
    assert tflash.flash_attention_plain.calls.count == 1
    assert tflash.flash_attention_segments.launches.count == 0


def test_flash_kernel_on_card():
    """The CUDA kernel against the plain version, strided views included, on
    packed rows and on the edges of the bf16 kernel's tile skip (rows no key
    matches among them), two runs bit-equal; and k, v expanded over the heads
    (a zero stride) against their copies (needs the card; ``python3
    chip_smoke.py --phases 1,2`` runs the full set)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU or interpret mode")
    for dtype, atol in ((torch.float32, 2e-5), (torch.bfloat16, 2e-2)):
        rng, q, k, v = _inputs(1, 2, 6, 1024, "float32")
        cases = {"packed": (_segments(rng, "packed", 2, 1024),) * 2}
        cases.update((n, ids) for n, ids in _skip_layouts(rng, 2, 1024).items()
                     if n in ("no key in a skipped tile", "interleaved"))
        # the encoder's layout: [B, S, H*64] viewed as [B, H, S, 64]
        q, k, v = (torch.from_numpy(x).cuda().to(dtype).transpose(1, 2).contiguous().transpose(1, 2)
                   for x in (q, k, v))
        for name, (seg_q, seg_kv) in cases.items():
            seg_q, seg_kv = torch.from_numpy(seg_q).cuda(), torch.from_numpy(seg_kv).cuda()
            tflash.flash_attention_segments.launches.reset()
            got = tflash.flash_attention_segments(q, k, v, seg_q, seg_kv, 0.125)
            again = tflash.flash_attention_segments(q, k, v, seg_q, seg_kv, 0.125)
            torch.cuda.synchronize()
            assert tflash.flash_attention_segments.launches.count == 2
            assert torch.equal(got, again), (name, dtype)
            want = tflash.flash_attention_plain(q, k, v, seg_q, seg_kv, 0.125)
            assert (got.float() - want.float()).abs().max().item() <= atol, (name, dtype)
        kv = k[:, :1].expand(-1, 6, -1, -1)
        seg = torch.ones((2, 1024), dtype=torch.int32, device="cuda")
        assert torch.equal(tflash.flash_attention_segments(q, kv, kv, seg, seg, 0.125),
                           tflash.flash_attention_segments(q, kv.contiguous(), kv.contiguous(), seg, seg, 0.125))
