"""The stochastic quantizer and flat_topk_int8 of the PyTorch port against
the JAX package. On the CPU the port's quantizer takes its plain version;
the JAX function takes its uniform-dither path (the TPU PRNG has no CPU
lowering). The random streams differ, so what is compared is what does not
depend on them: scales exactly, codes within one step of floor, and the
unbiased mean. The card-only twin at the end launches the CUDA kernel.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from intool_rag_tpu.ops import quant as jq
from intool_rag_tpu_torch.ops import quant as tq

torch.set_num_threads(2)


def _check_codes(x: np.ndarray, q: np.ndarray, scale: np.ndarray):
    scaled = np.clip(x / scale[:, None], -127.0, 127.0)
    lo = np.floor(scaled)
    assert ((q == lo) | (q == np.clip(lo + 1, -127, 127))).all()  # q in {floor, floor+1}


@pytest.mark.parametrize("shape", [(64, 256), (5, 37)])
def test_stochastic_scales_and_codes(shape):
    rng = np.random.default_rng(0)
    x = rng.standard_normal(shape).astype(np.float32)
    _, j_scale = jq.quantize_int8_stochastic(jnp.asarray(x), seed=3)
    q, scale = tq.quantize_int8_stochastic(torch.from_numpy(x), seed=3)
    assert q.dtype == torch.int8 and scale.dtype == torch.float32
    np.testing.assert_array_equal(scale.numpy(), np.asarray(j_scale))  # scales exactly equal
    _check_codes(x, q.numpy().astype(np.float32), scale.numpy())
    q2, _ = tq.quantize_int8_stochastic(torch.from_numpy(x), seed=3)
    q3, _ = tq.quantize_int8_stochastic(torch.from_numpy(x), seed=4)
    assert torch.equal(q, q2) and not torch.equal(q, q3)


def test_stochastic_is_unbiased():
    """The bar of the JAX package's own test: the mean over 64 seeds of the
    dequantized output is within 0.35 quantization steps of x everywhere."""
    x = jnp.linspace(-1, 1, 4 * 128).reshape(4, 128).astype(jnp.float32)
    xt = torch.from_numpy(np.array(x))
    acc = torch.zeros_like(xt)
    for seed in range(64):
        q, scale = tq.quantize_int8_stochastic(xt, seed=seed)
        acc += tq.dequantize_int8(q, scale)
    step = 1.0 / 127.0
    assert float((acc / 64 - xt).abs().max()) < 0.35 * step
    # and the JAX reference meets the same bar on the same input
    jacc = np.zeros(x.shape, np.float32)
    for seed in range(64):
        jacc += np.asarray(jq.dequantize_int8(*jq.quantize_int8_stochastic(x, seed=seed)))
    assert np.abs(jacc / 64 - np.asarray(x)).max() < 0.35 * step


def test_stochastic_zero_rows_and_extremes():
    x = torch.zeros(3, 16)
    x[1] = torch.linspace(-2, 2, 16)
    q, scale = tq.quantize_int8_stochastic(x, seed=0)
    assert (q[0] == 0).all() and scale[0] == pytest.approx(1e-9 / 127.0)
    assert q[1].min() == -127 and q[1].max() == 127  # clipped, never 128
    with pytest.raises(ValueError):
        tq.quantize_int8_stochastic(torch.zeros(4), seed=0)


@pytest.mark.parametrize("valid_n,block_n", [(None, 16_384), (700, 256), (1000, 333)])
def test_flat_topk_int8_matches_jax(valid_n, block_n):
    rng = np.random.default_rng(1)
    corpus = rng.standard_normal((1000, 64)).astype(np.float32)
    corpus /= np.linalg.norm(corpus, axis=1, keepdims=True)
    queries = rng.standard_normal((9, 64)).astype(np.float32)
    jc, js = jq.quantize_int8(jnp.asarray(corpus))
    tc, ts = tq.quantize_int8(torch.from_numpy(corpus))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    jv, jr = jq.flat_topk_int8(jnp.asarray(queries), jc, js, 10, block_n=block_n, valid_n=valid_n)
    tv, tr = tq.flat_topk_int8(torch.from_numpy(queries), tc, ts, 10, block_n=block_n, valid_n=valid_n)
    assert tr.dtype == torch.int32
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))  # integer products: same ranking
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-6)


def test_quant_kernel_on_card():
    """Card-only: the CUDA kernel against the plain version (chip_smoke.py
    phase 2 holds the full statistical check)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the stochastic quantizer kernel is CUDA-only")
    rng = np.random.default_rng(2)
    x = rng.standard_normal((257, 1000)).astype(np.float32)
    before = tq.quantize_int8_stochastic.launches.count
    q, scale = tq.quantize_int8_stochastic(torch.from_numpy(x).cuda(), seed=7)
    assert tq.quantize_int8_stochastic.launches.count == before + 1
    _, p_scale = tq.quantize_int8_stochastic_reference(torch.from_numpy(x), seed=7)
    assert torch.equal(scale.cpu(), p_scale)
    _check_codes(x, q.cpu().numpy().astype(np.float32), scale.cpu().numpy())
