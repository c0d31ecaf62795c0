"""Int8 quantization for the dense index (port of
``intool_rag_tpu/ops/quant.py``).

Symmetric per-row absmax scaling; ``torch.round`` rounds half to even, as
``jnp.round`` does, so codes match the JAX package bit for bit.

:func:`quantize_int8_stochastic` is the stochastic-rounding quantizer for
streaming requantization. On a CUDA tensor it launches the hand-written
kernel of ``kernels/quant_stochastic.cu`` (which replaces the TPU kernel
``_quant_kernel``); :func:`quantize_int8_stochastic_reference` is its
plain version, taken only for a tensor on the CPU. The kernel draws from
Philox keyed on (seed, row, column), the plain version from a
``torch.Generator``, so the two share scales bit for bit and the rounding
distribution, not the random stream.
"""

from __future__ import annotations

import ctypes

import torch

from .flat_fused import LaunchCount, _int_dot
from .topk import NEG_INF, merge_topk, top_k

_SOURCE = "quant_stochastic.cu"


# XLA compiles ``absmax / 127.0`` under ``jax.jit`` as ``absmax · (1/127)``
# (and torch on CUDA divides by a Python scalar the same way): the scale
# rule of every JAX build that quantizes inside a jitted function
_INV127 = torch.tensor(1.0 / 127.0, dtype=torch.float32).item()


def _row_scale(xf: torch.Tensor, reciprocal: bool) -> torch.Tensor:
    absmax = xf.abs().amax(dim=1).clamp_min(1e-9)
    return absmax * _INV127 if reciprocal else absmax / 127.0


def quantize_int8(x: torch.Tensor, *, reciprocal: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric absmax quantization.
    Returns (values int8 [N, D], scales f32 [N]). ``reciprocal`` takes the
    scale as ``absmax · (1/127)``, the jitted JAX builds' rule."""
    xf = x.float()
    scale = _row_scale(xf, reciprocal)
    q = torch.round(xf / scale[:, None]).clamp(-127, 127)
    return q.to(torch.int8), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale[:, None]


def quantize_int8_residual(
    x: torch.Tensor, *, reciprocal: bool = False
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Two-level int8 row encoding ``row ≈ scale · (q1 + q2/128)``.

    ``q2 = round(128·(row/scale − q1))`` lies in [−64, 64] because
    |row/scale − q1| ≤ 0.5. Returns ``(q1 int8 [N,D], q2 int8 [N,D],
    scale f32 [N])``; ``reciprocal`` as in :func:`quantize_int8`."""
    xf = x.float()
    scale = _row_scale(xf, reciprocal)
    scaled = xf / scale[:, None]
    q1f = torch.round(scaled.clamp(-127.0, 127.0))
    q2 = torch.round(128.0 * (scaled - q1f)).to(torch.int8)
    return q1f.to(torch.int8), q2, scale


def _stochastic_scaled(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(clip(x/scale, ±127), scale [N, 1])``, the deterministic half of
    the stochastic quantizer."""
    xf = x.float()
    absmax = xf.abs().amax(dim=1, keepdim=True).clamp_min(1e-9)
    # a tensor divisor: torch divides by a Python scalar on CUDA by multiplying
    # with its reciprocal, which is 1 ulp off the IEEE quotient the kernel
    # (and torch on the CPU) computes
    scale = absmax / torch.full_like(absmax, 127.0)
    return (xf / scale).clamp(-127.0, 127.0), scale


def quantize_int8_stochastic_reference(
    x: torch.Tensor, seed: int = 0
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the stochastic quantizer: ``floor(x/scale + u)``
    with ``u`` uniform on the 2^-24 grid of [0, 1), unbiased for any x."""
    scaled, scale = _stochastic_scaled(x)
    gen = torch.Generator(device=x.device).manual_seed(seed)
    bits24 = torch.randint(0, 1 << 24, scaled.shape, generator=gen, device=x.device)
    u = bits24.float() * (1.0 / (1 << 24))
    q = torch.floor(scaled + u).clamp(-127.0, 127.0)
    return q.to(torch.int8), scale[:, 0]


def _lib() -> ctypes.CDLL:
    from ..kernels import build

    lib = build.load(_SOURCE)
    if not getattr(lib, "_argtypes_set", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.quant_stochastic.argtypes = [p, i, i, ctypes.c_ulonglong, p, p, p]
        lib.quant_stochastic.restype = ctypes.c_int
        lib._argtypes_set = True
    return lib


def quantize_int8_stochastic(x: torch.Tensor, seed: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row absmax int8 quantization with stochastic rounding (unbiased
    under repeated requantization). Returns (values int8 [N, D], scales
    f32 [N]). The same seed gives the same codes."""
    if x.dim() != 2:
        raise ValueError(f"expected [n, d], got {tuple(x.shape)}")
    if not x.is_cuda:
        return quantize_int8_stochastic_reference(x, seed)
    xf = x.float().contiguous()
    n, d = xf.shape
    q = torch.empty((n, d), dtype=torch.int8, device=x.device)
    scale = torch.empty(n, dtype=torch.float32, device=x.device)
    if n == 0 or d == 0:
        return q, scale
    rc = _lib().quant_stochastic(
        xf.data_ptr(), n, d, int(seed) & (2**64 - 1), q.data_ptr(), scale.data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    quantize_int8_stochastic.launches.add("K4")
    if rc != 0:
        raise RuntimeError(f"quantize_int8_stochastic launch failed: cudaError {rc}")
    return q, scale


quantize_int8_stochastic.launches = LaunchCount()


def flat_topk_int8(
    queries: torch.Tensor,
    corpus_q: torch.Tensor,
    corpus_scale: torch.Tensor,
    k: int,
    *,
    block_n: int = 16384,
    valid_n: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Blockwise int8 MIPS top-k: exact int8×int8→int32 products, rescaled
    to f32 as ``acc · q_scale · c_scale``. Returns (scores [Q, k], rows
    [Q, k] i32). (The JAX version's ``use_approx`` has no counterpart.)"""
    n, _ = corpus_q.shape
    q = queries.shape[0]
    valid_n = n if valid_n is None else valid_n
    k = min(k, n)
    q_int, q_scale = quantize_int8(queries)
    block_n = min(block_n, n)
    best_vals = torch.full((q, k), NEG_INF, dtype=torch.float32, device=corpus_q.device)
    best_rows = torch.full((q, k), -1, dtype=torch.int32, device=corpus_q.device)
    for start in range(0, n, block_n):
        block = corpus_q[start : start + block_n]
        acc = _int_dot(q_int, block)
        scores = acc.float() * q_scale[:, None] * corpus_scale[start : start + block_n][None, :]
        ids = torch.arange(start, start + block.shape[0], device=corpus_q.device, dtype=torch.int32)
        scores = torch.where(ids[None, :] < valid_n, scores, NEG_INF)
        bvals, bpos = top_k(scores, min(k, block.shape[0]))
        best_vals, best_rows = merge_topk(best_vals, best_rows, bvals, ids[bpos], k)
    return best_vals, best_rows
