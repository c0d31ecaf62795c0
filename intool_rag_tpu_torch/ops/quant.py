"""Int8 quantization for the dense index (port of the non-kernel part of
``intool_rag_tpu/ops/quant.py``).

Symmetric per-row absmax scaling; ``torch.round`` rounds half to even, as
``jnp.round`` does, so codes match the JAX package bit for bit. The
stochastic-rounding quantizer (the TPU kernel ``_quant_kernel``) is not
ported yet (ROADMAP Queue B).
"""

from __future__ import annotations

import torch


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric absmax quantization.
    Returns (values int8 [N, D], scales f32 [N])."""
    xf = x.float()
    scale = xf.abs().amax(dim=1).clamp_min(1e-9) / 127.0
    q = torch.round(xf / scale[:, None]).clamp(-127, 127)
    return q.to(torch.int8), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale[:, None]


def quantize_int8_residual(
    x: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Two-level int8 row encoding ``row ≈ scale · (q1 + q2/128)``.

    ``q2 = round(128·(row/scale − q1))`` lies in [−64, 64] because
    |row/scale − q1| ≤ 0.5. Returns ``(q1 int8 [N,D], q2 int8 [N,D],
    scale f32 [N])``."""
    xf = x.float()
    scale = xf.abs().amax(dim=1).clamp_min(1e-9) / 127.0
    scaled = xf / scale[:, None]
    q1f = torch.round(scaled.clamp(-127.0, 127.0))
    q2 = torch.round(128.0 * (scaled - q1f)).to(torch.int8)
    return q1f.to(torch.int8), q2, scale
