"""Flash attention with segment ids (port of the TPU flash-attention
kernel the JAX encoder calls at ``intool_rag_tpu/models/encoder.py:138``).

``softmax(q·kᵀ·sm_scale, masked to equal segment ids)·v`` for
``q, k, v [B, H, S, 64]`` and ``seg [B, S]`` i32. Packed rows carry ids
1..P and pads 0; an unpacked long row passes its 0/1 attention mask, so
pads attend among themselves and every row keeps at least one key. On the
card the work runs in the hand-written CUDA kernel of
``kernels/flash_attention.cu``, blockwise over the keys with f32 running
max and sum: no ``[S, S]`` tensor is built. :func:`flash_attention_plain`
is the plain version (it does build the logits);
:func:`flash_attention_segments` takes it only for tensors on the CPU, and
launches the kernel or raises on CUDA tensors.

The tensors may be strided views (the encoder passes its ``[B, S, H·64]``
projections viewed as ``[B, H, S, 64]``); only the last dim must be
contiguous. The result comes back as a ``[B, H, S, 64]`` view of a
``[B, S, H, 64]`` tensor, so the encoder's reshape to ``[B, S, H·64]`` is
free.
"""

from __future__ import annotations

import ctypes

import torch

from .flat_fused import LaunchCount, _check_rc

HEAD_DIM = 64
MAX_SEQ = 8192
# the library's DEFAULT_MASK_VALUE: -0.7 · f32 max, finite so that a wholly
# masked key block rescales away instead of producing inf - inf
MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)
_SOURCE = "flash_attention.cu"
_DTYPES = (torch.bfloat16, torch.float32)


def _check(q, k, v, seg_q, seg_kv) -> None:
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(
            f"q, k, v must share one [B, H, S, {HEAD_DIM}] shape, got {tuple(q.shape)}, "
            f"{tuple(k.shape)}, {tuple(v.shape)}"
        )
    b, _, s, dh = q.shape
    if dh != HEAD_DIM:
        raise ValueError(f"head dim must be {HEAD_DIM}, got {dh}")
    if s % 128 or not 0 < s <= MAX_SEQ:
        raise ValueError(f"S must be a multiple of 128 up to {MAX_SEQ}, got {s}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must all be bfloat16 or all float32, got {q.dtype}, {k.dtype}, {v.dtype}")
    for name, seg in (("seg_q", seg_q), ("seg_kv", seg_kv)):
        if tuple(seg.shape) != (b, s) or seg.dtype != torch.int32:
            raise ValueError(f"{name} must be int32 [{b}, {s}], got {seg.dtype} {tuple(seg.shape)}")


def flash_attention_plain(q, k, v, seg_q, seg_kv, sm_scale: float) -> torch.Tensor:
    """Plain version: f32 logits ``[B, H, S, S]``, the library's mask
    value where the segment ids differ, softmax, ``p`` rounded to v's type,
    ``p·v``. Returns ``[B, H, S, 64]`` in v's type."""
    _check(q, k, v, seg_q, seg_kv)
    flash_attention_plain.calls.add(str(q.dtype))
    logits = (q.float() @ k.float().transpose(-1, -2)) * sm_scale
    pair = seg_q[:, None, :, None] == seg_kv[:, None, None, :]
    logits = logits.masked_fill(~pair, MASK_VALUE)
    return torch.softmax(logits, dim=-1).to(v.dtype) @ v


flash_attention_plain.calls = LaunchCount()


def _lib() -> ctypes.CDLL:
    from ..kernels import build

    lib = build.load(_SOURCE)
    if not getattr(lib, "_argtypes_set", False):
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.flash_attention_segments.argtypes = [p] * 6 + [i] * 4 + [ll] * 12 + [ctypes.c_float, p]
        lib.flash_attention_segments.restype = ctypes.c_int
        lib._argtypes_set = True
    return lib


def _strides(t: torch.Tensor, name: str) -> tuple[int, int, int]:
    """(batch, head, row) strides in elements of a tensor the kernel can
    read: last dim contiguous, every 64-value row 16-byte aligned."""
    per16 = 16 // t.element_size()
    sb, sh, ss, sd = t.stride()
    if sd != 1 or sb % per16 or sh % per16 or ss % per16 or t.data_ptr() % 16:
        raise ValueError(
            f"{name}: the {HEAD_DIM} values of a head must be contiguous and 16-byte aligned, "
            f"got strides {t.stride()}"
        )
    return sb, sh, ss


def flash_attention_segments(q, k, v, seg_q, seg_kv, sm_scale: float) -> torch.Tensor:
    """Attention confined to equal segment ids, ``[B, H, S, 64]`` in q's
    type. ``q, k, v [B, H, S, 64]`` bf16 or f32 (strided views allowed),
    ``seg_q, seg_kv [B, S]`` int32, S a multiple of 128 up to 8192."""
    _check(q, k, v, seg_q, seg_kv)
    if not q.is_cuda:
        return flash_attention_plain(q, k, v, seg_q, seg_kv, sm_scale)
    dev = q.device
    for name, t in (("k", k), ("v", v), ("seg_q", seg_q), ("seg_kv", seg_kv)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
    b, h, s, dh = q.shape
    seg_q, seg_kv = seg_q.contiguous(), seg_kv.contiguous()
    out = torch.empty((b, s, h, dh), dtype=q.dtype, device=dev).transpose(1, 2)
    strides = [x for t, n in ((q, "q"), (k, "k"), (v, "v"), (out, "out")) for x in _strides(t, n)]
    rc = _lib().flash_attention_segments(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), seg_q.data_ptr(), seg_kv.data_ptr(),
        out.data_ptr(), b, h, s, int(q.dtype == torch.bfloat16), *strides, float(sm_scale),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    flash_attention_segments.launches.add("K5 bf16" if q.dtype == torch.bfloat16 else "K5 f32")
    _check_rc(rc, "flash_attention_segments")
    return out


flash_attention_segments.launches = LaunchCount()
