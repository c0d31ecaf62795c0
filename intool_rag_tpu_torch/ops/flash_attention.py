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

The call is differentiable: when a gradient is wanted it goes through
:class:`FlashAttentionSegments`, whose forward also keeps each row's f32
sum ``l`` and max ``m`` (apart, as the library keeps them: ``m + log l``
would lose ``log l`` beside the mask value of a row no key matches) and
whose backward is :func:`flash_attention_backward`: the two kernels of
``kernels/flash_attention_bwd.cu`` (dk and dv in one, dq in the other) on
the card, :func:`flash_attention_backward_plain` for CPU tensors. Neither
direction ever falls back on a CUDA tensor. Every kernel (forward, dkv and
dq; bf16, and f32 as 3xTF32 on the tensor cores) skips the (query tile, key
tile) pairs whose ids cannot meet; :func:`computed_tiles`
is the plain model of that rule, at the tiles of :data:`TILES`.

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
_SOURCE_BWD = "flash_attention_bwd.cu"
_DTYPES = (torch.bfloat16, torch.float32)
# (query tile, key tile) of the kernels that skip tiles. bf16: the forward
# streams 128-key tiles and dq 64-key tiles past a CTA's 128 queries, dkv
# 64-query tiles past a CTA's 128 keys. f32 (3xTF32): the forward and dq
# stream 32-key tiles past a CTA's 64 queries, dkv 32-query tiles past a
# CTA's 64 keys.
TILES = {"fwd": (128, 128), "dkv": (64, 128), "dq": (128, 64), "fwd f32": (64, 32), "dkv f32": (32, 64),
         "dq f32": (64, 32)}


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


def _pair_mask(seg_q, seg_kv) -> torch.Tensor:
    return seg_q[:, None, :, None] == seg_kv[:, None, None, :]


def flash_attention_plain(q, k, v, seg_q, seg_kv, sm_scale: float, save_residuals: bool = False):
    """Plain version: f32 logits ``[B, H, S, S]``, the library's mask
    value where the segment ids differ, softmax, ``p`` rounded to v's type,
    ``p·v``. Returns ``[B, H, S, 64]`` in v's type; with ``save_residuals``
    ``(out, l, m)``, the rows' f32 sums and maxima ``[B, H, S]``."""
    _check(q, k, v, seg_q, seg_kv)
    flash_attention_plain.calls.add(str(q.dtype))
    logits = (q.float() @ k.float().transpose(-1, -2)) * sm_scale
    logits = logits.masked_fill(~_pair_mask(seg_q, seg_kv), MASK_VALUE)
    out = torch.softmax(logits, dim=-1).to(v.dtype) @ v
    if not save_residuals:
        return out
    m = logits.max(dim=-1).values
    return out, torch.exp(logits - m[..., None]).sum(dim=-1), m


flash_attention_plain.calls = LaunchCount()


def _check_backward(q, l, m, **like_q) -> None:
    """``l, m`` f32 ``[B, H, S]``; every tensor of ``like_q`` (o, do) of q's shape and type."""
    b, h, s, _ = q.shape
    for name, t in like_q.items():
        if t.shape != q.shape or t.dtype != q.dtype:
            raise ValueError(f"{name} must match q ({q.dtype} {tuple(q.shape)}), got {t.dtype} {tuple(t.shape)}")
    for name, t in (("l", l), ("m", m)):
        if tuple(t.shape) != (b, h, s) or t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 [{b}, {h}, {s}], got {t.dtype} {tuple(t.shape)}")


def tiles_key(what: str, dtype: torch.dtype) -> str:
    """The :data:`TILES` key of kernel ``what`` (``fwd``, ``dkv``, ``dq``)
    at ``dtype``; the f32 kernels have tiles of their own."""
    return what if dtype == torch.bfloat16 else f"{what} f32"


def cta_rows(what: str, dtype: torch.dtype) -> int:
    """Rows a CTA of kernel ``what`` owns at ``dtype``: its tile counts
    (:func:`count_tiles`) have one entry per ``cta_rows`` rows of S."""
    tq, tk = TILES[tiles_key(what, dtype)]
    return tk if what == "dkv" else tq


def computed_tiles(seg_q, seg_kv, m, query_tile: int, key_tile: int) -> torch.Tensor:
    """Plain model of the tile skip of the kernels (forward, dkv, dq; bf16 and f32):
    ``[B, H, S/query_tile, S/key_tile]`` bool, True where the kernel computes
    the pair (query tile, key tile). A pair is skipped only when the
    ``[min, max]`` ranges of the two tiles' ids are disjoint, so that no
    pair of equal id lies in it whatever the order of the ids, and no query
    row of the query tile is one that no key matches (``m`` is the mask
    value there, and ``p = 1/l`` on every key). On a skipped pair ``p`` and
    ``ds`` are exactly 0. ``m`` is the forward's ``[B, H, S]`` row max."""
    b, s = seg_q.shape

    def ranges(seg, tile):
        t = seg.reshape(b, s // tile, tile)
        return t.amin(-1), t.amax(-1)

    qlo, qhi = ranges(seg_q, query_tile)
    klo, khi = ranges(seg_kv, key_tile)
    meet = (qlo[:, :, None] <= khi[:, None, :]) & (klo[:, None, :] <= qhi[:, :, None])
    nomatch = (m == MASK_VALUE).reshape(b, m.shape[1], s // query_tile, query_tile).any(-1)
    return meet[:, None] | nomatch[..., None]


def flash_attention_backward_plain(q, k, v, seg_q, seg_kv, o, l, m, do, sm_scale: float):
    """Plain version of the backward kernels: ``(dq, dk, dv)`` from the
    forward's ``o``, ``l``, ``m`` and the output gradient ``do``, on f32
    ``[B, H, S, S]`` tensors. ``p = exp(s − m)/l`` is rebuilt from the
    residuals (a masked pair gives 0, or ``1/l`` on a row no key matches);
    ``p`` and ``ds = (do·vᵀ − Σ o·do)·p·sm_scale`` are rounded to the input
    type before ``dv = pᵀ·do``, ``dk = dsᵀ·q`` and ``dq = ds·k``, as in the
    library's kernels, and every sum is f32."""
    _check(q, k, v, seg_q, seg_kv)
    _check_backward(q, l, m, o=o, do=do)
    flash_attention_backward_plain.calls.add(str(q.dtype))
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    logits = (qf @ kf.transpose(-1, -2)) * sm_scale
    logits = logits.masked_fill(~_pair_mask(seg_q, seg_kv), MASK_VALUE)
    p = torch.exp(logits - m[..., None]) * (1.0 / l)[..., None]
    del logits
    di = (o.float() * dof).sum(dim=-1)
    ds = (dof @ vf.transpose(-1, -2) - di[..., None]) * p
    ds = (ds * sm_scale).to(q.dtype).float()
    p = p.to(q.dtype).float()
    dv = (p.transpose(-1, -2) @ dof).to(v.dtype)
    dk = (ds.transpose(-1, -2) @ qf).to(k.dtype)
    dq = (ds @ kf).to(q.dtype)
    return dq, dk, dv


flash_attention_backward_plain.calls = LaunchCount()


def _lib() -> ctypes.CDLL:
    from ..kernels import build

    lib = build.load(_SOURCE)
    if not getattr(lib, "_argtypes_set", False):
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.flash_attention_segments.argtypes = [p] * 8 + [i] * 4 + [ll] * 12 + [ctypes.c_float, p, p]
        lib.flash_attention_count_tiles.argtypes = [p, ll]
        lib.flash_attention_segments.restype = lib.flash_attention_f32_planes.restype = ctypes.c_int
        lib._argtypes_set = True
    return lib


def bind_bwd(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Sets the argument types of a library built from ``flash_attention_bwd.cu``."""
    if not getattr(lib, "_argtypes_set", False):
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.flash_attention_dkv.argtypes = [p] * 11 + [i] * 4 + [ll] * 18 + [ctypes.c_float, p, p]
        lib.flash_attention_dq.argtypes = [p] * 10 + [i] * 4 + [ll] * 15 + [ctypes.c_float, p, p]
        lib.flash_attention_bwd_f32_planes.argtypes = [i]
        lib.flash_attention_bwd_f32_smem.argtypes = [i]
        lib.flash_attention_bwd_count_tiles.argtypes = [p, ll]
        lib.flash_attention_dkv.restype = lib.flash_attention_dq.restype = ctypes.c_int
        lib._argtypes_set = True
    return lib


def _lib_bwd() -> ctypes.CDLL:
    from ..kernels import build

    return bind_bwd(build.load(_SOURCE_BWD))


def _readable(t: torch.Tensor) -> bool:
    """Can the kernels read ``t`` through its strides: last dim contiguous,
    every 64-value row 16-byte aligned."""
    per16 = 16 // t.element_size()
    sb, sh, ss, sd = t.stride()
    return sd == 1 and not (sb % per16 or sh % per16 or ss % per16 or t.data_ptr() % 16)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` (contiguous) at a 16-byte aligned address: the bf16 kernels
    bulk-copy the ids and row statistics."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _strides(t: torch.Tensor, name: str) -> tuple[int, int, int]:
    """(batch, head, row) strides in elements of a tensor the kernel can read."""
    if not _readable(t):
        raise ValueError(
            f"{name}: the {HEAD_DIM} values of a head must be contiguous and 16-byte aligned, "
            f"got strides {t.stride()}"
        )
    b, h, s, _ = t.shape
    sb, sh, ss = t.stride()[:3]
    # a dim of size 1 never advances; give it its natural stride (a TMA map refuses 0)
    return (sb if b > 1 else h * s * HEAD_DIM), (sh if h > 1 else s * HEAD_DIM), ss


def _tma_readable(t: torch.Tensor, name: str) -> torch.Tensor:
    """``t`` as a bf16 kernel's TMA reads it: a view that repeats rows (a
    zero stride, e.g. k and v expanded over the heads) becomes a copy."""
    return t.contiguous() if min(_strides(t, name)) <= 0 else t


def _same_device(dev, **tensors) -> None:
    for name, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")


def _empty_bhsd(q: torch.Tensor) -> torch.Tensor:
    """An uninitialized ``[B, H, S, 64]`` view of a ``[B, S, H, 64]`` tensor."""
    b, h, s, dh = q.shape
    return torch.empty((b, s, h, dh), dtype=q.dtype, device=q.device).transpose(1, 2)


def _variant(name: str, q: torch.Tensor) -> str:
    return f"{name} {'bf16' if q.dtype == torch.bfloat16 else 'f32'}"


def _forward_cuda(q, k, v, seg_q, seg_kv, sm_scale: float, save_residuals: bool):
    """Launch the forward kernel: ``(out, l, m)``, ``l`` and ``m`` None
    unless ``save_residuals``."""
    dev = q.device
    _same_device(dev, k=k, v=v, seg_q=seg_q, seg_kv=seg_kv)
    b, h, s, _ = q.shape
    if q.dtype == torch.bfloat16:
        q, k, v = (_tma_readable(t, n) for t, n in ((q, "q"), (k, "k"), (v, "v")))
    seg_q, seg_kv = _aligned(seg_q.contiguous()), _aligned(seg_kv.contiguous())
    out = _empty_bhsd(q)
    l = m = None
    if save_residuals:
        l = torch.empty((b, h, s), dtype=torch.float32, device=dev)
        m = torch.empty_like(l)
    strides = [x for t, n in ((q, "q"), (k, "k"), (v, "v"), (out, "out")) for x in _strides(t, n)]
    lib = _lib()
    scratch = None  # the f32 kernel's split planes, allocated per call
    if q.dtype == torch.float32:
        scratch = torch.empty(lib.flash_attention_f32_planes() * q.numel(), dtype=torch.float32, device=dev)
    rc = lib.flash_attention_segments(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), seg_q.data_ptr(), seg_kv.data_ptr(),
        out.data_ptr(), l.data_ptr() if save_residuals else None,
        m.data_ptr() if save_residuals else None, b, h, s, int(q.dtype == torch.bfloat16),
        *strides, float(sm_scale), None if scratch is None else scratch.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    flash_attention_segments.launches.add(_variant("K5", q))
    _check_rc(rc, "flash_attention_segments")
    return out, l, m


def _backward_operands(q, k, v, seg_q, seg_kv, l, m, do, di):
    """Checks shared by the two backward wrappers; returns the operands the
    kernels read (ids and row statistics contiguous) and their strides."""
    _check(q, k, v, seg_q, seg_kv)
    _check_backward(q, l, m, do=do)
    if not q.is_cuda:
        raise ValueError("the backward kernels take CUDA tensors; CPU tensors go through "
                         "flash_attention_backward, which uses the plain version")
    _same_device(q.device, k=k, v=v, seg_q=seg_q, seg_kv=seg_kv, l=l, m=m, do=do, di=di)
    if di.shape != l.shape or di.dtype != torch.float32:
        raise ValueError(f"di must be float32 {tuple(l.shape)}, got {di.dtype} {tuple(di.shape)}")
    stats = [_aligned(t.contiguous()) for t in (seg_q, seg_kv, l, m, di)]
    strides = [x for t, n in ((q, "q"), (k, "k"), (v, "v"), (do, "do")) for x in _strides(t, n)]
    if q.dtype == torch.bfloat16 and min(strides) <= 0:  # TMA reads them: no repeated rows
        raise ValueError(f"the bf16 backward kernels need positive strides, got {strides}")
    return stats, strides


def _scratch(q: torch.Tensor, dkv: bool):
    """The f32 kernels' split planes (``flash_attention_bwd.cu``: the hi and
    lo of each operand, row-major and transposed), allocated per call; None
    for bf16."""
    if q.dtype == torch.bfloat16:
        return None
    planes = _lib_bwd().flash_attention_bwd_f32_planes(int(dkv))
    return torch.empty(planes * q.numel(), dtype=torch.float32, device=q.device)


def flash_attention_dkv(q, k, v, seg_q, seg_kv, l, m, do, di, sm_scale: float):
    """``(dk, dv)`` by the dkv kernel (CUDA tensors only). ``l, m`` are the
    forward's residuals and ``di = Σ_d o·do``, all ``[B, H, S]`` f32."""
    stats, strides = _backward_operands(q, k, v, seg_q, seg_kv, l, m, do, di)
    dk, dv = _empty_bhsd(k), _empty_bhsd(v)
    b, h, s, _ = q.shape
    scratch = _scratch(q, True)
    rc = _lib_bwd().flash_attention_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), *(t.data_ptr() for t in stats),
        dk.data_ptr(), dv.data_ptr(), b, h, s, int(q.dtype == torch.bfloat16), *strides,
        *_strides(dk, "dk"), *_strides(dv, "dv"), float(sm_scale),
        None if scratch is None else scratch.data_ptr(), torch.cuda.current_stream(q.device).cuda_stream,
    )
    flash_attention_dkv.launches.add(_variant("K5 dkv", q))
    _check_rc(rc, "flash_attention_dkv")
    return dk, dv


flash_attention_dkv.launches = LaunchCount()


def flash_attention_dq(q, k, v, seg_q, seg_kv, l, m, do, di, sm_scale: float) -> torch.Tensor:
    """``dq`` by the dq kernel (CUDA tensors only); arguments as
    :func:`flash_attention_dkv`."""
    stats, strides = _backward_operands(q, k, v, seg_q, seg_kv, l, m, do, di)
    dq = _empty_bhsd(q)
    b, h, s, _ = q.shape
    scratch = _scratch(q, False)
    rc = _lib_bwd().flash_attention_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), *(t.data_ptr() for t in stats),
        dq.data_ptr(), b, h, s, int(q.dtype == torch.bfloat16), *strides, *_strides(dq, "dq"),
        float(sm_scale), None if scratch is None else scratch.data_ptr(),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    flash_attention_dq.launches.add(_variant("K5 dq", q))
    _check_rc(rc, "flash_attention_dq")
    return dq


flash_attention_dq.launches = LaunchCount()


def count_tiles(counts: torch.Tensor | None) -> None:
    """Have the kernels (forward, dkv and dq; bf16 and f32) report what their
    tile skip did: until called with None, each launch writes, per CTA, the
    streamed tiles that two of its consumers computed (bf16: its two
    consumer warpgroups; f32: two warps of its one) and that it loaded into
    ``counts``, int32 CUDA ``[B, H, S/R, 3]`` at that launch's shape, R =
    :func:`cta_rows` (a larger grid makes the launch fail). A measurement of
    the kernels, held against :func:`computed_tiles` at :data:`TILES`, with
    ``m`` from the forward's own launch (a CTA holding a row no key matches
    computes every tile)."""
    if counts is not None and not (counts.is_cuda and counts.dtype == torch.int32 and counts.is_contiguous()):
        raise ValueError(f"counts must be a contiguous int32 CUDA tensor, got {counts.dtype} on {counts.device}")
    ptr, n = (None, 0) if counts is None else (counts.data_ptr(), counts.numel())
    _lib().flash_attention_count_tiles(ptr, n)
    _lib_bwd().flash_attention_bwd_count_tiles(ptr, n)


def flash_attention_backward(q, k, v, seg_q, seg_kv, o, l, m, do, sm_scale: float):
    """``(dq, dk, dv)``, each a ``[B, H, S, 64]`` view of a ``[B, S, H, 64]``
    tensor in its input's type. CUDA tensors go through the dkv and dq
    kernels (``di`` is a small torch expression, as in the library) or raise;
    CPU tensors take :func:`flash_attention_backward_plain`."""
    _check(q, k, v, seg_q, seg_kv)
    _check_backward(q, l, m, o=o, do=do)
    if not q.is_cuda:
        return flash_attention_backward_plain(q, k, v, seg_q, seg_kv, o, l, m, do, sm_scale)
    if not _readable(do) or min(_strides(do, "do")) <= 0:
        do = do.contiguous()  # whatever layout the next op's backward produced
    if q.dtype == torch.bfloat16:
        q, k, v = (_tma_readable(t, n) for t, n in ((q, "q"), (k, "k"), (v, "v")))
    di = (o.float() * do.float()).sum(dim=-1).contiguous()
    dk, dv = flash_attention_dkv(q, k, v, seg_q, seg_kv, l, m, do, di, sm_scale)
    dq = flash_attention_dq(q, k, v, seg_q, seg_kv, l, m, do, di, sm_scale)
    return dq, dk, dv


class FlashAttentionSegments(torch.autograd.Function):
    """The differentiable call: the forward saves ``o``, ``l`` and ``m``;
    the backward is :func:`flash_attention_backward`."""

    @staticmethod
    def forward(ctx, q, k, v, seg_q, seg_kv, sm_scale):
        if q.is_cuda:
            out, l, m = _forward_cuda(q, k, v, seg_q, seg_kv, sm_scale, True)
        else:
            out, l, m = flash_attention_plain(q, k, v, seg_q, seg_kv, sm_scale, save_residuals=True)
        ctx.save_for_backward(q, k, v, seg_q, seg_kv, out, l, m)
        ctx.sm_scale = sm_scale
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable  # as in the library: no higher-order gradient
    def backward(ctx, do):
        dq, dk, dv = flash_attention_backward(*ctx.saved_tensors, do, ctx.sm_scale)
        return dq, dk, dv, None, None, None


def flash_attention_segments(q, k, v, seg_q, seg_kv, sm_scale: float) -> torch.Tensor:
    """Attention confined to equal segment ids, ``[B, H, S, 64]`` in q's
    type. ``q, k, v [B, H, S, 64]`` bf16 or f32 (strided views allowed),
    ``seg_q, seg_kv [B, S]`` int32, S a multiple of 128 up to 8192.
    Differentiable in q, k and v."""
    _check(q, k, v, seg_q, seg_kv)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttentionSegments.apply(q, k, v, seg_q, seg_kv, sm_scale)
    if not q.is_cuda:
        return flash_attention_plain(q, k, v, seg_q, seg_kv, sm_scale)
    return _forward_cuda(q, k, v, seg_q, seg_kv, sm_scale, False)[0]


flash_attention_segments.launches = LaunchCount()
