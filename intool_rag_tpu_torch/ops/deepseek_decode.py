"""The DeepSeek-V2 decoder's one-token step in fused kernels
(``kernels/deepseek_decode.cu``), for ``models/deepseek_v2._DecodeSteps``.

A step of plain operations launched ~2,800 kernels on the card (27 layers
of ~100 small ones); these five wrappers do the work of ~60 of them a
layer in five launches: :func:`rms_norm` (optionally after the residual
add), :func:`mla_rope_latent` (YaRN rope of ``q_pe`` and ``k_pe``, the
latent's norm, the cache entry), :func:`mla_decode` (the absorbed attention
over the latent cache on the tensor cores, contiguous splits of a row's
positions a block and a combine; :func:`mla_decode_plan` mirrors the split),
:func:`moe_router` (softmax, greedy top-k, the dense gates and the expert
tally) and :func:`moe_combine` (the gate-weighted sum of the experts'
outputs). Each has its plain PyTorch version beside it (``*_reference``),
which a wrapper takes only for tensors on the CPU; on a CUDA tensor it
launches its kernel (bfloat16 only) or raises. Each counts its launches
(``.launches``).
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from .flat_fused import LaunchCount

_SOURCE = "deepseek_decode.cu"
MLA_CHUNK = 32  # mla_decode: positions a unit of the plan (the kernel's MLA_CHUNK)
MLA_HEADS = 16  # mla_decode: heads a tile, the M of its tensor-core products
MLA_RANK, MLA_ROPE = 512, 64  # mla_decode: the latent and rope widths it takes


def _lib() -> ctypes.CDLL:
    from ..kernels import build

    lib = build.load(_SOURCE)
    if not getattr(lib, "_argtypes_set", False):
        p, i, f, q = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
        lib.rms_norm.argtypes = [p, q, p, q, p, i, i, f, p, p, p]
        lib.mla_rope_latent.argtypes = [p, q, p, p, f, p, f, i, i, i, i, i, p, p, p]
        lib.mla_decode.argtypes = [p, q, q, p, q, q, p, q, q, p, q, i, i, i, i, i, i, i, f, p, p, p, p, q, q, p]
        lib.moe_router.argtypes = [p, i, i, i, f, p, p, p, i, p]
        lib.moe_combine.argtypes = [p, p, i, i, i, p, p]
        for fn in (lib.rms_norm, lib.mla_rope_latent, lib.mla_decode, lib.moe_router, lib.moe_combine):
            fn.restype = ctypes.c_int
        lib._argtypes_set = True
    return lib


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")


def _bf16(name: str, *tensors: torch.Tensor) -> None:
    for t in tensors:
        if t.dtype != torch.bfloat16:
            raise ValueError(f"{name}: the kernel takes bfloat16, got {t.dtype}")


def _rows(x: torch.Tensor, name: str) -> int:
    """The row stride of a 2-D tensor whose rows are contiguous."""
    if x.dim() != 2 or (x.shape[1] > 1 and x.stride(1) != 1):
        raise ValueError(f"{name}: expected [n, d] with contiguous rows, got {tuple(x.shape)} {x.stride()}")
    return x.stride(0)


# ---------------- rms_norm ----------------


def rms_norm_reference(x: torch.Tensor, weight: torch.Tensor, eps: float,
                       residual: torch.Tensor | None = None):
    """``(x · rsqrt(mean(x²) + eps)) · weight`` in f32, in x's dtype, over the
    last dim; with ``residual``, of ``s = x + residual`` (in x's dtype),
    returning ``(s, normed)``."""
    s = x if residual is None else x + residual
    sf = s.float()
    normed = (sf * torch.rsqrt(torch.mean(sf * sf, dim=-1, keepdim=True) + eps) * weight).to(x.dtype)
    return normed if residual is None else (s, normed)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float, residual: torch.Tensor | None = None):
    """RMSNorm of ``x [n, d]`` (rows contiguous), as
    :func:`rms_norm_reference`."""
    if not x.is_cuda:
        return rms_norm_reference(x, weight, eps, residual)
    _bf16("rms_norm", x, weight, *(() if residual is None else (residual,)))
    n, d = x.shape
    xs = _rows(x, "rms_norm")
    out = torch.empty((n, d), dtype=x.dtype, device=x.device)
    total = None if residual is None else torch.empty_like(out)
    rs = 0 if residual is None else _rows(residual, "rms_norm")
    _check(_lib().rms_norm(x.data_ptr(), xs, 0 if residual is None else residual.data_ptr(), rs,
                           weight.contiguous().data_ptr(), n, d, float(eps),
                           0 if total is None else total.data_ptr(), out.data_ptr(), _stream(x)), "rms_norm")
    rms_norm.launches.add("add+norm" if residual is not None else "norm")
    return out if residual is None else (total, out)


rms_norm.launches = LaunchCount()


# ---------------- mla_rope_latent ----------------


def mla_rope_latent_reference(qkv: torch.Tensor, positions: torch.Tensor, inv_freq: torch.Tensor, rope_scale: float,
                              kv_norm_weight: torch.Tensor, eps: float, heads: int, nope: int, rope: int, rank: int):
    """From the fused projection's rows ``qkv [B, heads·(nope + rope) + rank
    + rope]``: ``(q_pe [B, heads, rope], latent [B, rank + rope])``, the
    heads' rope queries and the shared rope key through YaRN rope at
    ``positions [B]`` (HF's de-interleave, then rotate-half, in f32, tables
    ``cos(pos · inv_freq) · rope_scale``), and the latent ``c`` through its
    RMSNorm, ``[c | k_pe]``."""
    b = qkv.shape[0]
    width = heads * (nope + rope)
    pe = torch.cat([qkv[:, :width].view(b, heads, nope + rope)[..., nope:], qkv[:, None, -rope:]], dim=1)
    angles = positions.float()[:, None] * inv_freq
    cos, sin = torch.cos(angles) * rope_scale, torch.sin(angles) * rope_scale
    cos, sin = torch.cat([cos, cos], dim=-1)[:, None], torch.cat([sin, sin], dim=-1)[:, None]
    xf = pe.float().unflatten(-1, (rope // 2, 2)).transpose(-1, -2).flatten(-2)
    rot = torch.cat([-xf[..., rope // 2:], xf[..., : rope // 2]], dim=-1)
    pe = (xf * cos + rot * sin).to(qkv.dtype)
    c = rms_norm_reference(qkv[:, width : width + rank], kv_norm_weight, eps)
    return pe[:, :heads].contiguous(), torch.cat([c, pe[:, heads]], dim=-1)


def mla_rope_latent(qkv: torch.Tensor, positions: torch.Tensor, inv_freq: torch.Tensor, rope_scale: float,
                    kv_norm_weight: torch.Tensor, eps: float, heads: int, nope: int, rope: int, rank: int):
    """As :func:`mla_rope_latent_reference`."""
    if not qkv.is_cuda:
        return mla_rope_latent_reference(qkv, positions, inv_freq, rope_scale, kv_norm_weight, eps, heads, nope,
                                         rope, rank)
    _bf16("mla_rope_latent", qkv, kv_norm_weight)
    b = qkv.shape[0]
    qs = _rows(qkv, "mla_rope_latent")
    if qkv.shape[1] != heads * (nope + rope) + rank + rope:
        raise ValueError(f"mla_rope_latent: row width {qkv.shape[1]} does not fit the heads and the latent")
    pos = positions.reshape(-1).to(torch.int64).contiguous()
    freq = inv_freq.float().contiguous()
    q_pe = torch.empty((b, heads, rope), dtype=qkv.dtype, device=qkv.device)
    latent = torch.empty((b, rank + rope), dtype=qkv.dtype, device=qkv.device)
    _check(_lib().mla_rope_latent(qkv.data_ptr(), qs, pos.data_ptr(), freq.data_ptr(), float(rope_scale),
                                  kv_norm_weight.contiguous().data_ptr(), float(eps), b, heads, nope, rope, rank,
                                  q_pe.data_ptr(), latent.data_ptr(), _stream(qkv)), "mla_rope_latent")
    mla_rope_latent.launches.add("rope+latent")
    return q_pe, latent


mla_rope_latent.launches = LaunchCount()


# ---------------- mla_decode ----------------


def mla_decode_reference(q_lat: torch.Tensor, q_pe: torch.Tensor, kv: torch.Tensor, valid: torch.Tensor, first: int,
                         end: int, scale: float) -> torch.Tensor:
    """One query a row over the latent cache: ``q_lat [H, B, r]``, ``q_pe
    [B, H, rope]``, ``kv [B, P, r + rope]`` (``[c | k_pe]``), ``valid [B,
    P]``; positions ``[first, end)``, a position seen where valid or the
    last (the query's own). Scores ``(q_lat·c + q_pe·k_pe) · scale`` and
    their softmax in f32, ``o_lat = p·c`` → ``[H, B, r]``, the products in
    the cache's dtype as :meth:`~..models.deepseek_v2.LatentAttention.attend`
    forms them (the kernel sums the scores in f32 and rounds ``p`` to bf16
    before normalising it)."""
    r = q_lat.shape[-1]
    lat = kv[:, first:end]
    seen = valid[:, first:end].clone()
    seen[:, -1] = True
    qq = torch.cat([q_lat.transpose(0, 1), q_pe.to(q_lat.dtype)], dim=-1)  # [B, H, r + rope]
    scores = torch.bmm(qq, lat.transpose(1, 2)).float() * scale
    p = torch.softmax(scores.masked_fill(~seen[:, None, :], -math.inf), dim=-1)
    return torch.bmm(p.to(lat.dtype), lat[..., :r]).transpose(0, 1).to(q_lat.dtype)


def _chunks(positions: int) -> int:
    return -(-positions // MLA_CHUNK)


def mla_decode_splits(rows: int, positions: int, sms: int) -> int:
    """Blocks of :func:`mla_decode` a row of 16 heads (``rows`` = batch ×
    heads / 16): ⌊sms / rows⌋, so the grid fills the card once, never more
    than the row's chunks of :data:`MLA_CHUNK` positions and at least one."""
    return max(1, min(sms // rows, _chunks(positions)))


def mla_decode_plan(rows: int, positions: int, sms: int) -> list[tuple[int, int, int]]:
    """The partition the kernel computes: block ``g`` holds split ``j = g %
    s`` of row ``g // s`` (``s`` of :func:`mla_decode_splits`), chunks
    ``[j·chunks // s, (j + 1)·chunks // s)``, as ``(row, first chunk, end
    chunk)``; the combine merges blocks ``[row·s, (row + 1)·s)``."""
    chunks, s = _chunks(positions), mla_decode_splits(rows, positions, sms)
    return [(g // s, g % s * chunks // s, (g % s + 1) * chunks // s) for g in range(rows * s)]


def check_mla_widths(heads: int, rank: int, rope: int) -> None:
    """Raises unless :func:`mla_decode`'s kernel takes these widths: heads in
    tiles of :data:`MLA_HEADS`, rank :data:`MLA_RANK`, rope :data:`MLA_ROPE`."""
    if heads % MLA_HEADS or rank != MLA_RANK or rope != MLA_ROPE:
        raise ValueError(f"mla_decode: the kernel takes heads in tiles of {MLA_HEADS}, rank {MLA_RANK} and rope "
                         f"{MLA_ROPE}; got {heads}, {rank}, {rope}")


@functools.lru_cache(maxsize=None)
def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def mla_decode(q_lat: torch.Tensor, q_pe: torch.Tensor, kv: torch.Tensor, valid: torch.Tensor, first: int, end: int,
               scale: float) -> torch.Tensor:
    """As :func:`mla_decode_reference`; on the card the scores and the
    latent sum run on the tensor cores, a block for each split of a row of
    :func:`mla_decode_plan`, then a combine. Heads a multiple of 16, rank
    512, rope 64 (:func:`check_mla_widths`)."""
    if not q_lat.is_cuda:
        return mla_decode_reference(q_lat, q_pe, kv, valid, first, end, scale)
    _bf16("mla_decode", q_lat, q_pe, kv)
    heads, b, r = q_lat.shape
    rope = q_pe.shape[-1]
    if (q_pe.shape[:2] != (b, heads) or kv.shape[0] != b or kv.shape[2] != r + rope or valid.shape != kv.shape[:2]
            or not 0 <= first < end <= kv.shape[1]):
        raise ValueError(f"mla_decode: shapes {tuple(q_lat.shape)} {tuple(q_pe.shape)} {tuple(kv.shape)} "
                         f"{tuple(valid.shape)} with positions [{first}, {end})")
    check_mla_widths(heads, r, rope)
    if (q_lat.stride(2) != 1 or q_pe.stride(2) != 1 or kv.stride(2) != 1 or valid.stride(1) != 1
            or valid.dtype != torch.bool):
        raise ValueError("mla_decode: the last dim of each input must be contiguous, valid bool")
    if (q_lat.stride(0) % 2 or q_lat.stride(1) % 2 or q_pe.stride(0) % 2 or q_pe.stride(1) % 2
            or q_lat.data_ptr() % 4 or q_pe.data_ptr() % 4 or kv.stride(0) % 8 or kv.stride(1) % 8
            or kv.data_ptr() % 16):
        raise ValueError("mla_decode: the queries need even strides and 4-byte aligned starts, the cache 16-byte "
                         "aligned rows")
    rows = b * (heads // MLA_HEADS)
    splits = mla_decode_splits(rows, end - first, _sms(kv.device))
    o_part = torch.empty((rows * splits, MLA_HEADS, r), dtype=torch.float32, device=kv.device)
    ml = torch.empty((2, rows * splits, MLA_HEADS), dtype=torch.float32, device=kv.device)
    out = torch.empty((heads, b, r), dtype=q_lat.dtype, device=kv.device)
    _check(_lib().mla_decode(q_lat.data_ptr(), q_lat.stride(0), q_lat.stride(1), q_pe.data_ptr(), q_pe.stride(0),
                             q_pe.stride(1), kv.data_ptr(), kv.stride(0), kv.stride(1), valid.data_ptr(),
                             valid.stride(0), b, heads, r, rope, int(first), int(end), splits, float(scale),
                             o_part.data_ptr(), ml[0].data_ptr(), ml[1].data_ptr(), out.data_ptr(), out.stride(0),
                             out.stride(1), _stream(kv)), "mla_decode")
    mla_decode.launches.add("mma+combine")
    return out


mla_decode.launches = LaunchCount()


# ---------------- moe_router ----------------


def moe_router_reference(logits: torch.Tensor, k: int, factor: float, real: torch.Tensor | None = None,
                         tally: torch.Tensor | None = None, tally_rows: int = 1) -> torch.Tensor:
    """``logits [T, E]`` f32 → the dense gates ``[T, E]``: the softmax's
    top ``k`` (greedy, not renormalised) times ``factor``, 0 elsewhere.
    With ``tally [rows, 3]`` int64: adds to its first ``tally_rows`` rows
    the pairs of the tokens ``real [T]`` marks (all where None), the experts
    they touch, and the largest expert's pairs."""
    scores = torch.softmax(logits.float(), dim=-1)
    w, idx = torch.topk(scores, k, dim=-1)
    gates = torch.zeros_like(scores).scatter_(1, idx, w * factor)
    if tally is not None:
        ones = torch.ones_like(idx) if real is None else real[:, None].expand(idx.shape).to(idx.dtype)
        counts = torch.zeros(logits.shape[1], dtype=torch.int64, device=logits.device).scatter_add_(
            0, idx.reshape(-1), ones.reshape(-1))
        tally[:tally_rows] += torch.stack([counts.sum(), (counts > 0).sum(), counts.max()])
    return gates


def moe_router(logits: torch.Tensor, k: int, factor: float, real: torch.Tensor | None = None,
               tally: torch.Tensor | None = None, tally_rows: int = 1) -> torch.Tensor:
    """As :func:`moe_router_reference` (at most 64 experts on the card)."""
    if not logits.is_cuda:
        return moe_router_reference(logits, k, factor, real, tally, tally_rows)
    t, e = logits.shape
    if logits.dtype != torch.float32 or not logits.is_contiguous():
        raise ValueError("moe_router: expected contiguous float32 logits")
    if real is not None and (real.dtype != torch.bool or not real.is_contiguous() or real.numel() != t):
        raise ValueError("moe_router: real must be a contiguous bool [T]")
    if tally is not None and (tally.dtype != torch.int64 or not tally.is_contiguous() or tally.shape[1] != 3
                              or not 0 < tally_rows <= tally.shape[0]):
        raise ValueError("moe_router: tally must be a contiguous int64 [rows, 3]")
    gates = torch.empty_like(logits)
    _check(_lib().moe_router(logits.data_ptr(), t, e, int(k), float(factor), 0 if real is None else real.data_ptr(),
                             gates.data_ptr(), 0 if tally is None else tally.data_ptr(), int(tally_rows),
                             _stream(logits)), "moe_router")
    moe_router.launches.add("router")
    return gates


moe_router.launches = LaunchCount()


# ---------------- moe_combine ----------------


def moe_combine_reference(out: torch.Tensor, gates: torch.Tensor) -> torch.Tensor:
    """``y [T, hidden] = Σ_e gates[t, e] · out[e, t]`` in f32, in out's
    dtype (``out [E, T, hidden]``, ``gates [T, E]`` f32)."""
    return torch.einsum("eth,te->th", out.float(), gates.float()).to(out.dtype)


def moe_combine(out: torch.Tensor, gates: torch.Tensor) -> torch.Tensor:
    """As :func:`moe_combine_reference`; the card skips the zero gates."""
    if not out.is_cuda:
        return moe_combine_reference(out, gates)
    _bf16("moe_combine", out)
    e, t, h = out.shape
    if gates.shape != (t, e) or gates.dtype != torch.float32 or not (gates.is_contiguous() and out.is_contiguous()):
        raise ValueError("moe_combine: expected contiguous out [E, T, H] and float32 gates [T, E]")
    y = torch.empty((t, h), dtype=out.dtype, device=out.device)
    _check(_lib().moe_combine(out.data_ptr(), gates.data_ptr(), e, t, h, y.data_ptr(), _stream(out)), "moe_combine")
    moe_combine.launches.add("combine")
    return y


moe_combine.launches = LaunchCount()
