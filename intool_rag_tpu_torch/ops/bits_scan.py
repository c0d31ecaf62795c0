"""Probed scan over planar 1-bit residual codes (port of
``intool_rag_tpu/ops/bits_pallas.py``).

The capacity tier (``index/bits_index.py``) keeps each IVF list as a
contiguous, block-aligned region of one store. A query tile of 8 scans the
blocks of its probed lists; the score of a slot is the exact IVF-residual
decomposition ``q·c_list + q·r̂`` with ``r̂`` the sign-quantized residual.
On the card the scan runs in the hand-written CUDA kernel of
``kernels/bits_scan.cu``: codes stream as packed bits and are unpacked to
±1 in registers in front of the tensor cores, so the 16×-wider dequantized
form never exists in device memory; only the ``[Q, n_cand]`` grouped-max
candidates are written. :func:`bits_scan_reference` is the plain version;
:func:`bits_scan` takes it only for tensors on the CPU, and launches the
kernel or raises on CUDA tensors.

Planar packing: byte ``j`` of a row holds bit-plane ``b`` at dim
``b·(D/8) + j``, and each plane is one scale group (8 per row). Empty
slots carry ``scales[:, 0, :] = -1`` and score ``-inf``.

Candidate layout (the fold tail relies on it): with
``lw = block_n/group_l``, the block ``bi`` of probe ``p`` fills columns
``(p·blocks_per_list + bi)·lw + lane`` with the max over ``g`` of slot
``g·lw + lane`` of that block, the smallest maximizing ``g`` winning.
"""

from __future__ import annotations

import ctypes

import torch

from .flat_fused import LaunchCount, _candidates_topk, _check_rc
from .topk import NEG_INF

N_PLANES = 8  # bit planes per byte == scale groups per row
_SOURCE = "bits_scan.cu"
# plane widths W = D/8 the kernel tiles: whole 16-dim MMA steps, unrolled
KERNEL_DIMS = (128, 256, 384, 1024)
_SMEM_LIMIT = 227 * 1024


def encode_bits_planar(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Sign-quantize rows to planar-packed bits + per-plane scales.

    ``x [n, d]`` (d % 8 == 0) → ``codes [n, d//8] uint8``, ``scales [n, 8]
    f32``: plane ``b`` covers dims ``[b·d/8, (b+1)·d/8)`` and
    ``scale_b = mean |x_plane|``."""
    n, d = x.shape
    if d % N_PLANES:
        raise ValueError(f"d={d} must be divisible by {N_PLANES}")
    planes = x.reshape(n, N_PLANES, d // N_PLANES)
    scales = planes.abs().mean(dim=2)
    weights = (1 << torch.arange(N_PLANES, device=x.device, dtype=torch.int32))[None, :, None]
    codes = ((planes >= 0).to(torch.int32) * weights).sum(dim=1).to(torch.uint8)
    return codes, scales


def _pm1(ci: torch.Tensor, b: int) -> torch.Tensor:
    return (2 * ((ci >> b) & 1) - 1).float()


def decode_bits_planar(codes: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`encode_bits_planar` (``scales [n, 8]``)."""
    ci = codes.to(torch.int32)
    planes = [_pm1(ci, b) * scales[:, b : b + 1].float() for b in range(N_PLANES)]
    return torch.cat(planes, dim=1)


def _check_scan(qb, codes, scales, probe_blocks, c_sel, blocks_per_list, block_n, group_l):
    q, d = qb.shape
    n_cap, w = codes.shape
    if q % 8:
        raise ValueError("pad queries to a multiple of 8")
    if w * N_PLANES != d:
        raise ValueError(f"codes width {w} != D/8 = {d // N_PLANES}")
    if n_cap % block_n:
        raise ValueError("store not block-aligned")
    if tuple(scales.shape) != (n_cap // block_n, N_PLANES, block_n):
        raise ValueError(
            f"scales must be block-major [N_cap/block_n, 8, block_n], got {tuple(scales.shape)}"
        )
    if block_n % group_l:
        raise ValueError(f"block_n={block_n} must be a multiple of group_l={group_l}")
    qt_n, nprobe = probe_blocks.shape
    if qt_n != q // 8 or tuple(c_sel.shape) != (q, nprobe):
        raise ValueError("probe_blocks/c_sel shape mismatch")
    if blocks_per_list < 1:
        raise ValueError(f"blocks_per_list={blocks_per_list} must be positive")


def bits_scan_reference(
    qb, codes, scales, probe_blocks, c_sel, *, blocks_per_list: int, block_n: int, group_l: int
):
    """Plain version of the scan kernel: candidates ``(vals [Q, n_cand] f32,
    slot ids i32)``, one query tile at a time. ``qb`` holds the queries
    already rounded to bf16; products and the plane sum run in f32, planes
    in order 0..7, each times its per-slot scale."""
    q, d = qb.shape
    w = d // N_PLANES
    qt_n, nprobe = probe_blocks.shape
    lw = block_n // group_l
    n_cand = nprobe * blocks_per_list * lw
    dev = codes.device
    codes3 = codes.reshape(-1, block_n, w)
    offs = torch.arange(blocks_per_list, device=dev)
    g_iota = torch.arange(group_l, device=dev, dtype=torch.int32)[None, None, :, None]
    lane = torch.arange(lw, device=dev, dtype=torch.int32)
    vals = torch.empty((q, n_cand), dtype=torch.float32, device=dev)
    idx = torch.empty((q, n_cand), dtype=torch.int32, device=dev)
    for t in range(qt_n):
        blk = (probe_blocks[t].long()[:, None] + offs[None, :]).reshape(-1)  # [P·B]
        ci = codes3[blk].to(torch.int32)  # [P·B, bn, W]
        sc = scales[blk].float()  # [P·B, 8, bn]
        q_tile = qb[8 * t : 8 * t + 8].float()
        cent = c_sel[8 * t : 8 * t + 8].float().repeat_interleave(blocks_per_list, dim=1)
        scores = cent[:, :, None].expand(8, blk.shape[0], block_n).clone()
        for b in range(N_PLANES):
            part = q_tile[:, b * w : (b + 1) * w] @ _pm1(ci, b).reshape(-1, w).T
            scores = scores + part.reshape(8, -1, block_n) * sc[None, :, b, :]
        scores = torch.where((sc[:, 0, :] >= 0.0)[None], scores, NEG_INF)
        s4 = scores.reshape(8, -1, group_l, lw)
        gmax = s4.amax(dim=2)
        garg = torch.where(s4 == gmax[:, :, None, :], g_iota, group_l).amin(dim=2)
        base = (blk * block_n).to(torch.int32)[None, :, None]
        vals[8 * t : 8 * t + 8] = gmax.reshape(8, n_cand)
        idx[8 * t : 8 * t + 8] = (base + garg * lw + lane).reshape(8, n_cand)
    return vals, idx


def _lib() -> ctypes.CDLL:
    from ..kernels import build

    lib = build.load(_SOURCE)
    if not getattr(lib, "_argtypes_set", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.bits_scan.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, p, p, p]
        lib.bits_scan.restype = ctypes.c_int
        lib._argtypes_set = True
    return lib


def _kernel_operand(t: torch.Tensor, dtype, dev, name: str) -> None:
    if not (t.is_cuda and t.device == dev and t.dtype == dtype and t.is_contiguous()):
        raise ValueError(
            f"{name} must be a contiguous {dtype} tensor on {dev}, got {t.dtype} "
            f"{tuple(t.shape)} on {t.device} (contiguous: {t.is_contiguous()})"
        )
    if t.data_ptr() % 16 != 0:
        raise ValueError(f"{name} is not 16-byte aligned")


def bits_scan(
    qb, codes, scales, probe_blocks, c_sel, *, blocks_per_list: int, block_n: int, group_l: int
):
    """Scan candidates ``(vals [Q, n_cand] f32, slot ids [Q, n_cand] i32)``,
    ``n_cand = nprobe·blocks_per_list·block_n/group_l``. ``qb [Q, D]`` bf16
    in tiles of 8; ``probe_blocks [Q/8, nprobe]`` i32 start block of each
    probed list; ``c_sel [Q, nprobe]`` f32 centroid dots."""
    _check_scan(qb, codes, scales, probe_blocks, c_sel, blocks_per_list, block_n, group_l)
    if not codes.is_cuda:
        return bits_scan_reference(
            qb, codes, scales, probe_blocks, c_sel,
            blocks_per_list=blocks_per_list, block_n=block_n, group_l=group_l,
        )
    q, d = qb.shape
    qt_n, nprobe = probe_blocks.shape
    if d not in KERNEL_DIMS:
        raise ValueError(
            f"the scan kernel tiles each plane in 16-dim steps for D in {KERNEL_DIMS}, got D={d}"
        )
    if block_n % 32:
        raise ValueError(f"the scan kernel takes block_n in multiples of 32 slots, got {block_n}")
    smem = 8 * d * 2 + 8 * (block_n + 4) * 4
    if smem > _SMEM_LIMIT:
        raise ValueError(
            f"block_n={block_n} at D={d} needs {smem} bytes of shared memory (> {_SMEM_LIMIT})"
        )
    if qt_n * nprobe * blocks_per_list >= 2**31:
        raise ValueError("too many (tile, probe, block) work items for one launch")
    dev = codes.device
    _kernel_operand(qb, torch.bfloat16, dev, "queries")
    _kernel_operand(codes, torch.uint8, dev, "codes")
    _kernel_operand(scales, torch.float32, dev, "scales")
    _kernel_operand(probe_blocks, torch.int32, dev, "probe_blocks")
    _kernel_operand(c_sel, torch.float32, dev, "c_sel")
    n_cand = nprobe * blocks_per_list * (block_n // group_l)
    vals = torch.empty((q, n_cand), dtype=torch.float32, device=dev)
    idx = torch.empty((q, n_cand), dtype=torch.int32, device=dev)
    rc = _lib().bits_scan(
        qb.data_ptr(), codes.data_ptr(), scales.data_ptr(), probe_blocks.data_ptr(),
        c_sel.data_ptr(), q, d, scales.shape[0], block_n, nprobe, blocks_per_list, group_l,
        vals.data_ptr(), idx.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
    )
    bits_scan.launches.add("K3")
    _check_rc(rc, "bits_scan")
    return vals, idx


bits_scan.launches = LaunchCount()


def ivf_bits_topk(
    queries: torch.Tensor,  # [Q, D] f32 (Q % 8 == 0; caller pads)
    codes: torch.Tensor,  # [N_cap, D//8] uint8, list-major block-aligned
    scales: torch.Tensor,  # [N_cap/block_n, 8, block_n] f32 block-major
    probe_blocks: torch.Tensor,  # [Q//8, nprobe] i32 start block of each probe
    c_sel: torch.Tensor,  # [Q, nprobe] f32 per-query centroid dots
    k: int,
    *,
    blocks_per_list: int,
    block_n: int = 1024,
    group_l: int = 8,
    tail: str = "fold",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Probed scan + top-k tail (counterpart of ``ivf_bits_topk_pallas``).
    Returns ``(scores [Q, k] f32, SLOT ids [Q, k] i32)``; callers map slots
    to global rows through the store's gid table. The 8 queries of a tile
    share the tile's probe list, each with its own centroid dot in
    ``c_sel``. ``tail``: ``fold`` (fold-by-2 then exact top-k, when
    ``n_cand >= 8·k``) or ``blocked`` (exact)."""
    if tail not in ("fold", "blocked", "exact"):
        raise ValueError(f"tail must be 'fold' or 'blocked', got {tail!r}")
    qb = queries.to(torch.bfloat16).contiguous()
    cand_vals, cand_idx = bits_scan(
        qb, codes, scales, probe_blocks.to(torch.int32).contiguous(), c_sel.float().contiguous(),
        blocks_per_list=blocks_per_list, block_n=block_n, group_l=group_l,
    )
    return _candidates_topk(cand_vals, cand_idx, k, tail="fold" if tail == "fold" else "exact")
