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
candidates are written. A scan plan groups the (tile, probe) pairs that
probe the same list (:func:`scan_plan_reference` is its plain model), so
each probed block is read once for up to :data:`GROUP_CAP` query tiles.
:func:`bits_scan_reference` is the plain version; :func:`bits_scan` takes
it only for tensors on the CPU, and launches the kernel or raises on CUDA
tensors.

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
# query tiles that share one read of a block (the kernel's registers hold at
# most 4): the plan's group size, the fastest of 1..4 on the card (PERF.md §6)
GROUP_CAP = 4


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


def _slot_scores(q_tile, cent, ci, sc):
    """Scores ``[8, n]`` of ``n`` slots for one query tile: ``q_tile [8, D]``
    (bf16 values), ``cent [8, n]`` each query's centroid dot, ``ci [n, W]``
    the slots' codes (int32), ``sc [8, n]`` their plane scales. Each plane's
    products are summed exactly (f64) and rounded to f32 once, so a score does
    not depend on which other slots share the call; then the plane times its
    scale is added in f32, planes in order 0..7, and an empty slot is -inf."""
    w = ci.shape[1]
    q64 = q_tile.double()
    scores = cent.float()
    for b in range(N_PLANES):
        part = (q64[:, b * w : (b + 1) * w] @ _pm1(ci, b).double().T).float()
        scores = scores + part * sc[b][None, :]
    return torch.where(sc[0][None, :] >= 0.0, scores, NEG_INF)


def _grouped_max(scores, blk, block_n: int, group_l: int):
    """``scores [8, nb, block_n]`` of blocks ``blk [nb]`` → the candidates
    ``(vals, idx) [8, nb·lw]``: per lane the max over g, the smallest
    maximizing g winning (an all -inf group gives g = 0)."""
    lw = block_n // group_l
    s4 = scores.reshape(scores.shape[0], -1, group_l, lw)
    gmax = s4.amax(dim=2)
    g_iota = torch.arange(group_l, device=scores.device, dtype=torch.int32)[None, None, :, None]
    garg = torch.where(s4 == gmax[:, :, None, :], g_iota, group_l).amin(dim=2)
    lane = torch.arange(lw, device=scores.device, dtype=torch.int32)
    base = (blk * block_n).to(torch.int32)[None, :, None]
    return gmax.reshape(scores.shape[0], -1), (base + garg * lw + lane).reshape(scores.shape[0], -1)


def bits_scan_reference(
    qb, codes, scales, probe_blocks, c_sel, *, blocks_per_list: int, block_n: int, group_l: int
):
    """Plain version of the scan kernel: candidates ``(vals [Q, n_cand] f32,
    slot ids i32)``, one query tile at a time. ``qb`` holds the queries
    already rounded to bf16; each plane's products are summed exactly and
    rounded to f32, then times its per-slot scale added in f32, planes in
    order 0..7 (:func:`_slot_scores`)."""
    q, d = qb.shape
    w = d // N_PLANES
    qt_n, nprobe = probe_blocks.shape
    n_cand = nprobe * blocks_per_list * (block_n // group_l)
    dev = codes.device
    codes3 = codes.reshape(-1, block_n, w)
    offs = torch.arange(blocks_per_list, device=dev)
    vals = torch.empty((q, n_cand), dtype=torch.float32, device=dev)
    idx = torch.empty((q, n_cand), dtype=torch.int32, device=dev)
    for t in range(qt_n):
        blk = (probe_blocks[t].long()[:, None] + offs[None, :]).reshape(-1)  # [P·B]
        ci = codes3[blk].to(torch.int32).reshape(-1, w)  # [P·B·bn, W]
        sc = scales[blk].float().permute(1, 0, 2).reshape(N_PLANES, -1)  # [8, P·B·bn]
        cent = c_sel[8 * t : 8 * t + 8].float().repeat_interleave(blocks_per_list * block_n, dim=1)
        scores = _slot_scores(qb[8 * t : 8 * t + 8], cent, ci, sc)
        vals[8 * t : 8 * t + 8], idx[8 * t : 8 * t + 8] = _grouped_max(
            scores.reshape(8, -1, block_n), blk, block_n, group_l)
    return vals, idx


def scan_plan_reference(probe_blocks: torch.Tensor, group_cap: int = GROUP_CAP):
    """Plain model of the kernel's scan plan over the (tile, probe) pairs
    ``i = tile·nprobe + probe`` of ``probe_blocks [T, nprobe]``: ``order
    [T·nprobe] i32``, the pairs sorted by (first block of the probed list,
    i), and ``groups [n_groups, 3] i32``, each ``(block, first, count)``: a
    run of ``count <= group_cap`` pairs of equal block at ``order[first:]``,
    cut from the start of each run. A work item is (group, bi): block
    ``block + bi``, read once for the group's query tiles. (The kernel plans
    rectangles of at most 2,048 pairs at a time.)"""
    pb = probe_blocks.reshape(-1).long()
    n = pb.numel()
    pos = torch.arange(n, device=pb.device)
    order = torch.argsort(pb * n + pos)  # keys are distinct: a stable, total order
    blk = pb[order]
    new_run = torch.ones(n, dtype=torch.bool, device=pb.device)
    new_run[1:] = blk[1:] != blk[:-1]
    run_start = torch.cummax(torch.where(new_run, pos, 0), dim=0).values
    run_id = torch.cumsum(new_run.long(), dim=0) - 1
    run_end = run_start + torch.bincount(run_id)[run_id]
    first = ((pos - run_start) % group_cap == 0).nonzero()[:, 0]
    count = torch.clamp(run_end[first] - first, max=group_cap)
    groups = torch.stack([blk[first], first, count], dim=1).to(torch.int32)
    return groups, order.to(torch.int32)


def _lib() -> ctypes.CDLL:
    from ..kernels import build

    lib = build.load(_SOURCE)
    if not getattr(lib, "_argtypes_set", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.bits_scan.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, i, p, p, p, p]
        lib.bits_scan.restype = ctypes.c_int
        lib.bits_scan_plan.argtypes = [p, i, i, i, p, p]
        lib.bits_scan_plan.restype = ctypes.c_int
        lib.bits_scan_plan_ints.restype = ctypes.c_int
        lib.bits_scan_smem.argtypes = [i]
        lib.bits_scan_smem.restype = ctypes.c_int
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
    if qt_n * nprobe * blocks_per_list >= 2**31 or codes.shape[0] >= 2**31 - 1:
        raise ValueError("too many (tile, probe, block) work items or slots for one launch")
    dev = codes.device
    _kernel_operand(qb, torch.bfloat16, dev, "queries")
    _kernel_operand(codes, torch.uint8, dev, "codes")
    _kernel_operand(scales, torch.float32, dev, "scales")
    _kernel_operand(probe_blocks, torch.int32, dev, "probe_blocks")
    _kernel_operand(c_sel, torch.float32, dev, "c_sel")
    n_cand = nprobe * blocks_per_list * (block_n // group_l)
    vals = torch.empty((q, n_cand), dtype=torch.float32, device=dev)
    idx = torch.empty((q, n_cand), dtype=torch.int32, device=dev)
    lib = _lib()
    plan = torch.empty(lib.bits_scan_plan_ints(), dtype=torch.int32, device=dev)  # the scan plan's scratch
    rc = lib.bits_scan(
        qb.data_ptr(), codes.data_ptr(), scales.data_ptr(), probe_blocks.data_ptr(),
        c_sel.data_ptr(), q, d, scales.shape[0], block_n, nprobe, blocks_per_list, group_l,
        GROUP_CAP, vals.data_ptr(), idx.data_ptr(), plan.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
    )
    bits_scan.launches.add("K3")
    _check_rc(rc, "bits_scan")
    return vals, idx


bits_scan.launches = LaunchCount()


def scan_plan(probe_blocks: torch.Tensor, group_cap: int = GROUP_CAP):
    """The plan the kernel builds before its scan, as :func:`scan_plan_reference`
    returns it: ``(groups [n_groups, 3], order [T·nprobe])`` i32 on the card
    (one rectangle: at most 2,048 pairs). For checks; :func:`bits_scan`
    builds its own."""
    qt_n, nprobe = probe_blocks.shape
    dev = probe_blocks.device
    _kernel_operand(probe_blocks, torch.int32, dev, "probe_blocks")
    n = qt_n * nprobe
    plan = torch.empty(4 + 5 * n, dtype=torch.int32, device=dev)
    _check_rc(_lib().bits_scan_plan(probe_blocks.data_ptr(), qt_n, nprobe, group_cap, plan.data_ptr(),
                                    torch.cuda.current_stream(dev).cuda_stream), "bits_scan_plan")
    n_groups = int(plan[0])
    groups = plan[4 : 4 + 4 * n].reshape(n, 4)[:n_groups, :3]
    return groups, plan[4 + 4 * n :]


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
