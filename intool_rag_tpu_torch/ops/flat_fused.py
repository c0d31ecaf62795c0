"""Fused flat-search score + partial top-k (port of
``intool_rag_tpu/ops/flat_pallas.py``).

The scoring pass runs in the hand-written CUDA kernels of
``kernels/flat_partial_topk.cu`` (K1: bf16/f16/f32 corpus, K2: int8
corpus); they write only the ``[Q, N/group_l]`` grouped-max candidates, and
the small top-k tail over those runs as torch ops. :func:`plan_launch`
picks the tensor-core kernels' query-tile width and how a corpus block's
tiles split into work items. The same candidate arrays
come from the plain versions :func:`partial_topk_reference` and
:func:`partial_topk_int8_reference`; a wrapper takes them only for tensors
that lie on the CPU. On a CUDA tensor it launches its kernel or raises.

Candidate layout (the TPU kernels' contract, which the fold tail relies
on): corpus block ``b`` covers rows ``[b·block_n, (b+1)·block_n)``,
``block_n = 128·group_l``, and
``cand[q, b·128 + lane] = max_j score[q, b·block_n + j·128 + lane]`` with
the smallest maximizing ``j``.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from .topk import NEG_INF, blocked_topk, top_k

LANES = 128
_SOURCE = "flat_partial_topk.cu"
# query-tile widths (the wgmma N) the tensor-core kernels are built for
TILE_WIDTHS = (8, 16, 32, 64, 128)
# kernel variant -> the C entry point's kind, and the widest tile whose
# accumulators, running max and j fit in a thread's registers
_KINDS = {
    "K1 bf16": (0, 128), "K1 bf16 precise": (1, 128), "K1 f16": (2, 128),
    "K2 int8": (3, 128), "K2 int8+q2": (4, 64), "K2 int8+c2": (5, 64), "K2 int8r": (6, 64),
    "K1 f32": (7, 128),
}
MAX_GROUP_L = 128  # the kernels keep j in one byte
# a split block's last CTA merges splits x width partial rows of 128 lanes
# alone: 16 or 32 splits of 64-128-wide tiles took 3.7-27 ms on the H100
# where the unsplit launch took 0.18-0.39 ms (2 x 128 and 8 x 16 stayed
# fast; chip_smoke.py phase 13's shard shapes, NVIDIA H100 80GB HBM3, 700 W)
MAX_MERGE_ROWS = 256


class LaunchCount:
    """Kernel launches a wrapper made, per variant (thread-safe)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.by_variant: dict[str, int] = {}

    def add(self, variant: str) -> None:
        with self._lock:
            self.by_variant[variant] = self.by_variant.get(variant, 0) + 1

    def reset(self) -> None:
        with self._lock:
            self.by_variant = {}

    @property
    def count(self) -> int:
        return sum(self.by_variant.values())


def choose_group_width(n: int, k: int, target_recall: float = 0.98) -> int:
    """Largest power-of-two group width L (≤128) with expected recall
    ``1 - k·L/(2N)`` ≥ target."""
    l = 128
    while l > 8 and 1.0 - (k * l) / (2.0 * max(n, 1)) < target_recall:
        l //= 2
    return l


def _check_layout(corpus: torch.Tensor, group_l: int, valid_n: int, d_multiple: int) -> None:
    n, d = corpus.shape
    block_n = LANES * group_l
    if n % block_n != 0 or d % d_multiple != 0:
        raise ValueError(
            f"corpus shape {tuple(corpus.shape)} not padded to ({block_n}, {d_multiple})"
        )
    if not 0 <= valid_n <= n:
        raise ValueError(f"valid_n={valid_n} outside [0, {n}]")


def _d_multiple(variant: str) -> int:
    """Elements in one 128-byte k-chunk of the variant's operands: D must
    be a multiple of it."""
    return 128 if variant.startswith("K2") else 32 if variant == "K1 f32" else 64


def plan_launch(q: int, n: int, d: int, group_l: int, n_sm: int, variant: str) -> tuple[int, int]:
    """``(width, splits)`` of a tensor-core K1/K2 launch: the query-tile
    width (the smallest of :data:`TILE_WIDTHS` that holds all ``q`` queries,
    else the variant's widest), and into how many work items each corpus
    block's ``group_l`` tiles split: none where the blocks already give the
    ``n_sm`` persistent CTAs an item each, else the divisor of ``group_l``
    that gives each CTA the fewest 128-row tiles (rounds of items times
    tiles per item), the smallest such, among the splits whose merge stays
    small: ``splits · width ≤ MAX_MERGE_ROWS``. Raises on shapes the kernel
    refuses."""
    if variant not in _KINDS:
        raise ValueError(f"no tensor-core kernel for {variant!r}")
    d_multiple = _d_multiple(variant)
    if q < 1 or n < 1 or d < 1 or n_sm < 1:
        raise ValueError(f"empty launch: Q {q}, N {n}, D {d}, {n_sm} SMs")
    if not 1 <= group_l <= MAX_GROUP_L:
        raise ValueError(f"group_l {group_l} outside [1, {MAX_GROUP_L}]")
    if n % (LANES * group_l) != 0 or d % d_multiple != 0:
        raise ValueError(f"corpus [{n}, {d}] not padded to ({LANES * group_l}, {d_multiple})")
    widest = _KINDS[variant][1]
    width = next((w for w in TILE_WIDTHS if q <= w <= widest), widest)
    items = -(-q // width) * (n // (LANES * group_l))
    if items >= n_sm:
        return width, 1
    splits = min((s for s in range(1, group_l + 1) if group_l % s == 0 and s * width <= MAX_MERGE_ROWS),
                 key=lambda s: (-(-items * s // n_sm) * (group_l // s), s))
    return width, splits


def _grouped_max(scores: torch.Tensor, group_l: int, valid_n: int):
    """The shared epilogue (``_reduce_block``) on full [Q, N] scores."""
    q, n = scores.shape
    rows = torch.arange(n, device=scores.device)
    scores = torch.where(rows[None, :] < valid_n, scores, NEG_INF)
    nb = n // (LANES * group_l)
    s3 = scores.reshape(q, nb, group_l, LANES)
    gmax = s3.amax(dim=2)
    j = torch.arange(group_l, device=scores.device, dtype=torch.int32)[None, None, :, None]
    garg = torch.where(s3 == gmax[:, :, None, :], j, group_l).amin(dim=2)
    lane = torch.arange(LANES, device=scores.device, dtype=torch.int32)
    base = (torch.arange(nb, device=scores.device, dtype=torch.int32) * (LANES * group_l))[:, None]
    idx = base[None] + garg * LANES + lane
    return gmax.reshape(q, nb * LANES), idx.reshape(q, nb * LANES).to(torch.int32)


def partial_topk_reference(q_hi, q_lo, corpus, group_l: int, valid_n: int):
    """Plain version of K1: f32 products of the (bf16 or f32) operands,
    ``q_hi·cᵀ + q_lo·cᵀ`` when ``q_lo`` is given, then the grouped max."""
    c = corpus.float()
    scores = q_hi.float() @ c.T
    if q_lo is not None:
        scores = scores + q_lo.float() @ c.T
    return _grouped_max(scores, group_l, valid_n)


def _int_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact int32 ``a·bᵀ`` of int8 operands. float64 holds every partial
    sum exactly (|sum| ≤ 127²·D < 2^53) and runs on both CPU and CUDA."""
    return (a.double() @ b.double().T).to(torch.int32)


def partial_topk_int8_reference(q1, q2, c1, c2, cscale, group_l: int, valid_n: int):
    """Plain version of K2: ``f32(q1·c1) [+ f32(q2·c1)/128]
    [+ f32(q1·c2)/128]``, times the row scale, in the TPU kernel's order,
    then the grouped max."""
    scores = _int_dot(q1, c1).float()
    if q2 is not None:
        scores = scores + _int_dot(q2, c1).float() * (1.0 / 128.0)
    if c2 is not None:
        scores = scores + _int_dot(q1, c2).float() * (1.0 / 128.0)
    scores = scores * cscale.float()[None, :]
    return _grouped_max(scores, group_l, valid_n)


def _lib() -> ctypes.CDLL:
    from ..kernels import build

    lib = build.load(_SOURCE)
    if not getattr(lib, "_argtypes_set", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.flat_partial_topk.argtypes = [i, p, p, p, p, p, i, i, i, i, i, i, i, i, p, p, p, p, p, p]
        lib.flat_partial_topk_smem.argtypes = [i, i]
        for fn in (lib.flat_partial_topk, lib.flat_partial_topk_smem):
            fn.restype = ctypes.c_int
        lib._argtypes_set = True
    return lib


_SM_COUNT: dict[int, int] = {}
_ARRIVALS: dict[tuple[int, int], torch.Tensor] = {}


def _sm_count(dev: torch.device) -> int:
    if dev.index not in _SM_COUNT:
        _SM_COUNT[dev.index] = torch.cuda.get_device_properties(dev).multi_processor_count
    return _SM_COUNT[dev.index]


def _arrivals(dev: torch.device, stream: int, size: int) -> torch.Tensor:
    """Zeroed arrival counters of the split merge, one buffer per (device,
    stream): the last CTA of each (block, query tile) resets its counter, so
    the buffer is zero again once a launch on that stream has run."""
    key = (dev.index, stream)
    buf = _ARRIVALS.get(key)
    if buf is None or buf.numel() < size:
        buf = _ARRIVALS[key] = torch.zeros(max(size, 4096), dtype=torch.int32, device=dev)
    return buf


def _launch_tensor_cores(variant, c1, c2, q1, q2, cscale, group_l: int, valid_n: int, dev):
    """One K1/K2 launch on the tensor cores; allocates the candidates and,
    when :func:`plan_launch` splits the blocks, the merge scratch."""
    n, d = c1.shape
    q = q1.shape[0]
    n_sm = _sm_count(dev)
    width, splits = plan_launch(q, n, d, group_l, n_sm, variant)
    m = n // group_l
    vals = torch.empty((q, m), dtype=torch.float32, device=dev)
    idx = torch.empty((q, m), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    part_vals = part_j = arrivals = None
    if splits > 1:
        part_vals = torch.empty((splits, q, m), dtype=torch.float32, device=dev)
        part_j = torch.empty((splits, q, m), dtype=torch.uint8, device=dev)
        arrivals = _arrivals(dev, stream, -(-q // width) * (n // (LANES * group_l)))
    rc = _lib().flat_partial_topk(
        _KINDS[variant][0], _ptr(c1), _ptr(c2), _ptr(q1), _ptr(q2), _ptr(cscale), q, n, d, group_l,
        valid_n, width, splits, n_sm, _ptr(vals), _ptr(idx), _ptr(part_vals), _ptr(part_j),
        _ptr(arrivals), stream,
    )
    return rc, vals, idx


def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def _cuda_operands(tensors, dtype, d):
    dev = None
    for t in tensors:
        if t is None:
            continue
        if not t.is_cuda or t.dtype != dtype or not t.is_contiguous() or t.shape[-1] != d:
            raise ValueError(
                f"kernel operand must be a contiguous CUDA {dtype} tensor with last dim {d}, "
                f"got {t.dtype} {tuple(t.shape)} on {t.device}"
            )
        if t.data_ptr() % 16 != 0:
            raise ValueError("kernel operand is not 16-byte aligned")
        if dev is not None and t.device != dev:
            raise ValueError("kernel operands lie on different devices")
        dev = t.device
    return dev


def _check_rc(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")


def partial_topk(q_hi, q_lo, corpus, group_l: int, valid_n: int):
    """K1 candidates ``(vals [Q, N/group_l] f32, idx i32)``. ``corpus`` is
    bf16 (``q_hi``/``q_lo`` bf16), f16 (``q_hi`` f16, no ``q_lo``) or f32
    (``q_hi`` f32, no ``q_lo``)."""
    _check_layout(corpus, group_l, valid_n, 32 if corpus.dtype == torch.float32 else 64)
    if not corpus.is_cuda:
        return partial_topk_reference(q_hi, q_lo, corpus, group_l, valid_n)
    n, d = corpus.shape
    if corpus.dtype not in (torch.bfloat16, torch.float16, torch.float32):
        raise ValueError(f"K1 takes a bfloat16, float16 or float32 corpus, got {corpus.dtype}")
    if q_lo is not None and corpus.dtype != torch.bfloat16:
        raise ValueError("the split-query pass (q_lo) takes a bfloat16 corpus only")
    dev = _cuda_operands((q_hi, q_lo, corpus), corpus.dtype, d)
    if corpus.dtype == torch.float32:
        variant = "K1 f32"
        q_hi, q_lo = split_query_tf32(q_hi)
    else:
        variant = "K1 f16" if corpus.dtype == torch.float16 else (
            "K1 bf16" if q_lo is None else "K1 bf16 precise")
    rc, vals, idx = _launch_tensor_cores(variant, corpus, None, q_hi, q_lo, None, group_l, valid_n, dev)
    partial_topk.launches.add(variant)
    _check_rc(rc, "partial_topk")
    return vals, idx


partial_topk.launches = LaunchCount()


def partial_topk_int8(q1, q2, c1, c2, cscale, group_l: int, valid_n: int):
    """K2 candidates ``(vals [Q, N/group_l] f32, idx i32)`` over int8
    planes ``c1`` (+ residual ``c2``) with per-row scales ``cscale``."""
    _check_layout(c1, group_l, valid_n, 128)
    if c2 is not None and c2.shape != c1.shape:
        raise ValueError(f"residual plane {tuple(c2.shape)} != {tuple(c1.shape)}")
    if not c1.is_cuda:
        return partial_topk_int8_reference(q1, q2, c1, c2, cscale, group_l, valid_n)
    n, d = c1.shape
    dev = _cuda_operands((q1, q2, c1, c2), torch.int8, d)
    if not (cscale.is_cuda and cscale.dtype == torch.float32 and cscale.is_contiguous()
            and cscale.shape == (n,) and cscale.device == dev):
        raise ValueError("corpus scales must be a contiguous CUDA float32 [N] tensor")
    variant = {(False, False): "K2 int8", (True, False): "K2 int8+q2",
               (False, True): "K2 int8+c2", (True, True): "K2 int8r"}[(q2 is not None, c2 is not None)]
    rc, vals, idx = _launch_tensor_cores(variant, c1, c2, q1, q2, cscale, group_l, valid_n, dev)
    partial_topk_int8.launches.add(variant)
    _check_rc(rc, "partial_topk_int8")
    return vals, idx


partial_topk_int8.launches = LaunchCount()


def split_query_bf16(queries: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``q ≈ q_hi + q_lo`` as a bf16 pair (``flat_pallas.py:236-244``)."""
    qf = queries.float()
    q_hi = qf.to(torch.bfloat16)
    q_lo = (qf - q_hi.float()).to(torch.bfloat16)
    return q_hi.contiguous(), q_lo.contiguous()


TF32_HI_MASK = -8192  # 0xFFFFE000 as int32: keeps sign, exponent and 10 mantissa bits


def split_query_tf32(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``x = hi + lo`` exactly for f32 ``x``: ``hi`` is ``x`` with its low 13
    mantissa bits cleared (a tf32 value), ``lo = x − hi``. K1 f32's 3xTF32
    products take the queries split this way and split the corpus the same
    way in shared memory."""
    x = x.float().contiguous()
    hi = (x.view(torch.int32) & TF32_HI_MASK).view(torch.float32)
    return hi, x - hi


def split_query_int8(queries: torch.Tensor):
    """``(q1, q2, s1)``: ``s1 = max(absmax, 1e-9)/127``,
    ``q1 = round(clip(q/s1))``, ``q2 = round(128·(q/s1 − q1))`` on the
    fixed s1/128 grid (``flat_pallas.py:439-450``)."""
    qf = queries.float()
    s1 = qf.abs().amax(dim=1, keepdim=True).clamp_min(1e-9) / 127.0
    scaled = qf / s1
    q1f = torch.round(scaled.clamp(-127.0, 127.0))
    q2 = torch.round(128.0 * (scaled - q1f)).to(torch.int8)
    return q1f.to(torch.int8).contiguous(), q2.contiguous(), s1


def _candidates_topk(cand_vals, cand_idx, k: int, *, tail: str):
    """Top-k over the candidate arrays. ``fold``: elementwise fold-by-2
    (``a >= b`` keeps the first half), then an exact top-k; ``exact``:
    :func:`blocked_topk`. (JAX's ``approx_max_k`` has no torch
    counterpart; on the CPU it equals the exact top-k used here.)"""
    if tail not in ("fold", "exact"):
        raise ValueError(f"tail must be 'fold' or 'exact', got {tail!r}")
    k_eff = min(k, cand_vals.shape[1])
    if tail == "fold" and cand_vals.shape[1] >= 8 * k_eff:
        half = cand_vals.shape[1] // 2
        a, b = cand_vals[:, :half], cand_vals[:, half : 2 * half]
        take_a = a >= b
        fold_vals = torch.where(take_a, a, b)
        fold_idx = torch.where(take_a, cand_idx[:, :half], cand_idx[:, half : 2 * half])
        top_vals, top_pos = top_k(fold_vals, k_eff)
        return top_vals, torch.gather(fold_idx, 1, top_pos)
    top_vals, top_pos = blocked_topk(cand_vals, k_eff, block=1024)
    return top_vals, torch.gather(cand_idx, 1, top_pos)


def flat_topk_fused(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    k: int,
    *,
    group_l: int = 16,
    valid_n: int | None = None,
    tail: str = "fold",
    precise: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused flat MIPS top-k over a bf16, f16 or f32 corpus (counterpart of
    ``flat_topk_pallas``). ``corpus [N, D]`` has N a multiple of
    ``128·group_l``. ``precise`` (bf16 corpus only) adds the split-query
    compensation pass so scores match an f32 query against the bf16
    corpus; other corpora take the queries in their own dtype. Returns
    ``(scores [Q, k] f32, rows [Q, k] i32)``."""
    n = corpus.shape[0]
    valid_n = n if valid_n is None else int(valid_n)
    if corpus.dtype not in (torch.bfloat16, torch.float16, torch.float32):
        raise ValueError(
            f"flat_topk_fused takes a bfloat16, float16 or float32 corpus, got {corpus.dtype}")
    if precise and corpus.dtype == torch.bfloat16:
        q_hi, q_lo = split_query_bf16(queries)
    else:
        q_hi, q_lo = queries.to(corpus.dtype).contiguous(), None
    vals, idx = partial_topk(q_hi, q_lo, corpus, group_l, valid_n)
    return _candidates_topk(vals, idx, k, tail=tail)


def flat_topk_fused_int8(
    queries: torch.Tensor,
    corpus_q: torch.Tensor,
    corpus_scale: torch.Tensor,
    k: int,
    *,
    corpus_res: torch.Tensor | None = None,
    group_l: int = 32,
    valid_n: int | None = None,
    tail: str = "fold",
    precise: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused flat MIPS top-k over an int8 corpus (counterpart of
    ``flat_topk_pallas_int8``): ``corpus_q [N, D]`` int8 with per-row
    ``corpus_scale [N]`` and optional residual plane ``corpus_res``. The
    per-query scale is applied after the tail (it is constant within a
    row). Returns ``(scores [Q, k] f32, rows [Q, k] i32)``."""
    if corpus_q.dtype != torch.int8:
        raise ValueError(f"corpus must be int8, got {corpus_q.dtype}")
    n = corpus_q.shape[0]
    valid_n = n if valid_n is None else int(valid_n)
    q1, q2, s1 = split_query_int8(queries)
    vals, idx = partial_topk_int8(
        q1, q2 if precise else None, corpus_q, corpus_res, corpus_scale, group_l, valid_n
    )
    vals, idx = _candidates_topk(vals, idx, k, tail=tail)
    return vals * s1, idx
