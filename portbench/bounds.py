"""Operations and bytes from shapes, and the published peaks they are held
against (NVIDIA H100 SXM data sheet, dense, at the 700 W limit).

``kernel_bound`` and ``scan_bound`` are copies of the bounds of the port's
kernel table (``chip_smoke.py``'s ``_bound`` and ``_scan_bound``): the least
time of a call, the larger of bytes over the HBM rate and operations over
the peak of their type; every input read once, every output written once.
"""

from __future__ import annotations

HBM_BYTES_S = 3.35e12
PEAK = {"bf16": 989e12, "int8": 1979e12, "tf32": 494.7e12, "f32": 67e12}


def kernel_bound(q, n, d, passes, elem, n_q_ops, n_c_ops, peak, cand_cols, scales=False) -> tuple[float, str]:
    """Least time (s) of one K1/K2 call over ``n`` valid corpus rows and
    ``q`` queries: ``passes`` products of [q, d] by [d, n], ``n_q_ops`` query
    planes and ``n_c_ops`` corpus planes of ``elem`` bytes, per-row scales
    (4 bytes a row) with ``scales``, ``cand_cols`` (value, index) pairs a
    query written. Returns ``(seconds, 'bytes' | 'operations')``."""
    nbytes = n_q_ops * q * d * elem + n_c_ops * n * d * elem + (4 * n if scales else 0) + q * cand_cols * 8
    ops = passes * 2.0 * q * n * d
    t_bytes, t_ops = nbytes / HBM_BYTES_S, ops / peak
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def k2_int8r_bound(q: int, valid_n: int, n_pad: int, d: int, group_l: int = 32) -> tuple[float, str]:
    """K2 over the residual int8 mirror, as the kernel table counts it: three
    int8 products (q1·c1, q2·c1, q1·c2), two query planes and two corpus
    planes, per-row scales, one candidate column per ``group_l`` rows."""
    return kernel_bound(q, valid_n, d, 3, 1, 2, 2, PEAK["int8"], n_pad // group_l, scales=True)


def scan_bound(distinct_blocks: int, scanned_blocks: int, n_probe_entries: int, block_n: int, d: int, q: int,
               n_cand: int) -> tuple[float, str]:
    """Least time (s) of one K3 scan: bytes are every DISTINCT probed block
    once (planar sign codes, d/8 bytes a row, and 8 f32 plane gains a row),
    the bf16 queries, the probe table and centroid dots (4 bytes each) and the
    candidates (value, index) once; operations are 2 × 8 queries × d for
    every slot a tile scans, at the bf16 peak."""
    block_bytes = block_n * (d // 8 + 32)
    nbytes = distinct_blocks * block_bytes + q * d * 2 + n_probe_entries * 4 * 2 + q * n_cand * 8
    ops = 2.0 * 8 * d * scanned_blocks * block_n
    t_bytes, t_ops = nbytes / HBM_BYTES_S, ops / PEAK["bf16"]
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def encoder_layer_params(model: dict) -> int:
    """Weights of one encoder layer's matrix products (q, k, v, output, the
    two MLP projections)."""
    h, f = model["hidden_size"], model["intermediate_size"]
    return 4 * h * h + 2 * h * f


def encoder_flops(model: dict, real_tokens: list[int]) -> float:
    """Useful operations of one encoder forward over sequences of these
    real (unpadded) token counts: 2 × the layers' matrix weights a token,
    plus attention's two products (2 × 2 × s² × hidden a layer)."""
    layers, h = model["num_hidden_layers"], model["hidden_size"]
    tokens = sum(real_tokens)
    attn = sum(4.0 * s * s * h for s in real_tokens)
    return layers * (2.0 * encoder_layer_params(model) * tokens + attn)
