"""Ragged packing for encoder inference: several variable-length texts
per fixed-width row behind block-diagonal (segment-id) attention (the
port's own copy of ``intool_rag_tpu/models/packing.py``, numpy only).

Replaces pad-to-bucket batching: the matrix units see only real tokens
(plus bin slack), instead of every row padded to the batch's bucket. Used
by the embedding provider (``providers/cuda_embed.py``, ``EMBED_PACKED=1``).
"""

from __future__ import annotations

import numpy as np


def pack_bins(lengths: list[int], width: int) -> list[list[int]]:
    """First-fit-decreasing bin packing: returns bins as index lists.
    Items longer than ``width`` are truncated to it by
    :func:`build_packed_arrays` (they still get their own bin)."""
    order = sorted(range(len(lengths)), key=lambda i: -lengths[i])
    bins: list[list] = []  # [used, [indices]]
    for i in order:
        length = min(lengths[i], width)
        for b in bins:
            if b[0] + length <= width:
                b[0] += length
                b[1].append(i)
                break
        else:
            bins.append([length, [i]])
    return bins


def shrink_width(bins: list[list], width: int, *, snap: int = 128) -> int:
    """Snap the row width down to the packed high-water mark — a
    handful of short texts shouldn't pay a full-width row."""
    used = max(b[0] for b in bins)
    return min(width, -(-used // snap) * snap)


def build_packed_arrays(
    rows: list[list[int]],
    bins: list[list],
    width: int,
    pad_id: int,
    *,
    p_snap: int = 4,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Materialize one launch chunk of packed bins.

    Returns ``(ids [n, W], segment_ids [n, W], cls_index [n, P],
    row_index [n, P])`` where ``row_index[b, p]`` is the original row
    index of segment ``p`` in bin ``b`` (−1 for empty slots) and
    ``cls_index`` is each segment's first-token offset.
    """
    n = len(bins)
    p_max = -(-max(len(b[1]) for b in bins) // p_snap) * p_snap
    ids = np.full((n, width), pad_id, np.int32)
    seg = np.zeros((n, width), np.int32)
    cls = np.zeros((n, p_max), np.int32)
    idx = np.full((n, p_max), -1, np.int64)
    for j, (_, members) in enumerate(bins):
        off = 0
        for p_i, i in enumerate(members):
            r = rows[i][:width]
            ids[j, off : off + len(r)] = r
            seg[j, off : off + len(r)] = p_i + 1
            cls[j, p_i] = off
            idx[j, p_i] = i
            off += len(r)
    return ids, seg, cls, idx
