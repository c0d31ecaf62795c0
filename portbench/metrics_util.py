"""Arithmetic shared by the metric readers."""

from __future__ import annotations


def idle_share(trace) -> float | None:
    """Percent of the slice's wall time with no device operation."""
    if trace is None or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)


def scanned_blocks(scan: dict, tier: dict):
    """The capacity-tier blocks one K3 call scans that hold a row: ``(every
    (tile, probe, block) entry, as a flat tensor of block ids)``. A list's
    blocks past its last row hold nothing, and the bounds count no work
    there, so a scan that skipped them would read as no slower."""
    import torch

    held = torch.as_tensor(tier["gid"]).reshape(-1, tier["block_n"]).ge(0).any(dim=1)
    pb = scan["probe_blocks"].long().cpu()
    blocks = (pb[:, :, None] + torch.arange(scan["blocks_per_list"])).reshape(-1)
    return blocks[held[blocks]]
