"""K3 (kernels/bits_scan.cu, plan and scan): the least time of the traced
slice's scans (portbench/bounds.py over the probed blocks that hold rows)
over the device time of the two kernels by name in the slice, in percent."""

import torch

from portbench import bounds
from portbench.metrics_util import scanned_blocks

KERNELS = ("bits_scan_kernel", "bits_plan_kernel")


def read(run):
    if run.trace is None or not run.scans or run.tier is None:
        return None
    seconds = run.trace.kernel_seconds(lambda name: any(k in name for k in KERNELS))
    if seconds <= 0:
        return None
    total = 0.0
    for s in run.scans:
        blocks = scanned_blocks(s, run.tier)
        n_cand = s["probe_blocks"].shape[1] * s["blocks_per_list"] * s["block_n"] // s["group_l"]
        total += bounds.scan_bound(int(torch.unique(blocks).numel()), int(blocks.numel()),
                                   int(s["probe_blocks"].numel()), s["block_n"], s["d"], s["q"], n_cand)[0]
    return 100.0 * total / seconds
