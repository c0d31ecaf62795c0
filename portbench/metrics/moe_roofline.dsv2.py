"""Decoder, routed experts: the least time of the sliced wave's routed
expert products (``portbench/bounds_moe.py``, from the program's ``moe.*``
counters over the wave: touched experts' bf16 weights and the pairs' vectors
against 6 · hidden · width operations a pair) over the device time of the
operations launched in its ``moe.experts`` spans, in percent."""

from portbench import bounds_moe
from portbench.metrics_dsv2 import device_seconds_in, sliced


def read(run):
    rec = sliced(run)
    if rec is None or not rec["counters"]["moe.calls"]:
        return None
    seconds = device_seconds_in(run.trace, "moe.experts")
    if not seconds:
        return None
    return 100.0 * bounds_moe.experts_bound(run.config, rec["counters"]) / seconds
