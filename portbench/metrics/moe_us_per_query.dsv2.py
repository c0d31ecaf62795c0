"""Decoder, routed experts: microseconds of device time a question in the
program's ``moe.experts`` spans (the grouped products over token-expert
pairs), in the profiler slice, each operation attributed to the span
its launch fell in (correlation ids), over the questions sent in the
slice."""

from portbench.metrics_dsv2 import us_per_query


def read(run):
    return us_per_query(run, "moe.experts")
