"""Decoder, prefill: microseconds of device time a question in the
program's ``llm.refill`` spans (a refill group's prefill through the
scheduler), in the profiler slice, each operation attributed to the span
its launch fell in (correlation ids), over the questions sent in the
slice."""

from portbench.metrics_dsv2 import us_per_query


def read(run):
    return us_per_query(run, "llm.refill")
