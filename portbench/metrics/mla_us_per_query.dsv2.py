"""Decoder, latent attention: microseconds of device time a question in
the program's ``mla.attend`` spans (prefill's expanded and decode's
absorbed attention products), in the profiler slice, each operation attributed to the span
its launch fell in (correlation ids), over the questions sent in the
slice."""

from portbench.metrics_dsv2 import us_per_query


def read(run):
    return us_per_query(run, "mla.attend")
