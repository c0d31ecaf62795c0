"""Retrieval: microseconds of device time a question in the harness's
``portbench.retrieve`` ranges (the wave's query encoder, dense search,
BM25 and fusion, as ``/search`` runs them), in the profiler slice, each
operation attributed to the range its launch fell in (correlation ids),
over the questions sent in the slice."""

from portbench.metrics_dsv2 import us_per_query


def read(run):
    return us_per_query(run, "portbench.retrieve")
