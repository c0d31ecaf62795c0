"""Hybrid engine: device kernels launched inside the harness's
``portbench.hybrid`` range, per batch of the traced slice."""


def read(run):
    if run.trace is None or not run.trace.range_count("portbench.hybrid"):
        return None
    return run.trace.kernels_launched_in("portbench.hybrid") / run.trace.range_count("portbench.hybrid")
