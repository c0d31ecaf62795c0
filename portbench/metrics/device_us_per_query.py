"""The card's time a question costs: the union of device operations in the
profiler slice at the end of the window, over the questions sent inside it,
in microseconds. The slice starts and ends on batch boundaries, each ended
by a synchronise, so it holds every operation of its batches and no other.
Where the slice holds no device operation (no card), there is nothing to
read."""


def read(run):
    if run.trace is None or not run.slice_queries:
        return None
    busy = run.trace.busy_s
    return 1e6 * busy / run.slice_queries if busy > 0 else None
