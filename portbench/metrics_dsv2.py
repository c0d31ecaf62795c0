"""What the ``query`` cells' readers share (``portbench/metrics/*.dsv2.py``):
device time attributed to the program's spans and ranges of a name, and the
sliced waves' record that ``portbench/systems/query.py`` leaves in
``run.dsv2``. Every reading is None where there is nothing to read: no
device trace, no device operation, no such span, no sliced wave."""

from __future__ import annotations


def _within(spans: list[tuple[float, float]], t: float) -> bool:
    lo, hi = 0, len(spans)
    while lo < hi:
        mid = (lo + hi) // 2
        if spans[mid][0] <= t:
            lo = mid + 1
        else:
            hi = mid
    return lo > 0 and t <= spans[lo - 1][1]


def _merged(spans) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def device_seconds_in(trace, name: str) -> float | None:
    """Device seconds of the operations launched inside the host ranges
    named ``name`` (the program's spans and ``record_function`` ranges):
    an operation counts where its launch call (by correlation id) falls in
    one; without a recorded launch, where it starts inside the range's
    device projection. None where the slice holds no such range."""
    if trace is None:
        return None
    spans = _merged((ts, ts + dur) for n, ts, dur in trace.ranges if n == name)
    if not spans:
        return None
    inside = {c for ts, c in trace.launches if c is not None and _within(spans, ts)}
    known = {c for _, c in trace.launches if c is not None}
    gpu = _merged((ts, ts + dur) for n, ts, dur in trace.gpu_ranges if n == name)
    total = 0.0
    for _, ts, dur, c in trace.device:
        if (c in inside) if (c is not None and c in known) else _within(gpu, ts):
            total += dur
    return total / 1e6


def us_per_query(run, name: str) -> float | None:
    """Microseconds of device time a question of the slice inside ``name``."""
    if run.trace is None or not run.slice_queries:
        return None
    seconds = device_seconds_in(run.trace, name)
    return 1e6 * seconds / run.slice_queries if seconds else None


def sliced(run) -> dict | None:
    """The sliced waves' record, where the slice held one."""
    rec = getattr(run, "dsv2", None)
    return rec if rec and rec.get("waves") else None
