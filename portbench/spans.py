"""The port's own spans in a traced slice. ``observability.stop_device_trace``
writes the spans the program recorded in the window into the exported trace
as ``user_annotation`` events, which ``portbench/trace.py`` reads as ranges
beside the harness's own; counters come from the process's
``observability.get_metrics()``. Each reading is None where the program
records no such span or counter, as a program from before them does not."""

from __future__ import annotations

BATCH_RANGE = "portbench.hybrid"  # one a batch of the slice
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel")


def _intervals(trace, name: str) -> list[tuple[float, float]]:
    return sorted((ts, ts + dur) for n, ts, dur in trace.ranges if n == name)


def per_batch_ms(trace, name: str) -> float | None:
    """Milliseconds a batch in spans named ``name``: their summed durations
    over the slice's batches."""
    if trace is None or not trace.range_count(BATCH_RANGE):
        return None
    spans = _intervals(trace, name)
    return sum(b - a for a, b in spans) / 1e3 / trace.range_count(BATCH_RANGE) if spans else None


def counter_share(numerator: str, denominator: str) -> float | None:
    """100 × the process counter ``numerator`` over ``denominator``."""
    from intool_rag_tpu_torch.observability import get_metrics

    counters = get_metrics().snapshot()["counters"]
    den = counters.get(denominator, 0)
    return 100.0 * counters.get(numerator, 0) / den if den else None


def _union(spans: list[tuple[float, float]]) -> float:
    total, end = 0.0, -float("inf")
    for a, b in sorted(spans):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def self_share(trace, name: str) -> float | None:
    """The share of the time in spans named ``name`` that no range inside
    them covers (their self time), in percent."""
    if trace is None:
        return None
    outer = _intervals(trace, name)
    if not outer:
        return None
    inner = [(ts, ts + dur) for n, ts, dur in trace.ranges]
    total = covered = 0.0
    for a, b in outer:
        total += b - a
        covered += _union([(x, y) for x, y in inner if a <= x and y <= b and (x, y) != (a, b)])
    return 100.0 * (total - covered) / total if total > 0 else None


def launches_within(trace, outer: str, inner: str) -> tuple[int, int]:
    """(kernel launch calls inside ranges named ``outer``, those of them
    also inside ranges named ``inner``), matched by time."""
    outer_spans, inner_spans = _intervals(trace, outer), _intervals(trace, inner)
    calls = [ts for name, ts, _ in trace.host if name.startswith(LAUNCH_CALLS)]
    inside = [ts for ts in calls if _covers(outer_spans, ts)]
    return len(inside), sum(_covers(inner_spans, ts) for ts in inside)


def _covers(spans: list[tuple[float, float]], t: float) -> bool:
    return any(a <= t <= b for a, b in spans)
