"""The reduction of a ``torch.profiler`` slice of the window, exported as a
Chrome trace: device operations (kernels, copies, sets), the host's CUDA
runtime and driver calls (which carry the correlation id of the operation
they launched), the harness's ``record_function`` ranges, and the host's
operator events, which name what the host was doing while the device sat
idle.
"""

from __future__ import annotations

import heapq
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")


class Trace:
    """The events of one exported slice (times in microseconds)."""

    def __init__(self, events: list[dict], window_s: float) -> None:
        self.window_s = window_s
        device = [e for e in events if e.get("cat") in DEVICE_CATS]
        self.device = [(e["name"], float(e["ts"]), float(e.get("dur", 0.0)), _corr(e)) for e in device]
        self.kernels = [d for d, e in zip(self.device, device) if e["cat"] == "kernel"]
        self.launches = [(float(e["ts"]), _corr(e)) for e in events if e.get("cat") in LAUNCH_CATS]
        self.ranges = [(e["name"], float(e["ts"]), float(e.get("dur", 0.0)))
                       for e in events if e.get("cat") == "user_annotation"]
        self.gpu_ranges = [(e["name"], float(e["ts"]), float(e.get("dur", 0.0)))
                           for e in events if e.get("cat") == "gpu_user_annotation"]
        self.host = [(e["name"], float(e["ts"]), float(e.get("dur", 0.0)))
                     for e in events if e.get("cat") in HOST_CATS and "ts" in e]
        stamps = [float(e["ts"]) for e in events if "ts" in e and e.get("ph") == "X"]
        ends = [float(e["ts"]) + float(e.get("dur", 0.0)) for e in events if "ts" in e and e.get("ph") == "X"]
        self.span = (min(stamps), max(ends)) if stamps else (0.0, 0.0)

    def busy_intervals(self) -> list[tuple[float, float]]:
        """The union of the device operations' intervals, merged."""
        spans = sorted((ts, ts + dur) for _, ts, dur, _ in self.device)
        merged: list[list[float]] = []
        for a, b in spans:
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return [(a, b) for a, b in merged]

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e6

    def kernel_seconds(self, match) -> float:
        """Device seconds of the kernels whose name ``match`` accepts."""
        return sum(dur for name, _, dur, _ in self.kernels if match(name)) / 1e6

    def kernels_launched_in(self, range_name: str) -> int:
        """Device kernels launched inside the host ranges of that name: the
        kernels whose launch call (by correlation id) falls in a range, and
        where no launch call is recorded, those inside the range's device
        projection."""
        ranges = sorted((ts, ts + dur) for name, ts, dur in self.ranges if name == range_name)
        inside = {c for ts, c in self.launches if c is not None and _within(ranges, ts)}
        known = {c for _, c in self.launches if c is not None}
        gpu = sorted((ts, ts + dur) for name, ts, dur in self.gpu_ranges if name == range_name)
        count = 0
        for _, ts, dur, c in self.kernels:
            if c is not None and c in known:
                count += c in inside
            else:
                count += _within(gpu, ts)
        return count

    def range_count(self, range_name: str) -> int:
        return sum(1 for name, _, _ in self.ranges if name == range_name)

    def top_device_ops(self, n: int = 10) -> list[list]:
        total: dict[str, float] = defaultdict(float)
        for name, _, dur, _ in self.device:
            total[name] += dur / 1e6
        return [[k, v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> list[list]:
        """The device's idle time in the slice by what the host was doing:
        each gap between busy intervals goes to the innermost host event
        covering its midpoint."""
        busy = self.busy_intervals()
        lo, hi = self.span
        edges = [lo] + [x for ab in busy for x in ab] + [hi]
        gaps = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
        host = sorted(self.host, key=lambda h: h[1])
        total: dict[str, float] = defaultdict(float)
        heap: list = []
        i = 0
        for a, b in sorted(gaps, key=lambda g: g[0] + g[1]):
            mid = 0.5 * (a + b)
            while i < len(host) and host[i][1] <= mid:
                name, ts, dur = host[i]
                heapq.heappush(heap, (-ts, ts + dur, name))
                i += 1
            while heap and heap[0][1] < mid:
                heapq.heappop(heap)
            total[heap[0][2] if heap else "host (no recorded op)"] += (b - a) / 1e6
        return [[k, v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:n]]


def _corr(e: dict):
    c = e.get("args", {}).get("correlation")
    return int(c) if c is not None else None


def _within(ranges: list[tuple[float, float]], t: float) -> bool:
    lo, hi = 0, len(ranges)
    while lo < hi:
        mid = (lo + hi) // 2
        if ranges[mid][0] <= t:
            lo = mid + 1
        else:
            hi = mid
    return lo > 0 and t <= ranges[lo - 1][1]
