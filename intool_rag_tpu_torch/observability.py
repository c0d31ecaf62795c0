"""Phase timing, metrics and on-demand device traces (port of
``intool_rag_tpu/observability.py``).

- :func:`trace_phase`: a wall-clock phase timer that also opens a
  ``torch.profiler.record_function`` range, so phases show in a device
  trace;
- :class:`Metrics`: in-process counters and rolling latency windows with
  nearest-rank p50 / p95 / p99 and mean, which the service exports at
  ``GET /metrics``;
- :func:`start_device_trace` / :func:`stop_device_trace`: a
  ``torch.profiler`` window (CPU, and CUDA when asked for), exported as a
  Chrome trace JSON under the log directory.
"""

from __future__ import annotations

import contextlib
import logging
import math
import os
import threading
import time
from collections import defaultdict, deque

import torch

logger = logging.getLogger(__name__)


class Metrics:
    def __init__(self, window: int = 512) -> None:
        self._counters: dict[str, int] = defaultdict(int)
        self._latencies: dict[str, deque] = defaultdict(lambda: deque(maxlen=window))
        self._lock = threading.Lock()

    def inc(self, name: str, value: int = 1) -> None:
        with self._lock:
            self._counters[name] += value

    def observe(self, name: str, seconds: float) -> None:
        with self._lock:
            self._latencies[name].append(seconds)

    @staticmethod
    def _percentile(values: list[float], p: float) -> float:
        """Nearest-rank percentile."""
        if not values:
            return 0.0
        values = sorted(values)
        return values[max(0, min(math.ceil(p * len(values)) - 1, len(values) - 1))]

    def snapshot(self) -> dict:
        with self._lock:
            out: dict = {"counters": dict(self._counters), "latency_s": {}}
            for name, window in self._latencies.items():
                vals = list(window)
                out["latency_s"][name] = {
                    "count": len(vals),
                    "p50": round(self._percentile(vals, 0.50), 6),
                    "p95": round(self._percentile(vals, 0.95), 6),
                    "p99": round(self._percentile(vals, 0.99), 6),
                    "mean": round(sum(vals) / len(vals), 6) if vals else 0.0,
                }
            return out


_metrics = Metrics()


def get_metrics() -> Metrics:
    """The process-global metrics (LLM wave serving reports here)."""
    return _metrics


@contextlib.contextmanager
def trace_phase(name: str, metrics: Metrics | None = None):
    """Time a phase into ``metrics`` (default: the process-global ones)."""
    metrics = metrics or _metrics
    start = time.perf_counter()
    with torch.profiler.record_function(name):
        yield
    elapsed = time.perf_counter() - start
    metrics.observe(name, elapsed)
    logger.debug("phase %s: %.3fs", name, elapsed)


_trace: dict = {}
_trace_lock = threading.Lock()


def start_device_trace(log_dir: str, cuda: bool = True) -> None:
    """Start a ``torch.profiler`` window; ``cuda`` adds the CUDA activity
    (ask for it only when the service runs on the card). One window at a
    time: a second start raises."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with _trace_lock:
        if _trace:
            raise RuntimeError("a device trace is already running")
        prof = torch.profiler.profile(activities=activities)
        prof.start()
        _trace.update(prof=prof, log_dir=log_dir)
    logger.info("device trace started → %s", log_dir)


def stop_device_trace() -> str:
    """Stop the window and write its Chrome trace JSON under the log
    directory; returns the file's path."""
    with _trace_lock:
        prof, log_dir = _trace.pop("prof"), _trace.pop("log_dir")
        prof.stop()
        os.makedirs(log_dir, exist_ok=True)
        path = os.path.join(log_dir, f"trace-{os.getpid()}-{time.time_ns()}.json")
        prof.export_chrome_trace(path)
    logger.info("device trace stopped → %s", path)
    return path
