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
  Chrome trace JSON under the log directory;
- :func:`device_work`: the gate that keeps the window's start and stop
  apart from work that launches on the card from other threads.
"""

from __future__ import annotations

import contextlib
import math
import os
import threading
import time
from collections import defaultdict, deque

import torch

from .logging import get_logger

logger = get_logger(__name__)


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


class DeviceGate:
    """Keeps a trace's start and stop apart from device work on other
    threads. ``torch.profiler``'s start and stop are not safe against a
    kernel launch on another thread at that moment: the process can die
    of a segfault inside the profiler (torch 2.11 on an H100, while a
    request thread launched the encoder's matmuls). So every thread that
    may launch work holds the gate shared while it works, and a trace
    takes it alone to start and to stop: it waits for the work in flight
    and holds new work back until it is through. Between start and stop
    work runs as ever, and the window records it.

    A thread that serves others already inside (the LLM wave worker)
    enters ``urgent``: held back only while the trace holds the gate,
    never while the trace waits for it, which would deadlock. A thread
    may enter again while it is inside."""

    def __init__(self) -> None:
        self._cond = threading.Condition()
        self._inside = 0  # shared holders, counting each thread once
        self._waiting = 0  # traces waiting to take the gate alone
        self._alone = False
        self._depth = threading.local()

    @contextlib.contextmanager
    def shared(self, urgent: bool = False):
        depth = getattr(self._depth, "n", 0)
        if not depth:
            with self._cond:
                while self._alone or (self._waiting and not urgent):
                    self._cond.wait()
                self._inside += 1
        self._depth.n = depth + 1
        try:
            yield
        finally:
            self._depth.n = depth
            if not depth:
                with self._cond:
                    self._inside -= 1
                    if not self._inside:
                        self._cond.notify_all()

    @contextlib.contextmanager
    def alone(self):
        if getattr(self._depth, "n", 0):
            raise RuntimeError("a device trace cannot start or stop inside device work")
        with self._cond:
            self._waiting += 1
            try:
                while self._alone or self._inside:
                    self._cond.wait()
            finally:
                self._waiting -= 1
            self._alone = True
        try:
            yield
        finally:
            with self._cond:
                self._alone = False
                self._cond.notify_all()


_gate = DeviceGate()


def device_work(urgent: bool = False):
    """Hold the device gate shared (see :class:`DeviceGate`) around work
    that may launch on the card."""
    return _gate.shared(urgent)


_trace: dict = {}
_trace_lock = threading.Lock()


def start_device_trace(log_dir: str, cuda: bool = True) -> None:
    """Start a ``torch.profiler`` window; ``cuda`` adds the CUDA activity
    (ask for it only when the service runs on the card). One window at a
    time: a second start raises. Starts with the device gate held alone;
    start and stop it on one thread (the profiler keeps per-thread state)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with _trace_lock:
        if _trace:
            raise RuntimeError("a device trace is already running")
        prof = torch.profiler.profile(activities=activities)
        with _gate.alone():
            prof.start()
        _trace.update(prof=prof, log_dir=log_dir)
    logger.info("device trace started → %s", log_dir)


def stop_device_trace() -> str:
    """Stop the window and write its Chrome trace JSON under the log
    directory; returns the file's path. Stops with the device gate held
    alone; the export lets work run on."""
    with _trace_lock:
        with _gate.alone():
            prof, log_dir = _trace.pop("prof"), _trace.pop("log_dir")
            prof.stop()
        os.makedirs(log_dir, exist_ok=True)
        path = os.path.join(log_dir, f"trace-{os.getpid()}-{time.time_ns()}.json")
        prof.export_chrome_trace(path)
    logger.info("device trace stopped → %s", path)
    return path
