"""Spans, metrics and on-demand device traces (port of
``intool_rag_tpu/observability.py``).

- :class:`trace_phase`: a span. With no collector open it costs one flag
  check (and times into the ``Metrics`` a caller passes, as the service's
  phases do). While a collector is open it records its name, its start and
  end (``time.perf_counter_ns``), its thread, its id, its parent's id (a
  ``contextvars`` stack) and a trace id; :meth:`trace_phase.count` adds
  counters to the process-global metrics and to the span's args;
- collectors: :class:`collect_spans` (tests and tools) and a device-trace
  window. Recorded spans go into one bounded buffer, cleared when the last
  collector closes; :func:`bind_trace` gives the root spans inside it one
  trace id (the service binds one per request);
- :class:`Metrics`: in-process counters and rolling latency windows with
  nearest-rank p50 / p95 / p99 and mean, which the service exports at
  ``GET /metrics``;
- :func:`start_device_trace` / :func:`stop_device_trace`: a
  ``torch.profiler`` window (CPU, and CUDA when asked for), exported as a
  Chrome trace JSON under the log directory, with the spans every thread
  recorded in the window on the trace's clock;
- :func:`device_work`: the gate that keeps the window's start and stop
  apart from work that launches on the card from other threads.
"""

from __future__ import annotations

import contextlib
import contextvars
import itertools
import json
import math
import os
import re
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

    def inc_many(self, counters: dict[str, int]) -> None:
        with self._lock:
            for name, value in counters.items():
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


MAX_SPANS = 1 << 18  # the buffer's bound; spans past it are counted, not kept
CLOCK_ANCHOR = "observability.clock"

_collecting = 0  # open collectors: spans record only while this is not 0
_spans: list = []  # recorded spans of every thread, cleared when the last collector closes
_collect_lock = threading.Lock()
# (span id, trace id) of the span open in this context; span id 0: a trace bound, no span open
_current: contextvars.ContextVar[tuple[int, int] | None] = contextvars.ContextVar("observability_span",
                                                                                   default=None)
_span_ids = itertools.count(1)
_trace_ids = itertools.count(1)


def new_trace() -> int:
    """A trace id no span of this process holds yet."""
    return next(_trace_ids)


def span_context() -> tuple[int, int] | None:
    """(span id, trace id) of the span open in this context, or None."""
    return _current.get()


class trace_phase:
    """A span around a phase. Timed into ``metrics`` when given (a wall
    time in seconds, collector or not); recorded while a collector is open
    (:class:`collect_spans`, a device-trace window). After the block, a
    recorded span holds ``name``, ``start_ns`` / ``end_ns``
    (``time.perf_counter_ns``), ``tid`` (the native thread id), ``id``,
    ``parent`` (0 for a root), ``trace`` and ``args``."""

    __slots__ = ("name", "metrics", "start_ns", "end_ns", "tid", "id", "parent", "trace", "args", "_token")

    def __init__(self, name: str, metrics: Metrics | None = None) -> None:
        self.name = name
        self.metrics = metrics
        self._token = None

    def __enter__(self) -> "trace_phase":
        if _collecting:
            ctx = _current.get()
            self.args = None
            self.id = next(_span_ids)
            self.parent, self.trace = ctx if ctx is not None else (0, next(_trace_ids))
            self._token = _current.set((self.id, self.trace))
            self.tid = threading.current_thread().native_id  # gettid is a system call; this is not
            self.start_ns = time.perf_counter_ns()
        elif self.metrics is not None:
            self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if self._token is not None:
            self.end_ns = time.perf_counter_ns()
            _current.reset(self._token)
            self._token = None
            _keep(self)
        elif self.metrics is not None:
            self.end_ns = time.perf_counter_ns()
        if self.metrics is not None:
            self.metrics.observe(self.name, (self.end_ns - self.start_ns) / 1e9)

    def note(self, args: dict) -> None:
        """Adds ``args`` to the span's args while it records."""
        if self._token is not None:
            self.args = {**self.args, **args} if self.args else dict(args)

    def count(self, counters: dict[str, int]) -> None:
        """Adds ``counters`` to the process-global metrics, and to the
        span's args while it records."""
        _metrics.inc_many(counters)
        self.note(counters)


def _keep(span: trace_phase) -> None:
    if not _collecting:
        return
    if len(_spans) < MAX_SPANS:
        _spans.append(span)
    else:
        _metrics.inc("observability.spans_dropped")


def record_span(name: str, start_ns: int, end_ns: int, *, tid: int, context: tuple[int, int] | None = None,
                args: dict | None = None) -> trace_phase | None:
    """Records a span timed elsewhere (another thread's wait), as a child
    of ``context`` (a :func:`span_context`; None: a root of a new trace).
    Returns it, or None with no collector open."""
    if not _collecting:
        return None
    span = trace_phase(name)
    span.start_ns, span.end_ns, span.tid, span.args = start_ns, end_ns, tid, args
    span.id = next(_span_ids)
    span.parent, span.trace = context if context is not None else (0, next(_trace_ids))
    _keep(span)
    return span


class bind_trace:
    """Root spans opened inside take trace id ``trace`` (default: a new
    one) and no parent."""

    __slots__ = ("trace", "_token")

    def __init__(self, trace: int | None = None) -> None:
        self.trace = new_trace() if trace is None else trace

    def __enter__(self) -> "bind_trace":
        self._token = _current.set((0, self.trace))
        return self

    def __exit__(self, *exc) -> None:
        _current.reset(self._token)


def _open_collector() -> int:
    global _collecting
    with _collect_lock:
        _collecting += 1
        return len(_spans)


def _close_collector(start: int) -> list[trace_phase]:
    """The spans recorded since the collector that returned ``start``
    opened; the buffer empties when no collector is left."""
    global _collecting
    with _collect_lock:
        out = _spans[start:]
        _collecting -= 1
        if not _collecting:
            _spans.clear()
    return out


class collect_spans:
    """Records the spans of every thread while open: ``with collect_spans()
    as spans:`` fills ``spans`` with them when the block ends."""

    def __init__(self) -> None:
        self.spans: list[trace_phase] = []

    def __enter__(self) -> list[trace_phase]:
        self._start = _open_collector()
        return self.spans

    def __exit__(self, *exc) -> None:
        self.spans.extend(_close_collector(self._start))


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


def _clock_anchor() -> tuple[int, int]:
    """A ``record_function`` range named :data:`CLOCK_ANCHOR` on this
    thread, and two ``perf_counter_ns`` readings inside it."""
    with torch.profiler.record_function(CLOCK_ANCHOR):
        a = time.perf_counter_ns()
        b = time.perf_counter_ns()
    return a, b


def start_device_trace(log_dir: str, cuda: bool = True) -> None:
    """Start a ``torch.profiler`` window; ``cuda`` adds the CUDA activity
    (ask for it only when the service runs on the card). One window at a
    time: a second start raises. Starts with the device gate held alone;
    start and stop it on one thread (the profiler keeps per-thread state).
    The window is a span collector; two clock anchors open just after the
    start (the first warms the profiler's path)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with _trace_lock:
        if _trace:
            raise RuntimeError("a device trace is already running")
        prof = torch.profiler.profile(activities=activities)
        with _gate.alone():
            prof.start()
            anchors = [_clock_anchor(), _clock_anchor()]
            start = _open_collector()
        _trace.update(prof=prof, log_dir=log_dir, anchors=anchors, start=start)
    logger.info("device trace started → %s", log_dir)


def stop_device_trace() -> str:
    """Stop the window and write its Chrome trace JSON under the log
    directory, with the spans recorded in the window (:func:`merge_spans`);
    returns the file's path. Stops with the device gate held alone; the
    export lets work run on."""
    with _trace_lock:
        with _gate.alone():
            state = dict(_trace)
            _trace.clear()
            spans = _close_collector(state["start"])
            anchors = state["anchors"] + [_clock_anchor(), _clock_anchor()]
            state["prof"].stop()
        os.makedirs(state["log_dir"], exist_ok=True)
        path = os.path.join(state["log_dir"], f"trace-{os.getpid()}-{time.time_ns()}.json")
        state["prof"].export_chrome_trace(path)
        merge_spans(path, spans, anchors)
    logger.info("device trace stopped → %s", path)
    return path


_EVENTS_OPEN = re.compile(r'"traceEvents"\s*:\s*\[')
_ANCHOR = re.compile(r'"name"\s*:\s*"' + re.escape(CLOCK_ANCHOR)
                     + r'"[^{}]*?"ts"\s*:\s*([-+0-9.eE]+)\s*,\s*"dur"\s*:\s*([-+0-9.eE]+)')


def merge_spans(path: str, spans: list[trace_phase], anchors: list[tuple[int, int]]) -> None:
    """Writes ``spans`` into the exported Chrome trace at ``path``: ``"X"``
    events of category ``user_annotation`` on their thread's ``tid``, with
    ``args`` holding ``span``, ``parent``, ``trace`` and the span's own
    args. ``anchors`` are the window's clock anchors, in the order taken
    (two at the start, two at the stop); each anchor's range in the export
    against the midpoint of its readings gives the offset of
    ``perf_counter_ns`` from the trace's time base (microseconds), and the
    narrower of each pair is used. Times are converted on the line through
    the two offsets; their difference is written as the trace's
    ``observability.clock_drift_us``. Spans are clipped to the anchors'
    extent, inside the trace's first and last stamps, so those do not move.
    The events go in as text after the opening of ``traceEvents``: a window
    of a few seconds exports hundreds of MB, which a parse and a dump would
    take tens of seconds to rewrite."""
    with open(path, encoding="utf-8") as f:
        text = f.read()
    marks = sorted((float(ts), float(dur)) for ts, dur in _ANCHOR.findall(text))
    opened = _EVENTS_OPEN.search(text)
    head = text.find("{") + 1
    if len(marks) != len(anchors) or opened is None or head == 0 or text[: head - 1].strip():
        logger.warning("device trace: %d clock anchors in the export, %d taken; spans not written",
                       len(marks), len(anchors))
        return
    fits = [(dur, ts + dur / 2 - (a + b) / 2e3, (a + b) / 2e3) for (ts, dur), (a, b) in zip(marks, anchors)]
    (_, o1, t1), (_, o2, t2) = min(fits[:2]), min(fits[-2:])
    slope = (o2 - o1) / (t2 - t1) if t2 > t1 else 0.0
    lo, hi = marks[0][0], marks[-1][0] + marks[-1][1]
    pid = os.getpid()
    events = []
    for span in spans:
        start, end = (t / 1e3 + o1 + slope * (t / 1e3 - t1) for t in (span.start_ns, span.end_ns))
        start, end = max(start, lo), min(end, hi)
        if end < start:
            continue
        args = {"span": span.id, "parent": span.parent, "trace": span.trace, **(span.args or {})}
        events.append(json.dumps({"ph": "X", "cat": "user_annotation", "name": span.name, "pid": pid,
                                  "tid": span.tid, "ts": round(start, 3), "dur": round(end - start, 3),
                                  "args": args}) + ",")
    meta = {"clock": CLOCK_ANCHOR, "clock_offset_us": o1, "clock_drift_us": o2 - o1, "spans": len(events),
            "spans_outside": len(spans) - len(events)}
    with open(path, "w", encoding="utf-8") as f:
        f.write(text[:head] + '"observability": ' + json.dumps(meta) + ",")
        f.write(text[head : opened.end()])
        f.write("".join(events))
        f.write(text[opened.end() :])
