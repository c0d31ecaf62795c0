"""Request micro-batching (copy of ``intool_rag_tpu/service/batcher.py``):
concurrent queries coalesce into one batched device search.

Protocol: the first request to arrive becomes the batch leader, waits
``window_ms`` for followers, then executes the whole batch with one
call into the batched retrieval path; followers block on events.

Spans: ``batcher.wait``, a request's time from ``submit`` to the start of
its batch (on the request's thread, in the request's trace, its args the
batch's trace id), and ``batcher.run``, the batch, a root of a trace of its
own, its args the trace ids of the requests it serves. The wait is also
observed into the ``metrics`` given as ``search.queue_wait``.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable

from ..logging import get_logger
from ..config import get_config
from ..observability import Metrics, bind_trace, new_trace, record_span, span_context, trace_phase

logger = get_logger(__name__)


class _Pending:
    __slots__ = ("query", "project", "event", "result", "error", "submitted_ns", "tid", "context")

    def __init__(self, query: str, project: str | None) -> None:
        self.query = query
        self.project = project
        self.event = threading.Event()
        self.result: Any = None
        self.error: Exception | None = None
        self.submitted_ns = time.perf_counter_ns()
        self.tid = threading.current_thread().native_id
        self.context = span_context()


class QueryBatcher:
    """Coalesces ``submit`` calls into batched ``runner`` invocations.

    ``runner(queries, projects) -> list[result]`` must be thread-safe.
    """

    def __init__(
        self,
        runner: Callable[[list[str], list[str | None]], list],
        *,
        window_ms: float | None = None,
        max_batch: int | None = None,
        metrics: Metrics | None = None,
    ) -> None:
        cfg = get_config()
        self.runner = runner
        self.metrics = metrics
        self.window_s = (
            window_ms if window_ms is not None else cfg.QUERY_MICRO_BATCH_WINDOW_MS
        ) / 1000.0
        self.max_batch = max_batch or cfg.QUERY_MAX_BATCH
        self._lock = threading.Lock()
        self._pending: list[_Pending] = []
        self._leader_active = False
        self.batches_run = 0
        self.requests_served = 0

    def submit(self, query: str, project: str | None = None):
        req = _Pending(query, project)
        with self._lock:
            self._pending.append(req)
            is_leader = not self._leader_active
            if is_leader:
                self._leader_active = True
        if is_leader:
            if self.window_s > 0:
                time.sleep(self.window_s)
            self._run_batch()
        req.event.wait()
        if req.error is not None:
            raise req.error
        return req.result

    def _run_batch(self) -> None:
        with self._lock:
            batch = self._pending[: self.max_batch]
            self._pending = self._pending[self.max_batch :]
            # a new leader will be elected by the next submit
            self._leader_active = bool(self._pending)
        if not batch:
            return
        started = time.perf_counter_ns()
        batch_trace = new_trace()
        served = []
        for req in batch:
            if self.metrics is not None:
                self.metrics.observe("search.queue_wait", (started - req.submitted_ns) / 1e9)
            wait = record_span("batcher.wait", req.submitted_ns, started, tid=req.tid, context=req.context,
                               args={"batch": batch_trace})
            if wait is not None:
                served.append(wait.trace)
        try:
            with bind_trace(batch_trace), trace_phase("batcher.run") as span:
                span.note({"requests": served})
                results = self.runner(
                    [r.query for r in batch], [r.project for r in batch]
                )
            for req, result in zip(batch, results):
                req.result = result
        except Exception as exc:
            logger.error("batched query failed: %s", exc)
            for req in batch:
                req.error = exc
        finally:
            self.batches_run += 1
            self.requests_served += len(batch)
            for req in batch:
                req.event.set()
            # if followers piled past max_batch, drain them too
            with self._lock:
                more = bool(self._pending)
            if more:
                self._run_batch()
