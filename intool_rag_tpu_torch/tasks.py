"""Background task queue — a working version of the reference's dead
``AsyncTaskQueue`` (rag/background_tasks.py:11-97, zero importers —
SURVEY.md §0). Thread-based (the service is threaded, not asyncio):
N workers drain a queue of ingest jobs; job state is queryable.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
import traceback
import uuid
from typing import Any, Callable

from .logging import get_logger

logger = get_logger(__name__)


@dataclasses.dataclass
class Job:
    job_id: str
    kind: str
    status: str = "pending"  # pending | running | done | failed
    result: Any = None
    error: str | None = None
    submitted_at: float = dataclasses.field(default_factory=time.time)
    started_at: float | None = None
    finished_at: float | None = None

    def to_dict(self) -> dict:
        return {
            "job_id": self.job_id,
            "kind": self.kind,
            "status": self.status,
            "result": self.result,
            "error": self.error,
            "submitted_at": self.submitted_at,
            "started_at": self.started_at,
            "finished_at": self.finished_at,
        }


class TaskQueue:
    def __init__(self, workers: int = 1, max_jobs: int = 1000) -> None:
        self._queue: queue.Queue = queue.Queue()
        self._jobs: dict[str, Job] = {}
        self._lock = threading.Lock()
        self._max_jobs = max_jobs
        self._workers = [
            threading.Thread(target=self._worker, daemon=True, name=f"task-{i}")
            for i in range(workers)
        ]
        self._running = True
        for w in self._workers:
            w.start()

    def submit(self, kind: str, fn: Callable[[], Any]) -> Job:
        job = Job(job_id=str(uuid.uuid4()), kind=kind)
        with self._lock:
            if len(self._jobs) >= self._max_jobs:
                # evict oldest finished jobs
                finished = sorted(
                    (j for j in self._jobs.values() if j.status in ("done", "failed")),
                    key=lambda j: j.submitted_at,
                )
                for victim in finished[: len(self._jobs) - self._max_jobs + 1]:
                    del self._jobs[victim.job_id]
            self._jobs[job.job_id] = job
        self._queue.put((job, fn))
        return job

    def get(self, job_id: str) -> Job | None:
        with self._lock:
            return self._jobs.get(job_id)

    def list_jobs(self) -> list[dict]:
        with self._lock:
            return [j.to_dict() for j in self._jobs.values()]

    def _worker(self) -> None:
        while self._running:
            try:
                job, fn = self._queue.get(timeout=0.5)
            except queue.Empty:
                continue
            job.status = "running"
            job.started_at = time.time()
            try:
                job.result = fn()
                job.status = "done"
            except Exception as exc:
                job.status = "failed"
                job.error = f"{type(exc).__name__}: {exc}"
                logger.error("job %s failed: %s\n%s", job.job_id, exc,
                             traceback.format_exc())
            finally:
                job.finished_at = time.time()
                self._queue.task_done()

    def wait_all(self, timeout: float | None = None) -> bool:
        """Test helper: block until the queue drains."""
        deadline = time.time() + (timeout or 3600)
        while time.time() < deadline:
            with self._lock:
                pending = any(
                    j.status in ("pending", "running") for j in self._jobs.values()
                )
            if not pending:
                return True
            time.sleep(0.02)
        return False

    def shutdown(self) -> None:
        self._running = False
