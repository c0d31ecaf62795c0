"""One run of one cell: set up the system from the seed, warm every shape
the cell's traffic uses, measure for ``seconds``, then judge what the timed
path produced against the reference and print the result line.

What is particular to a kind of system (its pre-drawn work, how it is
built, one step of it, what it captures for the judge, and the reference)
lives in its module, ``portbench/systems/<system>.py``, which the cell's
configuration names; this file holds what every cell shares: set-up time
from the process's start, the window's clock, the profiler slice, metric
reading, peak memory, the program freed before the reference runs, and the
result line.

Closed loop: one client sends each pre-drawn batch through one step of the
system, and the next when it returns.

With ``trace`` the run also times the system's spans (each ended by a
synchronise) and records a ``torch.profiler`` slice at the end of the
window; it reports the per-layer metrics instead of the end-to-end ones.
A run without ``trace`` records such a slice only where one of the cell's
end-to-end metrics is read from the device trace; its length is the
traffic's ``device_slice_seconds``.
"""

from __future__ import annotations

import gc
import json
import math
import os
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

from . import data, judge, manifest
from .trace import Trace

FORBIDDEN = ("jax", "jaxlib", "flax", "intool_rag_tpu")


def forbidden_modules() -> list[str]:
    """Top-level names in ``sys.modules`` that the port's process must not
    hold, compared whole (``intool_rag_tpu_torch`` is not
    ``intool_rag_tpu``)."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


class Run:
    """What a metric reader reads. The system module adds the fields its
    own cells' readers read."""

    def __init__(self, cell: str, spec: dict, plan: dict) -> None:
        self.cell = cell
        self.config = spec["config"]
        self.traffic = spec["traffic"]
        self.plan = plan
        self.setup_s = math.nan
        self.window_s = math.nan
        self.queries = 0  # questions answered in the window
        self.batches = 0  # batches sent in the window
        self.batch_counts: dict[int, int] = {}  # times each pre-drawn batch ran
        self.slice_queries = 0  # questions sent inside the profiler slice
        self.spans: dict[str, list[float]] = {}  # seconds, traced runs only
        self.trace: Trace | None = None


def _sync(torch) -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


class _Slice:
    """A profiler slice through the port's own trace window
    (``observability.start_device_trace``), which starts and stops behind
    the port's device gate."""

    def __init__(self, directory: Path, torch) -> None:
        from intool_rag_tpu_torch import observability

        self.obs, self.dir, self.torch = observability, str(directory), torch
        self.t0 = None

    def start(self) -> None:
        _sync(self.torch)
        self.obs.start_device_trace(self.dir, cuda=self.torch.cuda.is_available())
        self.t0 = time.perf_counter()

    def stop(self) -> Trace:
        _sync(self.torch)
        window_s = time.perf_counter() - self.t0
        path = Path(self.obs.stop_device_trace())
        try:
            events = json.loads(path.read_text(encoding="utf-8"))
        finally:
            path.unlink()
        if isinstance(events, dict):
            events = events.get("traceEvents", [])
        return Trace(events, window_s)


def check_batches(traffic: dict, rng) -> np.ndarray:
    """The pre-drawn batches a run checks: ``check_batches`` of the first
    ``check_from`` (every window sends those), drawn from the seed."""
    pool = min(int(traffic["check_from"]), int(traffic["batches"]))
    return np.sort(rng.choice(pool, min(int(traffic["check_batches"]), pool), replace=False))


class _Pace:
    """Where the window's time went, by third: batches, the host's seconds
    in each phase the system's step names (``/search``: the encode call and
    the search call), the process's CPU seconds, and the collections of
    Python's garbage collector; then the host's load average. Printed on
    standard error, so a run whose rate drifts shows whether its own work
    grew or the host slowed it."""

    def __init__(self) -> None:
        self.rows: list[tuple[float, dict[str, float], float]] = []  # end, phase seconds, cpu s
        self.gc: list[float] = []
        self.t0 = 0.0

    def _on_gc(self, phase: str, info: dict) -> None:
        if phase == "start":
            self.gc.append(time.perf_counter() - self.t0)

    def start(self, t0: float) -> None:
        self.t0 = t0
        gc.callbacks.append(self._on_gc)

    def stop(self, seconds: float) -> None:
        gc.callbacks.remove(self._on_gc)
        names = list(self.rows[0][1]) if self.rows else []
        out = []
        for k in range(3):
            lo, hi = k * seconds / 3, (k + 1) * seconds / 3
            rows = [r for r in self.rows if lo <= r[0] < hi]
            n = len(rows)
            mean = lambda f: round(1e3 * sum(f(r) for r in rows) / n, 3) if n else None
            out.append({"batches": n, **{f"{name}_ms": mean(lambda r: r[1][name]) for name in names},
                        "cpu_ms": mean(lambda r: r[2]), "gc": sum(1 for t in self.gc if lo <= t < hi)})
        import torch

        print("portbench: the window by third " + json.dumps(out) + f"; load average {os.getloadavg()}, "
              f"torch threads {torch.get_num_threads()}", file=sys.stderr)


def _closed(system, run: Run, seconds: float, trace: bool, tracing: dict, slicer, torch, check: set[int],
            slice_s: float) -> None:
    """The closed loop: one step of the system after another, cycling
    through the plan's batches, for ``seconds``. The window ends on the
    first step boundary past ``seconds`` at which every checked batch has
    run and, where a slice is taken, the slice holds a step: a host too
    slow for that in ``seconds`` (a tiny CPU run under load) runs on until
    it does, where a full-size window has done so long before."""
    n_batches = len(run.plan["batches"])
    grabbed: set[int] = set()
    trace_at = seconds - slice_s if slicer is not None else math.inf
    pace = _Pace()
    clock, cpu = time.perf_counter, time.process_time
    _sync(torch)
    t0 = clock()
    pace.start(t0)
    i = 0
    while (now := clock() - t0) < seconds or len(grabbed) < len(check) or (slicer is not None and
                                                                           not run.slice_queries):
        if slicer is not None and not tracing.get("on") and now >= trace_at:
            slicer.start()
            tracing["on"] = True
            sliced_at = (run.queries, now)
        b = i % n_batches
        grab = b in check and b not in grabbed
        c0 = cpu()
        answered, phases = system.step(b, trace, grab)
        pace.rows.append((clock() - t0, phases, cpu() - c0))
        if grab:
            grabbed.add(b)
        run.batch_counts[b] = run.batch_counts.get(b, 0) + 1
        run.queries += answered
        if tracing.get("on"):
            run.slice_queries += answered
        i += 1
    _sync(torch)
    run.window_s = clock() - t0
    run.batches = i
    pace.stop(seconds)
    if tracing.get("on") and sliced_at[0] > 0:
        print(f"portbench: {sliced_at[0] / sliced_at[1]!r} queries/s before the profiler slice "
              f"({sliced_at[1]!r} s)", file=sys.stderr)
    if tracing.get("on"):
        run.trace = slicer.stop()
        tracing["on"] = False
        run.spans = system.spans


def run_cell(cell: str, seed: int, seconds: float, trace: bool, *, device: str = "cuda", t_start: float | None = None,
             spec: dict | None = None, faults=None, control: bool = False) -> tuple[dict, Run]:
    """Runs cell ``cell`` once; returns the result line's object (its
    ``checks`` come last) and the :class:`Run` its metrics were read from.
    The cell's configuration names the system module that builds, steps
    and judges it (``manifest.system``). ``spec`` replaces the manifest's
    cell (tests); ``faults(system)`` breaks the timed path underneath the
    module's wrappers (tests); ``control`` also judges the control (the
    reference one precision down, in the program's place) on the batches
    the run checks, under the key ``control`` (``portbench/calibrate.py``)."""
    t_start = time.perf_counter() if t_start is None else t_start
    import torch

    spec = spec or manifest.cell(manifest.load(), cell)
    config, traffic = spec["config"], spec["traffic"]
    kind = manifest.system(config)
    tmp = Path(tempfile.gettempdir()) / "portbench"
    if traffic["loop"] != "closed":
        raise ValueError(f"unknown loop {traffic['loop']!r}")
    run = Run(cell, spec, kind.plan(config, traffic, seed))
    sample_rng = data.host_rng(seed, data.SAMPLE)
    on_card = torch.device(device).type == "cuda"

    t_system = time.perf_counter()
    system = kind.build(config, seed, device, tmp)
    try:
        stages = dict(before_system=t_system - t_start, **system.timings)
        if faults is not None:
            faults(system)
        tracing = {}
        system.install(run, tracing)
        slicer = None
        device_slice = not trace and any(m["source"] == "device_trace" for m in spec["end_to_end"])
        if trace or device_slice:
            slicer = _Slice(tmp / "traces", torch)
            slicer.start()  # the profiler's first start initialises CUPTI: in set-up, not in the window
            slicer.stop()
        t_warm = time.perf_counter()
        system.warm(int(traffic["warm_batches"]))
        stages["warm"] = time.perf_counter() - t_warm
        check = set(check_batches(traffic, sample_rng).tolist())
        run.setup_s = time.perf_counter() - t_start
        slice_s = float(traffic["trace_seconds"] if trace else traffic.get("device_slice_seconds", 0.0))
        _closed(system, run, seconds, trace, tracing, slicer, torch, check, slice_s)
        sides = system.collect(run)
        attempted, failed = run.queries, 0
        peak = int(torch.cuda.max_memory_allocated()) if on_card else 0
        print("portbench: set-up s by stage " + json.dumps({k: round(v, 3) for k, v in stages.items()}),
              file=sys.stderr)

        metrics_src = spec["per_layer"] if trace else spec["end_to_end"]
        metrics = {}
        for m in metrics_src:
            value = manifest.reader(m["name"])(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        breakdown = None
        if trace and run.trace is not None:
            breakdown = {"device_ops": run.trace.top_device_ops(), "idle_gaps": run.trace.idle_gaps()}
    finally:
        system.close()  # what the run replaced goes back, and the program's state goes before the reference runs
    del system
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    reference = kind.reference(config, seed, device, run)
    numbers = [reference.numbers(side) for side in sides]
    correct, checks = judge.verdict(numbers, spec["limits"])
    correct = correct and failed == 0 and len(sides) > 0

    result = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed), "metrics": metrics,
              "device": {
                  "platform": "gpu" if on_card else "cpu",
                  "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
                  "count": 1, "memory_peak_bytes": peak}}
    if trace and run.trace is not None:
        result["device"]["busy_s"] = run.trace.busy_s
        result["device"]["window_s"] = run.trace.window_s
        result["breakdown"] = breakdown
    if control:
        ctrl = [reference.numbers(reference.control_side(side)) for side in sides]
        result["control"] = judge.verdict(ctrl, spec["limits"])[1]
    result["checks"] = checks
    return result, run
