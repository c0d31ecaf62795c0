"""One run of one cell: set up the system from the seed, warm every shape
the cell's traffic uses, measure for ``seconds``, then judge what the timed
path produced against the reference and print the result line.

Closed loop: one client sends each pre-drawn batch as the retrieval path
does, ``PageLevelRetriever._embed`` then ``HybridEngine.search``, and the
next when it returns.

With ``trace`` the run also times the harness's spans (each ended by a
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
import threading
import time
from pathlib import Path

import numpy as np

from . import data, generate, judge, manifest
from .trace import Trace

FORBIDDEN = ("jax", "jaxlib", "flax", "intool_rag_tpu")


def forbidden_modules() -> list[str]:
    """Top-level names in ``sys.modules`` that the port's process must not
    hold, compared whole (``intool_rag_tpu_torch`` is not
    ``intool_rag_tpu``)."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


class Run:
    """What a metric reader reads."""

    def __init__(self, cell: str, spec: dict, plan: dict) -> None:
        self.cell = cell
        self.config = spec["config"]
        self.model = spec["config"]["model"]
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
        self.scans: list[dict] = []  # K3 calls inside the traced slice
        self.tier: dict | None = None  # the capacity tier's layout once the window has closed
        self.restore = lambda: None  # puts back what the wrappers replaced


class _Capture:
    """The slots the wrappers fill while a checked batch runs."""

    def __init__(self) -> None:
        self.local = threading.local()

    def on(self) -> None:
        self.local.on, self.local.emb, self.local.fuse, self.local.probes = True, None, None, None

    def off(self) -> dict:
        out = {k: getattr(self.local, k, None) for k in ("emb", "fuse", "probes")}
        self.local.on = False
        return out

    @property
    def active(self) -> bool:
        return getattr(self.local, "on", False)


def _install_wrappers(system, capture: _Capture, run: Run, tracing: dict) -> None:
    """Pass-through wrappers that keep references to what a checked batch
    produced (query embeddings; the capacity tier's query tiles and probe
    table; fusion's two pools and its result) and, in the traced slice, the
    probe table of each K3 scan."""
    import intool_rag_tpu_torch.index.bits_index as bits_index
    import intool_rag_tpu_torch.index.hybrid as hybrid

    fuse, scan, probes = hybrid._fuse, bits_index.ivf_bits_topk, bits_index.tile_probes
    run.restore = lambda: (setattr(hybrid, "_fuse", fuse), setattr(bits_index, "ivf_bits_topk", scan),
                           setattr(bits_index, "tile_probes", probes))

    def fuse_wrapper(d_vals, d_rows, s_vals, s_rows, k, **kw):
        out = fuse(d_vals, d_rows, s_vals, s_rows, k, **kw)
        if capture.active:
            capture.local.fuse = (d_vals, d_rows, s_vals, s_rows, out)
        return out

    hybrid._fuse = fuse_wrapper
    embed = system.retriever._embed

    def embed_wrapper(queries):
        out = embed(queries)
        if capture.active:
            capture.local.emb = out
        return out

    system.retriever._embed = embed_wrapper

    def probes_wrapper(queries, centroids, nprobe):
        out = probes(queries, centroids, nprobe)
        if capture.active:
            capture.local.probes = (out[0], out[2])  # query order (tiles of 8), probed lists per tile
        return out

    bits_index.tile_probes = probes_wrapper

    def scan_wrapper(qs, codes, scales, probe_blocks, c_sel, k, **kw):
        if tracing.get("on"):
            run.scans.append({"q": qs.shape[0], "d": qs.shape[1], "probe_blocks": probe_blocks, **kw})
        return scan(qs, codes, scales, probe_blocks, c_sel, k, **kw)

    bits_index.ivf_bits_topk = scan_wrapper


def _host(x):
    return x.detach().cpu().numpy() if hasattr(x, "detach") else x


def _side(texts, cap: dict) -> dict:
    d_vals, d_rows, s_vals, s_rows, (f_vals, f_rows) = cap["fuse"]
    q = len(texts)
    side = {"texts": list(texts), "emb": cap["emb"][:q], "d_vals": d_vals[:q], "d_rows": d_rows[:q],
            "s_vals": s_vals[:q], "s_rows": s_rows[:q], "f_vals": f_vals[:q], "f_rows": f_rows[:q]}
    if cap["probes"] is not None:
        side["order"], side["probes"] = cap["probes"]
    return {k: _host(v) for k, v in side.items()}


def _tier(system) -> dict | None:
    """The capacity tier's layout, if the engine built one: its centroids,
    the row each slot holds (−1 empty), the slots of a list, and the slots
    of a scanned block."""
    ivf = getattr(system.engine.dense, "_ivf", None)
    if ivf is None or not hasattr(ivf, "gid"):
        return None
    return {"centroids": _host(ivf.centroids), "gid": _host(ivf.gid), "cap_l": int(ivf.cap_l),
            "block_n": int(ivf.block_n)}


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
    in the encode call and in the search call, the process's CPU seconds,
    and the collections of Python's garbage collector; then the host's load
    average. Printed on standard error, so a run whose rate drifts shows
    whether its own work grew or the host slowed it."""

    def __init__(self) -> None:
        self.rows: list[tuple[float, float, float, float]] = []  # end, encode s, search s, cpu s
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
        out = []
        for k in range(3):
            lo, hi = k * seconds / 3, (k + 1) * seconds / 3
            rows = [r for r in self.rows if lo <= r[0] < hi]
            n = len(rows)
            mean = lambda j: round(1e3 * sum(r[j] for r in rows) / n, 3) if n else None
            out.append({"batches": n, "encode_ms": mean(1), "search_ms": mean(2), "cpu_ms": mean(3),
                        "gc": sum(1 for t in self.gc if lo <= t < hi)})
        import torch

        print("portbench: the window by third " + json.dumps(out) + f"; load average {os.getloadavg()}, "
              f"torch threads {torch.get_num_threads()}", file=sys.stderr)


def _closed(system, run: Run, seconds: float, trace: bool, capture: _Capture, tracing: dict, slicer, torch,
            check: set[int], slice_s: float) -> list[dict]:
    from torch.profiler import record_function

    cfg = run.config["search"]
    k, kc = cfg["k"], cfg["candidates"]
    batches = run.plan["batches"]
    retriever, engine = system.retriever, system.engine
    spans = {"encode": [], "hybrid": []}
    captured: dict[int, tuple] = {}
    trace_at = seconds - slice_s if slicer is not None else math.inf
    pace = _Pace()
    clock, cpu = time.perf_counter, time.process_time
    _sync(torch)
    t0 = clock()
    pace.start(t0)
    i = 0
    while (now := clock() - t0) < seconds:
        if slicer is not None and not tracing.get("on") and now >= trace_at:
            slicer.start()
            tracing["on"] = True
            sliced_at = (i, now)
        b = i % len(batches)
        texts = batches[b]
        grab = b in check and b not in captured
        if grab:
            capture.on()
        c0 = cpu()
        if trace:
            with record_function("portbench.encode"):
                s = clock()
                emb = retriever._embed(texts)
                _sync(torch)
                spans["encode"].append(clock() - s)
            with record_function("portbench.hybrid"):
                s = clock()
                engine.search(texts, emb, k, candidates=kc)
                _sync(torch)
                spans["hybrid"].append(clock() - s)
            mid = s
        else:
            s = clock()
            emb = retriever._embed(texts)
            mid = clock()
            engine.search(texts, emb, k, candidates=kc)
        end = clock()
        pace.rows.append((end - t0, mid - s if not trace else spans["encode"][-1], end - mid, cpu() - c0))
        if grab:
            captured[b] = (texts, capture.off())
        run.batch_counts[b] = run.batch_counts.get(b, 0) + 1
        run.queries += len(texts)
        if tracing.get("on"):
            run.slice_queries += len(texts)
        i += 1
    _sync(torch)
    run.window_s = clock() - t0
    run.batches = i
    pace.stop(seconds)
    if tracing.get("on") and sliced_at[0] > 0:
        print(f"portbench: {sliced_at[0] * len(batches[0]) / sliced_at[1]!r} queries/s before the profiler slice "
              f"({sliced_at[1]!r} s)", file=sys.stderr)
    if tracing.get("on"):
        run.trace = slicer.stop()
        tracing["on"] = False
        run.spans = spans
    return [_side(*captured[b]) for b in sorted(captured)]


def _warm_closed(system, run: Run, torch) -> None:
    cfg = run.config["search"]
    for texts in run.plan["batches"][: int(run.traffic["warm_batches"])]:
        emb = system.retriever._embed(texts)
        system.engine.search(texts, emb, cfg["k"], candidates=cfg["candidates"])
    _sync(torch)


def run_cell(cell: str, seed: int, seconds: float, trace: bool, *, device: str = "cuda", t_start: float | None = None,
             spec: dict | None = None, faults=None, control: bool = False) -> tuple[dict, Run]:
    """Runs cell ``cell`` once; returns the result line's object (its
    ``checks`` come last) and the :class:`Run` its metrics were read from.
    ``spec`` replaces the manifest's cell (tests); ``faults(system)`` breaks
    the timed path underneath the harness's wrappers (tests); ``control``
    also judges the control (the reference one precision down, in the
    program's place) on the batches the run checks, under the key
    ``control`` (``portbench/calibrate.py``)."""
    t_start = time.perf_counter() if t_start is None else t_start
    import torch

    from . import system as system_mod

    spec = spec or manifest.cell(manifest.load(), cell)
    config, traffic = spec["config"], spec["traffic"]
    tmp = Path(tempfile.gettempdir()) / "portbench"
    system_mod.configure(config, tmp)
    bm = config["bm25"]
    vocab = data.vocabulary(seed, bm["vocab"])
    plan = generate.plan(traffic, vocab, seed)
    run = Run(cell, spec, plan)
    sample_rng = data.host_rng(seed, data.SAMPLE)
    on_card = torch.device(device).type == "cuda"

    t_system = time.perf_counter()
    system = system_mod.System(config, seed, device, tmp)
    stages = dict(before_system=t_system - t_start, **system.timings)
    if faults is not None:
        faults(system)
    capture, tracing = _Capture(), {}
    _install_wrappers(system, capture, run, tracing)
    slicer = None
    device_slice = not trace and any(m["source"] == "device_trace" for m in spec["end_to_end"])
    if trace or device_slice:
        slicer = _Slice(tmp / "traces", torch)
        slicer.start()  # the profiler's first start initialises CUPTI: in set-up, not in the window
        slicer.stop()
    t_warm = time.perf_counter()
    _warm_closed(system, run, torch)
    stages["warm"] = time.perf_counter() - t_warm
    check = set(check_batches(traffic, sample_rng).tolist())
    run.setup_s = time.perf_counter() - t_start
    slice_s = float(traffic["trace_seconds"] if trace else traffic.get("device_slice_seconds", 0.0))
    sides = _closed(system, run, seconds, trace, capture, tracing, slicer, torch, check, slice_s)
    attempted, failed = run.queries, 0
    run.tier = _tier(system)
    peak = int(torch.cuda.max_memory_allocated()) if on_card else 0
    print("portbench: set-up s by stage " + json.dumps({k: round(v, 3) for k, v in stages.items()}), file=sys.stderr)

    metrics_src = spec["per_layer"] if trace else spec["end_to_end"]
    metrics = {}
    for m in metrics_src:
        value = manifest.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    breakdown = None
    if trace and run.trace is not None:
        breakdown = {"device_ops": run.trace.top_device_ops(), "idle_gaps": run.trace.idle_gaps()}

    # the program's state goes before the reference runs
    run.restore()
    system.close()
    del system
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    reference = judge.Reference(config, seed, device, tier=run.tier)
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
        search = config["search"]
        ctrl = [reference.numbers(reference.control_side(side["texts"], search["candidates"], search["k"]))
                for side in sides]
        result["control"] = judge.verdict(ctrl, spec["limits"])[1]
    result["checks"] = checks
    return result, run
