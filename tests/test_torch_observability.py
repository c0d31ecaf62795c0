"""The port's observability module and the service's ``GET /metrics`` and
``POST /debug/trace`` against the JAX package's.

``Metrics.snapshot()`` of both packages after one seeded sequence of
``inc`` / ``observe`` calls: equal dicts (the percentiles and means are
rounded to 6 places in both, so equal means equal). ``trace_phase`` times
into the metrics it is given. The port's ``/metrics`` holds the JAX keys
and counts its requests; ``/debug/trace`` clamps ``seconds`` to [0.5, 60],
answers a malformed body with a 400 and, on the CPU, writes a Chrome
trace JSON with the window's CPU events. The device gate holds a trace's
start and stop back until the work in flight ends, holds new work back
meanwhile (but not the urgent work that serves it), and lets a window
run under concurrent requests. ``ensure_backend`` raises without CUDA
unless the CPU was asked for.

Spans: nested spans carry their parent's id and one trace id per root
(or the bound one); nothing is recorded or kept with no collector open;
a trace window holds the spans of every thread, on their own ``tid``, on
the trace's clock (a span around a ``record_function`` lands within 1 ms
of it) and clipped to the trace's first and last stamps; the encoder's
counters for one batch; the batcher's wait spans carry their batch's
trace id."""

from __future__ import annotations

import glob
import json
import os
import threading
import time

import numpy as np
import pytest
import torch

torch.set_num_threads(2)


def _drive(metrics_cls, seed: int):
    m = metrics_cls(window=16)
    rng = np.random.default_rng(seed)
    for _ in range(60):
        name = ["ingest", "query.retrieve", "search"][int(rng.integers(3))]
        if rng.random() < 0.4:
            m.inc(name + "_requests", int(rng.integers(1, 4)))
        else:
            m.observe(name, float(rng.exponential(0.05)))
    m.inc("empty_window_counter")
    return m.snapshot()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_snapshot_equals_jax(seed):
    from intool_rag_tpu.observability import Metrics as JMetrics
    from intool_rag_tpu_torch.observability import Metrics

    want, got = _drive(JMetrics, seed), _drive(Metrics, seed)
    assert got == want
    assert all(v["count"] <= 16 for v in got["latency_s"].values())  # the rolling window


def test_empty_snapshot_and_percentiles_equal_jax():
    from intool_rag_tpu.observability import Metrics as JMetrics
    from intool_rag_tpu_torch.observability import Metrics

    assert Metrics().snapshot() == JMetrics().snapshot() == {"counters": {}, "latency_s": {}}
    for values in ([], [0.3], [0.5, 0.1, 0.9, 0.2], list(np.linspace(0, 1, 101))):
        for p in (0.5, 0.95, 0.99):
            assert Metrics._percentile(list(values), p) == JMetrics._percentile(list(values), p)


def test_trace_phase_times_into_the_given_metrics():
    from intool_rag_tpu_torch.observability import Metrics, trace_phase

    m = Metrics()
    with trace_phase("phase.a", m):
        torch.ones(4).sum()
    with trace_phase("phase.a", m):
        pass
    snap = m.snapshot()
    assert snap["latency_s"]["phase.a"]["count"] == 2 and snap["latency_s"]["phase.a"]["p99"] >= 0.0


def test_ensure_backend():
    from intool_rag_tpu_torch.backend import ensure_backend

    assert ensure_backend("cpu") == "cpu"
    if torch.cuda.is_available():
        assert ensure_backend(None) == "cuda"
        return
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="CUDA"):
            ensure_backend(device)


@pytest.fixture
def service(tmp_path, monkeypatch):
    from intool_rag_tpu_torch import config
    from intool_rag_tpu_torch.providers.fake import FakeLLM
    from intool_rag_tpu_torch.providers.hash_embed import HashEmbeddingProvider
    from intool_rag_tpu_torch.service.app import RAGService

    monkeypatch.setenv("STORAGE_DIR", str(tmp_path / "storage"))
    monkeypatch.setenv("CACHE_DIR", str(tmp_path / "cache"))
    monkeypatch.setenv("LLM_PROVIDER", "fake")
    config.reset_config()
    yield RAGService(HashEmbeddingProvider(dimension=32), device="cpu", llm=FakeLLM())
    config.reset_config()


def test_metrics_route_keys_and_counters(service):
    from intool_rag_tpu_torch.observability import get_metrics

    status, snap = service.handle("GET", "/metrics")
    assert status == 200
    keys = {"counters", "latency_s", "corpus", "query_cache", "batcher"}
    assert keys <= set(snap) <= keys | {"process"}
    assert snap["counters"] == {} and snap["corpus"] == {"documents": 0, "chunks": 0, "bm25_vocab": 0}
    for _ in range(2):
        assert service.handle("POST", "/query", b'{"question": "anything?"}')[0] == 200
    assert service.handle("POST", "/search", b'{"question": "anything?"}')[0] == 200
    assert service.handle("POST", "/agent/query", b'{"question": "anything?"}')[0] == 200
    assert service.handle("POST", "/agent/query", b"[1]")[0] == 400
    snap = service.handle("GET", "/metrics")[1]
    assert snap["counters"] == {"query_requests": 2, "search_requests": 1, "agent_requests": 1}
    assert {k: v["count"] for k, v in snap["latency_s"].items()} == \
        {"query.retrieve": 2, "search": 1, "agent.query": 1, "search.queue_wait": 3}  # the batcher's wait
    assert snap["query_cache"] == {"hits": service.query_cache.hits, "misses": service.query_cache.misses}
    get_metrics().inc("test_process_counter")
    assert service.handle("GET", "/metrics")[1]["process"]["counters"]["test_process_counter"] >= 1


def test_debug_trace_writes_a_chrome_trace_on_the_cpu(service):
    from intool_rag_tpu_torch.config import get_config

    assert service.handle("POST", "/debug/trace", b"not json")[0] == 400
    assert service.handle("POST", "/debug/trace", b'{"seconds": "soon"}')[0] == 400
    status, out = service.handle("POST", "/debug/trace", b'{"seconds": 0.01}')
    assert status == 200 and out["seconds"] == 0.5  # clamped up
    assert out["trace_dir"] == str(get_config().STORAGE_DIR / "traces")
    files = glob.glob(os.path.join(out["trace_dir"], "*.json"))
    assert len(files) == 1
    trace = json.loads(open(files[0]).read())
    assert "traceEvents" in trace
    from intool_rag_tpu_torch.observability import start_device_trace, stop_device_trace

    start_device_trace(out["trace_dir"], cuda=False)
    try:
        with pytest.raises(RuntimeError, match="already running"):
            start_device_trace(out["trace_dir"], cuda=False)
    finally:
        stop_device_trace()
    assert len(glob.glob(os.path.join(out["trace_dir"], "*.json"))) == 2


def test_device_gate_keeps_a_trace_start_apart_from_work_in_flight(tmp_path):
    from intool_rag_tpu_torch import observability as obs

    release, stop_now, entered, paths = threading.Event(), threading.Event(), [], []

    def hold():
        with obs.device_work():
            entered.append("held")
            release.wait(5)

    def later(tag, urgent):
        with obs.device_work(urgent=urgent):
            entered.append(tag)

    def trace():  # torch.profiler starts and stops on one thread, as /debug/trace does
        obs.start_device_trace(str(tmp_path), False)
        stop_now.wait(5)
        paths.append(obs.stop_device_trace())

    holder = threading.Thread(target=hold)
    holder.start()
    while not entered:
        time.sleep(0.001)
    tracer = threading.Thread(target=trace)
    tracer.start()
    while not obs._gate._waiting:  # the trace waits for the work in flight
        time.sleep(0.001)
    plain = threading.Thread(target=later, args=("plain", False))
    urgent = threading.Thread(target=later, args=("urgent", True))
    plain.start()
    urgent.start()
    urgent.join(5)
    time.sleep(0.05)
    assert entered == ["held", "urgent"] and not obs._trace  # new work and the trace wait
    release.set()
    for t in (holder, plain):
        t.join(5)
    assert entered == ["held", "urgent", "plain"]  # the work ran once the trace had started
    stop_now.set()
    tracer.join(10)
    assert len(paths) == 1 and os.path.exists(paths[0]) and not obs._trace
    with obs.device_work():
        with obs.device_work():  # a thread may enter again while it is inside
            with pytest.raises(RuntimeError, match="inside device work"):
                obs.start_device_trace(str(tmp_path), False)
    assert not obs._trace
    assert obs._gate._inside == obs._gate._waiting == 0 and not obs._gate._alone


def test_debug_trace_under_concurrent_requests(service):
    stop, codes = threading.Event(), []

    def load(route):
        while not stop.is_set():
            codes.append(service.handle("POST", route, b'{"question": "anything?"}')[0])

    workers = [threading.Thread(target=load, args=(r,)) for r in ("/agent/query", "/search", "/query")]
    for w in workers:
        w.start()
    try:
        status, out = service.handle("POST", "/debug/trace", b'{"seconds": 0.5}')
    finally:
        stop.set()
        for w in workers:
            w.join(10)
    assert status == 200 and len(glob.glob(os.path.join(out["trace_dir"], "*.json"))) == 1
    assert codes and set(codes) == {200}


def _span_tree(obs):
    with obs.collect_spans() as spans:
        with obs.trace_phase("root.a") as a:
            with obs.trace_phase("child") as child:
                with obs.trace_phase("grandchild") as grandchild:
                    pass
            with obs.trace_phase("child.2") as child2:
                pass
        with obs.trace_phase("root.b") as b:
            pass
        with obs.bind_trace(777):
            with obs.trace_phase("root.bound") as bound:
                pass
    return spans, a, child, grandchild, child2, b, bound


def test_spans_nest_with_parent_ids_and_one_trace_id_per_root():
    from intool_rag_tpu_torch import observability as obs

    spans, a, child, grandchild, child2, b, bound = _span_tree(obs)
    assert [s.name for s in spans] == ["grandchild", "child", "child.2", "root.a", "root.b", "root.bound"]
    assert a.parent == b.parent == bound.parent == 0
    assert child.parent == child2.parent == a.id and grandchild.parent == child.id
    assert len({s.id for s in spans}) == len(spans)
    assert child.trace == grandchild.trace == child2.trace == a.trace != b.trace
    assert bound.trace == 777
    assert all(s.start_ns <= s.end_ns for s in spans) and a.start_ns <= child.start_ns <= child.end_ns <= a.end_ns
    assert obs.span_context() is None and not obs._spans and not obs._collecting


def test_no_span_is_recorded_or_kept_without_a_collector():
    from intool_rag_tpu_torch import observability as obs

    m = obs.Metrics()
    with obs.trace_phase("off") as off:
        with obs.trace_phase("off.timed", m) as timed:
            pass
    assert obs.record_span("off.wait", 0, 1, tid=1) is None
    assert not obs._spans and not hasattr(off, "id") and not hasattr(timed, "id") and not hasattr(off, "args")
    assert m.snapshot()["latency_s"]["off.timed"]["count"] == 1  # a caller's Metrics still times it
    opened_before = obs.trace_phase("straddles.the.open")
    opened_before.__enter__()
    with obs.collect_spans() as spans:
        opened_before.__exit__(None, None, None)
        with obs.trace_phase("inside"):
            pass
    assert [s.name for s in spans] == ["inside"] and not obs._spans
    with obs.trace_phase("after"):
        pass
    assert not obs._spans


def _export(path) -> list[dict]:
    with open(path, encoding="utf-8") as f:
        trace = json.load(f)
    return trace["traceEvents"], trace


def test_a_trace_window_holds_every_threads_spans_on_the_traces_clock(tmp_path):
    from intool_rag_tpu_torch import observability as obs

    def other():
        with obs.trace_phase("second.thread"):
            time.sleep(0.005)
        tids.append(threading.get_native_id())

    tids: list[int] = []
    obs.start_device_trace(str(tmp_path), cuda=False)
    try:
        with obs.trace_phase("probe.span"):
            with torch.profiler.record_function("probe"):
                torch.ones(64).sum()
        worker = threading.Thread(target=other)
        worker.start()
        worker.join(10)
        assert not worker.is_alive()
    finally:
        path = obs.stop_device_trace()
    events, trace = _export(path)
    by_name = {e["name"]: e for e in events if e.get("ph") == "X"}
    second, probe, span = by_name["second.thread"], by_name["probe"], by_name["probe.span"]
    assert second["tid"] == tids[0] != span["tid"] == probe["tid"] == threading.get_native_id()
    assert second["cat"] == span["cat"] == "user_annotation" and set(second["args"]) == {"span", "parent", "trace"}
    assert abs(span["ts"] - probe["ts"]) < 1000 and abs(span["ts"] + span["dur"] - probe["ts"] - probe["dur"]) < 1000
    meta = trace["observability"]
    assert meta["spans"] == 2 and meta["spans_outside"] == 0 and abs(meta["clock_drift_us"]) < 1000
    assert not obs._spans and not obs._collecting


def test_a_span_that_opened_before_the_window_is_clipped_to_the_window(tmp_path):
    from intool_rag_tpu_torch import observability as obs

    with obs.collect_spans() as spans:
        straddle = obs.trace_phase("straddle")
        straddle.__enter__()
        time.sleep(0.01)
        obs.start_device_trace(str(tmp_path), cuda=False)
        try:
            straddle.__exit__(None, None, None)
        finally:
            path = obs.stop_device_trace()
    assert [s.name for s in spans] == ["straddle"]
    events, _ = _export(path)
    theirs = [e for e in events if e.get("ph") == "X" and e["name"] != "straddle"]
    ours = next(e for e in events if e.get("name") == "straddle")
    first_anchor = min(e["ts"] for e in theirs if e["name"] == obs.CLOCK_ANCHOR)
    assert ours["ts"] == pytest.approx(first_anchor, abs=1e-3)  # the window opens at its first anchor
    assert min(e["ts"] for e in theirs) <= ours["ts"]
    assert ours["ts"] + ours["dur"] <= max(e["ts"] + e.get("dur", 0) for e in theirs)


def _span(obs, name, start_ns, end_ns):
    span = obs.trace_phase(name)
    span.start_ns, span.end_ns, span.tid, span.id, span.parent, span.trace, span.args = \
        start_ns, end_ns, 7, 1, 0, 1, {"embed.tokens": 3}
    return span


@pytest.mark.parametrize("start_us, end_us, want", [
    (3_000, 3_100, (3_000.0, 100.0)),  # inside: moved by the anchors' offset (1,000 µs) only
    (500, 3_000, (1_999.0, 1_001.0)),  # opened before the first anchor
    (8_000, 12_000, (8_000.0, 1_104.0)),  # closed after the last anchor
    (12_000, 13_000, None),  # after the window: left out
])
def test_merge_spans_converts_by_the_anchors_and_clips_to_the_window(tmp_path, start_us, end_us, want):
    from intool_rag_tpu_torch import observability as obs

    # the trace's stamps run from 1,000 to 10,000 µs, its anchors from 1,999 to 9,104; perf_counter_ns reads
    # 1,000 µs less than the trace's time base
    anchors = [(1_000_000, 1_002_000), (1_100_000, 1_100_000), (8_000_000, 8_000_000), (8_100_000, 8_100_000)]
    events = [{"ph": "X", "cat": "Trace", "name": "window", "pid": 1, "tid": 1, "ts": 1_000.0, "dur": 9_000.0}]
    events += [{"ph": "X", "cat": "user_annotation", "name": obs.CLOCK_ANCHOR, "pid": 1, "tid": 1,
                "ts": (a + b) / 2e3 + 1_000.0 - w / 2, "dur": w}
               for (a, b), w in zip(anchors, (4.0, 2.0, 2.0, 8.0))]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    obs.merge_spans(str(path), [_span(obs, "s", (start_us - 1_000) * 1000, (end_us - 1_000) * 1000)], anchors)
    out, trace = _export(path)
    assert [e for e in out if e.get("name") != "s"] == events  # the export's own events stay as they were
    got = [e for e in out if e.get("name") == "s"]
    assert trace["observability"]["clock_drift_us"] == pytest.approx(0.0, abs=1e-6)
    if want is None:
        assert not got and trace["observability"]["spans_outside"] == 1
        return
    assert (got[0]["ts"], got[0]["dur"]) == pytest.approx(want)
    assert got[0]["tid"] == 7 and got[0]["args"] == {"span": 1, "parent": 0, "trace": 1, "embed.tokens": 3}


def test_encoder_counters_and_spans_for_one_batch():
    from intool_rag_tpu_torch import observability as obs
    from intool_rag_tpu_torch.models.encoder import EncoderConfig, TextEncoder
    from intool_rag_tpu_torch.models.tokenizer import SimpleTokenizer
    from intool_rag_tpu_torch.providers.base import instruction_prefix
    from intool_rag_tpu_torch.providers.cuda_embed import CudaEmbeddingProvider

    encoder = TextEncoder(EncoderConfig.tiny(), device="cpu").init_random(torch.Generator().manual_seed(3))
    tokenizer = SimpleTokenizer(vocab_size=1024, max_length=128)
    provider = CudaEmbeddingProvider(encoder, tokenizer=tokenizer, device="cpu")
    words = ["invoice", "total", "amount", "shipping", "balance", "supplier", "contract", "delivery"]
    texts = [" ".join(words[: 2 + i]) + " " + " ".join(f"item{j}" for j in range(8 * i)) for i in range(3)]
    ids, mask = tokenizer.encode_batch([instruction_prefix(False) + t for t in texts])
    assert 16 < ids.shape[1] <= 32  # one micro-batch in the (4, 32) bucket
    keys = ("embed.tokens", "embed.slots", "embed.micro_batches")
    before = obs.get_metrics().snapshot()["counters"]
    with obs.collect_spans() as spans:
        out = provider.embed_batch(texts)
    after = obs.get_metrics().snapshot()["counters"]
    delta = {k: after.get(k, 0) - before.get(k, 0) for k in keys}
    assert out.shape == (3, 64)
    assert delta == {"embed.tokens": int(mask.sum()), "embed.slots": 4 * 32, "embed.micro_batches": 1}
    assert [s.name for s in spans] == ["embed.tokenize", "embed.forward", "embed.readback"]
    assert {k: spans[0].args[k] for k in keys} == delta


def test_batcher_wait_spans_carry_their_batchs_trace_id():
    from intool_rag_tpu_torch import observability as obs
    from intool_rag_tpu_torch.service.batcher import QueryBatcher

    m = obs.Metrics()
    batcher = QueryBatcher(lambda queries, projects: [q.upper() for q in queries], window_ms=200, max_batch=8,
                           metrics=m)
    results: dict[str, str] = {}
    traces: dict[str, int] = {}

    def request(query):
        with obs.bind_trace() as bound:
            traces[query] = bound.trace
            results[query] = batcher.submit(query)

    with obs.collect_spans() as spans:
        threads = [threading.Thread(target=request, args=(q,)) for q in ("a", "b")]
        threads[0].start()
        time.sleep(0.02)  # the first is the leader; the second joins its window
        threads[1].start()
        for t in threads:
            t.join(10)
    assert not any(t.is_alive() for t in threads) and results == {"a": "A", "b": "B"}
    assert batcher.batches_run == 1
    (run,) = [s for s in spans if s.name == "batcher.run"]
    waits = {s.trace: s for s in spans if s.name == "batcher.wait"}
    assert set(waits) == set(traces.values()) and sorted(run.args["requests"]) == sorted(traces.values())
    assert all(w.args == {"batch": run.trace} and w.end_ns <= run.start_ns for w in waits.values())
    assert run.parent == 0 and run.trace not in traces.values()
    assert waits[traces["a"]].end_ns - waits[traces["a"]].start_ns >= 150e6  # the leader waits out the window
    assert m.snapshot()["latency_s"]["search.queue_wait"]["count"] == 2
