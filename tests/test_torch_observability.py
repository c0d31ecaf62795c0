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
unless the CPU was asked for."""

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
        {"query.retrieve": 2, "search": 1, "agent.query": 1}
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
