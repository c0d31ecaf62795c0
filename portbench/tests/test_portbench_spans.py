"""The readers of the program's spans and counters on a hand-made trace:
per-batch sums, self time, launches matched to spans by time, and None
where the program records no such span or counter."""

from __future__ import annotations

import math

import pytest

from portbench import manifest
from portbench.spans import counter_share, launches_within, per_batch_ms, self_share
from portbench.trace import Trace


def _x(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "args": dict(args)}


def _batch(t0):
    """One batch at ``t0`` µs: the harness's two ranges, the program's spans
    inside them, and kernel launch calls (one outside any forward span)."""
    return [
        _x("user_annotation", "portbench.encode", t0, 1000),
        _x("user_annotation", "retrieve.embed", t0 + 10, 980),
        _x("user_annotation", "embed.tokenize", t0 + 20, 300, span=1, parent=0, trace=1),
        _x("user_annotation", "embed.forward", t0 + 330, 400),
        _x("cuda_runtime", "cudaLaunchKernel", t0 + 340, 2),
        _x("cuda_driver", "cuLaunchKernelEx", t0 + 700, 2),
        _x("cuda_runtime", "cudaMemcpyAsync", t0 + 720, 2),
        _x("user_annotation", "embed.readback", t0 + 740, 200),
        _x("cuda_runtime", "cudaLaunchKernel", t0 + 950, 2),  # in retrieve.embed, in no forward span
        _x("user_annotation", "portbench.hybrid", t0 + 1000, 500),
        _x("user_annotation", "hybrid.search", t0 + 1000, 490),
        _x("user_annotation", "bm25.prep", t0 + 1100, 50),
        _x("user_annotation", "bits.refine", t0 + 1200, 250),
        _x("kernel", "nvjet", t0 + 400, 300),
    ]


EVENTS = _batch(0) + _batch(2000)


def test_per_batch_sums_and_none_without_the_span():
    t = Trace(EVENTS, window_s=4e-3)
    assert math.isclose(per_batch_ms(t, "embed.tokenize"), 0.3)
    assert math.isclose(per_batch_ms(t, "embed.forward"), 0.4)
    assert math.isclose(per_batch_ms(t, "embed.readback"), 0.2)
    assert math.isclose(per_batch_ms(t, "bm25.prep"), 0.05)
    assert math.isclose(per_batch_ms(t, "bits.refine"), 0.25)
    assert per_batch_ms(t, "absent.span") is None and per_batch_ms(None, "embed.tokenize") is None
    no_batches = Trace([e for e in EVENTS if e["name"] != "portbench.hybrid"], window_s=4e-3)
    assert per_batch_ms(no_batches, "embed.tokenize") is None


def test_self_share_counts_time_no_inner_range_covers():
    t = Trace(EVENTS, window_s=4e-3)
    # retrieve.embed 980 µs; tokenize 300 + forward 400 + readback 200 inside it
    assert math.isclose(self_share(t, "retrieve.embed"), 100.0 * 80 / 980)
    assert math.isclose(self_share(t, "hybrid.search"), 100.0 * 190 / 490)
    assert self_share(t, "absent.span") is None


def test_launches_inside_forward_spans_by_time():
    t = Trace(EVENTS, window_s=4e-3)
    assert launches_within(t, "portbench.encode", "embed.forward") == (6, 4)  # cudaMemcpyAsync is no launch
    assert launches_within(t, "portbench.hybrid", "embed.forward") == (0, 0)


@pytest.mark.parametrize("name, want", [
    ("tokenize_ms", 0.3), ("encoder_launch_ms", 0.4), ("encoder_wait_ms", 0.2), ("bm25_prep_ms", 0.05),
    ("tokenize_ms.bits", 0.3), ("encoder_launch_ms.bits", 0.4), ("encoder_wait_ms.bits", 0.2),
    ("bm25_prep_ms.bits", 0.05), ("refine_ms.bits", 0.25),
])
def test_span_readers(name, want):
    class Run:
        trace = Trace(EVENTS, window_s=4e-3)

    assert math.isclose(manifest.reader(name)(Run()), want)
    Run.trace = Trace([e for e in EVENTS if e["cat"] != "user_annotation" or e["name"].startswith("portbench.")],
                      window_s=4e-3)
    assert manifest.reader(name)(Run()) is None  # a program without spans: nothing to read


@pytest.mark.parametrize("name", ["encoder_token_use", "encoder_token_use.bits"])
def test_token_use_reads_the_process_counters(monkeypatch, name):
    from intool_rag_tpu_torch import observability

    counters = observability.Metrics()
    monkeypatch.setattr(observability, "get_metrics", lambda: counters)
    assert manifest.reader(name)(None) is None
    counters.inc_many({"embed.tokens": 300, "embed.slots": 1024})
    assert math.isclose(manifest.reader(name)(None), 100.0 * 300 / 1024)
    assert math.isclose(counter_share("embed.tokens", "embed.slots"), 100.0 * 300 / 1024)


def test_every_new_metric_reads_in_its_one_cell():
    names = {"tokenize_ms", "encoder_launch_ms", "encoder_wait_ms", "encoder_token_use", "bm25_prep_ms"}
    names = names | {n + ".bits" for n in names} | {"refine_ms.bits"}
    metrics = {m["name"]: m for m in manifest.load()["per_layer"]}
    for name in names:
        cell = "bits-10m.batch256" if name.endswith(".bits") else "flat-int8r-1m.batch256"
        assert metrics[name]["workloads"] == [cell] and manifest.reader_path(name).exists()
        assert name in {m["name"] for m in manifest.cell(manifest.load(), cell)["per_layer"]}
