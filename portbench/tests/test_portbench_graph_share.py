"""The query encoder's graph share: the program's replay counter over its
micro-batches, and nothing from a program that records no replay."""

from __future__ import annotations

import math

import pytest

from portbench import manifest


@pytest.mark.parametrize("name", ["encoder_graph_share", "encoder_graph_share.bits"])
def test_graph_share_reads_the_process_counters(monkeypatch, name):
    from intool_rag_tpu_torch import observability

    counters = observability.Metrics()
    monkeypatch.setattr(observability, "get_metrics", lambda: counters)
    assert manifest.reader(name)(None) is None
    counters.inc_many({"embed.micro_batches": 200, "embed.graph_captures": 2})
    assert manifest.reader(name)(None) is None  # no replay counted: a program without the graphs
    counters.inc_many({"embed.graph_replays": 196})
    assert math.isclose(manifest.reader(name)(None), 100.0 * 196 / 200)


def test_graph_share_reads_in_its_one_cell():
    metrics = {m["name"]: m for m in manifest.load()["per_layer"]}
    for name, cell in (("encoder_graph_share", "flat-int8r-1m.batch256"),
                       ("encoder_graph_share.bits", "bits-10m.batch256")):
        assert metrics[name]["workloads"] == [cell] and metrics[name]["layer"] == "query encoder"
        assert name in {m["name"] for m in manifest.cell(manifest.load(), cell)["per_layer"]}
