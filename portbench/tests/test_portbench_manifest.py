"""BENCHMARK.json against the benchmark's contract, and every name in it
resolving to its file."""

from __future__ import annotations

import json
import re

import pytest

from portbench import manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


@pytest.fixture(scope="module")
def man():
    return manifest.load()


def test_top_level_keys_and_size(man):
    assert set(man) == KEYS
    assert manifest.MANIFEST.stat().st_size <= 64 * 1024
    assert man["command"] == ["python3", "portbench/run.py"]
    assert man["paths"] == ["portbench"]
    assert 1 <= man["run_seconds"] <= 51 and isinstance(man["run_seconds"], int)


def test_names_units_and_one_line_fields(man):
    names = [m["name"] for m in man["end_to_end"] + man["per_layer"]]
    for group in (names, [w["name"] for w in man["workloads"]], [c["name"] for c in man["configs"]]):
        assert len(group) == len(set(group))
        assert all(NAME.match(n) for n in group)
    for m in man["end_to_end"] + man["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for text in [w["why"] for w in man["workloads"]] + [c["why"] for c in man["configs"]] + \
            [m["layer"] for m in man["per_layer"]]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_entries_have_only_contract_keys(man):
    for c in man["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in man["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
    for m in man["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in man["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


@pytest.mark.parametrize("kind", ["config", "traffic", "limits", "reader"])
def test_every_name_resolves_to_its_file(man, kind):
    if kind == "config":
        for c in man["configs"]:
            cfg = json.loads((manifest.REPO / c["file"]).read_text())
            assert c["file"].startswith("portbench/configs/")
            assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
            assert cfg["reduced"] == c["reduced"] and all(k in cfg for k in c["reduced"])
    elif kind == "traffic":
        assert all(manifest.traffic_path(w["traffic"]).is_file() for w in man["workloads"])
    elif kind == "limits":
        assert all(manifest.limits_path(w["name"]).is_file() for w in man["workloads"])
    else:
        for m in man["end_to_end"] + man["per_layer"]:
            assert callable(manifest.reader(m["name"]))


def test_each_cell_reports_setup_another_end_to_end_and_a_layer(man):
    for w in man["workloads"]:
        spec = manifest.cell(man, w["name"])
        e2e = {m["name"] for m in spec["end_to_end"]}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert spec["per_layer"]


def test_per_layer_metrics_move_an_end_to_end_metric_of_their_cells(man):
    e2e = {m["name"]: m for m in man["end_to_end"]}
    for m in man["per_layer"]:
        moved = e2e[m["moves"]]
        for cell in m.get("workloads", [w["name"] for w in man["workloads"]]):
            assert manifest.applies(moved, cell), (m["name"], cell)
    assert {m["layer"] for m in man["per_layer"]} <= {
        "service", "batcher", "retriever + registry", "query encoder", "hybrid engine", "kernels", "device",
        "the whole step"}


def test_configurations_are_used_and_four_chip_cells_are_few(man):
    used = {w["config"] for w in man["workloads"]}
    assert used == {c["name"] for c in man["configs"]}
    assert sum(w["chips"] == 4 for w in man["workloads"]) <= max(1, len(man["workloads"]) // 4)
