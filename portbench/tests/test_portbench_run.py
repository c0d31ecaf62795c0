"""Whole runs of a tiny cell on the CPU: the result line's keys, the traced
run's device fields, and the import check."""

from __future__ import annotations

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import harness
from portbench.tests.tiny import tiny_spec

BENCH = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def closed_runs():
    return {trace: harness.run_cell("tiny", 3_000_000_021, 1.5, trace, device="cpu", spec=tiny_spec("flat"))
            for trace in (False, True)}


def test_result_line_keys(closed_runs):
    result, _ = closed_runs[False]
    line = json.loads(json.dumps(result))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(line["metrics"]) == {"search_qps", "setup_s"}
    assert all(set(m) == {"value", "unit"} for m in line["metrics"].values())
    assert set(line["checks"]) == {"emb_dist", "dense_err", "dense_miss", "bm25_err", "bm25_miss", "fused_gap"}
    assert all(set(c) == {"value", "limit"} for c in line["checks"].values())
    assert line["attempted"] > 0 and line["failed"] == 0


def test_traced_run_reports_per_layer_metrics_and_the_slice(closed_runs):
    result, run = closed_runs[True]
    line = json.loads(json.dumps(result))
    assert {"encode_ms", "hybrid_ms", "step_mfu", "device_idle_share"} <= set(line["metrics"])
    assert "search_qps" not in line["metrics"]
    assert line["device"]["window_s"] > 0 and "busy_s" in line["device"]
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert len(run.spans["encode"]) == run.batches


def test_capacity_tier_run_checks_its_probes_and_placement():
    result, run = harness.run_cell("tiny", 3_000_000_023, 1.0, True, device="cpu", spec=tiny_spec("bits"))
    assert {"probe_gap", "placement", "dense_miss"} <= set(result["checks"])
    assert result["checks"]["placement"]["value"] == 0.0 and result["checks"]["probe_gap"]["value"] < 1e-6
    assert run.tier is not None and run.scans
    assert {"step_mfu.bits", "encode_ms.bits", "hybrid_ms.bits", "search_qps.bits"} <= set(result["metrics"])
    assert "k3_roofline" not in result["metrics"]  # no K3 kernel ran on the CPU: the reader finds nothing


def test_untraced_run_takes_a_device_slice_only_for_a_device_metric(closed_runs):
    _, flat = closed_runs[False]
    assert flat.trace is None and flat.slice_queries == 0  # the flat cell's end-to-end metrics are host-clocked
    result, run = harness.run_cell("tiny", 3_000_000_025, 1.0, False, device="cpu", spec=tiny_spec("bits"))
    assert run.trace is not None and run.slice_queries > 0
    assert set(result["device"]) == {"platform", "kind", "count", "memory_peak_bytes"} and "breakdown" not in result
    assert "search_qps" not in result["metrics"] and "setup_s" in result["metrics"]
    assert "device_us_per_query" not in result["metrics"]  # no device operation on the CPU: nothing to read


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "intool_rag_tpu_torch_fake", object())
    assert "intool_rag_tpu" not in harness.forbidden_modules() or "intool_rag_tpu" in sys.modules
    monkeypatch.setitem(sys.modules, "jaxlib.fake", object())
    assert "jaxlib" in harness.forbidden_modules()


def test_a_run_loads_no_jax_nor_the_jax_package():
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from portbench import env; env.prepare()\n"
        "from portbench import harness\n"
        "from portbench.tests.tiny import tiny_spec\n"
        "harness.run_cell('tiny', 5, 0.5, False, device='cpu', spec=tiny_spec('bits'))\n"
        "print('FORBIDDEN', harness.forbidden_modules())\n" % str(BENCH.parent))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600)
    assert "FORBIDDEN []" in out.stdout, out.stderr[-2000:]


def _imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_sources_import_no_jax_and_the_reference_none_of_the_port():
    for path in BENCH.rglob("*.py"):
        assert not _imports(path) & {"jax", "jaxlib", "flax", "intool_rag_tpu"}, path
    for path in (BENCH / "reference").glob("*.py"):
        assert "intool_rag_tpu_torch" not in _imports(path), path
