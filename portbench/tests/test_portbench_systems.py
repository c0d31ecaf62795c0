"""A kind of system comes in as files of its own: a toy system module (a
seeded matrix product, its plain reference and a fault), written into a
temporary directory that the resolver is pointed at, runs through the
unchanged harness and readers on the CPU."""

from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from portbench import data, harness, manifest

BENCH = Path(__file__).resolve().parents[1]

TOY = textwrap.dedent('''
    """A toy system: ``x @ w`` over pre-drawn blocks of rows, in float32;
    its reference takes the product in float64."""

    import time

    import torch


    def plan(config, traffic, seed):
        g = torch.Generator().manual_seed(seed)
        return {"batches": [torch.randn((traffic["batch"], config["dim"]), generator=g)
                            for _ in range(traffic["batches"])]}


    def _weights(config, seed, dtype):
        g = torch.Generator().manual_seed(seed + 1)
        return torch.randn((config["dim"], config["dim"]), generator=g).to(dtype)


    def build(config, seed, device, tmp):
        return Toy(config, seed)


    class Toy:
        def __init__(self, config, seed):
            t0 = time.perf_counter()
            self.w = _weights(config, seed, torch.float32)
            self.product = torch.matmul
            self.spans = {"product": []}
            self.out = {}
            self.timings = {"weights": time.perf_counter() - t0}

        def install(self, run, tracing):
            self.batches = run.plan["batches"]

        def warm(self, count):
            for x in self.batches[:count]:
                self.product(x, self.w)

        def step(self, b, trace, grab):
            s = time.perf_counter()
            y = self.product(self.batches[b], self.w)
            time.sleep(0.002)
            seconds = time.perf_counter() - s
            if trace:
                self.spans["product"].append(seconds)
            if grab:
                self.out[b] = (self.batches[b], y)
            return y.shape[0], {"product": seconds}

        def collect(self, run):
            return [{"x": x, "y": y} for _, (x, y) in sorted(self.out.items())]

        def close(self):
            self.w = self.out = None


    class Reference:
        def __init__(self, config, seed):
            self.w = _weights(config, seed, torch.float64)

        def numbers(self, side):
            return {"max_err": float((side["y"].double() - side["x"].double() @ self.w).abs().max())}

        def control_side(self, side):
            return {"x": side["x"], "y": side["x"].bfloat16() @ self.w.bfloat16()}


    def reference(config, seed, device, run):
        return Reference(config, seed)
''')

OTHER = 'raise ImportError("a run imported a system module that its cell does not name")\n'


def _spec(system: str = "toy") -> dict:
    e2e = {m["name"]: m for m in manifest.load()["end_to_end"]}
    return {"entry": {"name": "toy.batch16", "chips": 1},
            "config": {"name": "toy", "system": system, "dim": 64},
            "traffic": {"loop": "closed", "batch": 16, "batches": 4, "check_batches": 2, "check_from": 4,
                        "warm_batches": 2, "trace_seconds": 0.2, "device_slice_seconds": 0.2},
            "limits": {"max_err": 1e-4},
            "end_to_end": [e2e[n] for n in ("search_qps", "device_us_per_query", "setup_s")],
            "per_layer": []}


@pytest.fixture
def systems(tmp_path, monkeypatch):
    (tmp_path / "toy.py").write_text(TOY)
    (tmp_path / "other.py").write_text(OTHER)
    monkeypatch.setattr(manifest, "SYSTEMS", tmp_path)
    return tmp_path


def _half_rows(system):
    """Half of the block left out: the second half of each product's rows is
    zero."""
    product = system.product

    def half(x, w):
        y = product(x, w)
        y[y.shape[0] // 2:] = 0
        return y

    system.product = half


def test_a_new_kind_runs_through_the_unchanged_harness(systems):
    result, run = harness.run_cell("toy.batch16", 3_000_000_041, 0.3, False, device="cpu", spec=_spec(),
                                   control=True)
    line = json.loads(json.dumps(result))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"] and list(line)[-1] == "checks"
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert line["correct"] is True and line["attempted"] == run.queries > 0 and line["failed"] == 0
    assert line["checks"]["max_err"]["value"] < 1e-4 and line["control"]["max_err"]["value"] > 1e-4
    # the unchanged readers: a rate and the set-up on the host clock; no device operation on the CPU
    assert set(line["metrics"]) == {"search_qps", "setup_s"}
    assert line["metrics"]["search_qps"]["value"] == run.queries / run.window_s
    assert line["metrics"]["setup_s"]["value"] == run.setup_s > 0
    assert run.trace is not None and run.slice_queries > 0
    assert manifest.reader("device_us_per_query")(run) is None


def test_a_new_kinds_fault_is_not_correct(systems):
    result, _ = harness.run_cell("toy.batch16", 3_000_000_043, 0.3, False, device="cpu", spec=_spec(),
                                 faults=_half_rows)
    assert result["correct"] is False and result["checks"]["max_err"]["value"] > 1e-4


def test_a_window_ends_only_once_its_checked_batches_and_a_sliced_step_have_run(systems):
    """A host too slow for its window (here a window of no length) runs on
    until every checked batch has run and the device slice holds a step."""
    seed, spec = 3_000_000_047, _spec()
    result, run = harness.run_cell("toy.batch16", seed, 0.0, False, device="cpu", spec=spec)
    checked = harness.check_batches(spec["traffic"], data.host_rng(seed, data.SAMPLE)).tolist()
    assert result["correct"] is True and set(result["checks"]) == {"max_err"}
    assert set(checked) <= set(run.batch_counts) and run.slice_queries > 0 and run.trace is not None


@pytest.mark.parametrize("name", ["nope", "../search", "search/x"])
def test_an_unknown_system_fails_before_set_up(systems, name):
    built = []
    with pytest.raises(ValueError, match="names the system") as err:
        harness.run_cell("toy.batch16", 5, 0.3, False, device="cpu", spec=_spec(name), faults=built.append)
    assert name in str(err.value) and "toy" in str(err.value) and not built


def test_every_configuration_resolves_to_its_module():
    man = manifest.load()
    for c in man["configs"]:
        config = json.loads((manifest.REPO / c["file"]).read_text())
        name = config.get("system", manifest.DEFAULT_SYSTEM)
        assert manifest.system_path(name).is_file(), (c["name"], name)
        module = manifest.system(config)
        assert all(callable(getattr(module, f, None)) for f in ("plan", "build", "reference")), name


def test_a_run_imports_only_its_own_cells_system_module(systems):
    code = textwrap.dedent(f"""
        import json, sys
        from pathlib import Path
        sys.path.insert(0, {str(BENCH.parent)!r})
        from portbench import env; env.prepare()
        from portbench import harness, manifest
        manifest.SYSTEMS = Path({str(systems)!r})
        from portbench.tests.test_portbench_systems import _spec
        result, _ = harness.run_cell("toy.batch16", 7, 0.3, False, device="cpu", spec=_spec())
        print("LOADED", json.dumps(sorted(m for m in sys.modules
                                          if m.startswith("portbench_system_") or m == "portbench.system")))
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600)
    assert 'LOADED ["portbench_system_toy"]' in out.stdout, out.stderr[-2000:]


def test_a_search_run_puts_back_the_environment_and_the_functions_it_wrapped(monkeypatch):
    """Runs in one process share nothing through the port's settings or the
    capture wrappers: each run sets and wraps, then puts them back."""
    import intool_rag_tpu_torch.index.bits_index as bits_index
    import intool_rag_tpu_torch.index.hybrid as hybrid

    from portbench.tests.tiny import tiny_spec

    monkeypatch.setenv("INDEX_KIND", "before")
    monkeypatch.delenv("IVF_NLIST", raising=False)
    wrapped = (hybrid._fuse, bits_index.ivf_bits_topk, bits_index.tile_probes)
    result, _ = harness.run_cell("tiny", 3_000_000_049, 0.0, False, device="cpu", spec=tiny_spec("bits"))
    assert result["correct"] is True
    assert os.environ["INDEX_KIND"] == "before" and "IVF_NLIST" not in os.environ
    assert (hybrid._fuse, bits_index.ivf_bits_topk, bits_index.tile_probes) == wrapped
