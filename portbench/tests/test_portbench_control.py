"""The control (the reference one precision down, put in the program's
place) must come out as not correct under each cell's limits; here on tiny
cells on the CPU. Its full-size readings, on the card, come from
``portbench/calibrate.py``."""

from __future__ import annotations

import pytest

from portbench import harness, judge, manifest
from portbench.tests.tiny import tiny_spec


@pytest.mark.parametrize("kind,seed", [("flat", 41), ("flat", 42), ("bits", 43)])
def test_control_is_not_correct(kind, seed):
    spec = tiny_spec(kind)
    result, _ = harness.run_cell("tiny", seed, 0.5, False, device="cpu", spec=spec, control=True)
    control = result["control"]
    assert set(control) == set(result["checks"])
    assert any(c["value"] > c["limit"] for c in control.values()), control


def test_every_cell_has_a_limit_for_each_number_it_compares():
    man = manifest.load()
    for w in man["workloads"]:
        spec = manifest.cell(man, w["name"])
        limits = spec["limits"]
        want = {"emb_dist", "dense_err", "dense_miss", "bm25_err", "bm25_miss", "fused_gap"}
        if spec["config"]["port_config"]["INDEX_KIND"] == "bits":
            want |= {"probe_gap", "placement"}
        assert set(limits) == want and set(limits) <= set(judge.NUMBERS)
        assert all(v > 0 for k, v in limits.items() if k != "placement") and limits.get("placement", 0) == 0
