"""The ``query`` system (``portbench/systems/query.py``) on a tiny cell on
the CPU: a run is correct, its control is not, each fault of the decoder
fails a check, and the cell's readers read None where there is nothing to
read."""

from __future__ import annotations

import dataclasses
from collections import Counter

import pytest
import torch

from portbench import generate, harness, manifest
from portbench.tests.tiny_query import CELL, tiny_query_spec

READERS = ("prefill_us_per_query.dsv2", "decode_us_per_query.dsv2", "mla_us_per_query.dsv2",
           "moe_us_per_query.dsv2", "moe_roofline.dsv2", "step_mfu.dsv2", "slot_occupancy.dsv2",
           "prefill_token_use.dsv2", "device_idle_share.dsv2", "retrieve_us_per_query.dsv2")


@pytest.fixture(scope="module")
def traced():
    return harness.run_cell("tiny", 3_000_000_211, 0.3, True, device="cpu", spec=tiny_query_spec(), control=True)


def test_a_tiny_run_is_correct_and_its_control_is_not(traced):
    result, run = traced
    assert result["correct"] is True and result["attempted"] == run.queries > 0
    checks, control = result["checks"], result["control"]
    assert list(checks) == ["prompt_exact", "logit_err", "route_miss", "cache_err"] == list(control)
    assert checks["prompt_exact"]["value"] == 0 and checks["logit_err"]["value"] < 1e-4
    assert any(c["value"] > c["limit"] for c in control.values()), control


def test_a_traced_run_reads_the_counters_and_no_device_time_on_the_cpu(traced):
    result, run = traced
    metrics = result["metrics"]
    assert {"slot_occupancy.dsv2", "prefill_token_use.dsv2", "step_mfu.dsv2"} <= set(metrics)
    assert 0 < metrics["slot_occupancy.dsv2"]["value"] <= 100 and 0 < metrics["prefill_token_use.dsv2"]["value"] <= 100
    for name in ("prefill_us_per_query.dsv2", "decode_us_per_query.dsv2", "mla_us_per_query.dsv2",
                 "moe_us_per_query.dsv2", "moe_roofline.dsv2", "retrieve_us_per_query.dsv2"):
        assert name not in metrics  # no device operation on the CPU: nothing to read
    rec = run.dsv2
    assert rec["waves"] >= 1 and len(rec["prompt_lens"]) == len(rec["answer_lens"]) == 8 * rec["waves"]
    assert rec["counters"]["moe.calls"] > 0 and rec["counters"]["llm.decode_tokens"] > 0
    spans = {name for name, _, _ in run.trace.ranges}
    assert {"llm.refill", "llm.decode", "mla.attend", "moe.route", "moe.experts", "moe.shared",
            "portbench.retrieve"} <= spans
    # the expert counters count real tokens' pairs: the prompts' and the fed answer tokens'
    c, k, layers = rec["counters"], run.config["num_experts_per_tok"], run.config["num_hidden_layers"] - 1
    assert c["moe.decode_assignments"] == k * layers * c["llm.decode_tokens"]
    assert c["moe.assignments"] - c["moe.decode_assignments"] == k * layers * sum(rec["prompt_lens"])


def _top_k_less(system):
    for layer in system.model.layers:
        if hasattr(layer.mlp, "route"):
            layer.mlp.cfg = dataclasses.replace(layer.mlp.cfg, num_experts_per_tok=layer.mlp.cfg.num_experts_per_tok - 1)


def _no_mscale(system):
    for layer in system.model.layers:
        layer.attn.scale = layer.attn.cfg.q_head_dim ** -0.5


def _no_shared(system):
    for layer in system.model.layers:
        if hasattr(layer.mlp, "shared"):
            layer.mlp.shared = None


def _latent_norm_scaled(system):
    """The latent's RMSNorm scale four times too large: every cache entry's
    ``c`` (prefill and the fused one-token step read the same weight)."""
    with torch.no_grad():
        for layer in system.model.layers:
            layer.attn.kv_norm.weight.mul_(4)


@pytest.mark.parametrize("fault,check", [(_top_k_less, "route_miss"), (_no_mscale, "logit_err"),
                                         (_no_shared, "logit_err"), (_latent_norm_scaled, "cache_err")],
                         ids=["top_k_less", "no_mscale", "no_shared", "latent_norm_scaled"])
def test_each_fault_fails_a_check(fault, check):
    result, _ = harness.run_cell("tiny", 3_000_000_223, 0.0, False, device="cpu", spec=tiny_query_spec(),
                                 faults=fault)
    assert result["correct"] is False
    assert result["checks"][check]["value"] > result["checks"][check]["limit"], result["checks"]


def test_readers_read_none_without_a_trace_or_a_sliced_wave(monkeypatch):
    from intool_rag_tpu_torch import observability

    monkeypatch.setattr(observability, "_metrics", observability.Metrics())
    spec = tiny_query_spec()
    run = harness.Run("tiny", spec, {"batches": []})
    for name in READERS:
        assert manifest.reader(name)(run) is None, name
    run.dsv2 = {"waves": 0}
    assert all(manifest.reader(name)(run) is None for name in READERS)


def test_every_wave_holds_the_same_answers_in_one_drawn_order():
    """The answer lengths are the traffic's quantiles in the order its
    ``order_seed`` draws, the same in every wave and every run, and not
    sorted by length (no client knows it)."""
    spec = tiny_query_spec()
    module = manifest.system(spec["config"])
    full = manifest.cell(manifest.load(), CELL)
    plans = [module.plan(full["config"], full["traffic"], seed)["batches"] for seed in (3_000_000_227, 11)]
    waves = plans[0]
    assert len(waves) == 8 and all(len(w) == 64 for w in waves)
    budgets = [[a for _, a in w] for plan in plans for w in plan]
    assert all(b == budgets[0] for b in budgets) and plans[0][0][0][0] != plans[1][0][0][0]
    assert Counter(budgets[0]) == Counter(generate.length_quantiles(full["traffic"]["answers"], 64).tolist())
    assert budgets[0] != sorted(budgets[0], reverse=True) and budgets[0].index(512) >= 32  # a refill
    streams = module.checked_streams(full["traffic"], full["config"]["slots"], 3_000_000_227)
    assert len(streams) == 8 and sum(s < 32 for s in streams) == 4


def test_the_cell_reports_its_metrics():
    spec = manifest.cell(manifest.load(), CELL)
    assert {m["name"] for m in spec["end_to_end"]} == {"device_us_per_query", "setup_s"}
    assert {m["name"] for m in spec["per_layer"]} == set(READERS)
    assert spec["config"]["reduced"] == [] and spec["entry"]["chips"] == 1
    assert set(spec["limits"]) == {"prompt_exact", "logit_err", "route_miss", "cache_err"}
