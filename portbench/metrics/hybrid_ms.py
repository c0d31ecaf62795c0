"""Hybrid engine: mean ms a batch of HybridEngine.search, ended by a
synchronise (harness span)."""


def read(run):
    spans = run.spans.get("hybrid")
    return 1000.0 * sum(spans) / len(spans) if spans else None
