"""Query encoder: mean ms a batch of the provider call that
PageLevelRetriever._embed makes, ended by a synchronise (harness span)."""


def read(run):
    spans = run.spans.get("encode")
    return 1000.0 * sum(spans) / len(spans) if spans else None
