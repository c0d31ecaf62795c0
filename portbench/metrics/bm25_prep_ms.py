"""Hybrid engine: ms a batch of the program's ``bm25.prep`` spans
(``BM25Index.topk_plan``: query terms, the hot-first reorder, the copies of
the term arrays to the card) in the traced slice, on the device trace's
clock."""

from portbench.spans import per_batch_ms


def read(run):
    return per_batch_ms(run.trace, "bm25.prep")
