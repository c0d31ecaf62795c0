"""Hybrid engine, bits tier: ms a batch of the program's ``bits.refine``
spans (``refine_from_host``: the pool's rows read back, the host gather, the
pageable copy to the card, the exact product and top-k) in the traced slice,
on the device trace's clock."""

from portbench.spans import per_batch_ms


def read(run):
    return per_batch_ms(run.trace, "bits.refine")
