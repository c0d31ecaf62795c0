"""Decoder scheduler: the prompts' real tokens over the slots of the padded
prompt buckets their refill groups prefilled (program counters
``llm.prefill_tokens`` / ``llm.prefill_slots`` over the process), in
percent."""

from portbench.spans import counter_share


def read(run):
    return counter_share("llm.prefill_tokens", "llm.prefill_slots")
