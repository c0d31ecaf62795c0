"""Decoder scheduler: the tokens the live streams kept over the slots of
every decode step (program counters ``llm.decode_tokens`` / ``llm.slot_steps``
over the process), in percent."""

from portbench.spans import counter_share


def read(run):
    return counter_share("llm.decode_tokens", "llm.slot_steps")
