"""Query encoder: the real tokens over the slots of the padded (batch,
sequence) buckets the encoder ran, from the program's counters
``embed.tokens`` and ``embed.slots`` over the process, in percent."""

from portbench.spans import counter_share


def read(run):
    return counter_share("embed.tokens", "embed.slots")
