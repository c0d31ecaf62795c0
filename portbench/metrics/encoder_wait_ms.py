"""Query encoder: ms a batch of the program's ``embed.readback`` spans (each
micro-batch's copy to the host: the host blocked on the card, then the copy)
in the traced slice, on the device trace's clock."""

from portbench.spans import per_batch_ms


def read(run):
    return per_batch_ms(run.trace, "embed.readback")
