"""Query encoder: ms a batch of the program's ``embed.forward`` spans (the
host's time to enqueue the encoder, input copies included) in the traced
slice, on the device trace's clock."""

from portbench.spans import per_batch_ms


def read(run):
    return per_batch_ms(run.trace, "embed.forward")
