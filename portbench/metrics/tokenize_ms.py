"""Query encoder: ms a batch of the program's ``embed.tokenize`` spans
(``CudaEmbeddingProvider``: the tokenizer and the numpy padding to the
bucket) in the traced slice, on the device trace's clock."""

from portbench.spans import per_batch_ms


def read(run):
    return per_batch_ms(run.trace, "embed.tokenize")
