"""Query encoder: the micro-batches that replayed a CUDA graph over all the
encoder ran, from the program's counters ``embed.graph_replays`` and
``embed.micro_batches`` over the process, in percent. None where no
micro-batch replayed, as in a program without the graphs, which records no
``embed.graph_replays``."""

from portbench.spans import counter_share


def read(run):
    from intool_rag_tpu_torch.observability import get_metrics

    if "embed.graph_replays" not in get_metrics().snapshot()["counters"]:
        return None
    return counter_share("embed.graph_replays", "embed.micro_batches")
