"""The whole step, decoder: the sliced wave's useful operations
(``portbench/bounds_moe.py``: its prompts and answers, 2 × the matrix weights
a real token passes, the head a sampled token, causal attention) at the bf16
peak, over the slice's wall time, in percent. Retrieval counts none."""

from portbench import bounds_moe
from portbench.bounds import PEAK
from portbench.metrics_dsv2 import sliced


def read(run):
    rec = sliced(run)
    if rec is None or run.trace is None or run.trace.window_s <= 0:
        return None
    flops = bounds_moe.decoder_flops(run.config, rec["prompt_lens"], rec["answer_lens"])
    return 100.0 * flops / PEAK["bf16"] / run.trace.window_s
