"""The whole batch: the time its useful arithmetic would take at the
published peaks, over the batch's wall time, in percent. The encoder's
operations count real tokens only (portbench/bounds.py), at the bf16 peak;
the dense kernel's at the peak of its type (K2: three int8 products over the
valid rows; K3: the traced scans' slots in blocks that hold rows, at the bf16
peak). BM25, fusion and the host refine count none."""

from portbench import bounds
from portbench.metrics_util import scanned_blocks
from portbench.reference.text import token_ids


def read(run):
    if not run.batches or run.window_s <= 0:
        return None
    model, port = run.model, run.config["port_config"]
    prefix = port["EMBEDDING_QUERY_INSTRUCTION"]
    max_len = min(model["max_position_embeddings"] - 2, 8192)
    enc = 0.0
    for b, times in run.batch_counts.items():
        lens = [len(token_ids(prefix + t, model["vocab_size"], max_len)) for t in run.plan["batches"][b]]
        enc += times * bounds.encoder_flops(model, lens)
    at_peak = enc / run.batches / bounds.PEAK["bf16"]
    spec = run.config["corpus"]
    if port["INDEX_KIND"] == "flat":
        at_peak += 3 * 2.0 * run.traffic["batch"] * spec["rows"] * spec["dim"] / bounds.PEAK["int8"]
    elif run.scans and run.tier is not None:
        traced = run.trace.range_count("portbench.hybrid") if run.trace is not None else 0
        if not traced:
            return None
        ops = sum(2.0 * 8 * s["d"] * scanned_blocks(s, run.tier).numel() * s["block_n"] for s in run.scans)
        at_peak += ops / traced / bounds.PEAK["bf16"]
    return 100.0 * at_peak / (run.window_s / run.batches)
