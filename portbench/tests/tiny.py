"""Tiny cells for CPU runs of the whole harness: the structure of each
configuration at test widths."""

from __future__ import annotations

import copy
import json

from portbench import manifest

CELLS = {"flat": "flat-int8r-1m.batch256", "bits": "bits-10m.batch256"}


def tiny_spec(kind: str = "flat") -> dict:
    """The ``flat`` or ``bits`` batch cell at test widths, under the cell's
    own limits: 65,536 rows and pools of 10, so that the kernels' grouped
    top-k tails lose about as few rows as at full size. The bits tier keeps
    16 lists of sixteen 1024-slot blocks, probes 4, and refines a pool of
    10, as many as it keeps (as at full size)."""
    cell = manifest.cell(manifest.load(), CELLS[kind])
    config = copy.deepcopy(cell["config"])
    config["model"].update(hidden_size=64, num_hidden_layers=2, num_attention_heads=4, intermediate_size=128,
                           vocab_size=1024, max_position_embeddings=130)
    config["corpus"].update(rows=65536, dim=64)
    config["search"].update(k=5, candidates=10)
    if config["corpus"]["kind"] == "micro_clusters":
        config["corpus"]["topics"] = 16
    config["bm25"].update(vocab=3000, terms_per_chunk=16, p_max=64)
    if kind == "bits":  # under 2^20 documents BM25 chooses its pool on packed keys
        config["port_config"].update(IVF_NLIST="16", IVF_NPROBE="4", IVF_REFINE_K="10")
        config["bm25"]["select_bits"] = 11
    traffic = copy.deepcopy(cell["traffic"])
    traffic.update(batch=32, batches=3, check_batches=2, check_from=3, warm_batches=2, trace_seconds=0.5,
                   device_slice_seconds=0.5)
    limits = json.loads(json.dumps(cell["limits"]))
    return dict(cell, config=config, traffic=traffic, limits=limits)
