"""The ``query`` cell at test widths for CPU runs of the whole harness: the
decoder's structure (MLA, a dense layer then expert layers with shared
experts, YaRN) at a tiny size in float32 (so that the program reads far
below every limit and a fault or the control far above), the flat
retrieval stack at ``tiny.py``'s widths, short waves, under the cell's own
limits."""

from __future__ import annotations

import copy
import json

from portbench import manifest

CELL = "dsv2lite-rag.wave64"


def tiny_query_spec() -> dict:
    cell = manifest.cell(manifest.load(), CELL)
    config = copy.deepcopy(cell["config"])
    config.update(hidden_size=64, num_hidden_layers=3, num_attention_heads=4, num_key_value_heads=4, kv_lora_rank=32,
                  qk_nope_head_dim=32, qk_rope_head_dim=16, v_head_dim=32, intermediate_size=128,
                  moe_intermediate_size=48, n_routed_experts=8, num_experts_per_tok=3, vocab_size=512,
                  cache_positions=512, slots=4, seg_len=4, dtype="float32")
    config["rope_scaling"].update(factor=4, original_max_position_embeddings=32)
    config["prompt"].update(template_tokens=8, context_tokens=64, chunk_min_chars=20, chunk_max_chars=120,
                            question_tokens_max=16, warm_buckets=[64, 128])
    config["checks"]["layers"] = [0, 1, 2]
    retrieval = config["retrieval"]
    retrieval["model"].update(hidden_size=64, num_hidden_layers=2, num_attention_heads=4, intermediate_size=128,
                              vocab_size=1024, max_position_embeddings=130)
    retrieval["corpus"].update(rows=16384, dim=64)
    retrieval["bm25"].update(vocab=3000, terms_per_chunk=16, p_max=64)
    traffic = copy.deepcopy(cell["traffic"])
    traffic.update(batch=8, batches=2, check_streams=4, check_from=2, check_batches=1, warm_batches=1,
                   trace_seconds=0.3, device_slice_seconds=0.3)
    traffic["answers"].update(median=6, min=2, max=12)
    return dict(cell, config=config, traffic=traffic, limits=json.loads(json.dumps(cell["limits"])))
