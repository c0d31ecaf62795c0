"""Operations and bytes of the ``query`` cells' decoder (DeepSeek-V2), from
the configuration and the program's counters, held against the published
peaks of ``portbench/bounds.py``.

- :func:`experts_bound`: the least time of the routed expert products over
  the counted calls: bytes are each call's touched experts' bf16 weights
  (gate, up, down) read once and its pairs' hidden vectors in and out,
  operations 6 · hidden · width a pair (the three products). Pairs and
  touched experts are the program's counts over real tokens only (bucket
  padding and idle slots, which the products compute all the same, are
  left out), so the bound is the work the requests need. The counters
  sum over calls, so each phase (prefill calls, one-token decode calls) is
  bounded on its sums: ``max(bytes / HBM, operations / peak)`` a phase,
  never more than the sum of each call's own bound, so the share the
  bound gives is never overstated. The same work whatever implements the
  products.
- :func:`decoder_flops`: the useful operations of prompts and answers of
  these lengths: 2 × the matrix weights a token passes (attention's
  projections, the dense or the routed and shared experts' SwiGLU, the
  router), the head once a sampled token, and attention's two products at
  each query's causal length (expanded form: ``heads × (nope + rope + v)``
  a key).
"""

from __future__ import annotations

from .bounds import HBM_BYTES_S, PEAK

BF16 = 2


def expert_bytes(cfg: dict) -> int:
    return 3 * cfg["hidden_size"] * cfg["moe_intermediate_size"] * BF16


def _phase_bound(cfg: dict, assignments: int, touched: int) -> float:
    h, w = cfg["hidden_size"], cfg["moe_intermediate_size"]
    nbytes = touched * expert_bytes(cfg) + assignments * h * BF16 * 2
    flops = 6.0 * h * w * assignments
    return max(nbytes / HBM_BYTES_S, flops / PEAK["bf16"])


def experts_bound(cfg: dict, counters: dict) -> float:
    """Seconds: the prefill calls' bound plus the decode calls' bound."""
    dec_a, dec_t = counters["moe.decode_assignments"], counters["moe.decode_experts_touched"]
    return (_phase_bound(cfg, counters["moe.assignments"] - dec_a, counters["moe.experts_touched"] - dec_t)
            + _phase_bound(cfg, dec_a, dec_t))


def token_weights(cfg: dict) -> int:
    """Matrix weights a token passes through below the head."""
    h, nh, r, dr = cfg["hidden_size"], cfg["num_attention_heads"], cfg["kv_lora_rank"], cfg["qk_rope_head_dim"]
    dn, dv = cfg["qk_nope_head_dim"], cfg["v_head_dim"]
    attn = h * nh * (dn + dr) + h * (r + dr) + r * nh * (dn + dv) + nh * dv * h
    dense = 3 * h * cfg["intermediate_size"]
    moe = h * cfg["n_routed_experts"] + 3 * h * cfg["moe_intermediate_size"] * (
        cfg["num_experts_per_tok"] + (cfg.get("n_shared_experts") or 0))
    n_dense = cfg["first_k_dense_replace"]
    return cfg["num_hidden_layers"] * attn + n_dense * dense + (cfg["num_hidden_layers"] - n_dense) * moe


def decoder_flops(cfg: dict, prompt_lens: list[int], answer_lens: list[int]) -> float:
    """Useful operations of prefilling each prompt and decoding its answer
    (its tokens but the last are fed back), with causal attention."""
    per_key = 2.0 * cfg["num_attention_heads"] * (cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]
                                                  + cfg["v_head_dim"]) * cfg["num_hidden_layers"]
    fed = sum(prompt_lens) + sum(a - 1 for a in answer_lens)
    keys = 0.0
    for p, a in zip(prompt_lens, answer_lens):
        keys += p * (p + 1) / 2 + sum(p + j + 1 for j in range(a - 1))
    head = 2.0 * cfg["hidden_size"] * cfg["vocab_size"] * sum(answer_lens)
    return 2.0 * token_weights(cfg) * fed + head + per_key * keys
