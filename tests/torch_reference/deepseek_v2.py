"""A plain float32 DeepSeek-V2 forward, in plain torch operations: the
reference that the CPU tests hold the port's DeepSeek-V2 decoder
(``intool_rag_tpu_torch/models/deepseek_v2.py``) to. No cache, no batching
across sequences inside attention, no absorption, no kernel; TF32 is off.
It imports nothing of the port; the benchmark keeps its own copy
(``portbench/reference/deepseek_v2.py``).

It follows Hugging Face's ``modeling_deepseek.py`` (DeepSeek-V2,
arXiv:2405.04434) for configurations without a query low-rank projection
(``q_lora_rank`` null), with greedy softmax routing in one group:

- RMSNorm (f32); ``q = x·W_q`` split into ``q_nope | q_pe``;
  ``[c | k_pe] = x·W_kva``; ``c`` through ``kv_a_layernorm``; ``[k_nope |
  v] = c·W_kvb``; ``q_pe`` and the one ``k_pe`` rotated by YaRN rope after
  HF's de-interleave (view ``[d/2, 2]``, transpose), rotate-half;
- causal softmax of ``[q_nope | q_pe]·[k_nope | k_pe]`` times ``mscale² /
  sqrt(nope + rope)``; ``o·W_o``;
- the first ``first_k_dense_replace`` layers a dense SwiGLU; the others
  ``Σ_k w_k E_{i_k}(x) + S(x)`` over the top-k softmax scores (not
  renormalised, times ``routed_scaling_factor``), ``S`` the shared experts;
- a final RMSNorm and the untied head.

Departures from HF: HF's auxiliary routing loss (training only) is left
out; every operation is in float32, where HF computes in the checkpoint's
dtype. Nothing else.

The weights come from a callable ``weight(name)`` (HF names, ``[out, in]``,
float32), asked for one layer's tensors at a time, so a caller can redraw
each from the seed instead of holding the model: :func:`redraw`.
"""

from __future__ import annotations

import hashlib
import math

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

FP8_MAX = 448.0  # the largest float8 e4m3 value


def yarn_mscale(scale: float = 1.0, mscale: float = 1.0) -> float:
    return 0.1 * mscale * math.log(scale) + 1.0 if scale > 1 else 1.0


def yarn_range(cfg: dict) -> tuple[int, int]:
    """HF's ``yarn_find_correction_range``."""
    rope, dim, base = cfg["rope_scaling"], cfg["qk_rope_head_dim"], cfg["rope_theta"]
    orig = rope["original_max_position_embeddings"]

    def corr(rotations: float) -> float:
        return dim * math.log(orig / (rotations * 2 * math.pi)) / (2 * math.log(base))

    return max(math.floor(corr(rope["beta_fast"])), 0), min(math.ceil(corr(rope["beta_slow"])), dim - 1)


def softmax_scale(cfg: dict) -> float:
    scale = (cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]) ** -0.5
    rope = cfg.get("rope_scaling") or {}
    if rope.get("mscale_all_dim"):
        m = yarn_mscale(rope["factor"], rope["mscale_all_dim"])
        scale = scale * m * m
    return scale


def rope_cos_sin(cfg: dict, n: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """HF's ``DeepseekV2YarnRotaryEmbedding`` tables for positions 0..n-1,
    ``[n, rope]`` float32 (plain rope without ``rope_scaling``)."""
    dim, base = cfg["qk_rope_head_dim"], cfg["rope_theta"]
    rope = cfg.get("rope_scaling") or {}
    extra = 1.0 / (base ** (torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim))
    scale = 1.0
    inv_freq = extra
    if rope:
        factor = rope["factor"]
        inter = 1.0 / (factor * base ** (torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim))
        low, high = yarn_range(cfg)
        if low == high:
            high += 0.001
        ramp = ((torch.arange(dim // 2, dtype=torch.float32, device=device) - low) / (high - low)).clamp(0, 1)
        inv_mask = 1.0 - ramp
        inv_freq = inter * (1 - inv_mask) + extra * inv_mask
        scale = yarn_mscale(factor, rope["mscale"]) / yarn_mscale(factor, rope["mscale_all_dim"])
    freqs = torch.outer(torch.arange(n, dtype=torch.float32, device=device), inv_freq)
    emb = torch.cat([freqs, freqs], dim=-1)
    return emb.cos() * scale, emb.sin() * scale


def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """HF's ``apply_rotary_pos_emb`` on ``x [..., S, d]``: de-interleave,
    then ``x·cos + rotate_half(x)·sin``."""
    d = x.shape[-1]
    x = x.reshape(*x.shape[:-1], d // 2, 2).transpose(-1, -2).reshape(x.shape)
    half = torch.cat([-x[..., d // 2:], x[..., : d // 2]], dim=-1)
    return x * cos + half * sin


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` through float8 e4m3 with one scale for the tensor (its largest
    magnitude at 448), back in float32: the control's precision."""
    scale = x.abs().max().clamp(min=1e-12) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def swiglu(x: torch.Tensor, gate: torch.Tensor, up: torch.Tensor, down: torch.Tensor) -> torch.Tensor:
    return (torch.nn.functional.silu(x @ gate.T) * (x @ up.T)) @ down.T


def forward(cfg: dict, weight, seqs: list[torch.Tensor], *, logits_from: list[int] | None = None,
            cache_layers=(), control: bool = False) -> dict:
    """Each sequence of ``seqs`` (token ids from position 0) through the
    model. Returns ``logits`` (per sequence, ``[S - logits_from, V]``
    float32), ``routes`` (per expert layer, per sequence: the chosen experts
    ``[S, k]`` and the top ``k + 1`` scores ``[S, k + 1]``, both in
    descending score order) and ``cache`` (per layer of ``cache_layers``,
    per sequence: ``[c | k_pe]`` ``[S, kv_lora_rank + rope]``). ``control``:
    the latent entries and every expert matrix through :func:`fp8`."""
    eps, nh = cfg["rms_norm_eps"], cfg["num_attention_heads"]
    dn, dr, dv, r = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"], cfg["kv_lora_rank"]
    k_top = cfg["num_experts_per_tok"]
    dev = seqs[0].device
    lens = [int(s.numel()) for s in seqs]
    cos, sin = rope_cos_sin(cfg, max(lens), dev)
    scale = softmax_scale(cfg)
    embed = weight("model.embed_tokens.weight")
    xs = [embed[s.long()] for s in seqs]
    del embed
    out = {"routes": {}, "cache": {}}
    expert_w = fp8 if control else (lambda t: t)
    for i in range(cfg["num_hidden_layers"]):
        p = f"model.layers.{i}."
        w_q, w_kva = weight(p + "self_attn.q_proj.weight"), weight(p + "self_attn.kv_a_proj_with_mqa.weight")
        w_kvn, w_kvb = weight(p + "self_attn.kv_a_layernorm.weight"), weight(p + "self_attn.kv_b_proj.weight")
        w_o, w_in = weight(p + "self_attn.o_proj.weight"), weight(p + "input_layernorm.weight")
        for j, x in enumerate(xs):
            s = x.shape[0]
            h = rms_norm(x, w_in, eps)
            q = (h @ w_q.T).view(s, nh, dn + dr).transpose(0, 1)  # [H, S, dn + dr]
            ckv = h @ w_kva.T
            c = rms_norm(ckv[:, :r], w_kvn, eps)
            k_pe = rotate(ckv[:, r:], cos[:s], sin[:s])
            q_pe = rotate(q[..., dn:], cos[:s], sin[:s])
            if control:
                c, k_pe = fp8(c), fp8(k_pe)
            if i in cache_layers:
                out["cache"].setdefault(i, []).append(torch.cat([c, k_pe], dim=-1))
            kv = (c @ w_kvb.T).view(s, nh, dn + dv).transpose(0, 1)  # [H, S, dn + dv]
            k = torch.cat([kv[..., :dn], k_pe.expand(nh, s, dr)], dim=-1)
            scores = torch.cat([q[..., :dn], q_pe], dim=-1) @ k.transpose(1, 2) * scale
            causal = torch.ones(s, s, dtype=torch.bool, device=dev).tril()
            probs = torch.softmax(scores.masked_fill(~causal, -math.inf), dim=-1)
            o = (probs @ kv[..., dn:]).transpose(0, 1).reshape(s, nh * dv)
            xs[j] = x + o @ w_o.T
        del w_q, w_kva, w_kvn, w_kvb, w_o, w_in
        w_post = weight(p + "post_attention_layernorm.weight")
        hs = torch.cat([rms_norm(x, w_post, eps) for x in xs])
        if i < cfg["first_k_dense_replace"]:
            y = swiglu(hs, *(weight(p + f"mlp.{n}_proj.weight") for n in ("gate", "up", "down")))
        else:
            scores = torch.softmax(hs @ weight(p + "mlp.gate.weight").T, dim=-1)
            top, idx = torch.topk(scores, k_top + 1, dim=-1)
            w_top, idx = top[:, :k_top] * cfg["routed_scaling_factor"], idx[:, :k_top]
            out["routes"][i] = list(zip(idx.split(lens), top.split(lens)))
            y = torch.zeros_like(hs)
            for e in torch.unique(idx).tolist():
                rows, pick = (idx == e).nonzero(as_tuple=True)
                q = f"{p}mlp.experts.{e}."
                ye = swiglu(hs[rows], *(expert_w(weight(q + f"{n}_proj.weight")) for n in ("gate", "up", "down")))
                y.index_add_(0, rows, ye * w_top[rows, pick, None])
            if cfg.get("n_shared_experts"):
                q = p + "mlp.shared_experts."
                y = y + swiglu(hs, *(expert_w(weight(q + f"{n}_proj.weight")) for n in ("gate", "up", "down")))
        xs = [x + part for x, part in zip(xs, y.split(lens))]
    w_norm, w_head = weight("model.norm.weight"), weight("lm_head.weight")
    starts = logits_from or [0] * len(xs)
    out["logits"] = [rms_norm(x[a:], w_norm, eps) @ w_head.T for x, a in zip(xs, starts)]
    return out


def weight_seed(seed: int, name: str) -> int:
    """The generator seed of tensor ``name`` in run ``seed``: the first 8
    bytes of sha256(``"<seed>/<name>"``), little-endian, 63 bits."""
    return int.from_bytes(hashlib.sha256(f"{int(seed)}/{name}".encode()).digest()[:8], "little") & ((1 << 63) - 1)


def redraw(cfg: dict, seed: int, device, dtype=torch.bfloat16):
    """``weight(name)`` for a model whose weights were drawn from the seed:
    1-D tensors (norm scales) are ones; a matrix ``[out, in]`` is
    normal(0, 1/sqrt(in)) from its own generator (:func:`weight_seed`), drawn
    on ``device`` in float32, then rounded to ``dtype`` as the program holds
    it, returned in float32."""
    shapes = hf_shapes(cfg)

    def weight(name: str) -> torch.Tensor:
        shape = shapes[name]
        if len(shape) == 1:
            return torch.ones(shape, dtype=torch.float32, device=device)
        gen = torch.Generator(device=device).manual_seed(weight_seed(seed, name))
        return (torch.randn(shape, generator=gen, device=device) * shape[1] ** -0.5).to(dtype).float()

    return weight


def hf_shapes(cfg: dict) -> dict[str, tuple[int, ...]]:
    """The shape of each tensor the forward asks for, by HF name."""
    h, nh, r, dr = cfg["hidden_size"], cfg["num_attention_heads"], cfg["kv_lora_rank"], cfg["qk_rope_head_dim"]
    dq = cfg["qk_nope_head_dim"] + dr
    shapes = {"model.embed_tokens.weight": (cfg["vocab_size"], h), "model.norm.weight": (h,),
              "lm_head.weight": (cfg["vocab_size"], h)}
    for i in range(cfg["num_hidden_layers"]):
        p = f"model.layers.{i}."
        shapes.update({p + "input_layernorm.weight": (h,), p + "post_attention_layernorm.weight": (h,),
                       p + "self_attn.q_proj.weight": (nh * dq, h), p + "self_attn.kv_a_proj_with_mqa.weight": (r + dr, h),
                       p + "self_attn.kv_a_layernorm.weight": (r,),
                       p + "self_attn.kv_b_proj.weight": (nh * (cfg["qk_nope_head_dim"] + cfg["v_head_dim"]), r),
                       p + "self_attn.o_proj.weight": (h, nh * cfg["v_head_dim"])})
        widths = {}
        if i < cfg["first_k_dense_replace"]:
            widths[p + "mlp."] = cfg["intermediate_size"]
        else:
            shapes[p + "mlp.gate.weight"] = (cfg["n_routed_experts"], h)
            widths.update({f"{p}mlp.experts.{e}.": cfg["moe_intermediate_size"] for e in range(cfg["n_routed_experts"])})
            if cfg.get("n_shared_experts"):
                widths[p + "mlp.shared_experts."] = cfg["moe_intermediate_size"] * cfg["n_shared_experts"]
        for q, w in widths.items():
            shapes.update({q + "gate_proj.weight": (w, h), q + "up_proj.weight": (w, h), q + "down_proj.weight": (h, w)})
    return shapes
