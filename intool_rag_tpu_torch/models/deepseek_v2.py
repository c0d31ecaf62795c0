"""DeepSeek-V2 decoder: multi-head latent attention (MLA) over a latent
cache, sparse experts with shared experts, and YaRN rotary embeddings. It
keeps :class:`~.decoder.DecoderLM`'s contract (``(ids, positions, cache,
valid_mask) -> logits``, ``init_cache``, ``embed``), so
:func:`~.decoder.generate`, :class:`~.scheduler.ContinuousGenerator` and
``CudaLLM`` serve it as they serve the Llama decoder.

The equations are those of Hugging Face's ``modeling_deepseek.py``
(DeepSeek-V2, arXiv:2405.04434), configurations without a query low-rank
projection:

- attention: ``q = x·W_q`` (heads of ``nope + rope`` dims); ``[c | k_pe] =
  x·W_kva``; ``c`` through its own RMSNorm; ``q_pe`` and the one shared
  ``k_pe`` rotated by YaRN rope, the rope dims de-interleaved first (view
  ``[d/2, 2]``, transpose) as HF does, so a released checkpoint loads
  unpermuted. The cache (:class:`LatentCache`) holds ``[c | k_pe]``:
  ``kv_lora_rank + qk_rope_head_dim`` values a token a layer;
- a fresh prefill (an empty cache) takes the expanded form: ``[k_nope | v] =
  c·W_kvb`` per head, causal softmax over ``[q_nope | q_pe]·[k_nope |
  k_pe]``, in query blocks so that no ``[B, H, S, S]`` score tensor past
  :data:`SCORE_BLOCK` elements is formed; every call over a filled cache
  (decode, speculative waves) takes the absorbed form: ``q_lat[h] =
  q_nope[h]·W_UK[h]``, scores ``q_lat·c + q_pe·k_pe`` over the cache as it
  is, ``o[h] = (p·c)·W_UV[h]ᵀ``: the per-head keys and values are never
  formed over the cache;
- the softmax scale is ``mscale² / sqrt(nope + rope)`` with YaRN's
  ``mscale(factor, mscale_all_dim)``;
- the first ``first_k_dense_replace`` layers are a dense SwiGLU; the rest
  route each token to its ``num_experts_per_tok`` experts of largest softmax
  score (f32, greedy, not renormalised, times ``routed_scaling_factor``) and
  add the shared experts (one SwiGLU of ``n_shared_experts`` × the expert
  width, as HF builds them). No token is dropped: the routed products run
  as two batched products over token–expert pairs sorted by expert
  (:func:`grouped_experts`), whatever the number of experts; the one-token
  step takes every expert's tile over all its tokens, weighted by dense
  gates (:meth:`MoE.dense_experts`), the same products with no sort.

The one-token step (:class:`_DecodeSteps`) runs in the fused kernels of
``ops/deepseek_decode.py`` on the card (norms, rope and the latent, the
absorbed attention, the router and the experts' weighted sum), ~25
launches a layer, and in their plain versions elsewhere.

Compute is in the configuration's dtype with norms, softmaxes and router
scores in f32, as the Llama decoder's; RMSNorm scales in f32 before the
cast (the port's rounding). HF's auxiliary loss is for training and is
left out.

Spans (``observability.trace_phase``, recorded only while a collector is
open): ``mla.attend`` (the attention products, absorption included),
``moe.route``, ``moe.experts`` (the grouped routed products) and
``moe.shared``. Counters (process metrics, added by :meth:`flush_counters`
from a device tally, so that no step waits on the card for them):
``moe.calls`` (expert layers run), ``moe.assignments`` (token–expert
pairs of real tokens: those the call's ``valid_mask`` marks, so bucket
padding and idle slots, whose pairs are computed all the same, are left
out), ``moe.experts_touched`` (experts given at least one real token's
pair, summed over calls), ``moe.expert_tokens_max`` (the largest expert's
real pairs, summed over calls), and the ``moe.decode_*`` twins for
one-token steps.
"""

from __future__ import annotations

import dataclasses
import hashlib
import math
from typing import ClassVar

import torch
from torch import nn

from ..device import resolve_device
from ..observability import get_metrics, trace_phase
from ..ops import deepseek_decode as fused
from .decoder import Linear, RMSNorm, _rotate_half, attention_mask

SCORE_BLOCK = 1 << 28  # score elements a prefill query block may form
DECODE_CAPACITY_TOKENS = 256  # up to this many tokens a call, every expert takes a slot a token (no host read)


@dataclasses.dataclass(frozen=True)
class DeepseekV2Config:
    vocab_size: int = 102_400
    hidden_size: int = 2048
    num_layers: int = 27
    num_heads: int = 16
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    intermediate_size: int = 10_944  # the dense layers' width
    moe_intermediate_size: int = 1408  # one expert's width
    n_routed_experts: int = 64
    n_shared_experts: int = 2
    num_experts_per_tok: int = 6
    first_k_dense_replace: int = 1
    routed_scaling_factor: float = 1.0
    rope_theta: float = 10_000.0
    rope_factor: float = 40.0  # YaRN; 1.0: plain rope
    rope_original_max_position: int = 4096
    rope_beta_fast: float = 32.0
    rope_beta_slow: float = 1.0
    rope_mscale: float = 0.707
    rope_mscale_all_dim: float = 0.707
    rms_norm_eps: float = 1e-6
    max_position: int = 8192  # cache positions a stream (the published context is 163,840)
    dtype: str = "bfloat16"
    prefill_chunk_tokens: int = 16_384  # rows of a prefill go through the layers this many tokens at a time
    # prompt lengths, each its own prefill shape (RAG prompts pass 2,048 tokens)
    prompt_buckets: ClassVar[tuple[int, ...]] = (64, 128, 256, 512, 1024, 2048, 4096, 8192)

    @classmethod
    def lite(cls) -> "DeepseekV2Config":
        """DeepSeek-V2-Lite's published sizes."""
        return cls()

    @classmethod
    def tiny(cls) -> "DeepseekV2Config":
        """Test size: every mechanism, YaRN ×4 over 32 original positions."""
        return cls(vocab_size=256, hidden_size=64, num_layers=3, num_heads=4, kv_lora_rank=32, qk_nope_head_dim=32,
                   qk_rope_head_dim=16, v_head_dim=32, intermediate_size=128, moe_intermediate_size=48,
                   n_routed_experts=8, n_shared_experts=2, num_experts_per_tok=3, rope_factor=4.0,
                   rope_original_max_position=32, max_position=128, dtype="float32", prefill_chunk_tokens=64)

    @classmethod
    def from_hf(cls, hf: dict, max_position: int = 8192, **overrides) -> "DeepseekV2Config":
        """The configuration of an HF ``deepseek_v2`` ``config.json``; raises
        on settings this decoder does not compute (a query low-rank
        projection, grouped routing, another scoring or rope)."""
        if hf.get("model_type") != "deepseek_v2":
            raise ValueError(f"not a deepseek_v2 config: model_type {hf.get('model_type')!r}")
        unsupported = {"q_lora_rank": None, "topk_method": "greedy", "scoring_func": "softmax", "n_group": 1,
                       "topk_group": 1, "norm_topk_prob": False, "moe_layer_freq": 1, "hidden_act": "silu",
                       "attention_bias": False, "tie_word_embeddings": False}
        for key, want in unsupported.items():
            if hf.get(key, want) != want:
                raise ValueError(f"deepseek_v2 config: {key}={hf[key]!r} is not supported (only {want!r})")
        rope = hf.get("rope_scaling") or {}
        if rope and rope.get("type", rope.get("rope_type")) != "yarn":
            raise ValueError(f"deepseek_v2 config: rope_scaling {rope!r} is not supported (only yarn)")
        fields = dict(
            vocab_size=hf["vocab_size"], hidden_size=hf["hidden_size"], num_layers=hf["num_hidden_layers"],
            num_heads=hf["num_attention_heads"], kv_lora_rank=hf["kv_lora_rank"],
            qk_nope_head_dim=hf["qk_nope_head_dim"], qk_rope_head_dim=hf["qk_rope_head_dim"],
            v_head_dim=hf["v_head_dim"], intermediate_size=hf["intermediate_size"],
            moe_intermediate_size=hf["moe_intermediate_size"], n_routed_experts=hf["n_routed_experts"],
            n_shared_experts=hf.get("n_shared_experts") or 0, num_experts_per_tok=hf["num_experts_per_tok"],
            first_k_dense_replace=hf.get("first_k_dense_replace", 0),
            routed_scaling_factor=float(hf.get("routed_scaling_factor", 1.0)),
            rope_theta=float(hf.get("rope_theta", 10_000.0)), rope_factor=float(rope.get("factor", 1.0)),
            rope_original_max_position=int(rope.get("original_max_position_embeddings",
                                                    hf.get("max_position_embeddings", 4096))),
            rope_beta_fast=float(rope.get("beta_fast", 32)), rope_beta_slow=float(rope.get("beta_slow", 1)),
            rope_mscale=float(rope.get("mscale", 1.0)), rope_mscale_all_dim=float(rope.get("mscale_all_dim", 0.0)),
            rms_norm_eps=float(hf.get("rms_norm_eps", 1e-6)),
            max_position=min(int(hf.get("max_position_embeddings", max_position)), max_position),
            dtype="bfloat16",
        )
        return cls(**{**fields, **overrides})

    @property
    def q_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def latent_dim(self) -> int:
        """Cache values a token a layer: the latent, then the rope key."""
        return self.kv_lora_rank + self.qk_rope_head_dim

    @property
    def torch_dtype(self) -> torch.dtype:
        return {"float32": torch.float32, "bfloat16": torch.bfloat16}[self.dtype]

    def is_moe(self, layer: int) -> bool:
        return self.n_routed_experts > 0 and layer >= self.first_k_dense_replace


# ---------------- YaRN ----------------


def yarn_mscale(scale: float, mscale: float = 1.0) -> float:
    return 0.1 * mscale * math.log(scale) + 1.0 if scale > 1.0 else 1.0


def yarn_range(cfg: DeepseekV2Config) -> tuple[int, int]:
    """(low, high): the rope dims below ``low`` keep their frequency, those
    from ``high`` on are divided by the factor, the ramp lies between."""
    dim, base, orig = cfg.qk_rope_head_dim, cfg.rope_theta, cfg.rope_original_max_position

    def corr(rotations: float) -> float:
        return dim * math.log(orig / (rotations * 2 * math.pi)) / (2 * math.log(base))

    return max(math.floor(corr(cfg.rope_beta_fast)), 0), min(math.ceil(corr(cfg.rope_beta_slow)), dim - 1)


def yarn_inv_freq(cfg: DeepseekV2Config, device=None) -> torch.Tensor:
    """``[rope / 2]`` f32: ``f_inter·ramp + f_extra·(1 − ramp)``; plain rope
    at a factor of 1."""
    dim = cfg.qk_rope_head_dim
    extra = 1.0 / (cfg.rope_theta ** (torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim))
    if cfg.rope_factor <= 1.0:
        return extra
    low, high = yarn_range(cfg)
    high = high + 0.001 if low == high else high
    ramp = ((torch.arange(dim // 2, dtype=torch.float32, device=device) - low) / (high - low)).clamp(0, 1)
    return extra / cfg.rope_factor * ramp + extra * (1 - ramp)


def softmax_scale(cfg: DeepseekV2Config) -> float:
    m = yarn_mscale(cfg.rope_factor, cfg.rope_mscale_all_dim) if cfg.rope_mscale_all_dim else 1.0
    return m * m / math.sqrt(cfg.q_head_dim)


def rope_tables(positions: torch.Tensor, cfg: DeepseekV2Config) -> tuple[torch.Tensor, torch.Tensor]:
    """``cos`` / ``sin`` ``[B, S, rope]`` f32, each half the same, times
    ``mscale(factor, mscale) / mscale(factor, mscale_all_dim)``."""
    angles = positions.float()[:, :, None] * yarn_inv_freq(cfg, positions.device)
    scale = yarn_mscale(cfg.rope_factor, cfg.rope_mscale) / yarn_mscale(cfg.rope_factor, cfg.rope_mscale_all_dim)
    cos, sin = torch.cos(angles) * scale, torch.sin(angles) * scale
    return torch.cat([cos, cos], dim=-1), torch.cat([sin, sin], dim=-1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """``x [..., rope]`` de-interleaved (view ``[rope/2, 2]``, transpose),
    then rotated in f32 (rotate-half), back in its dtype; ``cos`` / ``sin``
    broadcast against it."""
    d = x.shape[-1]
    xf = x.float().unflatten(-1, (d // 2, 2)).transpose(-1, -2).flatten(-2)
    return (xf * cos + _rotate_half(xf) * sin).to(x.dtype)


# ---------------- the latent cache ----------------


@dataclasses.dataclass
class LatentCache:
    """Per-layer latent entries, written in place: ``kv [L, B, P,
    kv_lora_rank + rope]``, the RMS-normalised latent ``c`` then the rotated
    ``k_pe``, in the compute dtype. ``valid`` / ``length`` and
    :meth:`put_rows` as :class:`~.decoder.KVCache`'s. ``first``: no row holds
    a valid position before it (the host's bound from refills' real tokens),
    so a call over the filled cache attends from there: one prompt in a
    larger bucket moves the cursor, not the positions every slot reads."""

    kv: torch.Tensor
    valid: torch.Tensor
    length: int = 0
    first: int = 0

    def put_rows(self, rows: torch.Tensor, start: int, sub: "LatentCache", first: int | None = None) -> None:
        """As :meth:`~.decoder.KVCache.put_rows`; ``first`` (the earliest
        real token among ``sub``'s rows, default ``start``) lowers the
        bound of an empty cache's or keeps the lowest."""
        end = start + sub.valid.shape[1]
        self.kv[:, rows, start:end] = sub.kv
        self.valid[rows] = False
        self.valid[rows, start:end] = sub.valid
        first = start if first is None else first
        self.first = first if self._empty else min(self.first, first)
        self._empty = False

    def __post_init__(self) -> None:
        self._empty = True  # no refill yet: ``first`` is 0 for a cache filled by calls

    def rows(self, lo: int, hi: int) -> "LatentCache":
        """Rows ``[lo, hi)`` as a cache that writes through to this one."""
        return LatentCache(self.kv[:, lo:hi], self.valid[lo:hi], self.length, self.first)


def init_latent_cache(config: DeepseekV2Config, batch: int, device=None, positions: int | None = None) -> LatentCache:
    dev = resolve_device(device)
    positions = positions or config.max_position
    return LatentCache(
        kv=torch.zeros((config.num_layers, batch, positions, config.latent_dim), dtype=config.torch_dtype, device=dev),
        valid=torch.zeros((batch, positions), dtype=torch.bool, device=dev),
    )


# ---------------- layers ----------------


def _causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, blocked: torch.Tensor, scale: float,
                      block: int = SCORE_BLOCK) -> torch.Tensor:
    """``q [B, S, H, D]`` against ``k [B, W, H, D]`` / ``v [B, W, H, Dv]``
    (this call's queries are the last S of the W positions), ``blocked [B,
    1, S, W]`` True where a key is not seen → ``[B, S, H, Dv]``. Queries go
    in blocks of at most ``block`` score elements, each against the keys up
    to its last query."""
    b, s, h, _ = q.shape
    w = k.shape[1]
    rows = max(1, min(s, block // max(1, b * h * w)))
    out = []
    for lo in range(0, s, rows):
        hi = min(s, lo + rows)
        end = w - (s - hi)
        scores = torch.einsum("bshd,bwhd->bhsw", q[:, lo:hi], k[:, :end]).float() * scale
        p = torch.softmax(scores.masked_fill(blocked[:, :, lo:hi, :end], -math.inf), dim=-1)
        out.append(torch.einsum("bhsw,bwhd->bshd", p.to(v.dtype), v[:, :end]))
    return out[0] if len(out) == 1 else torch.cat(out, dim=1)


class LatentAttention(nn.Module):
    """MLA for one layer. ``qkv_a`` holds HF's ``q_proj`` rows, then
    ``kv_a_proj_with_mqa``'s (one product for both); ``kv_b_proj`` is
    ``[heads × (nope + v), kv_lora_rank]`` as in HF."""

    def __init__(self, cfg: DeepseekV2Config, layer_idx: int) -> None:
        super().__init__()
        self.cfg, self.layer_idx = cfg, layer_idx
        h, nh = cfg.hidden_size, cfg.num_heads
        self.qkv_a = Linear(h, nh * cfg.q_head_dim + cfg.latent_dim)
        self.kv_norm = RMSNorm(cfg.kv_lora_rank, cfg.rms_norm_eps)
        self.kv_b_proj = Linear(cfg.kv_lora_rank, nh * (cfg.qk_nope_head_dim + cfg.v_head_dim))
        self.o_proj = Linear(nh * cfg.v_head_dim, h)
        self.scale = softmax_scale(cfg)

    def project(self, hidden: torch.Tensor, rope) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """``(q_nope [B, S, H, nope], q_pe [B, S, H, rope], latent [B, S,
        kv_lora_rank + rope])``: the rotated queries and this call's cache
        entries."""
        cfg = self.cfg
        b, s, _ = hidden.shape
        nh, dn, dr, r = cfg.num_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.kv_lora_rank
        qkv = self.qkv_a(hidden)
        q = qkv[..., : nh * (dn + dr)].view(b, s, nh, dn + dr)
        cos, sin = rope
        # the heads' q_pe and the one k_pe rotated together, k_pe as one more head
        pe = apply_rope(torch.cat([q[..., dn:], qkv[..., None, -dr:]], dim=2), cos[:, :, None], sin[:, :, None])
        latent = torch.cat([self.kv_norm(qkv[..., -(r + dr) : -dr]), pe[:, :, nh]], dim=-1)
        return q[..., :dn], pe[:, :, :nh], latent

    def attend(self, q_nope: torch.Tensor, q_pe: torch.Tensor, latent: torch.Tensor, blocked: torch.Tensor,
               cache: LatentCache, form: str = "auto") -> torch.Tensor:
        """Writes ``latent`` at the cache's cursor and attends over the
        filled prefix (``blocked [B, 1, S, W]``: True where a key is not
        seen) → ``[B, S, heads × v]``, before ``o_proj``. ``form``: ``auto``
        (expanded over an empty cache, absorbed otherwise), ``expanded`` or
        ``absorbed``."""
        cfg = self.cfg
        b, s = latent.shape[:2]
        nh, dn, dr, r, dv = cfg.num_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.kv_lora_rank, cfg.v_head_dim
        start, end = cache.length, cache.length + s
        kv = cache.kv[self.layer_idx]
        kv[:, start:end] = latent.to(kv.dtype)
        w_b = self.kv_b_proj.weight.to(latent.dtype).view(nh, dn + dv, r)
        with trace_phase("mla.attend"):
            if form == "expanded" or (form == "auto" and start == 0):
                lat = kv[:, :end]  # [B, W, r + dr]: only the filled prefix
                kvb = nn.functional.linear(lat[..., :r], w_b.view(nh * (dn + dv), r)).view(b, end, nh, dn + dv)
                k = torch.cat([kvb[..., :dn], lat[:, :, None, r:].expand(b, end, nh, dr)], dim=-1)
                o = _causal_attention(torch.cat([q_nope, q_pe], dim=-1), k, kvb[..., dn:], blocked, self.scale)
                return o.reshape(b, s, nh * dv)
            # absorbed: W_UK into the query, W_UV after the latent sum; (S · heads) rows a sequence,
            # over the positions from the cache's first real one
            lat, blocked, end = kv[:, cache.first : end], blocked[..., cache.first : end], end - cache.first
            q_lat = torch.bmm(q_nope.reshape(b * s, nh, dn).transpose(0, 1), w_b[:, :dn])  # [H, B·S, r]
            qq = torch.cat([q_lat.transpose(0, 1), q_pe.reshape(b * s, nh, dr)], dim=-1).view(b, s * nh, r + dr)
            scores = torch.bmm(qq, lat.transpose(1, 2)).view(b, s, nh, end).float() * self.scale
            p = torch.softmax(scores.masked_fill(blocked.transpose(1, 2), -math.inf), dim=-1).to(lat.dtype)
            o_lat = torch.bmm(p.view(b, s * nh, end), lat[..., :r])  # [B, S·H, r]
            o = torch.bmm(o_lat.view(b * s, nh, r).transpose(0, 1), w_b[:, dn:].transpose(1, 2))  # [H, B·S, v]
            return o.transpose(0, 1).reshape(b, s, nh * dv)

    def forward(self, hidden, rope, blocked: torch.Tensor, cache: LatentCache) -> torch.Tensor:
        return self.o_proj(self.attend(*self.project(hidden, rope), blocked, cache))

    def attend_one(self, q: torch.Tensor, q_pe: torch.Tensor, latent: torch.Tensor, cache: LatentCache,
                   out: torch.Tensor) -> None:
        """The absorbed form for one token a row (``q [B, heads, nope +
        rope]``, of which the nope dims are read; ``q_pe [B, heads, rope]``
        rotated; ``latent [B, rank + rope]``): writes ``latent`` at the
        cache's cursor and the attention over positions ``[first, cursor]``
        into ``out [B, heads × v]``, through :func:`~..ops.deepseek_decode.
        mla_decode` (the query's own position is always seen)."""
        cfg = self.cfg
        b = latent.shape[0]
        nh, dn, r, dv = cfg.num_heads, cfg.qk_nope_head_dim, cfg.kv_lora_rank, cfg.v_head_dim
        start = cache.length
        kv = cache.kv[self.layer_idx]
        kv[:, start] = latent
        w_b = self.kv_b_proj.weight.to(latent.dtype).view(nh, dn + dv, r)
        with trace_phase("mla.attend"):
            q_lat = torch.bmm(q[..., :dn].transpose(0, 1), w_b[:, :dn])  # [H, B, r]
            o_lat = fused.mla_decode(q_lat, q_pe, kv, cache.valid, cache.first, start + 1, self.scale)
            out.view(b, nh, dv).copy_(torch.bmm(o_lat, w_b[:, dn:].transpose(1, 2)).transpose(0, 1))


class SwiGLU(nn.Module):
    """``down(silu(gate(x)) · up(x))``; ``gate_up`` holds gate's rows, then up's."""

    def __init__(self, hidden: int, width: int) -> None:
        super().__init__()
        self.gate_up = Linear(hidden, 2 * width)
        self.down = Linear(width, hidden)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        g, u = self.gate_up(x).chunk(2, dim=-1)
        return self.down(nn.functional.silu(g) * u)


def grouped_experts(x: torch.Tensor, weights: torch.Tensor, idx: torch.Tensor, w_gate_up: torch.Tensor,
                    w_down: torch.Tensor, capacity: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """``Σ_k weights[t, k] · E_{idx[t, k]}(x[t])`` for ``x [T, hidden]``,
    ``weights [T, k]`` f32, ``idx [T, k]``, ``w_gate_up [E, 2·I, hidden]``,
    ``w_down [E, hidden, I]``, each product one batched product whatever E
    is. The T·k pairs are sorted by expert and laid into tiles of rows:

    - with ``capacity`` C (a step of few tokens: C = T, as no expert can
      take more), one ``[C, hidden]`` tile an expert, read with its weights
      as they lie, with no host read;
    - without (a prefill), tiles of the mean pairs an expert, as many as
      each expert's pairs fill, each with a copy of its expert's weights:
      one host read of the counts, and a popular expert (the template's
      tokens route alike in every prompt) costs no padding in the others.

    Returns (the result in x's dtype, the pairs an expert ``[E]``)."""
    t, k = idx.shape
    e = w_gate_up.shape[0]
    flat = idx.reshape(-1)
    order = torch.argsort(flat, stable=True)
    # not bincount: on the card it reads the ids' range back to the host
    counts = torch.zeros(e, dtype=torch.int64, device=x.device).scatter_add_(0, flat, torch.ones_like(flat))
    expert = flat[order]
    slot = torch.arange(t * k, device=x.device) - (torch.cumsum(counts, 0) - counts)[expert]
    w_gu, w_d = w_gate_up.to(x.dtype), w_down.to(x.dtype)
    if capacity is None:
        size = -(-t * k // e)
        tiles = [-(-c // size) for c in counts.tolist()]
        first = torch.tensor([sum(tiles[:i]) for i in range(e)], device=x.device)
        owner = torch.tensor([i for i, n in enumerate(tiles) for _ in range(n)], device=x.device)
        tile, row = first[expert] + slot // size, slot % size
        w_gu, w_d = w_gu[owner], w_d[owner]
    else:
        size, tile, row = capacity, expert, slot
    buf = x.new_zeros((w_gu.shape[0], size, x.shape[1]))
    buf[tile, row] = x[order // k]
    g, u = torch.bmm(buf, w_gu.transpose(1, 2)).chunk(2, dim=-1)
    out = torch.bmm(nn.functional.silu(g) * u, w_d.transpose(1, 2))
    pairs = torch.empty((t * k, x.shape[1]), dtype=x.dtype, device=x.device)
    pairs[order] = out[tile, row]
    y = torch.einsum("tkh,tk->th", pairs.view(t, k, -1).float(), weights)
    return y.to(x.dtype), counts


class MoE(nn.Module):
    """Routed experts (stacked: ``w_gate_up [E, 2·I, hidden]``, ``w_down [E,
    hidden, I]``) plus the shared experts as one SwiGLU."""

    def __init__(self, cfg: DeepseekV2Config) -> None:
        super().__init__()
        self.cfg = cfg
        e, i, h = cfg.n_routed_experts, cfg.moe_intermediate_size, cfg.hidden_size
        self.gate = Linear(h, e)
        self.w_gate_up = nn.Parameter(torch.empty(e, 2 * i, h))
        self.w_down = nn.Parameter(torch.empty(e, h, i))
        self.shared = SwiGLU(h, i * cfg.n_shared_experts) if cfg.n_shared_experts else None

    def route(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(weights, experts) ``[T, k]``: the f32 softmax scores' top k."""
        scores = torch.softmax(nn.functional.linear(x.float(), self.gate.weight.float()), dim=-1)
        w, idx = torch.topk(scores, self.cfg.num_experts_per_tok, dim=-1)
        return w * self.cfg.routed_scaling_factor, idx

    def experts(self, x: torch.Tensor, w: torch.Tensor, idx: torch.Tensor, tally: "_Tally | None",
                decode: bool, real: torch.Tensor | None = None) -> torch.Tensor:
        """The routed sum; ``real [T]`` (default all) marks the tokens the
        tally counts."""
        cap = x.shape[0] if x.shape[0] <= DECODE_CAPACITY_TOKENS else None
        y, _ = grouped_experts(x, w, idx, self.w_gate_up, self.w_down, cap)
        if tally is not None:
            tally.add_device(idx, real, self.cfg.n_routed_experts, decode)
        return y

    def dense_experts(self, x: torch.Tensor, gates: torch.Tensor) -> torch.Tensor:
        """The routed sum for a few tokens ``x [T, hidden]`` from the dense
        gates ``[T, E]`` (:func:`~..ops.deepseek_decode.moe_router`): every
        expert's products over all T tokens, as the capacity tiles of
        :func:`grouped_experts` hold them at T ≤ capacity (the same weights
        read, the same products), with no sort: one product for all experts'
        gate and up rows, one batched product for their down rows, and the
        gate-weighted sum (:func:`~..ops.deepseek_decode.moe_combine`)."""
        e, width, h = self.w_gate_up.shape
        gu = nn.functional.linear(x, self.w_gate_up.to(x.dtype).view(e * width, h)).view(x.shape[0], e, width)
        g, u = gu.chunk(2, dim=-1)
        act = (nn.functional.silu(g) * u).transpose(0, 1)  # [E, T, I]
        return fused.moe_combine(torch.bmm(act, self.w_down.to(x.dtype).transpose(1, 2)), gates)

    def forward(self, x: torch.Tensor, tally: "_Tally | None" = None, real: torch.Tensor | None = None) -> torch.Tensor:
        b, s, h = x.shape
        flat = x.reshape(b * s, h)
        with trace_phase("moe.route"):
            w, idx = self.route(flat)
        with trace_phase("moe.experts"):
            y = self.experts(flat, w, idx, tally, s == 1, real)
        if tally is not None:
            tally.add_call(s == 1)
        if self.shared is not None:
            with trace_phase("moe.shared"):
                y = y + self.shared(flat)
        return y.view(b, s, h)


class _Tally:
    """The expert layers' ``moe.*`` counters, for all calls and for
    one-token calls: call counts on the host; real tokens' pairs, touched
    experts and the largest expert's pairs summed on the device (no host
    read)."""

    def __init__(self, device) -> None:
        self.calls = [0, 0]  # [all, one-token]
        self.device = torch.zeros((2, 3), dtype=torch.int64, device=device)  # × (pairs, touched, largest)

    def add_device(self, idx: torch.Tensor, real: torch.Tensor | None, experts: int, decode: bool) -> None:
        """``idx [T, k]``'s pairs of the tokens ``real [T]`` marks (all
        where None)."""
        ones = torch.ones_like(idx) if real is None else real[:, None].expand(idx.shape).to(idx.dtype)
        counts = torch.zeros(experts, dtype=idx.dtype, device=idx.device).scatter_add_(0, idx.reshape(-1),
                                                                                      ones.reshape(-1))
        self.device[: 2 if decode else 1] += torch.stack([counts.sum(), (counts > 0).sum(), counts.max()])

    def add_call(self, decode: bool) -> None:
        self.calls[0] += 1
        self.calls[1] += int(decode)

    def flush(self) -> dict[str, int]:
        tallied = self.device.tolist()
        self.device.zero_()
        calls, self.calls = self.calls, [0, 0]
        out = {}
        for prefix, c, (a, t, m) in zip(("moe.", "moe.decode_"), calls, tallied):
            out.update({prefix + "assignments": a, prefix + "experts_touched": t, prefix + "expert_tokens_max": m,
                        prefix + "calls": c})
        return out if calls[0] else {}


class DeepseekV2Block(nn.Module):
    def __init__(self, cfg: DeepseekV2Config, layer_idx: int) -> None:
        super().__init__()
        self.input_ln = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.attn = LatentAttention(cfg, layer_idx)
        self.post_attn_ln = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.mlp = MoE(cfg) if cfg.is_moe(layer_idx) else SwiGLU(cfg.hidden_size, cfg.intermediate_size)

    def forward(self, hidden, rope, blocked, cache: LatentCache, tally, real) -> torch.Tensor:
        hidden = hidden + self.attn(self.input_ln(hidden), rope, blocked, cache)
        x = self.post_attn_ln(hidden)
        return hidden + (self.mlp(x, tally, real) if isinstance(self.mlp, MoE) else self.mlp(x))


class _Piece:
    """One part of a one-token step that reads and writes only buffers that
    stay put (``fn`` takes no argument): on the card a CUDA graph, captured
    once and replayed; elsewhere ``fn`` run as is, its outputs copied into
    buffers of their own, so that the parts after it read the same
    tensors either way. Built parts hold computed outputs (a captured graph
    is replayed once), so the next part's build reads real values; what
    the build's runs add to ``keep`` is undone."""

    def __init__(self, fn, pool, keep: torch.Tensor | None = None) -> None:
        self.fn, self.graph = fn, None
        saved = keep.clone() if keep is not None else None
        if pool is None:
            self.outputs = tuple(o.clone() for o in _tuple(fn()))
        else:
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                fn()
            torch.cuda.current_stream().wait_stream(side)
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph, pool=pool):
                self.outputs = _tuple(fn())
            self.graph.replay()
        if saved is not None:
            keep.copy_(saved)

    def __call__(self) -> tuple[torch.Tensor, ...]:
        if self.graph is not None:
            self.graph.replay()
        else:
            for buf, out in zip(self.outputs, _tuple(self.fn())):
                buf.copy_(out)
        return self.outputs


def _tuple(x) -> tuple:
    return x if isinstance(x, tuple) else (x,)


class _DecodeSteps:
    """The one-token step of a batch size as parts (:class:`_Piece`) around
    each layer's attention over the cache, which stays eager (its width
    grows with the cursor), in the fused ops of :mod:`~..ops.deepseek_decode`:
    per layer ``pre`` (:func:`~..ops.deepseek_decode.rms_norm`, the fused
    projection, :func:`~..ops.deepseek_decode.mla_rope_latent`), the attention
    (:meth:`LatentAttention.attend_one`, span ``mla.attend``), ``post``
    (``o_proj``, the residual add and the post-attention norm in one
    :func:`~..ops.deepseek_decode.rms_norm`), then ``mlp`` (the dense layer) or
    ``route`` (the f32 router product and
    :func:`~..ops.deepseek_decode.moe_router`, which also keeps the tally),
    ``experts`` (:meth:`MoE.dense_experts`) and ``shared`` (spans
    ``moe.route``, ``moe.experts``, ``moe.shared``). On the card each part is
    a CUDA graph and a layer launches ~25 kernels; on the CPU the ops'
    plain versions run as is."""

    def __init__(self, model: "DeepseekV2LM", batch: int) -> None:
        cfg, dev = model.config, model.embed.weight.device
        dt, h, eps = cfg.torch_dtype, cfg.hidden_size, cfg.rms_norm_eps
        nh, dn, dr, r = cfg.num_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.kv_lora_rank
        pool = torch.cuda.graph_pool_handle() if dev.type == "cuda" else None
        self.embedded = torch.zeros((batch, 1, h), dtype=dt, device=dev)
        self.positions = torch.zeros(batch, dtype=torch.int64, device=dev)
        self.real = torch.ones(batch, dtype=torch.bool, device=dev)  # the live slots, for the tally
        inv_freq = yarn_inv_freq(cfg, dev)
        rope_scale = yarn_mscale(cfg.rope_factor, cfg.rope_mscale) / yarn_mscale(cfg.rope_factor,
                                                                                 cfg.rope_mscale_all_dim)
        tally = model.moe_tally
        self.layers = []
        hidden = self.embedded.view(batch, h)
        for layer in model.layers:
            attn = layer.attn
            part = {"attn_out": torch.zeros((batch, nh * cfg.v_head_dim), dtype=dt, device=dev)}

            def pre(layer=layer, attn=attn, hidden=hidden):
                qkv = attn.qkv_a(fused.rms_norm(hidden, layer.input_ln.weight, eps))
                q_pe, latent = fused.mla_rope_latent(qkv, self.positions, inv_freq, rope_scale, attn.kv_norm.weight,
                                                     eps, nh, dn, dr, r)
                return qkv[:, : nh * (dn + dr)].view(batch, nh, dn + dr), q_pe, latent

            def post(layer=layer, hidden=hidden, o=part["attn_out"]):
                return fused.rms_norm(layer.attn.o_proj(o), layer.post_attn_ln.weight, eps, residual=hidden)

            part["pre"] = _Piece(pre, pool)
            part["post"] = _Piece(post, pool)
            after, x = part["post"].outputs
            if isinstance(layer.mlp, MoE):
                mlp = layer.mlp
                gate = mlp.gate.weight.float()  # the router's product is f32, as MoE.route's

                def route(x=x, gate=gate):
                    return fused.moe_router(nn.functional.linear(x.float(), gate), cfg.num_experts_per_tok,
                                            cfg.routed_scaling_factor, self.real, tally.device, tally_rows=2)

                part["route"] = _Piece(route, pool, keep=tally.device)
                (gates,) = part["route"].outputs
                part["experts"] = _Piece(lambda mlp=mlp, x=x, gates=gates: mlp.dense_experts(x, gates), pool)
                (y,) = part["experts"].outputs

                def shared(mlp=mlp, x=x, y=y, after=after):
                    return after + (y if mlp.shared is None else y + mlp.shared(x))

                part["shared"] = _Piece(shared, pool)
                hidden = part["shared"].outputs[0]
            else:
                part["mlp"] = _Piece(lambda mlp=layer.mlp, x=x, after=after: after + mlp(x), pool)
                hidden = part["mlp"].outputs[0]
            self.layers.append(part)
        self.out = hidden.view(batch, 1, h)

    def __call__(self, model: "DeepseekV2LM", cache: LatentCache) -> torch.Tensor:
        for layer, part in zip(model.layers, self.layers):
            q, q_pe, latent = part["pre"]()
            layer.attn.attend_one(q, q_pe, latent, cache, part["attn_out"])
            part["post"]()
            if "mlp" in part:
                part["mlp"]()
                continue
            with trace_phase("moe.route"):
                part["route"]()
            with trace_phase("moe.experts"):
                part["experts"]()
            model.moe_tally.add_call(True)
            with trace_phase("moe.shared"):
                part["shared"]()
        return self.out


def _mark_valid(cache: LatentCache, valid_mask: torch.Tensor | None, batch: int) -> None:
    """A one-token call's half of :func:`~.decoder.attention_mask`: marks its
    slot at the cursor valid (``valid_mask``, default all), or raises when
    the cache is full. The attention reads ``valid`` itself."""
    if cache.length + 1 > cache.valid.shape[1]:
        raise ValueError(f"the cache holds {cache.valid.shape[1]} positions; this call needs {cache.length + 1}")
    cache.valid[:, cache.length] = True if valid_mask is None else valid_mask.reshape(batch).bool()


class DeepseekV2LM(nn.Module):
    """``(input_ids, positions, cache, valid_mask=None) -> logits [B, S, V]
    f32``, as :class:`~.decoder.DecoderLM`, over a :class:`LatentCache`.
    :meth:`prefill` gives the last position's logits only (a prompt bucket's
    full logits would not fit at this vocabulary). A one-token call runs as
    :class:`_DecodeSteps` (CUDA graphs on the card, built on the first call
    of each batch size)."""

    def __init__(self, config: DeepseekV2Config, device: str | torch.device | None = None,
                 param_dtype: torch.dtype | None = None) -> None:
        super().__init__()
        self.config = cfg = config
        with torch.device("meta"):
            self.embed = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
            self.layers = nn.ModuleList(DeepseekV2Block(cfg, i) for i in range(cfg.num_layers))
            self.final_ln = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
            self.lm_head = Linear(cfg.hidden_size, cfg.vocab_size)
        dev = resolve_device(device)
        if dev.type == "cuda":  # the one-token step's attention is a kernel of fixed widths: refuse others here
            fused.check_mla_widths(cfg.num_heads, cfg.kv_lora_rank, cfg.qk_rope_head_dim)
        self.to(param_dtype or cfg.torch_dtype)  # on meta: the card holds one bf16 copy, never an f32 one
        self.to_empty(device=dev)
        self.moe_tally = _Tally(dev)
        self._steps: dict[int, _DecodeSteps] = {}

    @torch.no_grad()
    def init_random(self, seed: int) -> "DeepseekV2LM":
        """Seeded random weights, each HF-named tensor drawn from ``(seed,
        name)`` (:func:`draw_weight`) on the parameters' device and written
        into its place: a reference can redraw any one tensor alone."""
        dev = self.embed.weight.device
        for name, shape in hf_weight_shapes(self.config).items():
            target, where = _placement(self.config, name)
            self.get_parameter(target)[where].copy_(draw_weight(seed, name, shape, dev))
        return self

    def init_cache(self, batch: int, positions: int | None = None) -> LatentCache:
        return init_latent_cache(self.config, batch, self.embed.weight.device, positions)

    def _layers(self, input_ids, positions, cache: LatentCache, valid_mask) -> torch.Tensor:
        cfg = self.config
        hidden = self.embed(input_ids).to(cfg.torch_dtype)
        if input_ids.shape[1] == 1 and not torch.is_grad_enabled():
            _mark_valid(cache, valid_mask, input_ids.shape[0])
            steps = self._steps.get(input_ids.shape[0])
            if steps is None:
                steps = self._steps[input_ids.shape[0]] = _DecodeSteps(self, input_ids.shape[0])
            steps.positions.copy_(positions.reshape(-1))
            steps.embedded.copy_(hidden)
            if valid_mask is None:
                steps.real.fill_(True)
            else:
                steps.real.copy_(valid_mask.reshape(-1))
            return steps(self, cache)
        blocked = ~attention_mask(cache, input_ids, valid_mask)[:, 0]
        rope = rope_tables(positions, cfg)
        real = None if valid_mask is None else valid_mask.reshape(-1).bool()
        for layer in self.layers:
            hidden = layer(hidden, rope, blocked, cache, self.moe_tally, real)
        return hidden

    def forward(self, input_ids: torch.Tensor, positions: torch.Tensor, cache: LatentCache,
                valid_mask: torch.Tensor | None = None) -> torch.Tensor:
        hidden = self._layers(input_ids, positions, cache, valid_mask)
        cache.length += input_ids.shape[1]
        return self.lm_head(self.final_ln(hidden)).float()

    def prefill(self, input_ids: torch.Tensor, positions: torch.Tensor, cache: LatentCache,
                valid_mask: torch.Tensor | None = None) -> torch.Tensor:
        """The call of :meth:`forward`, rows at most ``prefill_chunk_tokens``
        tokens at a time, returning the last position's logits ``[B, V]``
        f32 only."""
        b, s = input_ids.shape
        rows = max(1, self.config.prefill_chunk_tokens // s)
        last = []
        for lo in range(0, b, rows):
            hi = min(b, lo + rows)
            view = cache.rows(lo, hi)
            mask = None if valid_mask is None else valid_mask[lo:hi]
            last.append(self._layers(input_ids[lo:hi], positions[lo:hi], view, mask)[:, -1])
        cache.length += s
        return self.lm_head(self.final_ln(torch.cat(last))).float()

    @torch.no_grad()
    def flush_counters(self) -> None:
        """Adds the expert layers' tally to the process metrics and zeroes it
        (one host read)."""
        counters = self.moe_tally.flush()
        if counters:
            get_metrics().inc_many(counters)


# ---------------- weights ----------------


def weight_seed(seed: int, name: str) -> int:
    """A 63-bit generator seed for the tensor ``name`` of run ``seed``."""
    return int.from_bytes(hashlib.sha256(f"{int(seed)}/{name}".encode()).digest()[:8], "little") & ((1 << 63) - 1)


def draw_weight(seed: int, name: str, shape, device) -> torch.Tensor:
    """One f32 tensor of HF name ``name``: norm scales (1-D) are ones;
    matrices (``[out, in]``, embeddings ``[vocab, hidden]``) are normal(0,
    1/sqrt(shape[1])), drawn on ``device`` from :func:`weight_seed`."""
    if len(shape) == 1:
        return torch.ones(shape, dtype=torch.float32, device=device)
    gen = torch.Generator(device=device).manual_seed(weight_seed(seed, name))
    return torch.randn(shape, generator=gen, device=device) * shape[1] ** -0.5


def hf_weight_shapes(cfg: DeepseekV2Config) -> dict[str, tuple[int, ...]]:
    """Every tensor of HF's ``DeepseekV2ForCausalLM`` (``[out, in]``)."""
    h, nh, r, dr = cfg.hidden_size, cfg.num_heads, cfg.kv_lora_rank, cfg.qk_rope_head_dim
    shapes = {"model.embed_tokens.weight": (cfg.vocab_size, h)}
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}."
        shapes.update({
            p + "input_layernorm.weight": (h,), p + "post_attention_layernorm.weight": (h,),
            p + "self_attn.q_proj.weight": (nh * cfg.q_head_dim, h),
            p + "self_attn.kv_a_proj_with_mqa.weight": (r + dr, h), p + "self_attn.kv_a_layernorm.weight": (r,),
            p + "self_attn.kv_b_proj.weight": (nh * (cfg.qk_nope_head_dim + cfg.v_head_dim), r),
            p + "self_attn.o_proj.weight": (h, nh * cfg.v_head_dim),
        })
        if cfg.is_moe(i):
            w = cfg.moe_intermediate_size
            shapes[p + "mlp.gate.weight"] = (cfg.n_routed_experts, h)
            for e in range(cfg.n_routed_experts):
                q = f"{p}mlp.experts.{e}."
                shapes.update({q + "gate_proj.weight": (w, h), q + "up_proj.weight": (w, h),
                               q + "down_proj.weight": (h, w)})
            if cfg.n_shared_experts:
                s = w * cfg.n_shared_experts
                shapes.update({p + "mlp.shared_experts.gate_proj.weight": (s, h),
                               p + "mlp.shared_experts.up_proj.weight": (s, h),
                               p + "mlp.shared_experts.down_proj.weight": (h, s)})
        else:
            f = cfg.intermediate_size
            shapes.update({p + "mlp.gate_proj.weight": (f, h), p + "mlp.up_proj.weight": (f, h),
                           p + "mlp.down_proj.weight": (h, f)})
    shapes["model.norm.weight"] = (h,)
    shapes["lm_head.weight"] = (cfg.vocab_size, h)
    return shapes


def _placement(cfg: DeepseekV2Config, name: str) -> tuple[str, tuple]:
    """Where HF tensor ``name`` lives in :class:`DeepseekV2LM`: (parameter
    name, index into it)."""
    whole = (slice(None),)
    top = {"model.embed_tokens.weight": "embed.weight", "model.norm.weight": "final_ln.weight",
           "lm_head.weight": "lm_head.weight"}
    if name in top:
        return top[name], whole
    _, _, i, rest = name.split(".", 3)
    p = f"layers.{i}."
    q_rows = cfg.num_heads * cfg.q_head_dim
    simple = {"input_layernorm.weight": "input_ln.weight", "post_attention_layernorm.weight": "post_attn_ln.weight",
              "self_attn.kv_a_layernorm.weight": "attn.kv_norm.weight",
              "self_attn.kv_b_proj.weight": "attn.kv_b_proj.weight", "self_attn.o_proj.weight": "attn.o_proj.weight",
              "mlp.gate.weight": "mlp.gate.weight", "mlp.down_proj.weight": "mlp.down.weight",
              "mlp.shared_experts.down_proj.weight": "mlp.shared.down.weight"}
    if rest in simple:
        return p + simple[rest], whole
    if rest == "self_attn.q_proj.weight":
        return p + "attn.qkv_a.weight", (slice(0, q_rows),)
    if rest == "self_attn.kv_a_proj_with_mqa.weight":
        return p + "attn.qkv_a.weight", (slice(q_rows, None),)
    halves = {"gate_proj": 0, "up_proj": 1}
    parts = rest.split(".")
    if parts[0] == "mlp" and parts[1] in halves:  # the dense layer's SwiGLU
        f = cfg.intermediate_size
        return p + "mlp.gate_up.weight", (slice(halves[parts[1]] * f, (halves[parts[1]] + 1) * f),)
    if parts[1] == "shared_experts":
        s = cfg.moe_intermediate_size * cfg.n_shared_experts
        return p + "mlp.shared.gate_up.weight", (slice(halves[parts[2]] * s, (halves[parts[2]] + 1) * s),)
    if parts[1] == "experts":
        e, w = int(parts[2]), cfg.moe_intermediate_size
        if parts[3] == "down_proj":
            return p + "mlp.w_down", (e,)
        return p + "mlp.w_gate_up", (e, slice(halves[parts[3]] * w, (halves[parts[3]] + 1) * w))
    raise KeyError(f"no place for {name!r} in the DeepSeek-V2 decoder")


def load_hf_deepseek_v2(config: DeepseekV2Config, state_dict: dict) -> dict[str, torch.Tensor]:
    """An HF ``DeepseekV2ForCausalLM`` state dict as this module's state
    dict (f32 on the CPU): the query and latent projections in one matrix,
    gate and up rows in one, the experts stacked. Raises on a missing
    tensor; tensors this decoder does not hold (rotary buffers) are ignored."""
    with torch.device("meta"):
        shapes = {k: v.shape for k, v in DeepseekV2LM(config, device="meta").state_dict().items()}
    out = {k: torch.empty(v, dtype=torch.float32) for k, v in shapes.items()}
    for name in hf_weight_shapes(config):
        if name not in state_dict:
            raise KeyError(f"the checkpoint lacks {name!r}")
        target, where = _placement(config, name)
        out[target][where] = torch.as_tensor(state_dict[name]).detach().cpu().float()
    return out
