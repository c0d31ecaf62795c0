"""Decoder-only generative LM, Llama-family architecture, with a KV cache
(port of ``intool_rag_tpu/models/decoder.py``).

The architecture is HF ``LlamaForCausalLM``'s, so checkpoints load
through :func:`load_hf_llama`:

- RMSNorm before each block, in f32, times its scale, then cast (the JAX
  package's rounding, not HF's, which casts before the scale);
- rotary position embeddings in HF's rotate-half convention, in f32;
- grouped-query attention as a grouped product over ``num_kv_heads``, no
  head repeat; scores, mask and softmax in f32 (the products of bf16
  operands are exact in f32, so the f32 product of their f32 copies is
  what the JAX package's ``preferred_element_type=float32`` computes);
- SwiGLU MLP (gate / up / down), no biases anywhere.

No library attention: the products are ``torch.einsum`` and
``nn.functional.linear``, as the JAX package's are XLA einsums and dense
layers (it has no Pallas kernel here).

:func:`generate` is the counterpart of ``make_generate_fn``: one prefill
over the left-padded prompt, then a host loop of single-token steps that
write into a cache allocated once per call. The JAX package compiles
prefill and decode into one XLA program; here each step launches its
kernels from the host. :func:`generate_lookup_speculative` is the
counterpart of ``make_lookup_speculative_fn``: greedy, one stream, each
step verifying a draft looked up in the prompt. Batched serving
(continuous batching, speculative waves) is ``models/scheduler.py``.
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from ..device import resolve_device
from .encoder import params_from_jax


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    vocab_size: int = 32_000
    hidden_size: int = 2048
    num_layers: int = 22
    num_heads: int = 32
    num_kv_heads: int = 4
    intermediate_size: int = 5632
    max_position: int = 2048
    rope_theta: float = 10_000.0
    rms_norm_eps: float = 1e-5
    dtype: str = "bfloat16"  # compute dtype

    @classmethod
    def tinyllama(cls) -> "DecoderConfig":
        """TinyLlama-1.1B dimensions."""
        return cls()

    @classmethod
    def tiny(cls) -> "DecoderConfig":
        """Test size (GQA still exercised)."""
        return cls(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4, num_kv_heads=2,
                   intermediate_size=128, max_position=64, dtype="float32")

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def torch_dtype(self) -> torch.dtype:
        return {"float32": torch.float32, "bfloat16": torch.bfloat16}[self.dtype]


@dataclasses.dataclass
class KVCache:
    """Per-layer key / value buffers, written in place.

    ``k`` / ``v``: ``[L, B, P, num_kv_heads, head_dim]`` in the compute
    dtype. ``valid``: ``[B, P]`` bool, False on prompt padding, which is
    never attended to. ``length``: the filled positions, the same for every
    row (ragged prompts are left-padded).
    """

    k: torch.Tensor
    v: torch.Tensor
    valid: torch.Tensor
    length: int = 0

    def put_rows(self, rows: torch.Tensor, start: int, sub: "KVCache", first: int | None = None) -> None:
        """Rows ``rows`` of this cache take ``sub``'s positions at ``[start,
        start + P_sub)`` and lose every other position (their history is
        cleared through ``valid``): the continuous-batching scheduler's slot
        refill. ``first`` (the first position holding a real token) is a hint
        this cache does not use."""
        end = start + sub.valid.shape[1]
        self.k[:, rows, start:end] = sub.k
        self.v[:, rows, start:end] = sub.v
        self.valid[rows] = False
        self.valid[rows, start:end] = sub.valid


def init_cache(config: DecoderConfig, batch: int, device: str | torch.device | None = None,
               positions: int | None = None) -> KVCache:
    """An empty cache of ``positions`` slots a row (default
    ``config.max_position``)."""
    dev = resolve_device(device)
    positions = positions or config.max_position
    shape = (config.num_layers, batch, positions, config.num_kv_heads, config.head_dim)
    return KVCache(
        k=torch.zeros(shape, dtype=config.torch_dtype, device=dev),
        v=torch.zeros(shape, dtype=config.torch_dtype, device=dev),
        valid=torch.zeros((batch, positions), dtype=torch.bool, device=dev),
    )


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def _rope_tables(positions: torch.Tensor, head_dim: int, theta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """HF Llama ``cos`` / ``sin``, ``[B, S, 1, Dh]`` f32, tiled (not
    interleaved) across the two halves."""
    inv_freq = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32, device=positions.device)
                                / head_dim))
    angles = positions.float()[:, :, None] * inv_freq
    cos, sin = torch.cos(angles), torch.sin(angles)
    return torch.cat([cos, cos], dim=-1)[:, :, None, :], torch.cat([sin, sin], dim=-1)[:, :, None, :]


def _rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """``x [B, S, H, Dh]`` rotated in f32, back in its dtype."""
    xf = x.float()
    return (xf * cos + _rotate_half(xf) * sin).to(x.dtype)


class Linear(nn.Module):
    """A bias-free projection; ``weight`` is ``[out, in]`` as in HF and
    ``nn.Linear``, cast to the input's dtype at use (a no-op when equal)."""

    def __init__(self, in_features: int, out_features: int) -> None:
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return nn.functional.linear(x, self.weight.to(x.dtype))


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float) -> None:
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        norm = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + self.eps)
        return (norm * self.weight).to(x.dtype)


class DecoderAttention(nn.Module):
    """One layer's attention over ``num_heads`` query heads and
    ``num_kv_heads`` kv heads (default: the config's; a tensor-parallel
    shard holds a slice of each, ``parallel/tp_decoder.py``). ``o_proj``
    maps the heads back to the full hidden width."""

    def __init__(self, cfg: DecoderConfig, layer_idx: int, num_heads: int | None = None,
                 num_kv_heads: int | None = None) -> None:
        super().__init__()
        self.cfg = cfg
        self.layer_idx = layer_idx
        self.num_heads = num_heads or cfg.num_heads
        self.num_kv_heads = num_kv_heads or cfg.num_kv_heads
        h, dh = cfg.hidden_size, cfg.head_dim
        self.q_proj = Linear(h, self.num_heads * dh)
        self.k_proj = Linear(h, self.num_kv_heads * dh)
        self.v_proj = Linear(h, self.num_kv_heads * dh)
        self.o_proj = Linear(self.num_heads * dh, h)

    def forward(self, hidden, rope: tuple[torch.Tensor, torch.Tensor], mask: torch.Tensor, cache: KVCache):
        cfg = self.cfg
        b, s, _ = hidden.shape
        dh, kh, nh = cfg.head_dim, self.num_kv_heads, self.num_heads
        q = _rope(self.q_proj(hidden).view(b, s, nh, dh), *rope)
        k = _rope(self.k_proj(hidden).view(b, s, kh, dh), *rope)
        v = self.v_proj(hidden).view(b, s, kh, dh)
        # this call's k / v into the preallocated cache, in place
        start, end = cache.length, cache.length + s
        cache.k[self.layer_idx, :, start:end] = k.to(cache.k.dtype)
        cache.v[self.layer_idx, :, start:end] = v.to(cache.v.dtype)
        # only the filled prefix [0, end): the masked tail would add exact zeros
        k_all = cache.k[self.layer_idx, :, :end].float()  # [B, W, K, Dh]
        v_all = cache.v[self.layer_idx, :, :end]
        q5 = q.view(b, s, kh, nh // kh, dh).float()
        scores = torch.einsum("bskrd,bpkd->bkrsp", q5, k_all) / math.sqrt(dh)  # [B, K, R, S, W] f32
        attn = torch.softmax(scores.masked_fill(~mask, -math.inf), dim=-1)
        out = torch.einsum("bkrsp,bpkd->bskrd", attn.to(v_all.dtype).float(), v_all.float())
        return self.o_proj(out.to(hidden.dtype).reshape(b, s, nh * dh))


class DecoderBlock(nn.Module):
    def __init__(self, cfg: DecoderConfig, layer_idx: int) -> None:
        super().__init__()
        self.input_ln = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.attn = DecoderAttention(cfg, layer_idx)
        self.post_attn_ln = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.gate_proj = Linear(cfg.hidden_size, cfg.intermediate_size)
        self.up_proj = Linear(cfg.hidden_size, cfg.intermediate_size)
        self.down_proj = Linear(cfg.intermediate_size, cfg.hidden_size)

    def forward(self, hidden, rope, mask, cache: KVCache):
        hidden = hidden + self.attn(self.input_ln(hidden), rope, mask, cache)
        normed = self.post_attn_ln(hidden)
        return hidden + self.down_proj(nn.functional.silu(self.gate_proj(normed)) * self.up_proj(normed))


class DecoderLM(nn.Module):
    """``(input_ids, positions, cache, valid_mask=None) -> logits [B, S, V] f32``.

    ``positions [B, S]`` are global token positions (prompt padding takes
    position 0 and is masked through ``cache.valid``). The call writes its
    k / v at ``[cache.length, cache.length + S)`` and advances
    ``cache.length`` by S; ``valid_mask`` marks which of this call's slots
    hold real tokens (default: all). Parameters are created on ``device``
    in ``param_dtype`` (default: the compute dtype) and are uninitialized
    until :meth:`init_random` or ``load_state_dict``.
    """

    def __init__(self, config: DecoderConfig, device: str | torch.device | None = None,
                 param_dtype: torch.dtype | None = None) -> None:
        super().__init__()
        self.config = config
        cfg = config
        with torch.device("meta"):
            self.embed = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
            self.layers = nn.ModuleList(DecoderBlock(cfg, i) for i in range(cfg.num_layers))
            self.final_ln = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
            self.lm_head = Linear(cfg.hidden_size, cfg.vocab_size)
        self.to_empty(device=resolve_device(device))
        self.to(param_dtype or cfg.torch_dtype)

    @torch.no_grad()
    def init_random(self, generator: torch.Generator) -> "DecoderLM":
        """Seeded random weights (:func:`init_decoder_params`), drawn on the
        generator's device one tensor at a time."""
        self.load_state_dict(init_decoder_params(self.config, generator, param_dtype=self.embed.weight.dtype))
        return self

    def init_cache(self, batch: int, positions: int | None = None) -> KVCache:
        """An empty cache for this model, on its parameters' device
        (:func:`init_cache`)."""
        return init_cache(self.config, batch, self.embed.weight.device, positions)

    def forward(self, input_ids: torch.Tensor, positions: torch.Tensor, cache: KVCache,
                valid_mask: torch.Tensor | None = None) -> torch.Tensor:
        cfg = self.config
        mask = attention_mask(cache, input_ids, valid_mask)
        rope = _rope_tables(positions, cfg.head_dim, cfg.rope_theta)
        hidden = self.embed(input_ids).to(cfg.torch_dtype)
        for layer in self.layers:
            hidden = layer(hidden, rope, mask, cache)
        logits = self.lm_head(self.final_ln(hidden)).float()
        cache.length += input_ids.shape[1]
        return logits


def attention_mask(cache, input_ids: torch.Tensor, valid_mask: torch.Tensor | None) -> torch.Tensor:
    """Marks this call's slots ``[cache.length, cache.length + S)`` valid
    (``valid_mask``, default all) and returns the ``[B, 1, 1, S, W]`` mask
    over the filled prefix ``W``: causal, and valid or the query's own slot
    (a pad query would otherwise see no key, and its NaN would reach later
    layers). Raises when the cache is too short."""
    s = input_ids.shape[1]
    start, end = cache.length, cache.length + s
    if end > cache.valid.shape[1]:
        raise ValueError(f"the cache holds {cache.valid.shape[1]} positions; this call needs {end}")
    cache.valid[:, start:end] = True if valid_mask is None else valid_mask.bool()
    p_idx = torch.arange(end, device=input_ids.device)
    q_pos = start + torch.arange(s, device=input_ids.device)
    causal = p_idx[None, :] <= q_pos[:, None]
    self_slot = p_idx[None, :] == q_pos[:, None]
    return (causal & (cache.valid[:, None, :end] | self_slot))[:, None, None]


def init_decoder_params(config: DecoderConfig, generator: torch.Generator,
                        param_dtype: torch.dtype = torch.float32) -> dict[str, torch.Tensor]:
    """A seeded random state dict on the generator's device: with the scales
    of flax's defaults for the JAX ``DecoderLM`` (projections normal(0,
    1/sqrt(fan_in)), embeddings normal(0, 1/sqrt(vocab)), unit norm scales),
    each tensor drawn in f32 and cast to ``param_dtype``. The values differ
    from the JAX package's; parity tests carry its weights across instead
    (:func:`decoder_state_from_flax`)."""
    dev = generator.device
    with torch.device("meta"):
        shapes = {k: v.shape for k, v in DecoderLM(config, device="meta").state_dict().items()}
    out = {}
    for name, shape in shapes.items():
        if name.endswith("_ln.weight"):
            out[name] = torch.ones(shape, dtype=param_dtype, device=dev)
            continue
        std = 1.0 / math.sqrt(shape[0] if name == "embed.weight" else shape[1])
        out[name] = (torch.randn(shape, generator=generator, device=dev) * std).to(param_dtype)
    return out


def cast_params_for_inference(config: DecoderConfig, state: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """The f32 tensors of ``state`` in bf16 when the config computes in bf16
    (decode reads every weight once a step, so one bf16 copy halves the
    bytes); unchanged for f32 configs."""
    if config.torch_dtype != torch.bfloat16:
        return state
    return {k: (v.to(torch.bfloat16) if v.dtype == torch.float32 else v) for k, v in state.items()}


# the JAX ``DecoderLM``'s params (nested numpy dicts, with or without the
# top-level ``"params"`` key) as this module's state dict: flax names its
# layers as the JAX encoder does, so the encoder's mapping serves (``kernel``
# → ``weight.T``, ``scale`` and ``embedding`` → ``weight``, ``layer_i`` →
# ``layers.i``)
decoder_state_from_flax = params_from_jax


def load_hf_llama(config: DecoderConfig, state_dict: dict) -> dict[str, torch.Tensor]:
    """An HF ``LlamaForCausalLM`` state dict as this module's state dict
    (the counterpart of the JAX ``load_torch_llama``): the names change,
    the ``[out, in]`` weights stay as they are."""
    def t(name: str) -> torch.Tensor:
        return torch.as_tensor(state_dict[name]).detach().cpu().float()

    out = {
        "embed.weight": t("model.embed_tokens.weight"),
        "final_ln.weight": t("model.norm.weight"),
        "lm_head.weight": t("lm_head.weight"),
    }
    for i in range(config.num_layers):
        p, q = f"model.layers.{i}", f"layers.{i}"
        out[f"{q}.input_ln.weight"] = t(f"{p}.input_layernorm.weight")
        out[f"{q}.post_attn_ln.weight"] = t(f"{p}.post_attention_layernorm.weight")
        for proj in ("q_proj", "k_proj", "v_proj", "o_proj"):
            out[f"{q}.attn.{proj}.weight"] = t(f"{p}.self_attn.{proj}.weight")
        for proj in ("gate_proj", "up_proj", "down_proj"):
            out[f"{q}.{proj}.weight"] = t(f"{p}.mlp.{proj}.weight")
    return out


# ---------------- generation ----------------


def prefill_logits(model, ids: torch.Tensor, positions: torch.Tensor, cache, mask: torch.Tensor) -> torch.Tensor:
    """The logits ``[B, V]`` of a prompt call at its last position: through
    the model's ``prefill`` where it has one (a decoder whose full prompt
    logits would not fit), else the last row of its call."""
    if hasattr(model, "prefill"):
        return model.prefill(ids, positions, cache, mask)
    return model(ids, positions, cache, mask)[:, -1]


def filter_logits(logits: torch.Tensor, top_k: int = 0, top_p: float = 1.0) -> torch.Tensor:
    """Top-k and nucleus filtering: logits outside the top-k set and / or
    the smallest set whose probability reaches ``top_p`` become -inf (the
    argmax is always kept)."""
    if top_k and top_k > 0:
        kth = torch.sort(logits, dim=-1).values[..., -top_k, None]
        logits = torch.where(logits < kth, -math.inf, logits)
    if top_p and top_p < 1.0:
        sorted_desc = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_desc, dim=-1)
        keep = torch.cumsum(probs, dim=-1) - probs < top_p
        kth = torch.where(keep, sorted_desc, math.inf).min(dim=-1, keepdim=True).values
        logits = torch.where(logits < kth, -math.inf, logits)
    return logits


def _sample(logits: torch.Tensor, temperature: float, top_k: int, top_p: float,
            generator: torch.Generator | None) -> torch.Tensor:
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    probs = torch.softmax(filter_logits(logits, top_k, top_p) / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


@torch.no_grad()
def generate(
    model: DecoderLM,
    prompt_ids: torch.Tensor,
    prompt_mask: torch.Tensor,
    *,
    max_new_tokens: int,
    temperature: float = 0.0,
    eos_id: int | None = None,
    pad_id: int = 0,
    top_k: int = 0,
    top_p: float = 1.0,
    generator: torch.Generator | None = None,
) -> torch.Tensor:
    """``prompt_ids [B, S]`` left-padded with ``pad_id`` (``prompt_mask`` 0
    on padding) → ``[B, max_new_tokens]`` new tokens. Greedy when
    ``temperature <= 0``; otherwise sampled from the filtered logits with
    ``generator``. After a row's ``eos_id`` every later token of that row
    is ``pad_id``; the loop ends early once every row is done."""
    b, s = prompt_ids.shape
    cache = model.init_cache(b)
    positions = torch.clamp(torch.cumsum(prompt_mask.long(), dim=1) - 1, min=0)
    tok = _sample(prefill_logits(model, prompt_ids, positions, cache, prompt_mask.bool()), temperature, top_k, top_p,
                  generator)
    pos = positions[:, -1] + 1  # each row's true prompt length
    eos = -1 if eos_id is None else eos_id
    done = tok == eos
    out = torch.full((b, max_new_tokens), pad_id, dtype=torch.long, device=prompt_ids.device)
    out[:, 0] = tok
    for t in range(1, max_new_tokens):
        if t % 8 == 0 and bool(done.all()):  # one host sync every 8 steps
            break
        logits = model(tok[:, None], pos[:, None], cache)
        nxt = torch.where(done, pad_id, _sample(logits[:, 0], temperature, top_k, top_p, generator))
        done = done | (nxt == eos)
        out[:, t] = nxt
        tok, pos = nxt, pos + 1
    if hasattr(model, "flush_counters"):
        model.flush_counters()
    return out


@torch.no_grad()
def generate_lookup_speculative(
    model: DecoderLM,
    prompt_ids: torch.Tensor,
    prompt_mask: torch.Tensor,
    *,
    max_new_tokens: int,
    gamma: int = 4,
    eos_id: int | None = None,
    pad_id: int = 0,
) -> torch.Tensor:
    """Greedy generation with prompt-lookup speculation, one stream
    (counterpart of the JAX ``make_lookup_speculative_fn``).

    ``prompt_ids [1, S]`` left-padded (``prompt_mask`` 0 on padding) →
    ``[max_new_tokens]`` tokens. Each wave drafts ``gamma - 1`` tokens: those
    after the last place in the prompt where the last two emitted tokens
    occur, found on the device. One forward of ``gamma`` tokens verifies
    the draft; the accepted prefix and the model's own next token are
    emitted. Every emitted token is the model's argmax after the same
    prefix, so the tokens are :func:`generate`'s at temperature 0, up to
    the rounding of a ``gamma``-token forward against a one-token one.

    The cache cursor advances ``gamma`` a wave whatever was accepted; the
    rejected slots are marked invalid, never attended to. So the cache is
    allocated with ``S + gamma * max_new_tokens`` slots (a wave emits at
    least one token), and the host reads the device once every 8 waves to
    stop. As with the JAX function, tokens after an EOS inside one wave's
    accepted prefix stay in the output: callers cut at the first EOS.
    """
    b, s = prompt_ids.shape
    if b != 1:
        raise ValueError("prompt-lookup speculation is single-stream")
    if gamma < 1:
        raise ValueError("gamma must be at least 1 (1: no draft, plain greedy steps)")
    dev = prompt_ids.device
    cache = model.init_cache(1, positions=s + gamma * max_new_tokens)
    positions = torch.clamp(torch.cumsum(prompt_mask.long(), dim=1) - 1, min=0)
    logits = model(prompt_ids, positions, cache, prompt_mask.bool())
    last = torch.argmax(logits[0, -1])
    n_real = positions[0, -1] + 1
    pi, pm = prompt_ids[0].long(), prompt_mask[0].bool()
    pi_ext = torch.cat([pi, torch.full((gamma,), pad_id, dtype=torch.long, device=dev)])
    pm_ext = torch.cat([pm, torch.zeros(gamma, dtype=torch.bool, device=dev)])
    bigram_ok = pm[:-1] & pm[1:]
    idx = torch.arange(s - 1, device=dev)
    jj = torch.arange(gamma, device=dev)
    eos = -1 if eos_id is None else eos_id
    out = torch.full((max_new_tokens + gamma,), pad_id, dtype=torch.long, device=dev)
    out[0] = last
    prev = pi[-1]
    n_emitted = torch.ones((), dtype=torch.long, device=dev)
    done = last == eos
    for wave in range(max_new_tokens):
        running = (n_emitted < max_new_tokens) & ~done
        if wave % 8 == 0 and not bool(running):  # one host sync every 8 waves
            break
        hit = (pi[:-1] == prev) & (pi[1:] == last) & bigram_ok
        match = torch.where(hit, idx, -1).max()
        start = torch.clamp(match + 2, 0, s)
        draft = torch.where(pm_ext[start + jj[:-1]] & (match >= 0), pi_ext[start + jj[:-1]], -1)
        feed = torch.cat([last[None], torch.clamp(draft, min=0)])
        base = cache.length
        lg = model(feed[None], (n_real - 1 + n_emitted + jj)[None], cache)
        o = torch.argmax(lg[0], dim=-1)
        m = torch.cumprod((o[:-1] == draft).long(), dim=0).sum()  # accepted draft tokens
        emitted = m + 1
        # this wave's slots past the accepted prefix are never attended to
        cache.valid[0, base : base + gamma] &= jj < emitted
        slots = torch.clamp(n_emitted, max=max_new_tokens) + jj
        out.index_copy_(0, slots, torch.where(running & (jj < emitted), o, out[slots]))
        done = done | (running & ((jj <= m) & (o == eos)).any())
        at = o.gather(0, torch.stack([torch.clamp(m - 1, min=0), m]))  # no host sync, unlike o[m]
        prev = torch.where(running, torch.where(m > 0, at[0], last), prev)
        last = torch.where(running, at[1], last)
        n_emitted = torch.where(running, n_emitted + emitted, n_emitted)
    return out[:max_new_tokens]
