"""Tensor-parallel decoder: the Llama-family decoder split Megatron-style
over a mesh's ``model`` axis (port of ``intool_rag_tpu/parallel/tp_decoder.py``).

- q/k/v and gate/up split their output dim: shard ``t`` holds query heads
  ``[t·H/tp, (t+1)·H/tp)`` and kv heads ``[t·K/tp, (t+1)·K/tp)``, so
  grouped-query attention's head → kv-head map stays inside a shard, and
  each shard keeps the kv heads of its own slice in its cache;
- o_proj and down_proj split their input dim: each shard's product is a
  partial sum of the full one, and :func:`..collectives.reduce` adds the
  partials in shard order (one all-reduce a block);
- ``lm_head`` splits the vocabulary: each shard's logits are gathered in
  shard order before sampling;
- embeddings and RMSNorm scales are replicated on the mesh's first device
  along the axis, where the residual stream lives.

The port's weights are ``[out, in]``, so the JAX spec ``P(None, axis)``
of a column-parallel ``[in, out]`` kernel splits dim 0 here, and the row
split ``P(axis, None)`` dim 1.

One process drives every shard (``parallel/mesh.py``): each layer
launches every shard's work, then sums. A row-parallel block's partials
(in the compute dtype, as each shard's product rounds them) are summed in
f32 and cast once, so a tp of 4 rounds the sum once, as one device rounds
its product. The JAX package shards the params and lets GSPMD insert the
collectives into unchanged programs; here :class:`TPDecoderLM` keeps
:class:`..models.decoder.DecoderLM`'s forward signature and makes its own
caches (:class:`TPKVCache`: one ``[L, B, P, K/tp, Dh]`` buffer a shard,
``valid`` and ``length`` shared), so :func:`..models.decoder.generate`,
:func:`..models.decoder.generate_lookup_speculative` and
:class:`..models.scheduler.ContinuousGenerator` run it unchanged.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ..models.decoder import (
    DecoderAttention,
    DecoderConfig,
    DecoderLM,
    KVCache,
    Linear,
    RMSNorm,
    _rope_tables,
    attention_mask,
    init_cache,
)
from .collectives import all_gather, reduce
from .mesh import Mesh, axis_devices, local_devices

_COL_PARALLEL = ("q_proj", "k_proj", "v_proj", "gate_proj", "up_proj")  # split dim 0 (output)
_ROW_PARALLEL = ("o_proj", "down_proj")  # split dim 1 (input)
_NORMS = ("input_ln", "post_attn_ln")


def decoder_param_spec(name: str, shape, axis: str = "model", tp: int = 1) -> tuple:
    """The split of one :class:`~..models.decoder.DecoderLM` state-dict
    entry: a tuple with the axis name at the split dim and None elsewhere
    (``()`` = replicated). Column-parallel weights and ``lm_head`` split
    dim 0 (their output), row-parallel weights dim 1 (their input). A dim
    that ``tp`` does not divide is replicated instead (the byte
    tokenizer's 257-entry ``lm_head``; real vocabularies divide every
    practical tp)."""
    parts = name.split(".")
    module = parts[-2] if len(parts) >= 2 else ""

    def ok(dim: int) -> bool:
        return tp <= 1 or shape[dim] % tp == 0

    if module in _COL_PARALLEL or module == "lm_head":
        return (axis, None) if ok(0) else ()
    if module in _ROW_PARALLEL:
        return (None, axis) if ok(1) else ()
    return ()  # embeddings, RMSNorm scales


def validate_tp(config: DecoderConfig, mesh: Mesh, axis: str = "model") -> int:
    """Checks the divisibility contract; returns the tp degree. Refuses a
    configuration that is not the Llama family's (DeepSeek-V2's latent
    attention and experts have no split here)."""
    if not isinstance(config, DecoderConfig):
        raise ValueError(f"tensor parallelism splits the Llama-family decoder only; {type(config).__name__} "
                         "(latent attention, routed experts) has no tensor-parallel split")
    tp = mesh.shape[axis]
    if config.num_kv_heads % tp or config.num_heads % tp:
        raise ValueError(
            f"tp={tp} must divide num_heads={config.num_heads} and num_kv_heads={config.num_kv_heads}"
        )
    if config.intermediate_size % tp:
        raise ValueError(f"tp={tp} must divide intermediate_size={config.intermediate_size}")
    return tp


def _split_dim(name: str) -> int:
    """The dim a split weight is split on: its input for row-parallel
    weights, else its output."""
    return 1 if name.split(".")[-2] in _ROW_PARALLEL else 0


@dataclasses.dataclass
class TPKVCache:
    """One :class:`~..models.decoder.KVCache` buffer a shard: ``k[t]`` /
    ``v[t]`` ``[L, B, P, K/tp, Dh]`` on shard ``t``'s device; ``valid`` and
    ``length`` shared, on the first device."""

    k: list[torch.Tensor]
    v: list[torch.Tensor]
    valid: torch.Tensor
    length: int = 0

    def shard(self, t: int) -> KVCache:
        """Shard ``t``'s view, at this cache's cursor (its attention writes
        ``k[t]`` / ``v[t]`` in place)."""
        return KVCache(self.k[t], self.v[t], self.valid, self.length)

    def put_rows(self, rows: torch.Tensor, start: int, sub: "TPKVCache", first: int | None = None) -> None:
        """:meth:`KVCache.put_rows` on every shard's buffer."""
        end = start + sub.valid.shape[1]
        for k, v, sub_k, sub_v in zip(self.k, self.v, sub.k, sub.v):
            r = rows.to(k.device, non_blocking=True)
            k[:, r, start:end] = sub_k
            v[:, r, start:end] = sub_v
        self.valid[rows] = False
        self.valid[rows, start:end] = sub.valid


class _ShardBlock(nn.Module):
    """One layer's slice on one shard: attention over its heads, the MLP
    over its share of the hidden units."""

    def __init__(self, cfg: DecoderConfig, layer_idx: int, tp: int) -> None:
        super().__init__()
        self.attn = DecoderAttention(cfg, layer_idx, cfg.num_heads // tp, cfg.num_kv_heads // tp)
        width = cfg.intermediate_size // tp
        self.gate_proj = Linear(cfg.hidden_size, width)
        self.up_proj = Linear(cfg.hidden_size, width)
        self.down_proj = Linear(width, cfg.hidden_size)

    def mlp(self, x: torch.Tensor) -> torch.Tensor:
        return self.down_proj(nn.functional.silu(self.gate_proj(x)) * self.up_proj(x))


class _Shard(nn.Module):
    def __init__(self, cfg: DecoderConfig, tp: int) -> None:
        super().__init__()
        self.layers = nn.ModuleList(_ShardBlock(cfg, i, tp) for i in range(cfg.num_layers))


class _Norms(nn.Module):
    def __init__(self, cfg: DecoderConfig) -> None:
        super().__init__()
        self.input_ln = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.post_attn_ln = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)


class TPDecoderLM(nn.Module):
    """``(input_ids, positions, cache, valid_mask=None) -> logits [B, S, V]
    f32``, as :class:`~..models.decoder.DecoderLM`, over ``devices`` (one
    a shard; entries may repeat). Inputs and logits live on the first
    device. Build it with :func:`shard_decoder_params`."""

    def __init__(self, config: DecoderConfig, devices: list[torch.device], state: dict[str, torch.Tensor],
                 param_dtype: torch.dtype) -> None:
        super().__init__()
        cfg = self.config = config
        self.devices = [torch.device(d) for d in devices]
        tp = self.tp = len(self.devices)
        first = self.devices[0]
        lm_split = bool(decoder_param_spec("lm_head.weight", (cfg.vocab_size, cfg.hidden_size), tp=tp))
        self.head_devices = self.devices if lm_split else [first]
        with torch.device("meta"):
            self.embed = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
            self.norms = nn.ModuleList(_Norms(cfg) for _ in range(cfg.num_layers))
            self.final_ln = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
            self.shards = nn.ModuleList(_Shard(cfg, tp) for _ in range(tp))
            rows = cfg.vocab_size // len(self.head_devices)
            self.lm_head = nn.ModuleList(Linear(cfg.hidden_size, rows) for _ in self.head_devices)
        for module in (self.embed, self.norms, self.final_ln):
            module.to_empty(device=first)
        for modules, devs in ((self.shards, self.devices), (self.lm_head, self.head_devices)):
            for module, dev in zip(modules, devs):
                module.to_empty(device=dev)
        self.to(param_dtype)
        self._load(state)

    def _targets(self, name: str) -> list[nn.Parameter]:
        """The parameters that hold ``name`` of a full state dict: one a
        shard for split weights, else the one replica."""
        parts = name.split(".")
        if parts[0] == "lm_head":
            return [head.weight for head in self.lm_head]
        if parts[0] == "layers" and parts[2] not in _NORMS:
            return [shard.get_parameter(name) for shard in self.shards]
        return [self.get_parameter(name.replace("layers.", "norms.", 1))]

    @torch.no_grad()
    def _load(self, state: dict[str, torch.Tensor]) -> None:
        with torch.device("meta"):
            names = set(DecoderLM(self.config, device="meta").state_dict())
        if set(state) != names:
            raise ValueError(f"state dict keys differ from the decoder's: {sorted(set(state) ^ names)[:6]}")
        for name, full in state.items():
            targets = self._targets(name)
            parts = torch.as_tensor(full).chunk(len(targets), _split_dim(name)) if len(targets) > 1 else [full]
            for target, part in zip(targets, parts):
                target.copy_(part)

    @torch.no_grad()
    def gather_state_dict(self, device=None) -> dict[str, torch.Tensor]:
        """The full :class:`~..models.decoder.DecoderLM` state dict, the
        slices concatenated in shard order on ``device`` (default: the
        first)."""
        device = self.devices[0] if device is None else device
        out = {}
        for name, _ in self.shards[0].named_parameters():
            out[name] = all_gather([s.get_parameter(name) for s in self.shards], device, dim=_split_dim(name))
        out["lm_head.weight"] = all_gather([h.weight for h in self.lm_head], device, dim=0)
        for name, param in self.named_parameters():
            if not name.startswith(("shards.", "lm_head.")):
                out[name.replace("norms.", "layers.", 1)] = param.detach().to(device)
        return out

    def init_cache(self, batch: int, positions: int | None = None) -> TPKVCache:
        """An empty cache: each shard's kv heads on its device."""
        cfg = self.config
        shard_cfg = dataclasses.replace(cfg, num_kv_heads=cfg.num_kv_heads // self.tp)
        parts = [init_cache(shard_cfg, batch, dev, positions) for dev in self.devices]
        valid = torch.zeros((batch, positions or cfg.max_position), dtype=torch.bool, device=self.devices[0])
        return TPKVCache([p.k for p in parts], [p.v for p in parts], valid)

    def _psum(self, partials: list[torch.Tensor]) -> torch.Tensor:
        """A row-parallel block's output: the shards' partial sums added in
        f32 in shard order on the first device, cast once."""
        return reduce([p.float() for p in partials], self.devices[0]).to(partials[0].dtype)

    def forward(self, input_ids: torch.Tensor, positions: torch.Tensor, cache: TPKVCache,
                valid_mask: torch.Tensor | None = None) -> torch.Tensor:
        cfg = self.config
        mask = attention_mask(cache, input_ids, valid_mask)
        rope = _rope_tables(positions, cfg.head_dim, cfg.rope_theta)
        # each shard's copies of what every layer reads (nothing is copied on a repeated device)
        masks = [mask.to(d, non_blocking=True) for d in self.devices]
        ropes = [tuple(r.to(d, non_blocking=True) for r in rope) for d in self.devices]
        views = [cache.shard(t) for t in range(self.tp)]
        hidden = self.embed(input_ids).to(cfg.torch_dtype)
        for i, norms in enumerate(self.norms):
            x = norms.input_ln(hidden)
            hidden = hidden + self._psum([
                shard.layers[i].attn(x.to(d, non_blocking=True), ropes[t], masks[t], views[t])
                for t, (shard, d) in enumerate(zip(self.shards, self.devices))])
            x = norms.post_attn_ln(hidden)
            hidden = hidden + self._psum([shard.layers[i].mlp(x.to(d, non_blocking=True))
                                          for shard, d in zip(self.shards, self.devices)])
        x = self.final_ln(hidden)
        logits = all_gather([head(x.to(d, non_blocking=True)) for head, d in zip(self.lm_head, self.head_devices)],
                            self.devices[0], dim=-1).float()
        cache.length += input_ids.shape[1]
        return logits


def shard_decoder_params(model_or_state, mesh: Mesh | None = None, axis: str = "model", *,
                         config: DecoderConfig | None = None) -> TPDecoderLM:
    """A :class:`TPDecoderLM` over ``mesh``'s ``axis`` (default: a 1-D
    mesh of every local CUDA device) from a
    :class:`~..models.decoder.DecoderLM` (its config and parameter dtype)
    or a state dict of one (then ``config`` is required, and the
    parameters take its compute dtype). Raises as :func:`validate_tp`
    does."""
    mesh = mesh if mesh is not None else Mesh(local_devices(), (axis,))
    if isinstance(model_or_state, nn.Module):
        config, state = model_or_state.config, model_or_state.state_dict()
        param_dtype = model_or_state.embed.weight.dtype
    elif config is None:
        raise ValueError("a state dict needs its config")
    else:
        state, param_dtype = model_or_state, config.torch_dtype
    validate_tp(config, mesh, axis)
    return TPDecoderLM(config, axis_devices(mesh, axis), state, param_dtype)
