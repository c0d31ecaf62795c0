"""Transformer text encoder, XLM-RoBERTa architecture (port of
``intool_rag_tpu/models/encoder.py``).

- RoBERTa positions: ``cumsum(mask)·mask + pad_token_id``, restarting at
  each segment of a packed row;
- post-LayerNorm blocks (attention → add & LN → exact-GELU MLP → add & LN);
- attention by one of three routes, chosen from the shape and the config
  alone: rows of ``S >= flash_min_len`` with ``S % 128 == 0`` go through
  :func:`..ops.flash_attention.flash_attention_segments` (the CUDA kernel on
  the card, its plain version on the CPU), packed or not; shorter packed
  rows build the pairwise segment mask; the rest mask pad keys;
- CLS pooling and L2 normalization (``[B, H] f32``, or ``[B, P, H]`` for the
  P segments of packed rows), or the last hidden state (``pool=False``).

On the flash route a pad query attends to the pad keys only, on the key-mask
route to the valid keys, so hidden states at pad positions differ between
routes (in both packages); only valid positions are ever read.

Sequence parallelism (``parallel/sequence.py``) runs each layer around an
outside attention, ring attention across the shards: it drives the pieces
:meth:`TextEncoder.embed`, :meth:`SelfAttention.project`,
:meth:`SelfAttention.output` and :meth:`EncoderLayer.finish` itself. The
JAX config's ``ring_axis`` field has no counterpart here: the caller of
``sp_encode_fn`` picks the ring, no module reads it from its config. The
tensor-parallel train step (``train/contrastive.py``) runs an
:class:`EncoderLayer` of ``H/tp`` heads and ``I/tp`` hidden units on each
shard's slices (:meth:`SelfAttention.context`, :meth:`EncoderLayer.up`,
:meth:`Linear.partial`), and sums the shards' partials itself.

Parameters live in ``param_dtype``. Serving keeps them in the compute
dtype (bf16-resident weights, read once per forward). Training builds the
model with ``param_dtype=torch.float32``: f32 master weights that every
layer casts to the compute dtype at the point of use, as flax does with
its f32 params, so the arithmetic of a forward is the same bit for bit and
the optimizer updates f32 values. There is no dropout in either package, so
``train()`` and ``eval()`` compute the same.

Parameters load from the JAX package's flax checkpoints through
:func:`load_encoder_checkpoint` + :func:`params_from_jax` (no flax
needed), and go back through :func:`params_to_jax` +
:func:`save_encoder_checkpoint`, which writes a file both packages open. LayerNorm here is torch's two-pass variance where flax computes
``E[x²] − E[x]²``; in f32 the two agree to ~1e-7 relative.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np
import torch
from torch import nn

from ..device import resolve_device
from ..ops.flash_attention import flash_attention_segments


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    vocab_size: int = 250_002
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    intermediate_size: int = 4096
    max_position: int = 8194
    type_vocab_size: int = 1
    pad_token_id: int = 1
    layer_norm_eps: float = 1e-5
    dtype: str = "bfloat16"  # compute dtype (and the parameters', unless param_dtype is given)
    # rows at least this long take the flash-attention route (no [S, S]
    # logits, which BGE-M3's 8192-token inputs need); 0 disables it
    flash_min_len: int = 1024

    @classmethod
    def bge_m3(cls) -> "EncoderConfig":
        return cls()

    @classmethod
    def tiny(cls) -> "EncoderConfig":
        """Small config for tests and CPU runs."""
        return cls(
            vocab_size=1024, hidden_size=64, num_layers=2, num_heads=4,
            intermediate_size=128, max_position=130, dtype="float32",
        )

    @property
    def torch_dtype(self) -> torch.dtype:
        return {"float32": torch.float32, "bfloat16": torch.bfloat16}[self.dtype]


class Linear(nn.Linear):
    """``nn.Linear`` that computes in its input's dtype: master weights of
    another dtype are cast at the point of use (a no-op when they match)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return nn.functional.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))

    def partial(self, x: torch.Tensor) -> torch.Tensor:
        """The product without the bias: a row-parallel shard's share of the
        full one, which the shards' sum completes (``train/contrastive.py``)."""
        return nn.functional.linear(x, self.weight.to(x.dtype))


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` that computes in its input's dtype (see :class:`Linear`)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return nn.functional.layer_norm(
            x, self.normalized_shape, self.weight.to(x.dtype), self.bias.to(x.dtype), self.eps
        )


class Embedding(nn.Embedding):
    """``nn.Embedding`` whose rows come out in ``dtype``. The cast follows
    the gather, so a master table is never cast whole; the values equal
    those of a table cast first."""

    def forward(self, ids: torch.Tensor, dtype: torch.dtype | None = None) -> torch.Tensor:
        return nn.functional.embedding(ids, self.weight).to(dtype or self.weight.dtype)


def heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """``[B, S, H·dh]`` as a ``[B, H, S, dh]`` view: nothing is copied."""
    b, s, width = x.shape
    return x.view(b, s, num_heads, width // num_heads).transpose(1, 2)


def attend(q, k, v, mask: torch.Tensor, segment_ids: torch.Tensor | None, flash_min_len: int) -> torch.Tensor:
    """Attention of ``[B, H, S, dh]`` heads by the route the shape and
    ``flash_min_len`` choose (module docstring), ``[B, H, S, dh]``."""
    s, dh = q.shape[2], q.shape[3]
    if flash_min_len and s >= flash_min_len and s % 128 == 0:
        # pads carry segment id 0 (valid tokens 1, or 1..P in a packed
        # row), so they attend among themselves and no row is empty
        seg = (mask if segment_ids is None else segment_ids).to(torch.int32).contiguous()
        return flash_attention_segments(q, k, v, seg, seg, 1.0 / dh**0.5)
    if segment_ids is not None:
        keep = (segment_ids[:, :, None] == segment_ids[:, None, :])[:, None]  # [B, 1, S, S]
    else:
        keep = mask[:, None, None, :].bool()
    logits = (q.float() @ k.float().transpose(-1, -2)) / dh**0.5
    logits = logits.masked_fill(~keep, torch.finfo(torch.float32).min)
    return torch.softmax(logits, dim=-1).to(v.dtype) @ v


def merge_heads(attn: torch.Tensor) -> torch.Tensor:
    """``[B, H, S, dh]`` back to ``[B, S, H·dh]``."""
    b, nh, s, dh = attn.shape
    return attn.transpose(1, 2).reshape(b, s, nh * dh)


class SelfAttention(nn.Module):
    """One layer's attention over ``num_heads`` heads (default: the
    config's; a tensor-parallel shard holds a slice of them,
    ``train/contrastive.py``). ``output`` maps the heads back to the full
    hidden width."""

    def __init__(self, cfg: EncoderConfig, num_heads: int | None = None) -> None:
        super().__init__()
        self.num_heads = num_heads or cfg.num_heads
        self.flash_min_len = cfg.flash_min_len
        h = cfg.hidden_size
        width = self.num_heads * (h // cfg.num_heads)
        self.query = Linear(h, width)
        self.key = Linear(h, width)
        self.value = Linear(h, width)
        self.output = Linear(width, h)

    def project(self, hidden: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """q, k and v as ``[B, H, S, dh]`` views of their projections."""
        return tuple(heads(proj(hidden), self.num_heads) for proj in (self.query, self.key, self.value))

    def context(
        self, hidden: torch.Tensor, mask: torch.Tensor, segment_ids: torch.Tensor | None = None
    ) -> torch.Tensor:
        """The heads' attention, merged: ``[B, S, H·dh]``, the output
        projection's input."""
        return merge_heads(attend(*self.project(hidden), mask, segment_ids, self.flash_min_len))

    def forward(
        self, hidden: torch.Tensor, mask: torch.Tensor, segment_ids: torch.Tensor | None = None
    ) -> torch.Tensor:
        return self.output(self.context(hidden, mask, segment_ids))


class EncoderLayer(nn.Module):
    """One post-LayerNorm block; ``num_heads`` and ``intermediate_size``
    (default: the config's) give a tensor-parallel shard's slice."""

    def __init__(self, cfg: EncoderConfig, num_heads: int | None = None,
                 intermediate_size: int | None = None) -> None:
        super().__init__()
        h, width = cfg.hidden_size, intermediate_size or cfg.intermediate_size
        self.attention = SelfAttention(cfg, num_heads)
        self.attention_ln = LayerNorm(h, eps=cfg.layer_norm_eps)
        self.intermediate = Linear(h, width)
        self.mlp_output = Linear(width, h)
        self.output_ln = LayerNorm(h, eps=cfg.layer_norm_eps)

    def forward(
        self, hidden: torch.Tensor, mask: torch.Tensor, segment_ids: torch.Tensor | None = None
    ) -> torch.Tensor:
        return self.finish(hidden, self.attention(hidden, mask, segment_ids))

    def finish(self, hidden: torch.Tensor, attn_out: torch.Tensor) -> torch.Tensor:
        """The rest of the layer after the attention's output projection:
        add & LayerNorm, the MLP, add & LayerNorm."""
        hidden = self.attention_ln(hidden + attn_out)
        return self.output_ln(hidden + self.mlp_output(self.up(hidden)))

    def up(self, hidden: torch.Tensor) -> torch.Tensor:
        """The MLP's hidden units: exact GELU of the first projection."""
        return nn.functional.gelu(self.intermediate(hidden), approximate="none")


class TextEncoder(nn.Module):
    """``forward(input_ids [B, S], attention_mask [B, S])`` → L2-normalized
    CLS embeddings ``[B, H] f32``; with ``segment_ids`` and ``cls_index``
    (packed rows, ``models/packing.py``) one embedding per segment,
    ``[B, P, H]``; with ``pool=False`` the last hidden state ``[B, S, H]``
    f32. Parameters are created on ``device`` in ``param_dtype`` (default:
    the config's compute dtype; ``torch.float32`` for training with f32
    master weights); they are uninitialized until :meth:`init_random` or
    ``load_state_dict``."""

    def __init__(
        self,
        config: EncoderConfig,
        device: str | torch.device | None = None,
        param_dtype: torch.dtype | None = None,
    ) -> None:
        super().__init__()
        self.config = config
        cfg = config
        with torch.device("meta"):
            self.word_emb = Embedding(cfg.vocab_size, cfg.hidden_size)
            self.pos_emb = Embedding(cfg.max_position, cfg.hidden_size)
            self.type_emb = Embedding(cfg.type_vocab_size, cfg.hidden_size)
            self.emb_ln = LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
            self.layers = nn.ModuleList(EncoderLayer(cfg) for _ in range(cfg.num_layers))
        self.to_empty(device=resolve_device(device))
        self.to(param_dtype or cfg.torch_dtype)

    @torch.no_grad()
    def init_random(self, generator: torch.Generator, std: float = 0.02) -> "TextEncoder":
        """Seeded random weights: normal(0, std) matrices and embeddings,
        zero biases, unit LayerNorm scales."""
        for name, p in self.named_parameters():
            if name.endswith("bias"):
                p.zero_()
            elif "_ln" in name:
                p.fill_(1.0)
            else:
                p.copy_(torch.randn(p.shape, generator=generator, device=p.device) * std)
        return self

    @torch.no_grad()
    def init_flax(self, generator: torch.Generator) -> "TextEncoder":
        """Seeded random weights with the scales of the JAX package's
        ``init_params`` (flax's defaults): matrices normal(0, 1/sqrt(fan_in)),
        embeddings normal(0, 1/sqrt(hidden)), zero biases, unit LayerNorm
        scales. Training from scratch starts here."""
        for name, p in self.named_parameters():
            if name.endswith("bias"):
                p.zero_()
            elif "_ln" in name:
                p.fill_(1.0)
            else:
                p.copy_(torch.randn(p.shape, generator=generator, device=p.device) / p.shape[1] ** 0.5)
        return self

    def forward(
        self,
        input_ids: torch.Tensor,
        attention_mask: torch.Tensor,
        *,
        pool: bool = True,
        positions: torch.Tensor | None = None,
        segment_ids: torch.Tensor | None = None,
        cls_index: torch.Tensor | None = None,
    ) -> torch.Tensor:
        cfg = self.config
        mask = attention_mask.long()
        if positions is None and segment_ids is not None:
            # packed rows: positions restart at each segment, so a packed
            # text sees the position ids it would see alone. Segments are
            # contiguous: subtract the running valid count at each segment's
            # start (carried forward by cummax) from the global running count.
            seg = segment_ids.long()
            valid = (seg > 0).long()
            c = torch.cumsum(valid, dim=1)
            change = torch.cat([torch.ones_like(seg[:, :1], dtype=torch.bool), seg[:, 1:] != seg[:, :-1]], dim=1)
            base = torch.where(change, c - valid, torch.zeros_like(c))
            positions = (c - torch.cummax(base, dim=1).values) * valid + cfg.pad_token_id
        elif positions is None:
            positions = roberta_positions(mask, cfg.pad_token_id)
        hidden = self.embed(input_ids, positions)
        for layer in self.layers:
            hidden = layer(hidden, mask, segment_ids)
        if not pool:
            return hidden.float()
        if cls_index is not None:  # each segment's first token -> [B, P, H]
            index = cls_index.long()[:, :, None].expand(-1, -1, hidden.shape[-1])
            return l2_normalize(torch.gather(hidden, 1, index).float())
        return l2_normalize(hidden[:, 0, :].float())

    def embed(self, input_ids: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        """Word + position + type embeddings, LayerNormed, in the compute
        dtype: the first layer's input."""
        dtype = self.config.torch_dtype
        hidden = (
            self.word_emb(input_ids.long(), dtype)
            + self.pos_emb(positions.long(), dtype)
            + self.type_rows(input_ids, dtype)
        )
        return self.emb_ln(hidden)

    def type_rows(self, input_ids: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """The type embeddings of ``input_ids``' tokens: every type id is 0."""
        return self.type_emb(torch.zeros_like(input_ids, dtype=torch.long), dtype)


def roberta_positions(mask: torch.Tensor, pad_token_id: int) -> torch.Tensor:
    """RoBERTa position ids of ``[B, S]`` rows: ``cumsum(mask)·mask +
    pad_token_id`` (valid tokens count from ``pad_token_id + 1``, pads sit
    at ``pad_token_id``)."""
    return torch.cumsum(mask, dim=1) * mask + pad_token_id


def l2_normalize(x: torch.Tensor) -> torch.Tensor:
    """Rows of unit L2 norm (a zero row stays zero)."""
    return x / x.norm(dim=-1, keepdim=True).clamp_min(1e-9)


def params_from_jax(tree: dict) -> dict[str, torch.Tensor]:
    """Map the JAX encoder's params (nested numpy dicts, with or without
    the top-level ``"params"`` key) onto :class:`TextEncoder`'s state dict:
    ``kernel`` → ``weight.T``, ``scale`` → LayerNorm ``weight``,
    ``embedding`` → ``Embedding.weight``."""
    tree = tree.get("params", tree)
    out: dict[str, torch.Tensor] = {}

    def walk(node, prefix):
        for key, val in node.items():
            name = key
            if key.startswith("layer_") and key[6:].isdigit():
                name = f"layers.{key[6:]}"
            if isinstance(val, dict):
                walk(val, f"{prefix}{name}.")
                continue
            arr = np.asarray(val, np.float32)
            if key == "kernel":
                arr, name = arr.T, "weight"
            elif key in ("scale", "embedding"):
                name = "weight"
            out[f"{prefix}{name}"] = torch.tensor(arr)

    walk(tree, "")
    return out


def load_torch_state_dict(config: EncoderConfig, state_dict: dict) -> dict[str, torch.Tensor]:
    """Map an HF ``XLMRobertaModel`` state dict (tensors or numpy arrays)
    onto :class:`TextEncoder`'s: released BGE-M3 weights load through this
    when they are available locally. Only names change; both sides store
    ``nn.Linear`` weights as ``[out, in]``."""

    def t(name):
        return torch.as_tensor(state_dict[name]).detach().float()

    out: dict[str, torch.Tensor] = {}

    def put(dst: str, src: str) -> None:
        out[f"{dst}.weight"], out[f"{dst}.bias"] = t(f"{src}.weight"), t(f"{src}.bias")

    out["word_emb.weight"] = t("embeddings.word_embeddings.weight")
    out["pos_emb.weight"] = t("embeddings.position_embeddings.weight")
    out["type_emb.weight"] = t("embeddings.token_type_embeddings.weight")
    put("emb_ln", "embeddings.LayerNorm")
    for i in range(config.num_layers):
        src, dst = f"encoder.layer.{i}", f"layers.{i}"
        for name in ("query", "key", "value"):
            put(f"{dst}.attention.{name}", f"{src}.attention.self.{name}")
        put(f"{dst}.attention.output", f"{src}.attention.output.dense")
        put(f"{dst}.attention_ln", f"{src}.attention.output.LayerNorm")
        put(f"{dst}.intermediate", f"{src}.intermediate.dense")
        put(f"{dst}.mlp_output", f"{src}.output.dense")
        put(f"{dst}.output_ln", f"{src}.output.LayerNorm")
    return out


def params_to_jax(state_dict: dict[str, torch.Tensor]) -> dict:
    """Inverse of :func:`params_from_jax`: a :class:`TextEncoder` state dict
    as the JAX encoder's ``{"params": ...}`` tree of f32 numpy arrays."""
    tree: dict = {}
    for name, tensor in state_dict.items():
        *path, leaf = name.split(".")
        if path[0] == "layers":
            path = [f"layer_{path[1]}", *path[2:]]
        arr = tensor.detach().float().cpu().numpy()
        if leaf == "weight":
            if path[-1].endswith("_emb"):
                leaf = "embedding"
            elif path[-1].endswith("_ln"):
                leaf = "scale"
            else:
                leaf, arr = "kernel", arr.T
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = np.ascontiguousarray(arr)
    return {"params": tree}


def save_encoder_checkpoint(path, model: "TextEncoder", *, store_dtype: str = "float32") -> None:
    """Persist an encoder (config + parameters) as one npz in the JAX
    package's checkpoint format, so both packages' ``load_encoder_checkpoint``
    open it. ``store_dtype="float16"`` halves the file; loading restores f32."""
    from .msgpack import packb

    dt = np.dtype(store_dtype)

    def cast(node):
        if isinstance(node, dict):
            return {k: cast(v) for k, v in node.items()}
        return node.astype(dt) if node.dtype == np.float32 else node

    meta = dataclasses.asdict(model.config)
    meta["ring_axis"] = None  # the JAX config's sequence-parallel field: sp_encode_fn picks the ring here
    np.savez_compressed(
        Path(path),
        meta=np.frombuffer(json.dumps(meta).encode("utf-8"), np.uint8),
        params=np.frombuffer(packb(cast(params_to_jax(model.state_dict()))), np.uint8),
    )


def load_encoder_checkpoint(path) -> tuple[EncoderConfig, dict]:
    """Read a checkpoint written by the JAX package's
    ``save_encoder_checkpoint``: ``(config, params tree of f32 numpy)``.
    Every field of the checkpoint's config is carried over but ``ring_axis``
    (``parallel/sequence.py::sp_encode_fn`` takes the ring from its caller,
    not from a config). Raises ``FileNotFoundError`` for a missing file."""
    from .msgpack import unpackb

    path = Path(path)
    if not path.exists():
        raise FileNotFoundError(f"encoder checkpoint {path} not found")
    with np.load(path) as z:
        meta = json.loads(bytes(z["meta"]).decode("utf-8"))
        tree = unpackb(bytes(z["params"]))
    known = {f.name for f in dataclasses.fields(EncoderConfig)}
    config = EncoderConfig(**{k: v for k, v in meta.items() if k in known})

    def to_f32(node):
        if isinstance(node, dict):
            return {k: to_f32(v) for k, v in node.items()}
        return node.astype(np.float32) if node.dtype == np.float16 else node

    return config, to_f32(tree)


def load_encoder(path, device: str | torch.device | None = None) -> TextEncoder:
    """A :class:`TextEncoder` with a checkpoint's weights, on ``device``."""
    config, tree = load_encoder_checkpoint(path)
    model = TextEncoder(config, device=device)
    model.load_state_dict(params_from_jax(tree))
    return model.eval()
