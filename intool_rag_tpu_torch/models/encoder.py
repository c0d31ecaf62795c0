"""Transformer text encoder, XLM-RoBERTa architecture (port of the
unpacked path of ``intool_rag_tpu/models/encoder.py``).

- RoBERTa positions: ``cumsum(mask)·mask + pad_token_id``;
- post-LayerNorm blocks (attention → add & LN → exact-GELU MLP → add & LN);
- masked attention logits set to the dtype's most negative value;
- CLS pooling and L2 normalization (``[B, H] f32``).

Parameters load from the JAX package's flax checkpoints through
:func:`load_encoder_checkpoint` + :func:`params_from_jax` (no flax
needed). LayerNorm here is torch's two-pass variance where flax computes
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
    dtype: str = "bfloat16"  # compute (and here storage) dtype

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


class SelfAttention(nn.Module):
    def __init__(self, cfg: EncoderConfig) -> None:
        super().__init__()
        self.num_heads = cfg.num_heads
        h = cfg.hidden_size
        self.query = nn.Linear(h, h)
        self.key = nn.Linear(h, h)
        self.value = nn.Linear(h, h)
        self.output = nn.Linear(h, h)

    def forward(self, hidden: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        b, s, h = hidden.shape
        dh = h // self.num_heads

        def heads(x):
            return x.reshape(b, s, self.num_heads, dh).transpose(1, 2)  # [B, H, S, dh]

        q, k, v = heads(self.query(hidden)), heads(self.key(hidden)), heads(self.value(hidden))
        logits = (q.float() @ k.float().transpose(-1, -2)) / dh**0.5
        logits = logits.masked_fill(~mask[:, None, None, :].bool(), torch.finfo(torch.float32).min)
        probs = torch.softmax(logits, dim=-1).to(v.dtype)
        attn = (probs @ v).transpose(1, 2).reshape(b, s, h)
        return self.output(attn)


class EncoderLayer(nn.Module):
    def __init__(self, cfg: EncoderConfig) -> None:
        super().__init__()
        h = cfg.hidden_size
        self.attention = SelfAttention(cfg)
        self.attention_ln = nn.LayerNorm(h, eps=cfg.layer_norm_eps)
        self.intermediate = nn.Linear(h, cfg.intermediate_size)
        self.mlp_output = nn.Linear(cfg.intermediate_size, h)
        self.output_ln = nn.LayerNorm(h, eps=cfg.layer_norm_eps)

    def forward(self, hidden: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        hidden = self.attention_ln(hidden + self.attention(hidden, mask))
        mlp = self.mlp_output(nn.functional.gelu(self.intermediate(hidden), approximate="none"))
        return self.output_ln(hidden + mlp)


class TextEncoder(nn.Module):
    """``forward(input_ids [B, S], attention_mask [B, S])`` → L2-normalized
    CLS embeddings ``[B, H] f32``. Parameters are created on ``device`` in
    the config's dtype; they are uninitialized until
    :meth:`init_random` or ``load_state_dict``."""

    def __init__(self, config: EncoderConfig, device: str | torch.device | None = None) -> None:
        super().__init__()
        self.config = config
        cfg = config
        with torch.device("meta"):
            self.word_emb = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
            self.pos_emb = nn.Embedding(cfg.max_position, cfg.hidden_size)
            self.type_emb = nn.Embedding(cfg.type_vocab_size, cfg.hidden_size)
            self.emb_ln = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
            self.layers = nn.ModuleList(EncoderLayer(cfg) for _ in range(cfg.num_layers))
        self.to_empty(device=resolve_device(device))
        self.to(cfg.torch_dtype)

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

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        mask = attention_mask.long()
        positions = torch.cumsum(mask, dim=1) * mask + cfg.pad_token_id
        hidden = (
            self.word_emb(input_ids.long())
            + self.pos_emb(positions)
            + self.type_emb(torch.zeros_like(input_ids, dtype=torch.long))
        )
        hidden = self.emb_ln(hidden)
        for layer in self.layers:
            hidden = layer(hidden, mask)
        cls = hidden[:, 0, :].float()
        return cls / cls.norm(dim=-1, keepdim=True).clamp_min(1e-9)


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


def load_encoder_checkpoint(path) -> tuple[EncoderConfig, dict]:
    """Read a checkpoint written by the JAX package's
    ``save_encoder_checkpoint``: ``(config, params tree of f32 numpy)``.
    Raises ``FileNotFoundError`` for a missing file."""
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
