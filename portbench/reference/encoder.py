"""XLM-RoBERTa encoder forward (BGE-M3's dense embedding), plain PyTorch in
float32 with TF32 off: word + RoBERTa position (cumsum of the mask, offset
by the pad id) + type embeddings and LayerNorm; post-LayerNorm layers
(self-attention over the valid keys, exact GELU MLP); the CLS state, L2
normalised. With ``control`` every matrix product takes int8 operands
(symmetric; weights per output row, activations per tensor), the
precision below the configuration's bf16.
"""

from __future__ import annotations

import contextlib

import torch

from .text import PAD


@contextlib.contextmanager
def exact_f32():
    """float32 products on the CUDA cores (no TF32) while inside."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def int_rows(x: torch.Tensor, bits: int = 8) -> torch.Tensor:
    """``x`` rounded to symmetric ``bits``-bit integers per row (last axis),
    as f32."""
    top = float(2 ** (bits - 1) - 1)
    scale = x.abs().amax(dim=-1, keepdim=True).clamp_min(1e-12) / top
    return torch.round(x / scale).clamp(-top, top) * scale


def int_tensor(x: torch.Tensor, bits: int = 8) -> torch.Tensor:
    """``x`` rounded to symmetric ``bits``-bit integers with one scale, as f32."""
    top = float(2 ** (bits - 1) - 1)
    scale = x.abs().amax().clamp_min(1e-12) / top
    return torch.round(x / scale).clamp(-top, top) * scale


def _linear(x, w, b, control):
    w = w.float()
    if control:
        x, w = int_tensor(x), int_rows(w)
    return x @ w.T + b.float()


def _layer_norm(x, w, b, eps):
    return torch.nn.functional.layer_norm(x, (x.shape[-1],), w.float(), b.float(), eps)


def encode(weights: dict[str, torch.Tensor], model: dict, ids: list[list[int]], *, control: bool = False,
           block: int = 256) -> torch.Tensor:
    """Unit CLS embeddings ``[len(ids), hidden]`` f32 of token-id rows."""
    dev = weights["embeddings.word_embeddings.weight"].device
    eps, heads, pad = model["layer_norm_eps"], model["num_attention_heads"], model["pad_token_id"]
    out = []
    with exact_f32(), torch.no_grad():
        for start in range(0, len(ids), block):
            rows = ids[start : start + block]
            s = max(len(r) for r in rows)
            tok = torch.full((len(rows), s), PAD, dtype=torch.long)
            for i, r in enumerate(rows):
                tok[i, : len(r)] = torch.tensor(r)
            tok = tok.to(dev)
            mask = (torch.arange(s)[None, :] < torch.tensor([len(r) for r in rows])[:, None]).to(dev)
            pos = torch.cumsum(mask.long(), 1) * mask.long() + pad
            x = (weights["embeddings.word_embeddings.weight"][tok].float()
                 + weights["embeddings.position_embeddings.weight"][pos].float()
                 + weights["embeddings.token_type_embeddings.weight"][0].float())
            x = _layer_norm(x, weights["embeddings.LayerNorm.weight"], weights["embeddings.LayerNorm.bias"], eps)
            b, h = x.shape[0], x.shape[2]
            dh = h // heads
            for li in range(model["num_hidden_layers"]):
                p = f"encoder.layer.{li}."

                def lin(name, v):
                    return _linear(v, weights[p + name + ".weight"], weights[p + name + ".bias"], control)

                q, k, v = (lin(f"attention.self.{n}", x).view(b, s, heads, dh).transpose(1, 2)
                           for n in ("query", "key", "value"))
                logits = (q @ k.transpose(-1, -2)) / dh**0.5
                logits = logits.masked_fill(~mask[:, None, None, :], float("-inf"))
                ctx = (torch.softmax(logits, dim=-1) @ v).transpose(1, 2).reshape(b, s, h)
                x = _layer_norm(x + lin("attention.output.dense", ctx), weights[p + "attention.output.LayerNorm.weight"],
                                weights[p + "attention.output.LayerNorm.bias"], eps)
                mlp = lin("output.dense", torch.nn.functional.gelu(lin("intermediate.dense", x)))
                x = _layer_norm(x + mlp, weights[p + "output.LayerNorm.weight"], weights[p + "output.LayerNorm.bias"], eps)
            cls = x[:, 0]
            out.append(cls / cls.norm(dim=1, keepdim=True))
    return torch.cat(out)
