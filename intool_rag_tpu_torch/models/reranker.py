"""Cross-encoder reranker (BGE-reranker-v2-m3 class: XLM-R body + linear
relevance head on CLS; port of ``intool_rag_tpu/models/reranker.py``).

Pair scoring runs batched on the device, either length-bucketed (pairs
sorted by length, 64 at a time, each batch padded to its own multiple of
32) or packed (several pairs per fixed-width row behind block-diagonal
attention, ``RERANK_PACKED=1``; ``RERANK_PACK_WIDTH`` sets the row width).
Packed rows of 1,024 tokens and more take the encoder's flash-attention
route. The body keeps its weights in the compute dtype when it serves and
in f32 when it trains (``param_dtype``); the head is f32 in both.
"""

from __future__ import annotations

import dataclasses
import os
import threading

import numpy as np
import torch
from torch import nn

from .encoder import EncoderConfig, TextEncoder, load_torch_state_dict, params_from_jax
from .packing import build_packed_arrays, pack_bins, shrink_width
from .tokenizer import SimpleTokenizer


class CrossEncoder(nn.Module):
    """XLM-R body + HF-style sequence-classification head: raw CLS →
    dense + tanh → out_proj(1), the head in f32 (matches
    ``XLMRobertaForSequenceClassification``, so released bge-reranker-v2-m3
    weights map one to one).

    ``forward(input_ids, attention_mask)`` scores one pair per row, ``[B]``.
    With ``segment_ids [B, S]`` (ids 1..P, pads 0) and ``cls_index [B, P]``
    (each pair's first-token offset) it scores packed rows, ``[B, P]``:
    block-diagonal attention keeps the pairs apart, so a packed pair scores
    as it would alone."""

    def __init__(
        self,
        config: EncoderConfig,
        device: str | torch.device | None = None,
        param_dtype: torch.dtype | None = None,
    ) -> None:
        super().__init__()
        self.config = config
        self.body = TextEncoder(config, device=device, param_dtype=param_dtype)
        dev = next(self.body.parameters()).device
        self.head_dense = nn.Linear(config.hidden_size, config.hidden_size, device=dev)
        self.head_out = nn.Linear(config.hidden_size, 1, device=dev)

    @torch.no_grad()
    def init_head(self, generator: torch.Generator) -> "CrossEncoder":
        """Seeded random head: normal(0, 1/sqrt(fan_in)) weights, zero biases."""
        for lin in (self.head_dense, self.head_out):
            w = lin.weight
            w.copy_(torch.randn(w.shape, generator=generator, device=w.device) / w.shape[1] ** 0.5)
            lin.bias.zero_()
        return self

    def init_flax(self, generator: torch.Generator) -> "CrossEncoder":
        """Seeded random weights at flax's default scales (see
        :meth:`TextEncoder.init_flax`)."""
        self.body.init_flax(generator)
        return self.init_head(generator)

    def forward(
        self,
        input_ids: torch.Tensor,
        attention_mask: torch.Tensor,
        *,
        segment_ids: torch.Tensor | None = None,
        cls_index: torch.Tensor | None = None,
    ) -> torch.Tensor:
        hidden = self.body(input_ids, attention_mask, pool=False, segment_ids=segment_ids)
        if cls_index is not None:
            index = cls_index.long()[:, :, None].expand(-1, -1, hidden.shape[-1])
            cls = torch.gather(hidden, 1, index)  # [B, P, H]
        else:
            cls = hidden[:, 0, :]
        return self.head_out(torch.tanh(self.head_dense(cls)))[..., 0]


def reranker_params_from_jax(tree: dict) -> dict[str, torch.Tensor]:
    """The flax ``CrossEncoder`` params (nested numpy dicts, with or without
    the top-level ``"params"`` key) as :class:`CrossEncoder`'s state dict:
    ``body/...`` through the encoder's mapping, the two head layers beside it."""
    inner = tree.get("params", tree)
    missing = {"body", "head_dense", "head_out"} - set(inner)
    if missing:
        raise ValueError(f"not a CrossEncoder tree: missing {sorted(missing)}")
    return params_from_jax(inner)


def load_reranker_torch_state_dict(config: EncoderConfig, state_dict: dict) -> dict[str, torch.Tensor]:
    """Map an HF ``XLMRobertaForSequenceClassification`` state dict
    (prefix ``roberta.``, head ``classifier.dense`` / ``classifier.out_proj``)
    onto :class:`CrossEncoder`'s."""
    prefix = "roberta."
    body = load_torch_state_dict(
        config, {k[len(prefix):]: v for k, v in state_dict.items() if k.startswith(prefix)}
    )
    out = {f"body.{k}": v for k, v in body.items()}
    for dst, src in (("head_dense", "classifier.dense"), ("head_out", "classifier.out_proj")):
        for leaf in ("weight", "bias"):
            out[f"{dst}.{leaf}"] = torch.as_tensor(state_dict[f"{src}.{leaf}"]).detach().float()
    return out


@dataclasses.dataclass
class Reranker:
    """Pair scorer: (query, passage) → relevance, higher is better."""

    model: CrossEncoder
    tokenizer: object

    def __post_init__(self) -> None:
        self.model.eval()
        self.config = self.model.config
        self.device = next(self.model.parameters()).device
        self.packed = os.getenv("RERANK_PACKED", "0") not in ("0", "false", "")
        self.pack_width = int(os.getenv("RERANK_PACK_WIDTH", "512"))
        self.last_padding_waste = 0.0
        # the tokenizer memo and the module are shared by service threads
        self._lock = threading.Lock()

    @classmethod
    def create(
        cls,
        config: EncoderConfig | None = None,
        tokenizer=None,
        params: dict | None = None,
        seed: int = 0,
        device: str | torch.device | None = None,
    ) -> "Reranker":
        """A serving reranker: the body's weights resident in the compute
        dtype, the head in f32. ``params`` is a :class:`CrossEncoder` state
        dict (f32 values are cast on load); without it the weights are
        random from ``seed``."""
        config = config or EncoderConfig.tiny()
        model = CrossEncoder(config, device=device)
        if params is None:
            dev = next(model.parameters()).device
            model.init_flax(torch.Generator(device=dev).manual_seed(seed))
        else:
            model.load_state_dict(params)
        return cls(
            model=model,
            # bounded by the model's positions, not the tokenizer's default
            tokenizer=tokenizer
            or SimpleTokenizer(vocab_size=config.vocab_size, max_length=min(512, config.max_position - 2)),
        )

    def _pair_rows(self, queries: list[str], passages: list[str]) -> list[list[int]]:
        tok = self.tokenizer
        ids_q, _ = tok.encode_batch(queries)
        ids_p, _ = tok.encode_batch(passages)
        sep = getattr(tok, "sep_id", 2)
        pad = tok.pad_id
        rows = []
        for q_row, p_row in zip(ids_q, ids_p):
            q_real = [t for t in q_row.tolist() if t != pad]
            p_real = [t for t in p_row.tolist() if t != pad][1:]  # drop CLS
            rows.append(q_real + [sep] + p_real)
        return rows

    def _dev(self, array: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(array, device=self.device)

    @torch.no_grad()
    def score_pairs_packed(
        self, queries: list[str], passages: list[str], *, width: int | None = None
    ) -> np.ndarray:
        """Score aligned pairs through ragged packing: first-fit-decreasing
        bins of fixed ``width`` rows, block-diagonal attention (segment
        ids), one CLS gather per pair. The layouts are mathematically
        identical; in f32 the scores match the bucketed path to rounding."""
        if not queries:
            return np.zeros(0, np.float32)
        with self._lock:
            pad = self.tokenizer.pad_id
            rows = self._pair_rows(queries, passages)
            w = width or self.pack_width
            w = max(w, -(-max(len(r) for r in rows) // 128) * 128)
            bins = pack_bins([len(r) for r in rows], w)
            w = shrink_width(bins, w)
            # rows per launch: about the tokens of one 64 x 192 bucket
            r_launch = max(1, (64 * 192) // w)
            real_tokens = sum(min(len(r), w) for r in rows)
            padded_tokens = 0
            pending: list[tuple[np.ndarray, torch.Tensor]] = []
            for s in range(0, len(bins), r_launch):
                ids, seg, cls, idxmat = build_packed_arrays(rows, bins[s : s + r_launch], w, pad)
                padded_tokens += ids.shape[0] * w
                seg_t = self._dev(seg)
                pending.append((idxmat, self.model(
                    self._dev(ids), (seg_t > 0).to(torch.int32), segment_ids=seg_t, cls_index=self._dev(cls),
                )))
        scores = np.zeros(len(rows), np.float32)
        for idxmat, out in pending:  # every launch is dispatched before any result is read
            valid = idxmat >= 0
            scores[idxmat[valid]] = out.float().cpu().numpy()[valid]
        self.last_padding_waste = padded_tokens / max(real_tokens, 1) - 1.0
        return scores

    @torch.no_grad()
    def score_pairs(
        self,
        queries: list[str],
        passages: list[str],
        *,
        bucket: int = 64,
        packed: bool | None = None,
    ) -> np.ndarray:
        """Score aligned (query, passage) pairs → [N] f32.

        Pairs are length-bucketed: sorted by token length, batched
        ``bucket`` at a time, each batch padded to its own multiple of 32,
        so padding waste stays bounded for natural length distributions
        (against padding all N pairs to the global maximum)."""
        if packed is None:
            packed = self.packed
        if packed:
            return self.score_pairs_packed(queries, passages)
        if not queries:
            return np.zeros(0, np.float32)
        with self._lock:
            pad = self.tokenizer.pad_id
            rows = self._pair_rows(queries, passages)
            order = sorted(range(len(rows)), key=lambda i: len(rows[i]))
            real_tokens = padded_tokens = 0
            pending: list[tuple[list[int], torch.Tensor]] = []
            for s in range(0, len(order), bucket):
                idx = order[s : s + bucket]
                chunk = [rows[i] for i in idx]
                width = -(-max(len(r) for r in chunk) // 32) * 32
                ids = np.full((len(idx), width), pad, np.int32)
                mask = np.zeros((len(idx), width), np.int32)
                for j, r in enumerate(chunk):
                    r = r[:width]
                    ids[j, : len(r)] = r
                    mask[j, : len(r)] = 1
                pending.append((idx, self.model(self._dev(ids), self._dev(mask))))
                real_tokens += sum(min(len(r), width) for r in chunk)
                padded_tokens += len(idx) * width
        scores = np.zeros(len(rows), np.float32)
        for idx, out in pending:  # every bucket is dispatched before any result is read
            scores[idx] = out.float().cpu().numpy()[: len(idx)]
        self.last_padding_waste = padded_tokens / max(real_tokens, 1) - 1.0
        return scores

    def rerank(self, query: str, candidates: list[dict], top_k: int, text_key: str = "text") -> list[dict]:
        """Rerank candidate hit dicts, returning the top_k with scores in
        ``rerank_score`` (retrieve-100 → rerank-10 per config)."""
        if not candidates:
            return []
        scores = self.score_pairs([query] * len(candidates), [c[text_key] for c in candidates])
        order = np.argsort(-scores)[:top_k]
        out = []
        for rank, i in enumerate(order):
            hit = dict(candidates[int(i)])
            hit["rerank_score"] = float(scores[int(i)])
            hit["rerank_position"] = rank
            out.append(hit)
        return out
