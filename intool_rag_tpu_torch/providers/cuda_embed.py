"""Embedding provider: batched encoder inference on the GPU (port of
``intool_rag_tpu/providers/tpu_embed.py``).

Batches pad to the same (batch, sequence) buckets as the JAX provider, or,
with ``EMBED_PACKED=1``, pack several texts into each fixed-width row
behind block-diagonal attention (``models/packing.py``;
``EMBED_PACK_WIDTH`` sets the row width, default 512). Rows of 1,024 tokens
and more, packed or padded, take the encoder's flash-attention route.
Weights: an encoder passed in, else the checkpoint named by the
``checkpoint`` argument or ``EMBEDDING_CHECKPOINT`` (a path that does not
exist raises), else, as in the JAX package, random weights of the
``EMBEDDING_PRESET`` size, drawn from a seeded ``torch.Generator`` on the
encoder's device, with a warning. Tokens: a tokenizer passed in, else
``get_tokenizer(EMBEDDING_MODEL)``, the HF tokenizer when its files are
local and the hashing tokenizer otherwise, as in the JAX provider.

Spans (``observability.trace_phase``): ``embed.tokenize`` (tokens and the
padded or packed layout; it counts ``embed.tokens``, the real tokens,
``embed.slots``, the padded (batch, sequence) bucket's or the packed rows'
slots, and ``embed.micro_batches``), ``embed.forward`` (the host's time to
enqueue the encoder, input copies included) and ``embed.readback`` (the
host blocked on the card, then the copy back).
"""

from __future__ import annotations

import os
import threading

import numpy as np
import torch

from ..logging import get_logger
from ..config import get_config
from ..device import resolve_device
from ..models.encoder import EncoderConfig, TextEncoder, load_encoder
from ..models.packing import build_packed_arrays, pack_bins, shrink_width
from ..models.tokenizer import get_tokenizer
from ..observability import trace_phase
from .base import instruction_prefix

logger = get_logger(__name__)

_SEQ_BUCKETS = (16, 32, 64, 128, 256, 512, 1024, 2048, 4096, 8192)
RANDOM_INIT_SEED = 0  # the generator of the weights used when none are given
_BATCH_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256)


def _bucket(n: int, buckets=_SEQ_BUCKETS) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def preset_config(device: torch.device) -> EncoderConfig:
    """The encoder size of ``EMBEDDING_PRESET`` (``auto``: ``bge_m3`` on the
    card, ``tiny`` on the CPU, as the JAX provider sizes by its backend)."""
    preset = get_config().EMBEDDING_PRESET
    if preset == "auto":
        preset = "tiny" if device.type == "cpu" else "bge_m3"
    if preset == "bge_m3":
        return EncoderConfig.bge_m3()
    if preset == "small":
        return EncoderConfig(vocab_size=32_768, hidden_size=384, num_layers=6, num_heads=6,
                             intermediate_size=1536, max_position=2050, dtype="bfloat16")
    if preset == "tiny":
        return EncoderConfig.tiny()
    raise ValueError(f"EMBEDDING_PRESET={preset!r}: expected auto, bge_m3, small or tiny")


class CudaEmbeddingProvider:
    """EmbeddingProvider over :class:`TextEncoder` on one device."""

    def __init__(
        self,
        encoder: TextEncoder | None = None,
        *,
        checkpoint: str | None = None,
        tokenizer=None,
        device: str | torch.device | None = None,
        model_name: str | None = None,
    ) -> None:
        cfg = get_config()
        self.model_name = model_name or cfg.EMBEDDING_MODEL
        if encoder is None:
            path = checkpoint or cfg.EMBEDDING_CHECKPOINT
            if path:
                encoder = load_encoder(path, device=device)
            else:
                dev = resolve_device(device)
                logger.warning(
                    "no weights for %s: random parameters from seed %d (embedding quality is a "
                    "placeholder until a checkpoint is given)", self.model_name, RANDOM_INIT_SEED)
                encoder = TextEncoder(preset_config(dev), device=dev).init_random(
                    torch.Generator(device=dev).manual_seed(RANDOM_INIT_SEED))
        self.encoder = encoder.eval()
        self.encoder_config = encoder.config
        self.device = next(encoder.parameters()).device
        self.tokenizer = tokenizer or get_tokenizer(
            self.model_name,
            vocab_size=self.encoder_config.vocab_size,
            max_length=min(self.encoder_config.max_position - 2, 8192),
        )
        self.batch_size = cfg.EMBEDDING_BATCH_SIZE
        self.packed = os.getenv("EMBED_PACKED", "0") not in ("0", "false", "")
        self.pack_width = int(os.getenv("EMBED_PACK_WIDTH", "512"))
        # the tokenizer memo and the module are shared by service threads
        self._lock = threading.Lock()

    @property
    def dimension(self) -> int:
        return self.encoder_config.hidden_size

    def embed_batch(self, texts: list[str], *, is_query: bool = False) -> np.ndarray:
        if not texts:
            return np.zeros((0, self.dimension), np.float32)
        prefix = instruction_prefix(is_query)
        if prefix:
            texts = [prefix + t for t in texts]
        if self.packed:
            return self._embed_batch_packed(texts)
        out = np.zeros((len(texts), self.dimension), np.float32)
        for start in range(0, len(texts), self.batch_size):
            batch = texts[start : start + self.batch_size]
            emb = self._encode_device(batch)
            with trace_phase("embed.readback"):
                out[start : start + len(batch)] = emb[: len(batch)].cpu().numpy()
        return out

    def embed_batch_device(self, texts: list[str], *, is_query: bool = False):
        """One micro-batch embedded and left on the device (rows past
        ``len(texts)`` are bucket padding); None when the batch exceeds
        one micro-batch or packing is on (callers then use
        :meth:`embed_batch`)."""
        if not texts or len(texts) > self.batch_size or self.packed:
            return None
        prefix = instruction_prefix(is_query)
        if prefix:
            texts = [prefix + t for t in texts]
        return self._encode_device(texts)

    @torch.no_grad()
    def _encode_device(self, batch: list[str]) -> torch.Tensor:
        with self._lock:
            with trace_phase("embed.tokenize") as span:
                ids, mask = self.tokenizer.encode_batch(batch)
                b_pad = _bucket(len(batch), _BATCH_BUCKETS)
                s_pad = _bucket(ids.shape[1])
                ids_p = np.full((b_pad, s_pad), self.tokenizer.pad_id, np.int32)
                mask_p = np.zeros((b_pad, s_pad), np.int32)
                ids_p[: len(batch), : ids.shape[1]] = ids
                mask_p[: len(batch), : ids.shape[1]] = mask
                span.count({"embed.tokens": int(mask.sum()), "embed.slots": b_pad * s_pad, "embed.micro_batches": 1})
            with trace_phase("embed.forward"):
                return self.encoder(
                    torch.as_tensor(ids_p, device=self.device), torch.as_tensor(mask_p, device=self.device)
                )

    @torch.no_grad()
    def _embed_batch_packed(self, texts: list[str]) -> np.ndarray:
        """Packed encode: first-fit-decreasing bins of fixed-width rows,
        block-diagonal attention, one CLS per segment. Each text's
        computation is the padded path's; only the layout differs. Every
        launch is dispatched before any result is copied back."""
        pad = self.tokenizer.pad_id
        with self._lock:
            with trace_phase("embed.tokenize"):
                ids_list: list[list[int]] = []
                for start in range(0, len(texts), self.batch_size):
                    ids, mask = self.tokenizer.encode_batch(texts[start : start + self.batch_size])
                    ids_list.extend(row[keep.astype(bool)].tolist() for row, keep in zip(ids, mask))
                w = max(self.pack_width, -(-max(len(r) for r in ids_list) // 128) * 128)
                bins = pack_bins([len(r) for r in ids_list], w)
                w = shrink_width(bins, w)
            r_launch = max(1, (self.batch_size * 256) // w)  # about a padded batch's tokens
            pending = []
            for s in range(0, len(bins), r_launch):
                with trace_phase("embed.tokenize") as span:
                    ids, seg, cls, idxmat = build_packed_arrays(ids_list, bins[s : s + r_launch], w, pad)
                    span.count({"embed.tokens": int((seg > 0).sum()), "embed.slots": seg.size,
                                "embed.micro_batches": 1})
                with trace_phase("embed.forward"):
                    seg_t = torch.as_tensor(seg, device=self.device)
                    emb = self.encoder(
                        torch.as_tensor(ids, device=self.device), (seg_t > 0).to(torch.int32),
                        segment_ids=seg_t, cls_index=torch.as_tensor(cls, device=self.device),
                    )
                pending.append((idxmat, emb))
        out = np.zeros((len(ids_list), self.dimension), np.float32)
        for idxmat, emb in pending:
            valid = idxmat >= 0
            with trace_phase("embed.readback"):
                out[idxmat[valid]] = emb.cpu().numpy()[valid]  # [n, P, H]
        return out

    def embed_single(self, text: str, *, is_query: bool = False) -> np.ndarray:
        return self.embed_batch([text], is_query=is_query)[0]
