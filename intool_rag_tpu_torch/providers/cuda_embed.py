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
enqueue the encoder, input copies included; it counts
``embed.graph_captures`` and ``embed.graph_replays``) and ``embed.readback``
(the host blocked on the card, then the copy back).

CUDA graphs. A short padded micro-batch costs the card less than the host's
616 launches take to enqueue, so such a bucket replays a CUDA graph of
:meth:`TextEncoder.forward` instead: one launch. :func:`graph_engages` is the
rule, from what the call can observe alone: a CUDA device, the padded route
(packed rows stay eager), a sequence bucket off the flash route (K5 is never
captured) and at most :data:`GRAPH_MAX_SLOTS` slots; above that a
micro-batch's device time exceeds its enqueue and the eager launches hide
behind the card. Capture is lazy, per (batch, sequence) bucket: the first
call runs eagerly (it warms cuBLAS and the allocator), the second warms the
capture stream and captures, later calls replay. Nothing is captured when the
provider is built. All graphs share one memory pool, safe because calls run
one at a time under the provider's lock and every graph's intermediates die
inside its replay. A replay rewrites the whole static input, pad rows and
columns included, through a pinned staging buffer, and the result is a copy of
the static output taken under the lock, so no caller holds memory that a
later replay writes.
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


# the most (batch × sequence) slots a replayed bucket holds: 64 × 128. On the
# H100 at BGE-M3 width an eager forward enqueues its 616 launches in ~12-27 ms;
# the card's time for the bucket is 22.7 ms at (64, 128), 59 ms at (64, 256)
GRAPH_MAX_SLOTS = 8_192


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


def graph_engages(device: torch.device, packed: bool, b_pad: int, s_pad: int, flash_min_len: int) -> bool:
    """Whether a micro-batch of bucket ``(b_pad, s_pad)`` replays a CUDA
    graph (module docstring): on the card, padded, off the flash route
    (``flash_min_len`` 0 turns that route off) and within
    :data:`GRAPH_MAX_SLOTS` slots."""
    return (device.type == "cuda" and not packed and (not flash_min_len or s_pad < flash_min_len)
            and b_pad * s_pad <= GRAPH_MAX_SLOTS)


class _BucketGraph:
    """One padded bucket's forward as a CUDA graph: static ``ids`` / ``mask``
    inputs on the card (one ``[2, B, S]`` int32 buffer), their pinned host
    staging, and the static output, allocated in ``pool``."""

    def __init__(self, encoder: TextEncoder, shape: tuple[int, int], pool, stream: torch.cuda.Stream) -> None:
        device = stream.device
        self.staging = torch.empty((2, *shape), dtype=torch.int32, pin_memory=True)
        self.inputs = torch.zeros((2, *shape), dtype=torch.int32, device=device)
        self.copied = torch.cuda.Event()  # the last staged copy has left the host buffer
        self.graph = torch.cuda.CUDAGraph()
        stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(stream):  # warm the capture stream's cuBLAS workspace
            encoder(self.inputs[0], self.inputs[1])
        with torch.cuda.graph(self.graph, pool=pool, stream=stream, capture_error_mode="thread_local"):
            self.output = encoder(self.inputs[0], self.inputs[1])

    def __call__(self, ids: np.ndarray, mask: np.ndarray) -> torch.Tensor:
        """Replays on the current stream; returns a copy of the output."""
        self.copied.synchronize()
        staged = self.staging.numpy()
        staged[0], staged[1] = ids, mask
        self.inputs.copy_(self.staging, non_blocking=True)
        self.copied.record()
        self.graph.replay()
        return self.output.clone()


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
        # the tokenizer memo, the module and the graphs are shared by service threads
        self._lock = threading.Lock()
        # (batch, sequence) bucket -> its graph; None once its first call ran eagerly
        self._graphs: dict[tuple[int, int], _BucketGraph | None] = {}
        self._graph_pool = self._capture_stream = None

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
            with trace_phase("embed.forward") as span:
                if not graph_engages(self.device, self.packed, b_pad, s_pad, self.encoder_config.flash_min_len):
                    return self._eager(ids_p, mask_p)
                return self._graphed(ids_p, mask_p, span)

    def _eager(self, ids_p: np.ndarray, mask_p: np.ndarray) -> torch.Tensor:
        return self.encoder(torch.as_tensor(ids_p, device=self.device), torch.as_tensor(mask_p, device=self.device))

    def _graphed(self, ids_p: np.ndarray, mask_p: np.ndarray, span: trace_phase) -> torch.Tensor:
        """The bucket's graph: the first call eager, the second captures,
        later ones replay (module docstring). Runs under ``_lock``."""
        key = ids_p.shape
        if key not in self._graphs:
            self._graphs[key] = None
            return self._eager(ids_p, mask_p)
        graph = self._graphs[key]
        with torch.cuda.device(self.device):
            if graph is None:
                if self._graph_pool is None:
                    self._graph_pool = torch.cuda.graph_pool_handle()
                    self._capture_stream = torch.cuda.Stream(self.device)
                graph = self._graphs[key] = _BucketGraph(self.encoder, key, self._graph_pool, self._capture_stream)
                span.count({"embed.graph_captures": 1})
            else:
                span.count({"embed.graph_replays": 1})
            return graph(ids_p, mask_p)

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
