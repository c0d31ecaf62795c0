"""Sequence parallelism for the long-context encoder (port of
``intool_rag_tpu/parallel/sequence.py``).

BGE-M3's 8,192-token inputs give a per-sequence activation footprint of
S·H a layer; splitting the sequence over a mesh's ``seq`` axis divides the
activation memory and the attention work a device by the shard count.

- embeddings, LayerNorm and the MLP are position-local: each shard runs
  them on its own slice of the sequence;
- attention needs every (q, kv) pair: ring attention. Each shard keeps an
  online-softmax accumulator (running max, sum and weighted value) over
  its queries while the K/V blocks move around the ring, so no shard holds
  more than its ``[S/n, S/n]`` score tile.

One process drives every shard (``parallel/mesh.py``). A ring step runs
every shard's block, then every block moves one shard on (a peer copy,
``Tensor.to(device, non_blocking=True)``, where the JAX package calls
``lax.ppermute``); the last block moves nowhere. The arithmetic is the JAX
function's, an einsum loop in f32 (no kernel in either package).
"""

from __future__ import annotations

import dataclasses
import weakref

import torch

from ..models.encoder import EncoderConfig, TextEncoder, l2_normalize, merge_heads, roberta_positions
from .collectives import all_gather
from .mesh import Mesh, axis_devices, local_devices

MASK_VALUE = -1e30  # large-negative, not -inf: a wholly masked block stays NaN-free through exp


def seq_mesh(devices=None) -> Mesh:
    """1-D mesh over ``devices`` (default: every local CUDA device) with
    axis ``seq``."""
    devices = list(devices) if devices is not None else local_devices()
    return Mesh(devices, ("seq",))


def _attend_block(qf, kb, vb, mb, acc, row_max, row_sum):
    """One K/V block into the online softmax of the scaled f32 queries."""
    valid = (mb > 0)[:, None, None, :]
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kb.float()).masked_fill(~valid, MASK_VALUE)
    new_max = torch.maximum(row_max, s.amax(dim=-1))
    corr = torch.exp(row_max - new_max)
    p = torch.exp(s - new_max[..., None]).masked_fill(~valid, 0.0)
    row_sum = row_sum * corr + p.sum(dim=-1)
    acc = acc * corr[..., None] + torch.einsum("bhqk,bhkd->bhqd", p, vb.float())
    return acc, new_max, row_sum


def ring_attention(q: list[torch.Tensor], k: list[torch.Tensor], v: list[torch.Tensor],
                   kv_mask: list[torch.Tensor], *, scale: float | None = None) -> list[torch.Tensor]:
    """Exact attention over a sequence split into shards: ``q``, ``k``,
    ``v`` hold each shard's ``[B, H, S/n, D]`` block (shard order, each on
    its device), ``kv_mask`` each shard's ``[B, S/n]`` (1 = valid key).
    Returns each shard's ``[B, H, S/n, D]`` f32 output on its device.

    Shard ``i`` attends its own block first, then the blocks of shards
    ``i−1, i−2, …``, the order in which the ring delivers them. Padded keys
    are masked at score time; a query row whose keys are all padded comes
    out as zeros."""
    n = len(q)
    devices = [x.device for x in q]
    scale = scale if scale is not None else 1.0 / q[0].shape[-1] ** 0.5
    qf = [x.float() * scale for x in q]
    acc = [x * 0.0 for x in qf]
    row_max = [a[..., 0] + MASK_VALUE for a in acc]
    row_sum = [a[..., 0] for a in acc]
    blocks = list(zip(k, v, kv_mask))  # the block each shard holds
    for step in range(n):
        for i in range(n):
            acc[i], row_max[i], row_sum[i] = _attend_block(qf[i], *blocks[i], acc[i], row_max[i], row_sum[i])
        if step < n - 1:  # one hop around the ring; none after the last block
            blocks = [tuple(x.to(devices[i], non_blocking=True) for x in blocks[i - 1]) for i in range(n)]
    return [a / s[..., None].clamp_min(1e-30) for a, s in zip(acc, row_sum)]


def _copies(model: TextEncoder, devices: list[torch.device]) -> dict[torch.device, TextEncoder]:
    """``model`` copied to each of ``devices`` where it does not live
    (sequence parallelism splits activations, not weights)."""
    probe = next(model.parameters())
    out: dict[torch.device, TextEncoder] = {}
    for dev in devices:
        if dev not in out and probe.to(dev) is not probe:
            out[dev] = TextEncoder(model.config, device=dev, param_dtype=probe.dtype)
            out[dev].load_state_dict(model.state_dict())
    return out


def sp_encode_fn(config: EncoderConfig, mesh: Mesh, *, pool: bool = True):
    """Sequence-parallel encode: ``fn(model, input_ids [B, S],
    attention_mask [B, S]) -> [B, H]`` L2-normalized CLS embeddings (or the
    last hidden state ``[B, S, H]`` f32 with ``pool=False``), on the mesh's
    first device, with S split over the mesh's ``seq`` axis. The inputs may
    be whole tensors or ``fn.place_batch``'s per-shard lists. A shard on
    another device than the model's runs a copy of it, which
    ``fn.replicas(model)`` makes on the first call and again only after the
    weights change.

    Every layer attends by :func:`ring_attention`, whatever the length
    (the JAX function sets ``flash_min_len=0``); positions are global
    RoBERTa ids, their running count spanning the shards; CLS pooling reads
    shard 0. ``model`` is a :class:`~..models.encoder.TextEncoder` of
    ``config`` (its ``flash_min_len`` aside). S must be a multiple of the
    axis size."""
    devices = axis_devices(mesh, "seq")
    n = len(devices)
    plain = dataclasses.replace(config, flash_min_len=0)

    def place(x) -> list[torch.Tensor]:
        """``[B, S]`` split along S, one slice a shard on its device."""
        if isinstance(x, list):
            return x
        x = torch.as_tensor(x)
        if x.shape[1] % n:
            raise ValueError(f"S={x.shape[1]} must be a multiple of the seq axis size {n}")
        return [c.to(d, non_blocking=True) for c, d in zip(x.chunk(n, dim=1), devices)]

    held: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()  # model -> (its weights' state, its copies)

    def replicas(model: TextEncoder) -> list[TextEncoder]:
        """``model`` on each shard's device: itself where it lives, else a
        copy, made once for each state of its weights (a parameter's
        storage and version counter: ``load_state_dict`` and an optimizer
        step move them)."""
        state = tuple((p.data_ptr(), p._version) for p in model.parameters())
        if model not in held or held[model][0] != state:
            held[model] = (state, _copies(model, devices))
        copies = held[model][1]
        return [copies.get(d, model) for d in devices]

    def fn(model: TextEncoder, input_ids, attention_mask) -> torch.Tensor:
        if dataclasses.replace(model.config, flash_min_len=0) != plain:
            raise ValueError("the model was built from another config than this function")
        ids, masks = place(input_ids), [m.long() for m in place(attention_mask)]
        positions = place(roberta_positions(all_gather(masks, devices[0], dim=1), config.pad_token_id))
        shard_models = replicas(model)
        hidden = [r.embed(i, p) for r, i, p in zip(shard_models, ids, positions)]
        for depth in range(config.num_layers):
            layers = [r.layers[depth] for r in shard_models]
            q, k, v = zip(*(layer.attention.project(h) for layer, h in zip(layers, hidden)))
            attn = ring_attention(list(q), list(k), list(v), masks)
            hidden = [layer.finish(h, layer.attention.output(merge_heads(a.to(h.dtype))))
                      for layer, h, a in zip(layers, hidden, attn)]
        if not pool:
            return all_gather([h.float() for h in hidden], devices[0], dim=1)
        return l2_normalize(hidden[0][:, 0, :].float())

    fn.place_batch = place
    fn.replicas = replicas
    return fn
