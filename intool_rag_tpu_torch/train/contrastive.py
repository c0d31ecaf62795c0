"""Contrastive fine-tuning of the text encoder (InfoNCE, in-batch
negatives; port of ``intool_rag_tpu/train/contrastive.py``).

The model trains with f32 master weights and the config's compute dtype
(``TextEncoder(..., param_dtype=torch.float32)``), under
``torch.optim.AdamW`` with optax's ``adamw`` defaults (betas 0.9 / 0.999,
eps 1e-8, weight decay 0.01 on every parameter, biases and LayerNorm
scales included: one parameter group) and the warm-up + cosine schedule of
:func:`warmup_cosine_factor`. Rows of ``S >= flash_min_len`` go through the
flash-attention kernels in both directions (``ops/flash_attention.py``).

The Megatron-style sharded step of the JAX package (``param_shardings``,
``shard_params``, ``make_sharded_train_step``) is not ported: those names
raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np
import torch

from ..device import resolve_device
from ..models.encoder import EncoderConfig, TextEncoder

ADAMW = dict(betas=(0.9, 0.999), eps=1e-8, weight_decay=0.01)  # optax.adamw's defaults
ADAM = dict(betas=(0.9, 0.999), eps=1e-8)  # optax.adam's defaults (eps outside the square root, as torch's)


@dataclasses.dataclass
class TrainState:
    """What one training run carries from step to step. The optimizer is
    bound to the model's parameters, so it lives here and not beside the
    step function; ``scheduler`` (optional) moves the learning rate once per
    step."""

    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler | None = None
    step: int = 0


def _not_ported(name: str):
    def fn(*args, **kwargs):
        raise NotImplementedError(
            f"{name}: the DP+TP sharded train step is not ported; train on one device with make_train_step"
        )

    fn.__name__ = name
    return fn


param_shardings = _not_ported("param_shardings")
shard_params = _not_ported("shard_params")
make_sharded_train_step = _not_ported("make_sharded_train_step")


# ---------------- optimizer / schedule ----------------


def warmup_cosine_factor(steps: int, warmup: int | None = None, alpha: float = 0.05) -> Callable[[int], float]:
    """``count -> lr(count) / lr`` of
    ``optax.warmup_cosine_decay_schedule(0, lr, warmup_steps=warmup,
    decay_steps=steps, end_value=alpha * lr)``: linear from 0 over the
    warm-up (default ``max(20, steps // 20)``), then a cosine down to
    ``alpha`` at ``steps`` and flat after. The first update (count 0) has
    rate 0, as in optax."""
    warmup = max(20, steps // 20) if warmup is None else warmup
    decay = steps - warmup
    if decay <= 0:
        raise ValueError(f"the schedule needs more than {warmup} steps (its warm-up), got {steps}")

    def factor(count: int) -> float:
        if count < warmup:
            return count / warmup
        cosine = 0.5 * (1.0 + math.cos(math.pi * min(count - warmup, decay) / decay))
        return (1.0 - alpha) * cosine + alpha

    return factor


def make_optimizer(model: torch.nn.Module, lr: float, steps: int | None = None):
    """``(optimizer, scheduler)``: AdamW over every parameter in one group;
    with ``steps`` the warm-up + cosine schedule, else a constant rate and
    no scheduler."""
    params = list(model.parameters())
    fused = all(p.is_cuda for p in params)  # one launch per step on the card
    optimizer = torch.optim.AdamW(params, lr=lr, fused=fused, **ADAMW)
    if steps is None:
        return optimizer, None
    return optimizer, torch.optim.lr_scheduler.LambdaLR(optimizer, warmup_cosine_factor(steps))


def clip_by_global_norm_(params, max_norm: float) -> torch.Tensor:
    """``optax.clip_by_global_norm(max_norm)`` on the gradients, in place:
    ``g / ‖g‖ · max_norm`` when the global norm ``‖g‖`` reaches
    ``max_norm``, else ``g`` unchanged (``clip_grad_norm_`` scales by
    ``max_norm / (‖g‖ + 1e-6)`` instead). Decided on the device, no host
    synchronisation. Returns the global norm."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.sqrt(sum(torch.sum(g.float() * g.float()) for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))
    return norm


def apply_update(state: TrainState, loss: torch.Tensor, clip: float | None = None) -> None:
    """Backward, the optional global-norm clip, one optimizer step, one
    scheduler step; gradients freed."""
    loss.backward()
    if clip:
        clip_by_global_norm_(state.model.parameters(), clip)
    state.optimizer.step()
    if state.scheduler is not None:
        state.scheduler.step()
    state.optimizer.zero_grad(set_to_none=True)
    state.step += 1


# ---------------- loss / step ----------------


def info_nce_loss(q_emb: torch.Tensor, p_emb: torch.Tensor, temperature: float) -> torch.Tensor:
    """In-batch-negative InfoNCE; both inputs [B, H] unit-norm."""
    logits = q_emb @ p_emb.T / temperature  # [B, B]
    labels = torch.arange(q_emb.shape[0], device=q_emb.device)
    return torch.nn.functional.cross_entropy(logits, labels)


def make_train_step(config: EncoderConfig, temperature: float = 0.05) -> Callable:
    """Returns ``train_step(state, batch) -> (state, loss)`` where batch =
    dict(q_ids, q_mask, p_ids, p_mask) of integer tensors on the model's
    device. ``state`` is updated in place and returned; ``loss`` stays on
    the device (no host synchronisation inside a step)."""

    def train_step(state: TrainState, batch: dict) -> tuple[TrainState, torch.Tensor]:
        model = state.model
        if model.config != config:
            raise ValueError("the state's model was built from another config than this step")
        q = model(batch["q_ids"], batch["q_mask"])
        p = model(batch["p_ids"], batch["p_mask"])
        loss = info_nce_loss(q, p, temperature)
        apply_update(state, loss)
        return state, loss.detach()

    return train_step


# ---------------- cached-pool trainer (single device) ----------------


def tokenize_pairs(tokenizer, queries, passages, *, max_len: int = 32):
    """Tokenize aligned (query, positive-passage) pairs to fixed width."""

    def enc(texts):
        ids, mask = tokenizer.encode_batch(texts)
        n, s = ids.shape
        if s >= max_len:
            return ids[:, :max_len], mask[:, :max_len]
        pid = tokenizer.pad_id
        out_i = np.full((n, max_len), pid, np.int32)
        out_m = np.zeros((n, max_len), np.int32)
        out_i[:, :s] = ids
        out_m[:, :s] = mask
        return out_i, out_m

    q_ids, q_mask = enc(queries)
    p_ids, p_mask = enc(passages)
    return {"q_ids": q_ids, "q_mask": q_mask, "p_ids": p_ids, "p_mask": p_mask}


def seeded_generator(seed: int, device: torch.device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def run_launches(state: TrainState, one_step: Callable[[], torch.Tensor], steps: int,
                 steps_per_launch: int) -> np.ndarray:
    """``ceil(steps / steps_per_launch)`` groups of ``steps_per_launch``
    steps of ``one_step() -> loss``; returns each group's mean loss. The
    losses are stacked on the device and read once, after the last step."""
    means = []
    for _ in range(-(-steps // steps_per_launch)):
        means.append(torch.stack([one_step() for _ in range(steps_per_launch)]).mean())
    return torch.stack(means).float().cpu().numpy()


def train_encoder_cached(
    config: EncoderConfig,
    pool: dict,
    *,
    steps: int = 800,
    batch: int = 64,
    lr: float = 1e-3,
    temperature: float = 0.05,
    seed: int = 0,
    steps_per_launch: int = 50,
    init: dict | None = None,
    device: str | torch.device | None = None,
    generator: torch.Generator | None = None,
):
    """InfoNCE fine-tune over a device-resident (query, positive) pool.
    In-batch negatives come from the sampled batch; batch indices come from
    ``generator`` (default: one seeded with ``seed + 1`` on the device).
    ``init`` is a :class:`TextEncoder` state dict to start from (default:
    :meth:`TextEncoder.init_flax` seeded with ``seed``). Returns ``(model,
    mean_losses)``: the trained encoder with f32 master weights and one mean
    loss per ``steps_per_launch`` steps."""
    dev = resolve_device(device)
    model = TextEncoder(config, device=dev, param_dtype=torch.float32)
    if init is not None:
        model.load_state_dict(init)
    else:
        model.init_flax(seeded_generator(seed, dev))
    model.train()
    gen = generator if generator is not None else seeded_generator(seed + 1, dev)
    state = TrainState(model, *make_optimizer(model, lr, steps))
    step_fn = make_train_step(config, temperature)
    on_dev = {k: torch.as_tensor(v, device=dev) for k, v in pool.items()}
    n = on_dev["q_ids"].shape[0]

    def one_step() -> torch.Tensor:
        idx = torch.randint(0, n, (batch,), generator=gen, device=dev)
        return step_fn(state, {k: v[idx] for k, v in on_dev.items()})[1]

    means = run_launches(state, one_step, steps, steps_per_launch)
    return model.eval(), means
