"""Decoder LM training (next-token cross-entropy; port of
``intool_rag_tpu/models/lm_train.py``).

Used two ways, as in the JAX package: fine-tuning or continued
pretraining of a :class:`~.decoder.DecoderLM` on token batches, and
training the small copy and RAG-QA models that make prompt-lookup
speculation measurable without downloadable weights (a 2-layer decoder
learns to quote its prompt in a few hundred steps).

Training runs through the serving ``DecoderLM.forward``, with f32 master
weights (``param_dtype=torch.float32``) and the config's compute dtype,
over a KV cache sized to the batch's length. The optimizer is
``torch.optim.Adam`` with optax's ``adam`` defaults (betas 0.9 / 0.999,
eps 1e-8 outside the square root), an optional linear warm-up with
``optax.linear_schedule``'s rates (the first update's rate is 0) and an
optional ``optax.clip_by_global_norm`` clip.
"""

from __future__ import annotations

from pathlib import Path
from typing import Iterable

import numpy as np
import torch

from ..device import resolve_device
from ..train.contrastive import ADAM, TrainState, apply_update, seeded_generator
from .decoder import DecoderConfig, DecoderLM, init_cache

# initial weights of the two speculation acceptance models (the copy task,
# vocabulary 64; RAG-QA, vocabulary 96; 2 x 64, 4 heads over 2, MLP 128):
# the JAX package's seed-0 draws, so that both trainers start alike.
# Rebuilt with ``JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_lm_train.py``.
SPEC_INIT = Path(__file__).parent / "fixtures" / "spec_acceptance_init.npz"


def copy_task_batch(
    rng: np.random.Generator, batch: int, seq: int, vocab: int, *, sep_id: int = 3, lo: int = 4
) -> np.ndarray:
    """[B, S] sequences ``prefix ++ SEP ++ prefix ++ prefix ...``: after SEP
    every token is a deterministic function of the prefix (induction)."""
    p_len = max(4, seq // 4)
    out = np.zeros((batch, seq), np.int32)
    for b in range(batch):
        prefix = rng.integers(lo, vocab, size=p_len)
        row = list(prefix) + [sep_id]
        while len(row) < seq:
            row.extend(prefix)
        out[b] = row[:seq]
    return out


def spec_init(task: str, path: Path | str = SPEC_INIT) -> dict[str, torch.Tensor]:
    """The committed initial state dict of an acceptance model, ``task`` =
    ``copy`` or ``rag_qa`` (see ``SPEC_INIT``)."""
    with np.load(path) as arrays:
        return {k.split("/", 1)[1]: torch.from_numpy(arrays[k]) for k in arrays.files
                if k.startswith(task + "/")}


def lm_loss(model: DecoderLM, batch: torch.Tensor) -> torch.Tensor:
    """Mean next-token NLL over all positions of ``batch [B, S]``, in f32."""
    b, s = batch.shape
    cache = init_cache(model.config, b, batch.device, positions=s)
    positions = torch.arange(s, device=batch.device).expand(b, s)
    logits = model(batch, positions, cache)
    logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
    nll = -torch.gather(logp, 2, batch[:, 1:, None].long())[..., 0]
    return nll.mean()


def make_optimizer(model: DecoderLM, lr: float, warmup: int = 0):
    """``(Adam, scheduler)``: the scheduler is ``optax.linear_schedule(0,
    lr, warmup)`` as a factor (None without warm-up). Step it after the
    optimizer, as ``apply_update`` does."""
    params = list(model.parameters())
    optimizer = torch.optim.Adam(params, lr=lr, fused=all(p.is_cuda for p in params), **ADAM)
    if not warmup:
        return optimizer, None
    return optimizer, torch.optim.lr_scheduler.LambdaLR(optimizer, lambda count: min(count, warmup) / warmup)


def make_train_step(config: DecoderConfig, clip: float | None = None):
    """``train_step(state, batch [B, S]) -> loss``: one next-token CE step,
    updating ``state`` in place; the loss stays on the device."""

    def train_step(state: TrainState, batch: torch.Tensor) -> torch.Tensor:
        if state.model.config != config:
            raise ValueError("the state's model was built from another config than this step")
        loss = lm_loss(state.model, batch)
        apply_update(state, loss, clip)
        return loss.detach()

    return train_step


def train_lm(
    config: DecoderConfig,
    batches: Iterable,  # [B, S] int arrays
    *,
    lr: float = 3e-3,
    seed: int = 0,
    init_params: dict | None = None,
    warmup: int = 0,
    clip: float | None = None,
    device: str | torch.device | None = None,
) -> tuple[DecoderLM, list[float]]:
    """Train over ``batches`` on ``device`` (default CUDA). ``init_params``
    is a state dict to start from (default: seeded random weights).
    Returns ``(model, losses)``: the model with f32 master weights, and the
    loss of every step (read once, after the last)."""
    dev = resolve_device(device)
    model = DecoderLM(config, device=dev, param_dtype=torch.float32)
    if init_params is not None:
        model.load_state_dict(init_params)
    else:
        model.init_random(seeded_generator(seed, dev))
    state = TrainState(model, *make_optimizer(model, lr, warmup))
    step = make_train_step(config, clip)
    losses = [step(state, torch.as_tensor(np.asarray(b), device=dev)) for b in batches]
    return model, torch.stack(losses).float().cpu().tolist()


def rag_qa_batch(
    rng: np.random.Generator, batch: int, seq: int, vocab: int, *,
    sep_q: int = 3, sep_a: int = 2, n_fields: int = 4, val_len: int = 5, lo: int = 4,
) -> np.ndarray:
    """[B, S] "document + question + quoted answer" sequences: ``n_fields``
    key→value clauses, then rounds of ``SEP_Q key SEP_A value…`` for
    random keys until ``seq``. After ``SEP_A`` the model must find the
    queried key and quote the value span after it."""
    out = np.zeros((batch, seq), np.int32)
    ids = np.arange(lo, vocab)
    for b in range(batch):
        keys = rng.choice(ids, size=n_fields, replace=False)
        vals = rng.integers(lo, vocab, size=(n_fields, val_len))
        row: list[int] = []
        for i in range(n_fields):
            row.append(int(keys[i]))
            row.extend(int(v) for v in vals[i])
        while len(row) < seq:
            i = int(rng.integers(n_fields))
            row.extend([sep_q, int(keys[i]), sep_a])
            row.extend(int(v) for v in vals[i])
        out[b] = row[:seq]
    return out


def rag_qa_prompts(
    rng: np.random.Generator, n: int, vocab: int, *,
    sep_q: int = 3, sep_a: int = 2, n_fields: int = 4, val_len: int = 5, lo: int = 4,
) -> tuple[list[list[int]], list[list[int]]]:
    """Held-out prompts ``doc ++ SEP_Q key SEP_A`` and the expected quoted
    answers (the queried key's value span)."""
    ids = np.arange(lo, vocab)
    prompts, answers = [], []
    for _ in range(n):
        keys = rng.choice(ids, size=n_fields, replace=False)
        vals = rng.integers(lo, vocab, size=(n_fields, val_len))
        doc: list[int] = []
        for i in range(n_fields):
            doc.append(int(keys[i]))
            doc.extend(int(v) for v in vals[i])
        i = int(rng.integers(n_fields))
        prompts.append(doc + [sep_q, int(keys[i]), sep_a])
        answers.append([int(v) for v in vals[i]])
    return prompts, answers


def train_rag_qa_lm(
    config: DecoderConfig, *, steps: int = 1200, batch: int = 32, seq: int = 64, lr: float = 3e-3,
    seed: int = 0, n_fields: int = 4, val_len: int = 5, warmup: int = 0, clip: float | None = None,
    init_params: dict | None = None, device: str | torch.device | None = None,
) -> tuple[DecoderLM, list[float]]:
    """Train ``config`` on the doc + question + quoted-answer task."""
    rng = np.random.default_rng(seed)
    batches = (rag_qa_batch(rng, batch, seq, config.vocab_size, n_fields=n_fields, val_len=val_len)
               for _ in range(steps))
    return train_lm(config, batches, lr=lr, seed=seed, warmup=warmup, clip=clip, init_params=init_params,
                    device=device)


def train_copy_lm(
    config: DecoderConfig, *, steps: int = 800, batch: int = 32, seq: int = 48, lr: float = 3e-3,
    seed: int = 0, init_params: dict | None = None, device: str | torch.device | None = None,
) -> tuple[DecoderLM, list[float]]:
    """Train ``config`` on the copy task."""
    rng = np.random.default_rng(seed)
    batches = (copy_task_batch(rng, batch, seq, config.vocab_size) for _ in range(steps))
    return train_lm(config, batches, lr=lr, seed=seed, init_params=init_params, device=device)
