"""Cross-encoder reranker training (pointwise relevance classification;
port of ``intool_rag_tpu/train/rerank.py``).

Binary relevance on (query, passage) pairs: positives are judged passages,
negatives are hard negatives drawn from the same retrieval pool. The pair
pool is tokenized once and parked on the device; every step samples a
random batch from it with a device generator. Optimizer and schedule are
the contrastive trainer's (``train/contrastive.py``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import resolve_device
from ..models.encoder import EncoderConfig
from ..models.reranker import CrossEncoder
from .contrastive import TrainState, apply_update, make_optimizer, run_launches, seeded_generator


@dataclasses.dataclass
class PairPool:
    """Tokenized (query ⊕ SEP ⊕ passage) pairs with binary labels."""

    ids: np.ndarray  # [N, S] i32
    mask: np.ndarray  # [N, S] i32
    labels: np.ndarray  # [N] f32 (1 relevant / 0 not)


def build_pair_pool(
    tokenizer,
    queries: list[str],
    passages: list[str],
    labels: list[float] | np.ndarray,
    *,
    max_len: int = 64,
    augment_shuffle: int = 0,
    rng: np.random.Generator | None = None,
) -> PairPool:
    """Tokenize aligned pairs to one fixed width (training wants a single
    shape; serving keeps its length-bucketed path).

    ``augment_shuffle`` adds that many word-order-shuffled copies of each
    passage (same query and label): relevance is a bag-of-evidence
    property, and without the augmentation the cross-encoder latches onto
    the corpus's positional template and loses its lift on documents whose
    words come in another order."""
    if augment_shuffle and rng is None:
        raise ValueError("augment_shuffle needs an rng")
    if augment_shuffle:
        labels = np.asarray(labels, np.float32)
        aq, ap, al = list(queries), list(passages), [labels]
        for _ in range(augment_shuffle):
            for q, p in zip(queries, passages):
                words = p.split()
                rng.shuffle(words)
                aq.append(q)
                ap.append(" ".join(words))
            al.append(labels)
        queries, passages = aq, ap
        labels = np.concatenate(al)
    sep = getattr(tokenizer, "sep_id", 2)
    pad = tokenizer.pad_id
    ids_q, _ = tokenizer.encode_batch(queries)
    ids_p, _ = tokenizer.encode_batch(passages)
    n = len(queries)
    ids = np.full((n, max_len), pad, np.int32)
    mask = np.zeros((n, max_len), np.int32)
    for i in range(n):
        q_real = [t for t in ids_q[i].tolist() if t != pad]
        p_real = [t for t in ids_p[i].tolist() if t != pad][1:]  # drop CLS
        row = (q_real + [sep] + p_real)[:max_len]
        ids[i, : len(row)] = row
        mask[i, : len(row)] = 1
    return PairPool(ids, mask, np.asarray(labels, np.float32))


def train_reranker(
    config: EncoderConfig,
    pool: PairPool,
    *,
    steps: int = 600,
    batch: int = 64,
    lr: float = 3e-4,
    seed: int = 0,
    steps_per_launch: int = 50,
    init_params: dict | None = None,
    device: str | torch.device | None = None,
    generator: torch.Generator | None = None,
):
    """Train a :class:`CrossEncoder` on the pool (sigmoid binary cross
    entropy, AdamW, warm-up + cosine schedule); returns ``(state_dict,
    mean_losses)``: the trained f32 parameters and, like
    :func:`..train.contrastive.train_encoder_cached`, one mean loss per
    ``steps_per_launch`` steps. ``init_params`` is a state
    dict to start from (default: random from ``seed``); batch indices come
    from ``generator`` (default: one seeded with ``seed + 1`` on the device)."""
    dev = resolve_device(device)
    model = CrossEncoder(config, device=dev, param_dtype=torch.float32)
    if init_params is not None:
        model.load_state_dict(init_params)
    else:
        model.init_flax(seeded_generator(seed, dev))
    model.train()
    gen = generator if generator is not None else seeded_generator(seed + 1, dev)
    state = TrainState(model, *make_optimizer(model, lr, steps))
    ids_d, mask_d, lab_d = (torch.as_tensor(x, device=dev) for x in (pool.ids, pool.mask, pool.labels))
    n = len(pool.labels)

    def one_step() -> torch.Tensor:
        idx = torch.randint(0, n, (batch,), generator=gen, device=dev)
        logits = model(ids_d[idx], mask_d[idx])
        loss = torch.nn.functional.binary_cross_entropy_with_logits(logits, lab_d[idx])
        apply_update(state, loss)
        return loss.detach()

    means = run_launches(state, one_step, steps, steps_per_launch)
    return {k: v.detach().clone() for k, v in model.state_dict().items()}, means
