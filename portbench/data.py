"""Inputs drawn from a run's seed: the BM25 vocabulary, the postings, the
dense corpus and the encoder's weights.

Every input has a stream of its own, so regenerating one after the window
(for the reference) gives the same values whatever else was drawn. Device
inputs are drawn on the device in a few large calls, in the dtype they are
served in.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .reference.text import STOPWORDS  # generated words avoid them: the analyzer keeps each unchanged

# stream ids, one per input
CORPUS, POSTINGS, WEIGHTS, VOCAB, TRAFFIC, SAMPLE, CENTERS = 1, 2, 3, 4, 5, 6, 7

ROW_BLOCK = 4096  # the store pads rows to this multiple
DIM_BLOCK = 128  # and the width to this one


def round_up(x: int, m: int) -> int:
    return max(m, -(-x // m) * m)


def stream_seed(seed: int, stream: int) -> int:
    """A 63-bit generator seed for ``stream`` of run ``seed``."""
    return ((int(seed) % (1 << 54)) << 8 | stream) & ((1 << 63) - 1)


def device_generator(seed: int, stream: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(stream_seed(seed, stream))


def host_rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % (1 << 64), stream])


# ---------------------------------------------------------------- vocabulary


def vocabulary(seed: int, size: int) -> list[str]:
    """``size`` distinct lowercase words of 3-10 letters, none a stopword."""
    rng = host_rng(seed, VOCAB)
    letters = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz", np.uint8)
    words: list[str] = []
    seen: set[str] = set()
    while len(words) < size:
        m = int(1.3 * (size - len(words))) + 64
        lens = rng.integers(3, 11, m)
        rows = letters[rng.integers(0, 26, (m, 10))]
        for row, n in zip(rows, lens):
            w = row[:n].tobytes().decode()
            if w not in seen and w not in STOPWORDS:
                seen.add(w)
                words.append(w)
                if len(words) == size:
                    break
    return words


# ---------------------------------------------------------------- Zipf


def zipf_folded_pmf(s: float, vocab: int, folds: int = 64) -> np.ndarray:
    """P(t) for ``(numpy zipf(s) - 1) % vocab``: the Zipf pmf over k ≥ 1
    folded onto ``vocab`` terms. ``folds`` folds are summed exactly, the rest
    by the integral of the tail."""
    t = np.arange(vocab, dtype=np.float64)
    pmf = np.zeros(vocab, np.float64)
    for m in range(folds):
        pmf += (t + 1 + m * vocab) ** -s
    pmf += (t + 1 + folds * vocab - 0.5) ** (1 - s) / (vocab * (s - 1))
    return pmf / pmf.sum()


def zipf_terms(gen: torch.Generator, shape, s: float, vocab: int, device) -> torch.Tensor:
    """int32 term ids drawn from :func:`zipf_folded_pmf` on the device."""
    cdf = torch.as_tensor(np.cumsum(zipf_folded_pmf(s, vocab)), device=device)
    u = torch.rand(shape, generator=gen, device=device, dtype=torch.float64)
    return torch.searchsorted(cdf, u, right=True).clamp_max(vocab - 1).to(torch.int32)


def zipf_terms_host(rng: np.random.Generator, size, s: float, vocab: int) -> np.ndarray:
    """int32 term ids, numpy's Zipf folded onto the vocabulary."""
    return ((rng.zipf(s, size=size) - 1) % vocab).astype(np.int32)


# ---------------------------------------------------------------- postings


def make_postings(seed: int, n: int, *, vocab: int, terms_per_chunk: int, p_max: int, zipf_s: float,
                  device, block: int = 1 << 19) -> dict:
    """Synthetic Zipf postings in the BM25Index layout, drawn on the device:
    ``terms_per_chunk`` Zipf terms a chunk with weights uniform in [0.5, 1.5),
    deduplicated per chunk (the first occurrence in term order keeps its
    weight), impact-ordered within a term, capped at ``p_max``, tail-padded
    with ``p_max`` sentinel postings (doc ``n``, weight 0); idf over the
    uncapped document frequencies. The layout of ``bench.py``'s
    ``make_sparse``."""
    gen = device_generator(seed, POSTINGS, device)
    t = terms_per_chunk
    parts_terms, parts_docs, parts_w = [], [], []
    for start in range(0, n, block):
        rows = min(block, n - start)
        terms = zipf_terms(gen, (rows, t), zipf_s, vocab, device)
        weights = torch.rand((rows, t), generator=gen, device=device) + 0.5
        st, sort_idx = torch.sort(terms, dim=1, stable=True)
        dup = torch.cat([torch.zeros((rows, 1), dtype=torch.bool, device=device), st[:, 1:] == st[:, :-1]], 1)
        keep = ~dup.reshape(-1)
        parts_terms.append(st.reshape(-1)[keep])
        docs = torch.arange(start, start + rows, dtype=torch.int32, device=device).repeat_interleave(t)
        parts_docs.append(docs[keep])
        parts_w.append(torch.gather(weights, 1, sort_idx).reshape(-1)[keep])
    flat_terms, flat_docs, flat_w = (torch.cat(p) for p in (parts_terms, parts_docs, parts_w))
    del parts_terms, parts_docs, parts_w
    # impact order within a term: descending weight, then term, both stable
    order = torch.sort(-flat_w, stable=True).indices
    order = order[torch.sort(flat_terms[order], stable=True).indices]
    flat_terms, flat_docs, flat_w = flat_terms[order], flat_docs[order], flat_w[order]
    del order
    df = torch.bincount(flat_terms.long(), minlength=vocab)
    counts = df.clamp(max=p_max)
    starts_full = torch.cumsum(df, 0) - df
    rank = torch.arange(flat_terms.numel(), device=device) - starts_full[flat_terms.long()]
    keep2 = rank < p_max
    term_start = (torch.cumsum(counts, 0) - counts).to(torch.int32)
    post_docs = torch.cat([flat_docs[keep2], torch.full((p_max,), n, dtype=torch.int32, device=device)])
    post_w = torch.cat([flat_w[keep2], torch.zeros(p_max, dtype=torch.float32, device=device)])
    dff = df.double()
    idf = torch.log(1.0 + (n - dff + 0.5) / (dff + 0.5)).float()
    out = {
        "term_start": term_start, "term_len": counts.to(torch.int32), "post_docs": post_docs,
        "post_w": post_w, "idf": idf, "df": df,
    }
    return out


# ---------------------------------------------------------------- dense corpora


def unit_corpus(seed: int, rows: int, dim: int, device, dtype=torch.bfloat16, block: int = 1 << 18) -> torch.Tensor:
    """``[round_up(rows, 4096), round_up(dim, 128)]`` store rows: the first
    ``rows`` are unit Gaussian directions (normalised in f32, then cast),
    the rest zero."""
    gen = device_generator(seed, CORPUS, device)
    out = torch.zeros((round_up(rows, ROW_BLOCK), round_up(dim, DIM_BLOCK)), dtype=dtype, device=device)
    for start in range(0, rows, block):
        x = torch.randn((min(block, rows - start), dim), generator=gen, device=device)
        out[start : start + x.shape[0], :dim] = (x / x.norm(dim=1, keepdim=True)).to(dtype)
    return out


def micro_cluster_corpus(seed: int, rows: int, dim: int, device, *, topics: int, group: int, radius: float,
                         dtype=torch.bfloat16, block: int = 250_000) -> torch.Tensor:
    """Store rows of the capacity tier's corpus (the micro-cluster corpus of
    the port's capacity runs): ``topics`` unit topic centres; every ``group``
    consecutive rows share a micro-centre (a topic centre plus an offset of
    norm ~``radius``, log-uniform in [0.5, 1.5]×) and scatter around it at
    ~10 % of that offset (log-uniform in [0.5, 2]×); rows unit-norm in f32,
    then cast."""
    centers = torch.randn((topics, dim), generator=device_generator(seed, CENTERS, device), device=device)
    centers /= centers.norm(dim=1, keepdim=True)
    gen = device_generator(seed, CORPUS, device)
    out = torch.zeros((round_up(rows, ROW_BLOCK), round_up(dim, DIM_BLOCK)), dtype=dtype, device=device)

    def log_uniform(shape, lo, hi):
        u = torch.rand(shape, generator=gen, device=device)
        return torch.exp(math.log(lo) + (math.log(hi) - math.log(lo)) * u)

    for start in range(0, rows, block):
        n = min(block, rows - start)
        n_micro = -(-n // group)
        ids = torch.randint(0, topics, (n_micro,), generator=gen, device=device)
        u = torch.randn((n_micro, dim), generator=gen, device=device) / math.sqrt(dim)
        r_micro = radius * log_uniform((n_micro, 1), 0.5, 1.5)
        micro = centers[ids] + r_micro * u
        s_row = 0.1 * r_micro[:, None, :] * log_uniform((n_micro, group, 1), 0.5, 2.0)
        w = torch.randn((n_micro, group, dim), generator=gen, device=device) / math.sqrt(dim)
        x = (micro[:, None, :] + s_row * w).reshape(n_micro * group, dim)[:n]
        out[start : start + n, :dim] = (x / x.norm(dim=1, keepdim=True)).to(dtype)
    return out


def corpus(seed: int, spec: dict, device) -> torch.Tensor:
    """The store rows of a configuration's ``corpus`` entry."""
    dtype = getattr(torch, spec["dtype"])
    if spec["kind"] == "unit_gaussian":
        return unit_corpus(seed, spec["rows"], spec["dim"], device, dtype)
    if spec["kind"] == "micro_clusters":
        return micro_cluster_corpus(seed, spec["rows"], spec["dim"], device, topics=spec["topics"],
                                    group=spec["group"], radius=spec["radius"], dtype=dtype)
    raise ValueError(f"unknown corpus kind {spec['kind']!r}")


# ---------------------------------------------------------------- encoder weights


def encoder_shapes(model: dict) -> dict[str, tuple[int, ...]]:
    """Parameter shapes of an XLM-RoBERTa encoder under Hugging Face's names
    (linear weights ``[out, in]``)."""
    h, f = model["hidden_size"], model["intermediate_size"]
    shapes = {
        "embeddings.word_embeddings.weight": (model["vocab_size"], h),
        "embeddings.position_embeddings.weight": (model["max_position_embeddings"], h),
        "embeddings.token_type_embeddings.weight": (model["type_vocab_size"], h),
        "embeddings.LayerNorm.weight": (h,), "embeddings.LayerNorm.bias": (h,),
    }
    for i in range(model["num_hidden_layers"]):
        p = f"encoder.layer.{i}."
        for proj in ("attention.self.query", "attention.self.key", "attention.self.value", "attention.output.dense"):
            shapes[p + proj + ".weight"] = (h, h)
            shapes[p + proj + ".bias"] = (h,)
        shapes[p + "attention.output.LayerNorm.weight"] = (h,)
        shapes[p + "attention.output.LayerNorm.bias"] = (h,)
        shapes[p + "intermediate.dense.weight"] = (f, h)
        shapes[p + "intermediate.dense.bias"] = (f,)
        shapes[p + "output.dense.weight"] = (h, f)
        shapes[p + "output.dense.bias"] = (h,)
        shapes[p + "output.LayerNorm.weight"] = (h,)
        shapes[p + "output.LayerNorm.bias"] = (h,)
    return shapes


def encoder_weights(seed: int, model: dict, device, dtype=torch.bfloat16) -> dict[str, torch.Tensor]:
    """Random weights, drawn in one call and scaled per tensor: matrices and
    embedding tables normal(0, 1/sqrt(fan-in)) (the scale of flax's default
    initialisers, which the JAX package trains from; the embedding tables'
    fan-in is the hidden width), biases normal(0, ``std``), LayerNorm scales
    1 + normal(0, ``std``) and shifts normal(0, ``std``), ``std`` from the
    configuration's ``weights``. Views of one buffer, in ``dtype``."""
    std = float(model["weights"]["std"])
    shapes = encoder_shapes(model)
    total = sum(math.prod(s) for s in shapes.values())
    flat = torch.randn(total, generator=device_generator(seed, WEIGHTS, device), device=device, dtype=dtype)
    out, pos = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        t = flat[pos : pos + n].view(shape)
        if len(shape) == 2:
            t.mul_(shape[1] ** -0.5)
        else:
            t.mul_(std)
            if name.endswith("LayerNorm.weight"):
                t.add_(1.0)
        out[name] = t
        pos += n
    return out
