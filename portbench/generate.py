"""The traffic generator: turns a traffic file (``portbench/traffic/<name>.json``)
and the run's seed into batches of questions.

Every seed gets the same work in another order: question lengths are the
quantiles of the file's length distribution (one full set per batch),
shuffled by the seed. Only the words of a question, drawn from the Zipf
distribution over the BM25 vocabulary, differ from seed to seed.
"""

from __future__ import annotations

import statistics

import numpy as np

from . import data


def length_quantiles(spec: dict, n: int) -> np.ndarray:
    """``n`` word counts at the quantiles (i + 0.5)/n of a log-normal of
    median ``spec['median']`` and shape ``spec['sigma']``, clipped to
    [``min``, ``max``]."""
    z = np.array([statistics.NormalDist().inv_cdf((i + 0.5) / n) for i in range(n)])
    words = np.rint(spec["median"] * np.exp(spec["sigma"] * z))
    return np.clip(words, spec["min"], spec["max"]).astype(np.int64)


def questions(rng: np.random.Generator, vocab: list[str], spec: dict, count: int, zipf_s: float,
              block: int) -> list[str]:
    """``count`` questions; each block of ``block`` holds the full set of
    quantile lengths in a shuffled order."""
    base = length_quantiles(spec, block)
    lens = np.concatenate([rng.permutation(base) for _ in range(-(-count // block))])[:count]
    terms = data.zipf_terms_host(rng, int(lens.sum()), zipf_s, len(vocab))
    words = np.asarray(vocab, dtype=object)[terms]
    out, pos = [], 0
    for n in lens:
        out.append(" ".join(words[pos : pos + n]))
        pos += n
    return out


def plan(traffic: dict, vocab: list[str], seed: int) -> dict:
    """The run's requests: ``batches`` lists of ``batch`` questions, which a
    closed loop cycles through the window, whatever its length."""
    rng = data.host_rng(seed, data.TRAFFIC)
    if traffic["loop"] != "closed":
        raise ValueError(f"unknown loop {traffic['loop']!r}")
    b = traffic["batch"]
    flat = questions(rng, vocab, traffic["words"], b * traffic["batches"], traffic["zipf_s"], b)
    return {"batches": [flat[i : i + b] for i in range(0, len(flat), b)]}
