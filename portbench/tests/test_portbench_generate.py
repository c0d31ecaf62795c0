"""The traffic generator: the same seed gives the same requests; another
seed gives the same lengths in another order."""

from __future__ import annotations

import numpy as np
import pytest

from portbench import data, generate, manifest


def _traffic(name):
    return manifest._json(manifest.traffic_path(name))


@pytest.mark.parametrize("seed", [3_000_000_011, 7])
def test_same_seed_same_plan(seed):
    vocab = data.vocabulary(5, 2000)
    a = generate.plan(_traffic("batch256"), vocab, seed)
    b = generate.plan(_traffic("batch256"), vocab, seed)
    assert a["batches"] == b["batches"]


@pytest.mark.parametrize("seeds", [(11, 12), (3_000_000_011, 3_000_000_012)])
def test_other_seed_same_sizes_other_order(seeds):
    vocab = data.vocabulary(5, 2000)
    traffic = _traffic("batch256")
    a, b = (generate.plan(traffic, vocab, s) for s in seeds)
    for x, y in zip(a["batches"], b["batches"]):
        assert sorted(len(t.split()) for t in x) == sorted(len(t.split()) for t in y)
    assert a["batches"] != b["batches"]


def test_lengths_follow_the_quantiles():
    spec = {"median": 12, "sigma": 0.6, "min": 4, "max": 48}
    lens = generate.length_quantiles(spec, 256)
    assert lens.min() >= 4 and lens.max() <= 48 and np.median(lens) == 12
    assert list(lens) == sorted(lens)


def test_batch_traffic_averages_the_cited_question_length():
    # BEIR's Natural Questions queries average 9.16 words (Thakur et al., 2021, Table 1)
    traffic = _traffic("batch256")
    lens = generate.length_quantiles(traffic["words"], traffic["batch"])
    assert abs(lens.mean() - 9.16) < 0.1 and "9.16" in traffic["source"]


def test_words_survive_the_analyzer():
    from portbench.reference.text import analyze

    vocab = data.vocabulary(9, 3000)
    assert len(set(vocab)) == 3000
    assert analyze(" ".join(vocab)) == vocab
