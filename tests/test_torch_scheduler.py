"""The port's continuous-batching scheduler against the JAX package's.

The JAX ``DecoderLM`` weights come across through
``decoder_state_from_flax``; the same seeded prompts and budgets go
through the JAX ``ContinuousGenerator`` and the port's on the CPU, in f32.
Greedy tokens must be equal per stream (tolerance: none), and equal to the
port's static ``generate`` of each prompt alone: with plain waves, with EOS
freeing slots early, across compactions (a cache too small for the run),
and with speculative waves. Speculation with sampling is refused. Sampled
tokens cannot equal the JAX package's (another generator): every one lies
in ``filter_logits``' kept set after its prefix, and one seed gives one
sequence. These mirror ``tests/test_scheduler.py``; its slow cases stay
slow here."""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch

from intool_rag_tpu.models import decoder as jdec
from intool_rag_tpu.models.scheduler import ContinuousGenerator as JGenerator
from intool_rag_tpu_torch.models import decoder as tdec
from intool_rag_tpu_torch.models.scheduler import ContinuousGenerator

torch.set_num_threads(2)
JCFG = jdec.DecoderConfig(vocab_size=257, hidden_size=64, num_layers=2, num_heads=4, num_kv_heads=2,
                          intermediate_size=128, max_position=512, dtype="float32")


@pytest.fixture(scope="module")
def params():
    return jdec.init_decoder_params(JCFG)


def _port(params, max_position: int = JCFG.max_position) -> tdec.DecoderLM:
    cfg = tdec.DecoderConfig(**{**dataclasses.asdict(JCFG), "max_position": max_position})
    model = tdec.DecoderLM(cfg, device="cpu").eval()
    model.load_state_dict(tdec.decoder_state_from_flax(jax.tree.map(np.asarray, params)))
    return model


def _static(model, ids: list[int], limit: int, eos: int | None = None) -> list[int]:
    """The static path, one prompt alone in its power-of-two bucket, cut at EOS."""
    bucket = 1 << max(3, (len(ids) - 1).bit_length())
    arr = torch.zeros((1, bucket), dtype=torch.long)
    mask = torch.zeros((1, bucket), dtype=torch.int32)
    arr[0, bucket - len(ids):] = torch.as_tensor(ids)
    mask[0, bucket - len(ids):] = 1
    toks = tdec.generate(model, arr, mask, max_new_tokens=limit, eos_id=eos)[0].tolist()
    return toks[: toks.index(eos)] if eos in toks else toks


def test_continuous_matches_jax_and_static_greedy(params, rng):
    n = 10
    prompts = [rng.integers(5, 250, size=int(rng.integers(4, 20))).tolist() for _ in range(n)]
    limits = [int(rng.integers(3, 10)) for _ in range(n)]
    model = _port(params)
    want, _ = JGenerator(JCFG, params, n_slots=4, seg_len=4).generate_many(prompts, limits)
    got, stats = ContinuousGenerator(model, n_slots=4, seg_len=4).generate_many(prompts, limits)
    assert got == want
    for i, (ids, limit) in enumerate(zip(prompts, limits)):
        assert got[i] == _static(model, ids, limit), i
    assert stats["total_tokens"] == sum(limits) and stats["p50_latency_s"] > 0
    assert stats["compactions"] == 0 and "tokens_per_wave" not in stats


def test_compaction_parity(params, rng):
    """A cache too small for the run compacts (prefills every live history
    again) at least once; the tokens equal an ample cache's and JAX's."""
    prompts = [rng.integers(5, 250, size=int(rng.integers(4, 16))).tolist() for _ in range(8)]
    limits = [int(rng.integers(8, 16)) for _ in range(8)]
    got, stats_small = ContinuousGenerator(_port(params, 64), n_slots=2, seg_len=4).generate_many(prompts, limits)
    big, stats_big = ContinuousGenerator(_port(params), n_slots=2, seg_len=4).generate_many(prompts, limits)
    small_cfg = dataclasses.replace(JCFG, max_position=64)
    want, jstats = JGenerator(small_cfg, params, n_slots=2, seg_len=4).generate_many(prompts, limits)
    assert stats_small["compactions"] >= 1 and stats_big["compactions"] == 0
    assert stats_small["compactions"] == jstats["compactions"]
    assert got == big == want


def test_continuous_respects_eos(params, rng):
    """Streams that hit EOS free their slot early; later tenants of a slot
    are unaffected by the earlier one's cache."""
    model = _port(params)
    prompts = [rng.integers(5, 250, size=6).tolist() for _ in range(6)]
    eos = _static(model, prompts[0], 4)[1]  # a token the greedy model emits
    got, _ = ContinuousGenerator(model, n_slots=2, seg_len=3, eos_id=eos).generate_many(prompts, 8)
    want, _ = JGenerator(JCFG, params, n_slots=2, seg_len=3, eos_id=eos).generate_many(prompts, 8)
    assert got == want and len(got) == 6
    for ids, toks in zip(prompts, got):
        assert len(toks) <= 8 and eos not in toks
        assert toks == _static(model, ids, 8, eos)
    assert len(got[0]) == 1  # its second token was EOS


def test_speculative_batched_matches_plain_and_jax(params, rng):
    """Speculative waves give the plain scheduler's greedy tokens for every
    stream, and JAX's speculative waves' tokens."""
    n = 8
    prompts = [rng.integers(5, 250, size=int(rng.integers(4, 24))).tolist() for _ in range(n)]
    limits = [int(rng.integers(6, 20)) for _ in range(n)]
    model = _port(params)
    plain, _ = ContinuousGenerator(model, n_slots=4, seg_len=4).generate_many(prompts, limits)
    got, stats = ContinuousGenerator(model, n_slots=4, seg_len=4, speculative_gamma=4,
                                     lookup_window=32).generate_many(prompts, limits)
    want, _ = JGenerator(JCFG, params, n_slots=4, seg_len=4, speculative_gamma=4,
                         lookup_window=32).generate_many(prompts, limits)
    assert got == plain == want
    assert stats["tokens_per_wave"] >= 1.0  # every active wave emits at least one token


@pytest.mark.slow
def test_speculative_accepts_on_repetition(params):
    """A prompt that repeats a block: once the stream quotes it, the window
    drafts the rest. Tokens equal plain greedy whatever is accepted; when the
    greedy stream repeats a bigram, more than one token a wave is emitted."""
    model = _port(params)
    block = list(range(40, 52))
    prompts = [block * 3, [7, 9, 11] * 6]
    plain, _ = ContinuousGenerator(model, n_slots=2, seg_len=4).generate_many(prompts, 40)
    got, stats = ContinuousGenerator(model, n_slots=2, seg_len=4, speculative_gamma=4,
                                     lookup_window=64).generate_many(prompts, 40)
    assert got == plain
    loops = any(len(set(zip(w, w[1:]))) < len(w) - 1 for w in plain)
    if loops:
        assert stats["tokens_per_wave"] > 1.0, stats


def test_speculative_refuses_sampling(params):
    with pytest.raises(ValueError, match="greedy"):
        ContinuousGenerator(_port(params), speculative_gamma=4, temperature=0.7)
    with pytest.raises(ValueError, match="greedy"):
        JGenerator(JCFG, params, speculative_gamma=4, temperature=0.7)


def test_sampling_stays_in_the_kept_set_and_repeats_per_seed(params, rng):
    model = _port(params)
    prompts = [rng.integers(5, 250, size=int(rng.integers(4, 12))).tolist() for _ in range(5)]
    gen = ContinuousGenerator(model, n_slots=2, seg_len=4, temperature=0.9, top_k=5)
    first, _ = gen.generate_many(prompts, 12, seed=3)
    again, _ = gen.generate_many(prompts, 12, seed=3)
    other, _ = gen.generate_many(prompts, 12, seed=4)
    assert first == again and first != other
    for ids, toks in zip(prompts, first):
        seq = torch.as_tensor([ids + toks])
        pos = torch.arange(seq.shape[1])[None]
        with torch.no_grad():
            logits = model(seq, pos, tdec.init_cache(model.config, 1, "cpu"))[0]
        kept = tdec.filter_logits(logits[len(ids) - 1 : -1], top_k=5) > -float("inf")
        assert bool(kept[torch.arange(len(toks)), torch.as_tensor(toks)].all())


@pytest.mark.slow
def test_speculative_compaction_parity(rng):
    """Speculation burns ``gamma`` cursor positions a wave, so compaction
    comes sooner; the tokens stay the plain path's and JAX's."""
    cfg = dataclasses.replace(JCFG, max_position=160)
    params = jdec.init_decoder_params(cfg)
    prompts = [rng.integers(5, 250, size=8).tolist() for _ in range(4)]
    model = _port(params, 160)
    plain, _ = ContinuousGenerator(model, n_slots=2, seg_len=4).generate_many(prompts, 24)
    got, stats = ContinuousGenerator(model, n_slots=2, seg_len=4, speculative_gamma=4,
                                     lookup_window=32).generate_many(prompts, 24)
    want, _ = JGenerator(cfg, params, n_slots=2, seg_len=4, speculative_gamma=4,
                         lookup_window=32).generate_many(prompts, 24)
    assert got == plain == want
    assert stats["compactions"] >= 1, stats
