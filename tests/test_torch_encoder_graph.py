"""The query encoder's CUDA graphs (``providers/cuda_embed.py``): which
micro-batches replay a graph, and that a replay gives the eager forward's
embeddings. The rule and the CPU provider run here; the replays need the
card (``python -m pytest --noconftest tests/test_torch_encoder_graph.py``
there) and skip without one. No JAX: the reference is the port's own eager
forward."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from intool_rag_tpu_torch import config
from intool_rag_tpu_torch.models.encoder import EncoderConfig, TextEncoder
from intool_rag_tpu_torch.models.tokenizer import SimpleTokenizer
from intool_rag_tpu_torch.observability import get_metrics
from intool_rag_tpu_torch.providers import cuda_embed
from intool_rag_tpu_torch.providers.cuda_embed import CudaEmbeddingProvider, graph_engages, preset_config

COUNTERS = ("embed.micro_batches", "embed.graph_captures", "embed.graph_replays")


def _texts(rng, n: int, words: int) -> list[str]:
    """``n`` texts of ``words`` words at most (``words`` + 2 tokens through
    the hashing tokenizer); the first has all of them."""
    lengths = [words, *rng.integers(1, words + 1, n - 1)]
    return [" ".join(f"w{rng.integers(10_000)}" for _ in range(k)) for k in lengths]


def _counts() -> dict[str, int]:
    counters = get_metrics().snapshot()["counters"]
    return {name: counters.get(name, 0) for name in COUNTERS}


def _since(before: dict[str, int]) -> dict[str, int]:
    return {name: value - before[name] for name, value in _counts().items()}


def _provider(encoder: TextEncoder) -> CudaEmbeddingProvider:
    cfg = encoder.config
    return CudaEmbeddingProvider(encoder, tokenizer=SimpleTokenizer(cfg.vocab_size, cfg.max_position - 2))


@pytest.mark.parametrize(
    "device, packed, b_pad, s_pad, flash_min_len, engages",
    [
        ("cuda", False, 64, 32, 1024, True),
        ("cuda", False, 64, 64, 1024, True),
        ("cuda", False, 1, 16, 1024, True),
        ("cuda", False, 64, 128, 1024, True),  # the cut: 8,192 slots
        ("cuda", False, 16, 512, 1024, True),
        ("cuda", False, 64, 256, 1024, False),  # past the cut
        ("cuda", False, 64, 512, 1024, False),
        ("cuda", False, 8, 1024, 1024, False),  # within the cut, but the flash route
        ("cuda", False, 64, 128, 0, True),  # flash_min_len 0: no flash route at all
        ("cuda", True, 64, 32, 1024, False),  # packed rows
        ("cpu", False, 64, 32, 1024, False),
    ],
)
def test_graph_engagement_rule(device, packed, b_pad, s_pad, flash_min_len, engages):
    assert graph_engages(torch.device(device), packed, b_pad, s_pad, flash_min_len) is engages


def test_cpu_provider_runs_eagerly_and_counts_no_graph():
    """On the CPU every micro-batch runs the eager forward: the embeddings
    are the encoder's on the provider's padded buckets, bit for bit, and only
    ``embed.micro_batches`` counts."""
    encoder = TextEncoder(EncoderConfig.tiny(), device="cpu").init_random(torch.Generator().manual_seed(0))
    provider = _provider(encoder)
    rng = np.random.default_rng(0)
    batches = [_texts(rng, 3, 12), _texts(rng, 3, 12), _texts(rng, 5, 40), _texts(rng, 3, 12)]
    before = _counts()
    for texts in batches:
        got = provider.embed_batch_device(texts)
        ids, mask = provider.tokenizer.encode_batch(texts)
        b_pad, s_pad = got.shape[0], cuda_embed._bucket(ids.shape[1])
        ids_p = np.full((b_pad, s_pad), provider.tokenizer.pad_id, np.int32)
        mask_p = np.zeros((b_pad, s_pad), np.int32)
        ids_p[: len(texts), : ids.shape[1]], mask_p[: len(texts), : ids.shape[1]] = ids, mask
        with torch.no_grad():
            want = encoder(torch.as_tensor(ids_p), torch.as_tensor(mask_p))
        assert torch.equal(got, want)
        np.testing.assert_array_equal(provider.embed_batch(texts), want[: len(texts)].numpy())
    assert _since(before) == {"embed.micro_batches": 8, "embed.graph_captures": 0, "embed.graph_replays": 0}
    assert provider._graphs == {}


# ---------------------------------------------------------------- on the card


@pytest.fixture
def small_encoder(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs have no CPU mode")
    monkeypatch.setenv("EMBEDDING_PRESET", "small")
    config.reset_config()
    try:
        cfg = preset_config(torch.device("cuda"))
    finally:
        monkeypatch.undo()
        config.reset_config()
    return TextEncoder(cfg, device="cuda").init_random(torch.Generator(device="cuda").manual_seed(0))


@pytest.mark.parametrize("bucket", [(64, 32), (64, 64), (4, 16)])
def test_replay_equals_eager_on_card(small_encoder, bucket):
    """Three micro-batches of one bucket (eager, capture, replay): the
    replay's embeddings are the eager forward's on the same texts, bit for
    bit, and a fresh provider's first (eager) call agrees."""
    b_pad, s_pad = bucket
    rng = np.random.default_rng(b_pad * s_pad)
    provider = _provider(small_encoder)
    for _ in range(3):
        texts = _texts(rng, b_pad, s_pad - 2)
        got = provider.embed_batch_device(texts)
        want = _provider(small_encoder).embed_batch_device(texts)
        assert got.shape == want.shape == (b_pad, small_encoder.config.hidden_size)
        assert torch.equal(got, want)
    assert provider._graphs[bucket] is not None


def test_short_batch_after_long_one_on_card(small_encoder):
    """In bucket (4, 16): a full batch of 14-word texts, then three texts of
    one to three words. The static inputs are rewritten whole, so the short
    batch's rows equal its eager embeddings and its pad rows those of a
    fresh eager call."""
    rng = np.random.default_rng(1)
    provider = _provider(small_encoder)
    for _ in range(3):
        provider.embed_batch_device(_texts(rng, 4, 14))
    short = _texts(rng, 3, 3)
    got = provider.embed_batch_device(short)
    assert torch.equal(got, _provider(small_encoder).embed_batch_device(short))
    np.testing.assert_array_equal(provider.embed_batch(short), _provider(small_encoder).embed_batch(short))


def test_device_result_outlives_later_calls_on_card(small_encoder):
    """``embed_batch_device`` hands out a copy: a later replay of the same
    bucket leaves an earlier result as it was."""
    rng = np.random.default_rng(2)
    provider = _provider(small_encoder)
    for _ in range(2):
        provider.embed_batch_device(_texts(rng, 64, 30))
    first = provider.embed_batch_device(_texts(rng, 64, 30))
    kept = first.clone()
    second = provider.embed_batch_device(_texts(rng, 64, 30))
    torch.cuda.synchronize()
    assert torch.equal(first, kept)
    assert not torch.equal(first, second)


def test_graph_counters_on_card(small_encoder):
    """n calls of one bucket: n micro-batches, one capture, n − 2 replays;
    a bucket past the cut counts neither."""
    rng = np.random.default_rng(3)
    provider = _provider(small_encoder)
    before = _counts()
    for _ in range(5):
        provider.embed_batch_device(_texts(rng, 64, 60))
    assert _since(before) == {"embed.micro_batches": 5, "embed.graph_captures": 1, "embed.graph_replays": 3}
    before = _counts()
    for _ in range(3):
        provider.embed_batch_device(_texts(rng, 64, 500))  # bucket (64, 512)
    assert _since(before) == {"embed.micro_batches": 3, "embed.graph_captures": 0, "embed.graph_replays": 0}
