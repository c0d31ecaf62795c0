"""The port's encoder, checkpoint reader and tokenizer against the JAX
package (same token ids and weights on both sides)."""

from __future__ import annotations

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from intool_rag_tpu.models import encoder as jenc
from intool_rag_tpu.models.tokenizer import SimpleTokenizer as JTokenizer
from intool_rag_tpu_torch.models import encoder as tenc
from intool_rag_tpu_torch.models.tokenizer import SimpleTokenizer as TTokenizer

torch.set_num_threads(2)

CKPT = Path(__file__).resolve().parents[1] / "intool_rag_tpu" / "models" / "weights" / "encoder_mid.npz"
TEXTS = [
    "Represent this sentence for searching relevant passages: invoice total due",
    "quarterly revenue grew 12% year over year",
    "東京都のデータ分析",
    "the a an",  # stopwords only: CLS + SEP
    "Ünïcode naïve İstanbul straße",
    "page 3 of the annual report lists every subsidiary by region",
    "x",
    "warranty terms and conditions for replacement parts",
]


def test_msgpack_reader_matches_flax():
    from flax import serialization

    from intool_rag_tpu_torch.models.msgpack import unpackb

    with np.load(CKPT) as z:
        blob = bytes(z["params"])
    want = jax.tree_util.tree_leaves_with_path(serialization.msgpack_restore(blob))
    got = jax.tree_util.tree_leaves_with_path(unpackb(blob))
    assert len(got) == len(want) == 101
    for (gp, gv), (wp, wv) in zip(got, want):
        assert gp == wp
        assert gv.dtype == wv.dtype and gv.shape == wv.shape
        np.testing.assert_array_equal(gv, wv)


@pytest.mark.parametrize("text", TEXTS)
def test_simple_tokenizer_ids_match(text):
    j = JTokenizer(vocab_size=8192, max_length=64).encode_batch([text, "short"])
    t = TTokenizer(vocab_size=8192, max_length=64).encode_batch([text, "short"])
    for a, b in zip(t, j):
        np.testing.assert_array_equal(a, b)


def _jax_embed(config, params, ids, mask):
    return np.asarray(jax.jit(jenc.encode_fn(config))(params, jnp.asarray(ids), jnp.asarray(mask)))


def test_tiny_encoder_matches_jax():
    cfg = jenc.EncoderConfig.tiny()
    params = jenc.init_params(cfg, seed=3)
    tree = jax.tree.map(np.asarray, params)
    rng = np.random.default_rng(0)
    ids = rng.integers(4, cfg.vocab_size, size=(4, 24)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[1, 10:] = 0
    mask[3, 3:] = 0
    ids[mask == 0] = cfg.pad_token_id
    model = tenc.TextEncoder(tenc.EncoderConfig.tiny(), device="cpu")
    model.load_state_dict(tenc.params_from_jax(tree))
    with torch.no_grad():
        got = model(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, _jax_embed(cfg, params, ids, mask), atol=1e-5, rtol=0)


def test_encoder_mid_matches_jax():
    """encoder_mid at full width (6 layers, 384) on 8 queries: L2-normalized
    embeddings agree to max-abs 1e-4."""
    jcfg, jparams = jenc.load_encoder_checkpoint(CKPT)
    model = tenc.load_encoder(CKPT, device="cpu")
    assert model.config.hidden_size == 384 and model.config.num_layers == 6
    ids, mask = JTokenizer(vocab_size=jcfg.vocab_size, max_length=128).encode_batch(TEXTS)
    with torch.no_grad():
        got = model(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    want = _jax_embed(jcfg, jparams, ids, mask)
    assert np.abs(got - want).max() <= 1e-4


def test_missing_checkpoint_raises(tmp_path, monkeypatch, caplog):
    """A checkpoint path that does not exist raises. With no checkpoint at
    all the provider starts from seeded random weights of the preset size
    and warns, as the JAX provider does; the same seed gives the same
    weights."""
    from intool_rag_tpu_torch import config
    from intool_rag_tpu_torch.providers.cuda_embed import CudaEmbeddingProvider

    with pytest.raises(FileNotFoundError):
        tenc.load_encoder(tmp_path / "absent.npz", device="cpu")
    with pytest.raises(FileNotFoundError):
        CudaEmbeddingProvider(checkpoint=str(tmp_path / "absent.npz"), device="cpu")
    monkeypatch.delenv("EMBEDDING_CHECKPOINT", raising=False)
    monkeypatch.setenv("EMBEDDING_PRESET", "auto")
    config.reset_config()
    try:
        with caplog.at_level("WARNING"):
            provider = CudaEmbeddingProvider(checkpoint="", device="cpu")
        assert "random parameters" in caplog.text
        assert provider.encoder_config == tenc.EncoderConfig.tiny()  # auto on the CPU
        again = CudaEmbeddingProvider(device="cpu")
        for a, b in zip(provider.encoder.parameters(), again.encoder.parameters()):
            assert torch.equal(a, b)
        emb = provider.embed_batch(TEXTS[:2])
        np.testing.assert_allclose(np.linalg.norm(emb, axis=1), 1.0, atol=1e-5)
    finally:
        monkeypatch.undo()
        config.reset_config()


def test_provider_buckets_and_device_embeddings():
    from intool_rag_tpu_torch.providers.cuda_embed import CudaEmbeddingProvider

    model = tenc.TextEncoder(tenc.EncoderConfig.tiny(), device="cpu")
    model.init_random(torch.Generator().manual_seed(0))
    provider = CudaEmbeddingProvider(model)
    emb = provider.embed_batch_device(TEXTS[:3], is_query=True)
    assert emb.shape == (4, 64)  # batch bucket 4
    host = provider.embed_batch(TEXTS[:3], is_query=True)
    np.testing.assert_allclose(host, emb[:3].numpy(), atol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(host, axis=1), 1.0, atol=1e-5)
