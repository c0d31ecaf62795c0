"""``CudaEmbeddingProvider`` with ``EMBED_PACKED`` against the JAX
package's ``TPUEmbeddingProvider``, packed and padded, with the same
weights on the texts of ``tests/test_providers.py``'s packing test."""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from intool_rag_tpu.models import encoder as jenc
from intool_rag_tpu.providers.tpu_embed import TPUEmbeddingProvider
from intool_rag_tpu_torch.models import encoder as tenc
from intool_rag_tpu_torch.providers.cuda_embed import CudaEmbeddingProvider

torch.set_num_threads(2)

ATOL = 2e-4  # f32, 2 layers; the JAX package's own packed-vs-padded bar


@pytest.fixture(scope="module")
def providers():
    cfg = jenc.EncoderConfig.tiny()
    params = jenc.init_params(cfg, seed=9)
    jprov = TPUEmbeddingProvider(config=cfg, params=params, model_name="tiny-test")
    model = tenc.TextEncoder(tenc.EncoderConfig.tiny(), device="cpu")
    model.load_state_dict(tenc.params_from_jax(jax.tree.map(np.asarray, params)))
    return jprov, CudaEmbeddingProvider(model, model_name="tiny-test")


def _texts(n: int, longest: int) -> list[str]:
    rng = np.random.default_rng(0)
    words = ["invoice", "total", "amount", "shipping", "terms", "due"]
    return [" ".join(rng.choice(words, int(rng.integers(2, longest)))) for _ in range(n)]


@pytest.mark.parametrize("is_query", [False, True], ids=["passages", "queries"])
@pytest.mark.parametrize("n,longest,batch_size", [(13, 40, 64), (70, 120, 16)],
                         ids=["one-launch", "several-launches"])
def test_packed_provider_matches_jax(providers, n, longest, batch_size, is_query):
    jprov, tprov = providers
    texts = _texts(n, longest)
    jprov.batch_size = tprov.batch_size = batch_size
    jprov.packed = tprov.packed = False
    padded_j = jprov.embed_batch(texts, is_query=is_query)
    padded_t = tprov.embed_batch(texts, is_query=is_query)
    jprov.packed = tprov.packed = True
    packed_j = jprov.embed_batch(texts, is_query=is_query)
    packed_t = tprov.embed_batch(texts, is_query=is_query)
    assert packed_t.shape == (n, 64) and packed_t.dtype == np.float32
    np.testing.assert_allclose(packed_t, packed_j, atol=ATOL, rtol=0)
    np.testing.assert_allclose(packed_t, padded_j, atol=ATOL, rtol=0)
    np.testing.assert_allclose(packed_t, padded_t, atol=ATOL, rtol=0)
    np.testing.assert_allclose(np.linalg.norm(packed_t, axis=1), 1.0, atol=1e-5)


def test_packed_provider_surface(providers, monkeypatch):
    _, tprov = providers
    tprov.packed = True
    assert tprov.embed_batch_device(["invoice total"]) is None  # callers then use embed_batch
    tprov.packed = False
    assert tprov.embed_batch_device(["invoice total"]).shape == (1, 64)
    np.testing.assert_allclose(
        tprov.embed_single("invoice total", is_query=True),
        tprov.embed_batch(["invoice total"], is_query=True)[0], atol=1e-6)
    assert tprov.model_name == "tiny-test" and tprov.embed_batch([]).shape == (0, 64)
    monkeypatch.setenv("EMBED_PACKED", "1")
    monkeypatch.setenv("EMBED_PACK_WIDTH", "2048")
    fresh = CudaEmbeddingProvider(tprov.encoder)
    assert fresh.packed and fresh.pack_width == 2048
    monkeypatch.setenv("EMBED_PACKED", "0")
    assert not CudaEmbeddingProvider(tprov.encoder).packed
