"""The training slice as a whole, on the CPU: synthetic relevance task ->
``train_encoder_cached`` -> saved checkpoint -> served by the port's
embedding provider (and opened by the JAX package) -> better dense
retrieval than the untrained encoder; ``train_reranker`` -> a ``Reranker``
behind the port's ``/search`` that reorders the hits and reports the
sigmoid of its logit as the score."""

from __future__ import annotations

import json
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from intool_rag_tpu.models import encoder as jenc
from intool_rag_tpu_torch import config as tconfig
from intool_rag_tpu_torch.eval.harness import build_engine_from_texts, evaluate_engine
from intool_rag_tpu_torch.eval.synthetic import make_relevance_task
from intool_rag_tpu_torch.ingest.schemas import (
    Chunk, ChunksIndex, NodeLevel, PageIndex, SemanticNode, VectorMeta, make_chunk_id,
)
from intool_rag_tpu_torch.models.encoder import EncoderConfig, TextEncoder, save_encoder_checkpoint
from intool_rag_tpu_torch.models.reranker import Reranker
from intool_rag_tpu_torch.models.tokenizer import SimpleTokenizer
from intool_rag_tpu_torch.providers.cuda_embed import CudaEmbeddingProvider
from intool_rag_tpu_torch.service.app import RAGService
from intool_rag_tpu_torch.storage.artifacts import FileStorageManager
from intool_rag_tpu_torch.train.contrastive import tokenize_pairs, train_encoder_cached
from intool_rag_tpu_torch.train.rerank import build_pair_pool, train_reranker

torch.set_num_threads(2)

CONFIG = EncoderConfig(vocab_size=2048, hidden_size=64, num_layers=2, num_heads=4, intermediate_size=128,
                       max_position=48, dtype="float32", flash_min_len=0)


@pytest.fixture(scope="module")
def task():
    return make_relevance_task(np.random.default_rng(31), n_train_queries=200)


@pytest.fixture(scope="module")
def tokenizer():
    return SimpleTokenizer(vocab_size=CONFIG.vocab_size, max_length=40)


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("EMBEDDING_QUERY_INSTRUCTION", "")
    monkeypatch.setenv("EMBED_PACKED", "0")
    monkeypatch.setenv("RERANK_PACKED", "0")
    monkeypatch.setenv("INDEX_KIND", "flat")
    monkeypatch.setenv("DENSE_INT8", "0")
    monkeypatch.setenv("DENSE_INT8_RESIDUAL", "0")
    monkeypatch.setenv("INDEX_DTYPE", "float32")
    tconfig.reset_config()
    yield
    monkeypatch.undo()
    tconfig.reset_config()


@pytest.fixture(scope="module")
def trained_encoder(task, tokenizer, tmp_path_factory):
    """(checkpoint path, mean losses, the trained model)."""
    keep = task.train_labels > 0
    pairs = tokenize_pairs(tokenizer, [q for q, k in zip(task.train_queries, keep) if k],
                           [p for p, k in zip(task.train_passages, keep) if k], max_len=24)
    model, means = train_encoder_cached(CONFIG, pairs, steps=150, batch=32, lr=1e-3, steps_per_launch=50,
                                        device="cpu")
    path = tmp_path_factory.mktemp("trained") / "encoder.npz"
    save_encoder_checkpoint(path, model)
    return path, means, model


def _dense_ndcg(provider, task) -> float:
    engine = build_engine_from_texts(task.texts, provider, device="cpu")
    return evaluate_engine(engine, provider, task.examples, k=10, modes=("dense",))["dense"]["ndcg@k"]


def test_trained_checkpoint_serves_and_beats_the_untrained_encoder(task, tokenizer, trained_encoder):
    path, means, _ = trained_encoder
    assert means.shape == (3,) and means[-1] < means[0]
    untrained = TextEncoder(CONFIG, device="cpu").init_flax(torch.Generator().manual_seed(0))
    before = _dense_ndcg(CudaEmbeddingProvider(untrained, tokenizer=tokenizer), task)
    served = CudaEmbeddingProvider(checkpoint=str(path), tokenizer=tokenizer, device="cpu")
    assert served.encoder_config == CONFIG
    after = _dense_ndcg(served, task)
    # found: NDCG@10 0.04 untrained, 0.88 after 150 steps
    assert after > before + 0.3, (before, after)


def test_saved_checkpoint_opens_in_the_jax_package(task, tokenizer, trained_encoder):
    path, _, model = trained_encoder
    jcfg, params = jenc.load_encoder_checkpoint(path)
    assert (jcfg.hidden_size, jcfg.num_layers, jcfg.flash_min_len, jcfg.ring_axis) == (64, 2, 0, None)
    ids, mask = tokenizer.encode_batch(task.texts[:16])
    want = np.asarray(jenc.TextEncoder(jcfg).apply(params, jnp.asarray(ids), jnp.asarray(mask)))
    with torch.no_grad():
        got = model(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def _write_storage(storage_dir, texts, emb) -> None:
    fsm = FileStorageManager(storage_dir)
    per_doc = 80
    for d in range(len(texts) // per_doc):
        doc_id = f"doc{d}"
        rows = range(d * per_doc, (d + 1) * per_doc)
        pages = [i // 8 for i in range(per_doc)]
        chunk_ids = [make_chunk_id(p, i) for i, p in enumerate(pages)]
        nodes = [SemanticNode("n_000", f"Chapter {d}", NodeLevel.CHAPTER, 0, children=["n_001"]),
                 SemanticNode("n_001", f"Section {d}.1", NodeLevel.SECTION, 0, parent_id="n_000")]
        fsm.save_page_index(PageIndex(doc_id, f"{doc_id}.pdf", "p0", "en", 10, nodes))
        fsm.save_chunks(ChunksIndex(doc_id, [Chunk(c, "n_001", p, texts[r]) for c, p, r in zip(chunk_ids, pages, rows)]))
        fsm.save_vectors(doc_id, emb[rows.start : rows.stop],
                         VectorMeta(doc_id, "trained", emb.shape[1], per_doc, chunk_ids, pages))


def test_trained_reranker_reorders_search_hits(task, tokenizer, trained_encoder, tmp_path, monkeypatch):
    pool = build_pair_pool(tokenizer, task.train_queries, task.train_passages, task.train_labels, max_len=24,
                           augment_shuffle=1, rng=np.random.default_rng(32))
    params, means = train_reranker(CONFIG, pool, steps=300, batch=64, lr=1e-3, steps_per_launch=100,
                                   device="cpu")
    assert means[-1] < means[0]
    reranker = Reranker.create(CONFIG, tokenizer=tokenizer, params=params, device="cpu")

    provider = CudaEmbeddingProvider(trained_encoder[2], tokenizer=tokenizer)
    _write_storage(tmp_path, task.texts, provider.embed_batch(task.texts))
    monkeypatch.setenv("STORAGE_DIR", str(tmp_path))
    monkeypatch.setenv("RETRIEVAL_CANDIDATES", "10")
    monkeypatch.setenv("RETRIEVAL_MIN_SCORE", "0.0")
    monkeypatch.setenv("RERANKER_CANDIDATES", "30")
    monkeypatch.setenv("QUERY_MAX_BATCH", "1")
    monkeypatch.setenv("RERANKER_ENABLED", "true")
    tconfig.reset_config()
    plain = RAGService(provider, device="cpu")
    assert plain.retriever._reranker is None  # no local weights: the factory serves nothing
    reranked = RAGService(provider, device="cpu", reranker=reranker)
    monkeypatch.setenv("QUERY_MAX_BATCH", "8")
    tconfig.reset_config()
    batched = RAGService(provider, device="cpu", reranker=reranker)  # the micro-batcher's path

    changed = 0
    for example in task.examples[:6]:
        body = json.dumps({"question": example.query}).encode()
        status, base = plain.handle("POST", "/search", body)
        status_r, out = reranked.handle("POST", "/search", body)
        status_b, out_b = batched.handle("POST", "/search", body)
        assert status == status_r == status_b == 200
        hits = out["hits"]
        assert len(hits) == 10 and out_b["hits"] == hits
        # score = sigmoid of the cross-encoder's logit for (query, hit text), in descending order
        logits = reranker.score_pairs([example.query] * len(hits), [h["text"] for h in hits])
        want = [round(1.0 / (1.0 + math.exp(-float(x))), 4) for x in logits]
        assert [h["score"] for h in hits] == pytest.approx(want, abs=2e-4)
        assert [h["score"] for h in hits] == sorted((h["score"] for h in hits), reverse=True)
        changed += [h["chunk_id"] for h in hits] != [h["chunk_id"] for h in base["hits"]]
    assert changed >= 4  # the cross-encoder's order is its own, not the hybrid one
    for service in (plain, reranked, batched):
        service.tasks.shutdown()

    monkeypatch.setenv("RERANKER_ENABLED", "false")  # the switch is the config's: the reranker stays unused
    tconfig.reset_config()
    body = json.dumps({"question": task.examples[0].query}).encode()
    assert reranked.handle("POST", "/search", body)[1]["hits"] == plain.handle("POST", "/search", body)[1]["hits"]
