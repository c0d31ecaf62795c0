"""The cross-encoder reranker, its trainer's pair pool, and the evaluation
host code: the port against the JAX package on the same seeded inputs."""

from __future__ import annotations

import dataclasses
import hashlib
import logging
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from intool_rag_tpu.eval import harness as jharness
from intool_rag_tpu.eval import metrics as jmetrics
from intool_rag_tpu.eval import synthetic as jsynthetic
from intool_rag_tpu.models import encoder as jenc
from intool_rag_tpu.models import reranker as jrer
from intool_rag_tpu.models.tokenizer import SimpleTokenizer as JaxTokenizer
from intool_rag_tpu.train import rerank as jtrain
from intool_rag_tpu_torch import config as tconfig
from intool_rag_tpu_torch.eval import harness as tharness
from intool_rag_tpu_torch.eval import metrics as tmetrics
from intool_rag_tpu_torch.eval import synthetic as tsynthetic
from intool_rag_tpu_torch.llm import reranker_factory
from intool_rag_tpu_torch.models.encoder import EncoderConfig
from intool_rag_tpu_torch.models.reranker import (
    CrossEncoder, Reranker, load_reranker_torch_state_dict, reranker_params_from_jax,
)
from intool_rag_tpu_torch.models.tokenizer import SimpleTokenizer
from intool_rag_tpu_torch.ops import flash_attention as tflash
from intool_rag_tpu_torch.train import rerank as ttrain

torch.set_num_threads(2)

# heads of 64 values and flash_min_len 128: packed rows of 128 tokens take the
# flash-attention route on the port's side
FLASH_CONFIG = dict(vocab_size=512, hidden_size=128, num_layers=2, num_heads=2, intermediate_size=256,
                    max_position=132, dtype="float32", flash_min_len=128)
WORDS = ["alpha", "beta", "gamma", "delta", "epsilon", "zeta", "eta", "theta"]


def _numpy_tree(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float32), tree)


def _jax_params(jcfg, seed: int):
    ones = jnp.ones((1, 8), jnp.int32)
    return jrer.CrossEncoder(jcfg).init(jax.random.PRNGKey(seed), ones, ones)


def _both(kw: dict, seed: int = 0):
    """(JAX config, its params, the port's CrossEncoder with those params)."""
    jcfg = jenc.EncoderConfig(**kw)
    params = _jax_params(jcfg, seed)
    model = CrossEncoder(EncoderConfig(**kw), device="cpu")
    model.load_state_dict(reranker_params_from_jax(_numpy_tree(params)))
    return jcfg, params, model.eval()


def _texts(rng, n: int, longest: int = 30):
    queries = [" ".join(rng.choice(WORDS, int(rng.integers(2, 6)))) for _ in range(n)]
    passages = [" ".join(rng.choice(WORDS, int(rng.integers(4, longest)))) for _ in range(n)]
    return queries, passages


@pytest.mark.parametrize("name", ["tiny", "flash"])
def test_cross_encoder_matches_flax_one_pair_per_row(name):
    kw = dict(FLASH_CONFIG) if name == "flash" else dataclasses.asdict(EncoderConfig.tiny())
    jcfg, params, model = _both(kw)
    rng = np.random.default_rng(0)
    s = 128 if name == "flash" else 24
    ids = rng.integers(4, jcfg.vocab_size, (3, s)).astype(np.int32)
    mask = (np.arange(s)[None] < np.array([[s], [s // 2], [5]])).astype(np.int32)
    ids = np.where(mask > 0, ids, 1).astype(np.int32)
    want = np.asarray(jrer.CrossEncoder(jcfg).apply(params, jnp.asarray(ids), jnp.asarray(mask)))
    with torch.no_grad():
        got = model(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    assert got.shape == (3,) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("name", ["tiny", "flash"])
def test_cross_encoder_matches_flax_packed(name):
    kw = dict(FLASH_CONFIG) if name == "flash" else dataclasses.asdict(EncoderConfig.tiny())
    jcfg, params, model = _both(kw, seed=1)
    rng = np.random.default_rng(1)
    s = 128
    ids = rng.integers(4, jcfg.vocab_size, (2, s)).astype(np.int32)
    seg = np.zeros((2, s), np.int32)
    cls = np.zeros((2, 4), np.int32)
    for row, cuts in enumerate(([0, 30, 71, 100, 120], [0, 64, 65, 90, 90])):
        for p in range(4):
            seg[row, cuts[p] : cuts[p + 1]] = p + 1
            cls[row, p] = cuts[p] if cuts[p + 1] > cuts[p] else 0
    ids = np.where(seg > 0, ids, 1).astype(np.int32)
    mask = (seg > 0).astype(np.int32)
    want = np.asarray(jrer.CrossEncoder(jcfg).apply(
        params, jnp.asarray(ids), jnp.asarray(mask), segment_ids=jnp.asarray(seg), cls_index=jnp.asarray(cls)))
    tflash.flash_attention_plain.calls.reset()
    with torch.no_grad():
        got = model(torch.from_numpy(ids), torch.from_numpy(mask), segment_ids=torch.from_numpy(seg),
                    cls_index=torch.from_numpy(cls)).numpy()
    assert got.shape == (2, 4)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    assert tflash.flash_attention_plain.calls.count == (2 if name == "flash" else 0)


@pytest.mark.parametrize("name,width", [("tiny", None), ("tiny", 32), ("flash", 128)])
def test_packed_scores_match_bucketed(name, width):
    """Same positions, same attention pattern, same head: only the layout
    differs. f32 on the CPU, atol 1e-5."""
    kw = dict(FLASH_CONFIG) if name == "flash" else dataclasses.asdict(EncoderConfig.tiny())
    reranker = Reranker.create(EncoderConfig(**kw), seed=3, device="cpu")
    queries, passages = _texts(np.random.default_rng(0), 17)  # odd count: partial bins and P padding
    base = reranker.score_pairs(queries, passages, packed=False)
    waste = reranker.last_padding_waste
    packed = reranker.score_pairs_packed(queries, passages, width=width)
    assert base.shape == packed.shape == (17,) and base.dtype == np.float32
    np.testing.assert_allclose(packed, base, atol=1e-5, rtol=0)
    assert 0.0 <= reranker.last_padding_waste and waste >= 0.0


def test_packed_env_default(monkeypatch):
    monkeypatch.setenv("RERANK_PACKED", "1")
    monkeypatch.setenv("RERANK_PACK_WIDTH", "256")
    reranker = Reranker.create(seed=3, device="cpu")
    assert reranker.packed and reranker.pack_width == 256
    scores = reranker.score_pairs(["a b c"], ["d e f g"])
    assert scores.shape == (1,) and np.isfinite(scores).all()
    assert reranker.score_pairs([], []).shape == (0,)


def test_score_pairs_and_rerank_order_match_the_jax_reranker():
    kw = dataclasses.asdict(EncoderConfig.tiny())
    jcfg, params, model = _both(kw, seed=7)
    jreranker = jrer.Reranker.create(jcfg, params=_numpy_tree(params))
    treranker = Reranker(model, SimpleTokenizer(vocab_size=jcfg.vocab_size, max_length=min(512, jcfg.max_position - 2)))
    queries, passages = _texts(np.random.default_rng(2), 70, longest=60)  # two buckets
    want = jreranker.score_pairs(queries, passages)
    got = treranker.score_pairs(queries, passages)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    assert abs(treranker.last_padding_waste - jreranker.last_padding_waste) < 1e-12
    rows = treranker._pair_rows(queries[:5], passages[:5])
    assert rows == jreranker._pair_rows(queries[:5], passages[:5])
    cands = [{"text": p, "chunk_id": i} for i, p in enumerate(dict.fromkeys(passages[:20]))]
    j_out = jreranker.rerank(queries[0], cands, top_k=5)
    t_out = treranker.rerank(queries[0], cands, top_k=5)
    assert [h["chunk_id"] for h in t_out] == [h["chunk_id"] for h in j_out]
    assert [h["rerank_position"] for h in t_out] == [0, 1, 2, 3, 4]
    np.testing.assert_allclose([h["rerank_score"] for h in t_out], [h["rerank_score"] for h in j_out], atol=1e-4)
    assert treranker.rerank("q", [], top_k=3) == []


def _hf_state_dict(rng, cfg) -> dict:
    """A seeded state dict under HF ``XLMRobertaForSequenceClassification`` names."""
    h, inter = cfg.hidden_size, cfg.intermediate_size

    def w(*shape):
        return (0.05 * rng.standard_normal(shape)).astype(np.float32)

    sd = {
        "roberta.embeddings.word_embeddings.weight": w(cfg.vocab_size, h),
        "roberta.embeddings.position_embeddings.weight": w(cfg.max_position, h),
        "roberta.embeddings.token_type_embeddings.weight": w(cfg.type_vocab_size, h),
        "roberta.embeddings.LayerNorm.weight": 1 + w(h), "roberta.embeddings.LayerNorm.bias": w(h),
        "classifier.dense.weight": w(h, h), "classifier.dense.bias": w(h),
        "classifier.out_proj.weight": w(1, h), "classifier.out_proj.bias": w(1),
    }
    for i in range(cfg.num_layers):
        p = f"roberta.encoder.layer.{i}"
        for name, shape in (("attention.self.query", (h, h)), ("attention.self.key", (h, h)),
                            ("attention.self.value", (h, h)), ("attention.output.dense", (h, h)),
                            ("intermediate.dense", (inter, h)), ("output.dense", (h, inter))):
            sd[f"{p}.{name}.weight"], sd[f"{p}.{name}.bias"] = w(*shape), w(shape[0])
        for name in ("attention.output.LayerNorm", "output.LayerNorm"):
            sd[f"{p}.{name}.weight"], sd[f"{p}.{name}.bias"] = 1 + w(h), w(h)
    return sd


def test_load_reranker_torch_state_dict_round_trip():
    """HF names -> the port's state dict equals HF names -> the JAX
    package's flax tree -> ``reranker_params_from_jax``; and the scores of
    the two packages agree on those weights."""
    cfg = EncoderConfig.tiny()
    jcfg = jenc.EncoderConfig(**dataclasses.asdict(cfg))
    sd = _hf_state_dict(np.random.default_rng(4), cfg)
    direct = load_reranker_torch_state_dict(cfg, sd)
    tree = jrer.load_reranker_torch_state_dict(jcfg, sd)
    via_jax = reranker_params_from_jax(_numpy_tree(tree))
    model = CrossEncoder(cfg, device="cpu")
    assert set(direct) == set(via_jax) == set(model.state_dict())
    for key in direct:
        assert direct[key].dtype == torch.float32
        assert torch.equal(direct[key], via_jax[key]), key
    model.load_state_dict(direct)
    ids = np.random.default_rng(0).integers(4, cfg.vocab_size, (3, 12)).astype(np.int32)
    mask = np.ones_like(ids)
    want = np.asarray(jrer.CrossEncoder(jcfg).apply(tree, jnp.asarray(ids), jnp.asarray(mask)))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    with pytest.raises(ValueError):
        reranker_params_from_jax({"params": {"body": {}}})


def test_reranker_from_hf_serves_the_given_weights():
    cfg = EncoderConfig.tiny()
    hf_config = types.SimpleNamespace(
        vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size, num_hidden_layers=cfg.num_layers,
        num_attention_heads=cfg.num_heads, intermediate_size=cfg.intermediate_size,
        max_position_embeddings=cfg.max_position, pad_token_id=1)
    sd = _hf_state_dict(np.random.default_rng(5), cfg)
    reranker = reranker_factory.reranker_from_hf(hf_config, sd, device="cpu")
    # the factory builds the default (bf16) config: the body's weights are resident in bf16, the head in f32
    assert reranker.model.body.word_emb.weight.dtype == torch.bfloat16
    assert reranker.model.head_dense.weight.dtype == torch.float32
    assert torch.equal(reranker.model.head_out.weight, torch.from_numpy(sd["classifier.out_proj.weight"]))
    scores = reranker.score_pairs(["alpha beta"] * 2, ["gamma delta", "epsilon"])
    assert scores.shape == (2,) and np.isfinite(scores).all() and scores[0] != scores[1]


@pytest.mark.parametrize("enabled,model", [("false", "BAAI/bge-reranker-v2-m3"), ("true", "no/such-model")])
def test_factory_returns_none_without_weights(enabled, model, monkeypatch, caplog):
    """Disabled, or enabled with no local weights: None, with a warning in
    the second case; random weights are never served."""
    monkeypatch.setenv("RERANKER_ENABLED", enabled)
    monkeypatch.setenv("RERANKER_MODEL", model)
    tconfig.reset_config()
    reranker_factory.reset_reranker()
    try:
        with caplog.at_level(logging.WARNING, logger=reranker_factory.logger.name):
            assert reranker_factory.get_reranker(device="cpu") is None
        assert bool(caplog.records) == (enabled == "true")
    finally:
        reranker_factory.reset_reranker()
        monkeypatch.undo()
        tconfig.reset_config()


def test_reranker_config_keys_match_the_jax_package(monkeypatch):
    from intool_rag_tpu import config as jconfig

    for env in ("RERANKER_MODEL", "RERANKER_ENABLED", "RERANKER_TOP_K", "RERANKER_CANDIDATES"):
        monkeypatch.delenv(env, raising=False)
    want, got = jconfig.Config(), tconfig.Config()
    for key in ("RERANKER_MODEL", "RERANKER_ENABLED", "RERANKER_TOP_K", "RERANKER_CANDIDATES"):
        assert getattr(got, key) == getattr(want, key), key
    monkeypatch.setenv("RERANKER_CANDIDATES", "37")
    monkeypatch.setenv("RERANKER_ENABLED", "1")
    assert tconfig.Config().RERANKER_CANDIDATES == 37 and tconfig.Config().RERANKER_ENABLED is True


@pytest.mark.parametrize("augment", [0, 2])
def test_build_pair_pool_equals_the_jax_one(augment):
    task = jsynthetic.make_relevance_task(np.random.default_rng(6), n_train_queries=12)
    kw = dict(max_len=24, augment_shuffle=augment)
    want = jtrain.build_pair_pool(JaxTokenizer(vocab_size=1024, max_length=32), task.train_queries,
                                  task.train_passages, task.train_labels,
                                  rng=np.random.default_rng(9) if augment else None, **kw)
    got = ttrain.build_pair_pool(SimpleTokenizer(vocab_size=1024, max_length=32), task.train_queries,
                                 task.train_passages, task.train_labels,
                                 rng=np.random.default_rng(9) if augment else None, **kw)
    assert len(got.labels) == len(task.train_labels) * (1 + augment)
    for field in ("ids", "mask", "labels"):
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype and np.array_equal(a, b), field
    with pytest.raises(ValueError):
        ttrain.build_pair_pool(SimpleTokenizer(), ["q"], ["p"], [1.0], augment_shuffle=1)


def test_train_reranker_loss_falls():
    """60 steps on a separable toy pool: the mean loss of the last 20 steps
    is under the first 20's, and the result loads into a serving reranker."""
    cfg = EncoderConfig(vocab_size=256, hidden_size=32, num_layers=1, num_heads=2, intermediate_size=64,
                        max_position=40, dtype="float32")
    tok = SimpleTokenizer(vocab_size=256, max_length=16)
    rng = np.random.default_rng(8)
    queries = [f"query {w}" for w in rng.choice(WORDS, 96)]
    passages = [q.split()[1] if i % 2 == 0 else "unrelated" for i, q in enumerate(queries)]
    labels = [1.0 if i % 2 == 0 else 0.0 for i in range(96)]
    pool = ttrain.build_pair_pool(tok, queries, passages, labels, max_len=8)
    params, means = ttrain.train_reranker(cfg, pool, steps=60, batch=32, lr=3e-3, steps_per_launch=20, device="cpu")
    assert means.shape == (3,) and means[-1] < means[0], means
    assert all(v.dtype == torch.float32 for v in params.values())
    again, _ = ttrain.train_reranker(cfg, pool, steps=60, batch=32, lr=3e-3, steps_per_launch=20, device="cpu")
    assert all(torch.equal(params[k], again[k]) for k in params)  # repeatable from its seed
    reranker = Reranker.create(cfg, tokenizer=tok, params=params, device="cpu")
    scores = reranker.score_pairs(["query alpha", "query alpha"], ["alpha", "unrelated"])
    assert scores[0] > scores[1]


RANKED = [[3, 1, 4, 1, 5], [9, 2, 6], [], [7, 7, 7], list(range(20))]
RELEVANT = [{1, 5}, {6}, {1}, set(), {0, 19, 25}]


@pytest.mark.parametrize("case", range(len(RANKED)))
@pytest.mark.parametrize("metric", ["recall", "mrr", "ndcg", "ndcg-graded"])
def test_metrics_equal_the_jax_functions(metric, case):
    ranked, relevant = RANKED[case], RELEVANT[case]
    gains = {item: float(1 + item % 3) for item in relevant} | {4: 1.0}
    for k in (1, 3, 10):
        if metric == "recall":
            assert tmetrics.recall_at_k(ranked, relevant, k) == jmetrics.recall_at_k(ranked, relevant, k)
        elif metric == "mrr":
            assert tmetrics.mrr(ranked, relevant) == jmetrics.mrr(ranked, relevant)
        elif metric == "ndcg":
            assert tmetrics.ndcg_at_k(ranked, relevant, k) == jmetrics.ndcg_at_k(ranked, relevant, k)
        else:
            assert tmetrics.ndcg_at_k(ranked, relevant, k, gains=gains) == jmetrics.ndcg_at_k(
                ranked, relevant, k, gains=gains)


@pytest.mark.parametrize("family", ["make_relevance_task", "make_relevance_task_graded", "make_relevance_task_ood"])
def test_synthetic_tasks_equal_the_jax_ones(family):
    want = getattr(jsynthetic, family)(np.random.default_rng(11))
    got = getattr(tsynthetic, family)(np.random.default_rng(11))
    assert got.texts == want.texts and got.train_queries == want.train_queries
    assert got.train_passages == want.train_passages
    assert np.array_equal(got.train_labels, want.train_labels) and np.array_equal(got.doc_topic, want.doc_topic)
    assert [(e.query, e.relevant_rows, e.gains) for e in got.examples] == [
        (e.query, e.relevant_rows, e.gains) for e in want.examples]


class _HashProvider:
    def __init__(self, dim: int = 256) -> None:
        self.dim = dim

    def embed_batch(self, texts, is_query=False):
        """Bag-of-words hash embeddings plus a small direction of the text's
        own, so that two documents with the same overlap do not tie."""
        out = np.zeros((len(texts), self.dim), np.float32)
        for i, t in enumerate(texts):
            for w in t.split():
                out[i, int.from_bytes(hashlib.md5(w.encode()).digest()[:4], "little") % self.dim] += 1.0
            seed = int.from_bytes(hashlib.md5(t.encode()).digest()[:4], "little")
            out[i] += 0.05 * np.random.default_rng(seed).standard_normal(self.dim).astype(np.float32)
        return out / np.maximum(np.linalg.norm(out, axis=1, keepdims=True), 1e-9)


def test_harness_matches_the_jax_harness(monkeypatch):
    """The same task, provider and reranker weights through both packages'
    engines: dense, sparse, hybrid and rerank metrics. The two engines pick
    their candidates with other approximations on the CPU (grouped maxima,
    tie order inside a context cohort whose documents score alike), so one
    or two of the 16 queries may gain or lose a relevant hit: the averages
    are held to two queries' worth, 0.13."""
    from intool_rag_tpu import config as jconfig

    monkeypatch.setenv("INDEX_KIND", "flat")
    monkeypatch.setenv("DENSE_INT8", "0")
    tconfig.reset_config()
    jconfig.reset_config()
    task = tsynthetic.make_relevance_task(np.random.default_rng(12), n_eval=16, n_train_queries=5)
    provider = _HashProvider()
    kw = dataclasses.asdict(EncoderConfig.tiny())
    jcfg, params, model = _both(kw, seed=2)
    jreranker = jrer.Reranker.create(jcfg, params=_numpy_tree(params))
    treranker = Reranker(model, SimpleTokenizer(vocab_size=jcfg.vocab_size, max_length=64))
    modes = ("dense", "sparse", "hybrid", "rerank")
    want = jharness.evaluate_engine(jharness.build_engine_from_texts(task.texts, provider), provider, task.examples,
                                    k=10, modes=modes, reranker=jreranker, rerank_candidates=16)
    got = tharness.evaluate_engine(tharness.build_engine_from_texts(task.texts, provider, device="cpu"), provider,
                                   task.examples, k=10, modes=modes, reranker=treranker, rerank_candidates=16)
    assert set(got) == set(modes)
    for mode in modes:
        for name in ("recall@k", "mrr", "ndcg@k"):
            assert abs(got[mode][name] - want[mode][name]) <= 0.13, (mode, name, got, want)
    with pytest.raises(ValueError):
        tharness.evaluate_engine(tharness.build_engine_from_texts(task.texts[:8], provider, device="cpu"), provider,
                                 task.examples[:1], modes=("rerank",))
    monkeypatch.undo()
    tconfig.reset_config()
    jconfig.reset_config()
