"""The system under test, built from a configuration and the run's seed:
the port's ``ChunkStore`` over the drawn corpus, its ``BM25Index`` built by
its own constructor from the drawn postings, its ``HybridEngine``, its
``TextEncoder`` holding the drawn weights behind ``CudaEmbeddingProvider``,
and ``PageLevelRetriever`` over a ``CorpusRegistry``.

The port reads its settings from the environment (``config.py``), so
:func:`configure` sets the configuration's ``port_config`` there before the
port is imported; every key not named keeps the port's default.
"""

from __future__ import annotations

import os
import time
from pathlib import Path

from . import data

# Hugging Face names of the drawn weights → the port's parameter names
_LAYER_NAMES = {
    "attention.self.query": "attention.query", "attention.self.key": "attention.key",
    "attention.self.value": "attention.value", "attention.output.dense": "attention.output",
    "attention.output.LayerNorm": "attention_ln", "intermediate.dense": "intermediate",
    "output.dense": "mlp_output", "output.LayerNorm": "output_ln",
}
_EMBED_NAMES = {
    "embeddings.word_embeddings": "word_emb", "embeddings.position_embeddings": "pos_emb",
    "embeddings.token_type_embeddings": "type_emb", "embeddings.LayerNorm": "emb_ln",
}


def port_name(hf_name: str) -> str:
    """The port's ``TextEncoder`` name of a Hugging Face XLM-R parameter."""
    stem, leaf = hf_name.rsplit(".", 1)
    if stem in _EMBED_NAMES:
        return f"{_EMBED_NAMES[stem]}.{leaf}"
    _, _, i, rest = stem.split(".", 3)
    return f"layers.{i}.{_LAYER_NAMES[rest]}.{leaf}"


def configure(config: dict, tmp: Path) -> None:
    """The port's settings in the environment: the configuration's keys, and
    the registry's storage and caches under the run's temporary directory."""
    for key, value in config["port_config"].items():
        os.environ[key] = str(value)
    os.environ["STORAGE_DIR"] = str(tmp / "storage")
    os.environ["CACHE_DIR"] = str(tmp / "cache")


class System:
    """The built system, and the handles the harness drives and wraps."""

    def __init__(self, config: dict, seed: int, device, tmp: Path) -> None:
        import torch

        from intool_rag_tpu_torch.config import reset_config
        from intool_rag_tpu_torch.index.bm25_index import BM25Index, BM25Params
        from intool_rag_tpu_torch.index.chunk_store import ChunkStore
        from intool_rag_tpu_torch.index.hybrid import HybridEngine
        from intool_rag_tpu_torch.index.registry import CorpusRegistry
        from intool_rag_tpu_torch.models.encoder import EncoderConfig, TextEncoder
        from intool_rag_tpu_torch.providers.cuda_embed import CudaEmbeddingProvider
        from intool_rag_tpu_torch.query.retriever import PageLevelRetriever

        cfg = reset_config()
        self.device = torch.device(device)
        self.timings: dict[str, float] = {}
        mark = [time.perf_counter()]

        def done(stage: str) -> None:
            if self.device.type == "cuda":
                torch.cuda.synchronize()
            now = time.perf_counter()
            self.timings[stage] = now - mark[0]
            mark[0] = now

        model, spec, bm = config["model"], config["corpus"], config["bm25"]
        n = spec["rows"]

        emb = data.corpus(seed, spec, self.device)
        store = ChunkStore(dim=spec["dim"], dtype=spec["dtype"], device=self.device)
        store._embeddings = emb
        store.valid_n = n
        store.mutation_count = 1
        done("corpus")
        post = data.make_postings(seed, n, vocab=bm["vocab"], terms_per_chunk=bm["terms_per_chunk"],
                                  p_max=bm["p_max"], zipf_s=bm["zipf_s"], device=self.device)
        self.vocab = data.vocabulary(seed, bm["vocab"])
        done("postings")
        bm25 = BM25Index(
            {w: i for i, w in enumerate(self.vocab)}, post["term_start"], post["term_len"], post["post_docs"],
            post["post_w"], post["idf"], n, BM25Params(k1=cfg.BM25_K1, b=cfg.BM25_B, p_max=bm["p_max"]),
            float(bm["terms_per_chunk"]), device=self.device,
        )
        del post
        done("bm25_index")

        encoder = TextEncoder(EncoderConfig(
            vocab_size=model["vocab_size"], hidden_size=model["hidden_size"], num_layers=model["num_hidden_layers"],
            num_heads=model["num_attention_heads"], intermediate_size=model["intermediate_size"],
            max_position=model["max_position_embeddings"], type_vocab_size=model["type_vocab_size"],
            pad_token_id=model["pad_token_id"], layer_norm_eps=model["layer_norm_eps"], dtype=model["dtype"],
        ), device=self.device)
        weights = data.encoder_weights(seed, model, self.device, getattr(torch, model["dtype"]))
        encoder.load_state_dict({port_name(k): v for k, v in weights.items()})
        del weights
        self.provider = CudaEmbeddingProvider(encoder, device=self.device)
        done("encoder")

        self.registry = CorpusRegistry(storage_dir=tmp / "storage", device=self.device)
        self.retriever = PageLevelRetriever(self.registry, self.provider)
        self.registry.store = store
        self.registry.bm25 = bm25
        self.registry.engine = HybridEngine(store, bm25)
        self.engine = self.registry.engine
        self.store = store
        done("registry")

    def close(self) -> None:
        """Drop every handle, so the port's device state can be freed."""
        self.retriever = self.engine = self.store = self.provider = self.registry = None
