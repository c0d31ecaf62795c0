"""The embedding tokenizer: with ``EMBEDDING_MODEL`` naming a local HF
tokenizer, both packages' embedding providers tokenize with it, so the same
encoder weights give the same token ids and the same embeddings (f32, 2
layers: 1e-4). A name with no local files makes both fall back to the
hashing tokenizer. The tokenizer is a small WordPiece vocabulary built
with ``tokenizers`` into a temporary directory: no hub files, no network."""

from __future__ import annotations

from pathlib import Path

import jax
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

TEXTS = [
    "The warranty covers parts and labour for two years.",
    "Invoices are due within thirty days of the delivery date.",
    "Returns need the original receipt and the serial number.",
    "Support answers every request within two working days.",
]


def build_wordpiece(directory: Path, vocab_size: int = 200, extra_tokens: int = 0) -> Path:
    """A WordPiece tokenizer with ``[PAD]`` (id 0), ``[UNK]``, ``[CLS]`` and
    ``[SEP]``, trained on ``TEXTS`` and saved for ``AutoTokenizer``, with
    ``extra_tokens`` added words after the trained vocabulary."""
    from tokenizers import Tokenizer, models, normalizers, pre_tokenizers, processors, trainers
    from transformers import PreTrainedTokenizerFast

    tok = Tokenizer(models.WordPiece(unk_token="[UNK]"))
    tok.normalizer = normalizers.BertNormalizer(lowercase=True)
    tok.pre_tokenizer = pre_tokenizers.BertPreTokenizer()
    specials = ["[PAD]", "[UNK]", "[CLS]", "[SEP]"]
    tok.train_from_iterator(TEXTS * 4, trainers.WordPieceTrainer(vocab_size=vocab_size, special_tokens=specials))
    tok.post_processor = processors.TemplateProcessing(
        single="[CLS] $A [SEP]", special_tokens=[("[CLS]", tok.token_to_id("[CLS]")),
                                                 ("[SEP]", tok.token_to_id("[SEP]"))])
    fast = PreTrainedTokenizerFast(tokenizer_object=tok, pad_token="[PAD]", unk_token="[UNK]", cls_token="[CLS]",
                                   sep_token="[SEP]")
    fast.add_tokens([f"extraword{i}" for i in range(extra_tokens)])
    fast.save_pretrained(str(directory))
    return directory


@pytest.fixture
def env(monkeypatch, tmp_path):
    pytest.importorskip("transformers")
    from intool_rag_tpu import config as jconfig
    from intool_rag_tpu_torch import config as tconfig

    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    monkeypatch.setenv("TRANSFORMERS_OFFLINE", "1")
    monkeypatch.setenv("EMBEDDING_PASSAGE_INSTRUCTION", "")
    monkeypatch.setenv("EMBED_PACKED", "0")

    def set_model(name: str) -> None:
        monkeypatch.setenv("EMBEDDING_MODEL", name)
        jconfig.reset_config()
        tconfig.reset_config()

    yield set_model
    jconfig.reset_config()
    tconfig.reset_config()


def _providers():
    """Both providers over the same tiny f32 encoder weights, each with the
    tokenizer its package's ``get_tokenizer`` picks for ``EMBEDDING_MODEL``."""
    from intool_rag_tpu.models import encoder as jenc
    from intool_rag_tpu.providers.tpu_embed import TPUEmbeddingProvider
    from intool_rag_tpu_torch.models import encoder as tenc
    from intool_rag_tpu_torch.providers.cuda_embed import CudaEmbeddingProvider

    cfg = jenc.EncoderConfig.tiny()
    params = jenc.init_params(cfg, seed=5)
    model = tenc.TextEncoder(tenc.EncoderConfig.tiny(), device="cpu")
    model.load_state_dict(tenc.params_from_jax(jax.tree.map(np.asarray, params)))
    return TPUEmbeddingProvider(config=cfg, params=params), CudaEmbeddingProvider(model)


def test_local_hf_tokenizer_gives_equal_ids_and_embeddings(env, tmp_path):
    from intool_rag_tpu.models.tokenizer import HFTokenizer as JHF
    from intool_rag_tpu_torch.models.tokenizer import HFTokenizer, SimpleTokenizer

    env(str(build_wordpiece(tmp_path / "wordpiece")))
    jprov, tprov = _providers()
    assert isinstance(jprov.tokenizer, JHF) and isinstance(tprov.tokenizer, HFTokenizer)
    assert tprov.tokenizer.pad_id == jprov.tokenizer.pad_id == 0
    want_ids, want_mask = jprov.tokenizer.encode_batch(TEXTS)
    got_ids, got_mask = tprov.tokenizer.encode_batch(TEXTS)
    np.testing.assert_array_equal(got_ids, want_ids)
    np.testing.assert_array_equal(got_mask, want_mask)
    simple_ids, _ = SimpleTokenizer(vocab_size=1024, max_length=128).encode_batch(TEXTS)
    assert simple_ids.shape != got_ids.shape or not np.array_equal(simple_ids, got_ids)
    np.testing.assert_allclose(tprov.embed_batch(TEXTS), jprov.embed_batch(TEXTS), atol=1e-4, rtol=0)


def test_name_without_local_files_falls_back_in_both(env):
    from intool_rag_tpu.models.tokenizer import SimpleTokenizer as JSimple
    from intool_rag_tpu_torch.models.tokenizer import SimpleTokenizer, get_tokenizer

    env("no-such-org/no-such-tokenizer")
    jprov, tprov = _providers()
    assert isinstance(jprov.tokenizer, JSimple) and isinstance(tprov.tokenizer, SimpleTokenizer)
    np.testing.assert_array_equal(tprov.tokenizer.encode_batch(TEXTS)[0], jprov.tokenizer.encode_batch(TEXTS)[0])
    np.testing.assert_allclose(tprov.embed_batch(TEXTS), jprov.embed_batch(TEXTS), atol=1e-4, rtol=0)
    tok = get_tokenizer("no-such-org/no-such-tokenizer", vocab_size=512, max_length=64)
    assert (tok.vocab_size, tok.max_length) == (512, 64)


def test_tokenizer_larger_than_the_embedding_table_falls_back(env, tmp_path):
    """A local tokenizer with more ids (1,100) than the tiny encoder has rows
    (1,024): the port falls back to the hashing tokenizer, whose ids all fit,
    where the JAX provider keeps the HF tokenizer (a recorded difference: an
    id past the table would be a device-side assert on CUDA)."""
    from intool_rag_tpu.models.tokenizer import HFTokenizer as JHF
    from intool_rag_tpu_torch.models.tokenizer import SimpleTokenizer, get_tokenizer

    path = build_wordpiece(tmp_path / "wide", extra_tokens=1100)
    env(str(path))
    jprov, tprov = _providers()
    assert isinstance(jprov.tokenizer, JHF) and len(jprov.tokenizer.tok) > 1024
    assert isinstance(tprov.tokenizer, SimpleTokenizer)
    assert tprov.tokenizer.vocab_size == tprov.encoder_config.vocab_size == 1024
    ids, _ = tprov.tokenizer.encode_batch(TEXTS + ["extraword1099 extraword7"])
    assert int(ids.max()) < 1024
    assert np.isfinite(tprov.embed_batch(TEXTS)).all()
    # the same tokenizer is kept when the table has room for every id
    assert not isinstance(get_tokenizer(str(path), vocab_size=2048, max_length=64), SimpleTokenizer)
