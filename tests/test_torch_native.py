"""The port's native analyzer (``intool_rag_tpu_torch/native``) against the
JAX package's: token streams and corpus counts must be equal, symbols
such as ``€`` included. Where ``g++`` is missing neither library builds,
and these tests skip.
"""

from __future__ import annotations

import shutil

import numpy as np
import pytest

from intool_rag_tpu.index.analyzer import tokenize as jax_tokenize
from intool_rag_tpu.index.bm25_index import BM25Index as JBM25Index
from intool_rag_tpu.native import build_corpus_native as jax_build_corpus
from intool_rag_tpu.native import tokenize_native as jax_tokenize_native
from intool_rag_tpu_torch import native
from intool_rag_tpu_torch.index import analyzer
from intool_rag_tpu_torch.index.bm25_index import BM25Index

# tests/test_native.py's texts, then symbols, C++, a+b and CJK runs
CASES = [
    "The Quick-Brown FOX jumps!",
    "发票金额总计人民币五千元整",
    "invoice发票2024 with mixed内容 and numbers 42",
    "ｆｕｌｌｗｉｄｔｈ　ｔｅｘｔ",
    "it is a the and x y 5 test",
    "Müller straße ÀÉÎÕÜ",
    "",
    "!!!",
    "a" * 300,
    "МОСКВА Москва москва",
    "ΑΘΗΝΑ Αθήνα αθήνα ΣΟΦΙΑ",
    "ﬁle ﬂow ﬃ ligatures oﬃce",
    "numbers ① ② ⑩ circled and Ⅷ roman",
    "İstanbul STRASSE ß",
    "€uro price 5€",
    "C++ and a+b and c# code",
    "total: 1.234,56 € (EUR) — net £12 ¥300 ©2024 ™",
    "東京タワー 서울특별시 漢字かなカナ混じり文 and 한국어",
    "emoji 🙂 run ✓ done",
]


@pytest.fixture(scope="module", autouse=True)
def _needs_gxx():
    if shutil.which("g++") is None:
        pytest.skip("g++ is missing: neither package builds its native analyzer")
    assert native.native_available(), "g++ is present but the port's native analyzer did not build"


def test_euro_keeps_its_symbol():
    assert analyzer.tokenize("€uro price 5€") == ["€uro", "price", "5€"]


@pytest.mark.parametrize("text", CASES)
def test_tokenize_matches_jax(text):
    want = jax_tokenize(text)
    assert want == jax_tokenize_native(text)  # the JAX package serves its native stream
    assert analyzer.tokenize(text) == want
    assert native.tokenize_native(text) == want


def test_python_path_differs_only_on_symbols():
    """The port's Python path keeps the JAX Python analyzer's rules: on
    letters, digits and CJK it equals the native stream; a symbol splits
    off."""
    from intool_rag_tpu.index.analyzer import tokenize_py as jax_tokenize_py

    for text in CASES:
        assert analyzer.tokenize_py(text) == jax_tokenize_py(text)
    assert analyzer.tokenize_py("€uro price 5€") == ["uro", "price", "5"]


def test_corpus_build_matches_jax():
    texts = CASES + ["shared shared shared tokens here", "shared tokens 5€ 5€"]
    got = native.build_corpus_native(texts)
    want = jax_build_corpus(texts)
    assert got[0] == want[0]
    for a, b in zip(got[1:], want[1:]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_bm25_index_counts_match_jax():
    """The BM25 corpus build of both packages, through their native paths:
    the same vocabulary and per-document counts, symbols included."""
    texts = ["the quick brown fox", "invoice total 发票金额 5€", "deep learning models in C++",
             "fox habitat in the north", "€uro fox document entirely"]
    got = BM25Index._count_terms(texts)
    want = JBM25Index._count_terms(texts)
    assert got[0] == want[0] and "5€" in got[0]
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(a, b)


def _per_doc(counted) -> list[dict[str, int]]:
    vocab, _, indptr, terms, counts, _ = counted
    return [{vocab[terms[j]]: int(counts[j]) for j in range(indptr[d], indptr[d + 1])}
            for d in range(len(indptr) - 1)]


def test_native_and_python_counts_agree_without_symbols(monkeypatch):
    """Where no symbol occurs the native corpus build and the Python one
    give the same vocabulary, document frequencies, lengths and per-document
    counts (each lists a document's terms in its own order)."""
    texts = [t for t in CASES if "€" not in t and "+" not in t and "£" not in t and "🙂" not in t]
    got = BM25Index._count_terms(texts)
    monkeypatch.setattr(native, "build_corpus_native", lambda t: None)
    monkeypatch.setattr(analyzer, "_native_tok", None)
    py = BM25Index._count_terms(texts)
    assert got[0] == py[0]
    for i in (1, 2, 5):  # df, doc_indptr, doc_len
        np.testing.assert_array_equal(got[i], py[i])
    assert _per_doc(got) == _per_doc(py)


def test_build_is_keyed_by_the_source():
    path = native.library_path()
    assert path.exists() and path.parent == native.BUILD_DIR
    assert path.name.startswith("libintool_native-")
