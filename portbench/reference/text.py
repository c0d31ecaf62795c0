"""Text to ids, as the served path defines them for ASCII text: the BM25
analyzer (lowercase, runs of word characters, stopwords and one-letter
words dropped, numbers kept) and the hashing tokenizer that the encoder
reads when no tokenizer files are present (CLS 0, SEP 2, each analyzed word
to 4 + md5(word)[:4] (little-endian) mod (vocab - 4))."""

from __future__ import annotations

import hashlib
import re

STOPWORDS = frozenset(
    """a an and are as at be but by for from has have if in into is it its of on
    or that the their then there these this to was were will with""".split()
)
_TOKEN = re.compile(r"\w+")
CLS, PAD, SEP, RESERVED = 0, 1, 2, 4


def analyze(text: str) -> list[str]:
    if not text.isascii():
        raise ValueError("the reference analyzes ASCII text only")
    return [t for t in _TOKEN.findall(text.lower()) if (len(t) > 1 and t not in STOPWORDS) or t.isdigit()]


def token_ids(text: str, vocab_size: int, max_length: int) -> list[int]:
    ids = [RESERVED + int.from_bytes(hashlib.md5(w.encode()).digest()[:4], "little") % (vocab_size - RESERVED)
           for w in analyze(text)]
    return [CLS] + ids[: max_length - 2] + [SEP]


def query_terms(text: str, vocab: dict[str, int], max_terms: int) -> list[tuple[int, int]]:
    """``(term id, count)`` of a question's known words, ascending by id,
    the first ``max_terms``."""
    counts: dict[int, int] = {}
    for w in analyze(text):
        tid = vocab.get(w)
        if tid is not None:
            counts[tid] = counts.get(tid, 0) + 1
    return sorted(counts.items())[:max_terms]
