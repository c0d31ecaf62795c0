"""Text analyzer for sparse (BM25) indexing (port of
``intool_rag_tpu/index/analyzer.py``).

Lowercases and NFKC-normalizes, splits on non-word boundaries, turns CJK
runs into overlapping bigrams, keeps numbers, drops a small English
stopword set and 1-character latin tokens. :func:`tokenize` goes through
the native C++ analyzer (``native/``) when it builds, as the JAX package's
does, and through :func:`tokenize_py` otherwise. The two differ on
symbols: the native analyzer keeps ``€`` inside ``5€``.
"""

from __future__ import annotations

import re
import unicodedata

from ..logging import get_logger

logger = get_logger(__name__)

_STOPWORDS = frozenset(
    """a an and are as at be but by for from has have if in into is it its of on
    or that the their then there these this to was were will with""".split()
)

# CJK unified ideographs, hiragana, katakana, hangul
_CJK_RANGES = (
    (0x3040, 0x30FF),
    (0x3400, 0x4DBF),
    (0x4E00, 0x9FFF),
    (0xAC00, 0xD7AF),
    (0xF900, 0xFAFF),
    (0x20000, 0x2A6DF),
)

_TOKEN_RE = re.compile(r"[\w]+", re.UNICODE)


def _is_cjk(ch: str) -> bool:
    cp = ord(ch)
    return any(lo <= cp <= hi for lo, hi in _CJK_RANGES)


def _split_mixed(token: str) -> list[str]:
    """Split a \\w+ token into latin/digit runs and CJK runs; CJK runs
    become bigrams."""
    out: list[str] = []
    run = []
    run_cjk = False

    def flush() -> None:
        if not run:
            return
        s = "".join(run)
        if run_cjk:
            if len(s) == 1:
                out.append(s)
            else:
                out.extend(s[i : i + 2] for i in range(len(s) - 1))
        else:
            if len(s) > 1 and s not in _STOPWORDS:
                out.append(s)
            elif s.isdigit():
                out.append(s)
        run.clear()

    for ch in token:
        cjk = _is_cjk(ch)
        if run and cjk != run_cjk:
            flush()
        run.append(ch)
        run_cjk = cjk
    flush()
    return out


def fold(text: str) -> str:
    """Case/compatibility folding shared by the Python and native
    tokenizers: NFKC, lowercase, then strip combining marks that survive
    recomposition (e.g. U+0307 from lowering İ). Python's ``\\w`` and the
    C++ tokenizer classify combining marks differently, so leaving them
    in splits tokens inconsistently between the two."""
    text = unicodedata.normalize("NFKC", text).lower()
    if not text.isascii():
        text = "".join(ch for ch in text if not unicodedata.combining(ch))
    return text


_native_tok = None
_native_checked = False


def tokenize(text: str) -> list[str]:
    """Analyze text into BM25 terms: the native analyzer's token stream
    where its library builds, else :func:`tokenize_py`'s. Which path serves
    is logged once."""
    global _native_tok, _native_checked
    if not _native_checked:
        from ..native import tokenize_native

        _native_tok = tokenize_native if tokenize_native("probe 探针 text") is not None else None
        _native_checked = True
        logger.info("BM25 analyzer: %s", "native C++ library" if _native_tok else "Python (no native library)")
    if _native_tok is not None:
        return _native_tok(text)
    return tokenize_py(text)


def tokenize_py(text: str) -> list[str]:
    """Pure-Python analyzer, the path where the native library is missing."""
    text = fold(text)
    terms: list[str] = []
    for token in _TOKEN_RE.findall(text):
        if token.isascii():
            # one non-CJK run: the rule _split_mixed applies to it
            if (len(token) > 1 and token not in _STOPWORDS) or token.isdigit():
                terms.append(token)
        else:
            terms.extend(_split_mixed(token))
    return terms
