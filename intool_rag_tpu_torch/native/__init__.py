"""ctypes bindings for the native C++ analyzer (port of
``intool_rag_tpu/native/__init__.py``).

``analyzer.cc`` builds with ``g++ -O3 -shared -fPIC`` on first use, into
``native/_build/`` (ignored by git), keyed by a hash of the source and the
flags, so an edited source rebuilds and two checkouts never share a stale
library. Nothing is built when this module is imported. Where ``g++`` is
missing or the build fails, :func:`native_available` is false and the
callers (``index/analyzer.py::tokenize``, ``BM25Index._count_terms``) take
the Python path, as the JAX package does: this is host code, not a device
path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from ..logging import get_logger

logger = get_logger(__name__)

SOURCE = Path(__file__).resolve().parent / "analyzer.cc"
BUILD_DIR = SOURCE.parent / "_build"
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_failed = False


def _prefold(text: str) -> str:
    """NFKC + casefold the text exactly as the Python analyzer does before
    handing it to C++. The native tokenizer folds only ASCII/Latin-1 case
    and fullwidth forms; uppercase Cyrillic/Greek, ligatures and enclosed
    numerals would otherwise give index terms that never match query
    terms. The C++ folds are no-ops on folded text."""
    from ..index.analyzer import fold

    return fold(text)


def library_path() -> Path:
    """Where the build of the current source lives."""
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(GXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libintool_native-{digest}.so"


def _build(target: Path) -> bool:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", *GXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                       check=True, capture_output=True, text=True, timeout=120)
        os.replace(tmp, target)
        return True
    except (OSError, subprocess.SubprocessError) as exc:
        detail = getattr(exc, "stderr", "") or exc
        logger.warning("native analyzer build failed: %s", detail)
        tmp.unlink(missing_ok=True)
        return False


def get_lib() -> ctypes.CDLL | None:
    """The loaded library, built on first use; None where it cannot be."""
    global _lib, _failed
    if _lib is not None or _failed:
        return _lib
    with _lock:
        if _lib is not None or _failed:
            return _lib
        target = library_path()
        if not target.exists() and not _build(target):
            _failed = True
            return None
        try:
            lib = ctypes.CDLL(str(target))
        except OSError as exc:
            logger.warning("native analyzer load failed: %s", exc)
            _failed = True
            return None
        lib.build_corpus.restype = ctypes.c_void_p
        lib.build_corpus.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_int64]
        lib.corpus_sizes.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64)]
        lib.corpus_copy.argtypes = [ctypes.c_void_p] + [ctypes.c_void_p] * 7
        lib.corpus_first_seen.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.free_corpus.argtypes = [ctypes.c_void_p]
        lib.tokenize_one.restype = ctypes.c_int64
        lib.tokenize_one.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_char_p, ctypes.c_int64, ctypes.POINTER(ctypes.c_int64),
        ]
        _lib = lib
        logger.info("native analyzer loaded from %s", target)
        return _lib


def native_available() -> bool:
    return get_lib() is not None


def build_corpus_native(texts: list[str], *, first_seen: bool = False):
    """Tokenize and count a corpus natively: ``(vocab list sorted, df [V]
    i32, doc_indptr [n+1] i64, pair_terms [nnz] i32, pair_counts [nnz] i32,
    doc_len [n] i32)``, with ``first_seen`` also each vocabulary term's rank
    in the order the texts' tokens meet them ([V] i32); None when the
    library is unavailable. A document's pairs come in hash-map order."""
    lib = get_lib()
    if lib is None:
        return None
    blobs = [_prefold(t).encode("utf-8") for t in texts]
    offsets = np.zeros(len(blobs) + 1, np.int64)
    offsets[1:] = np.cumsum([len(b) for b in blobs])
    handle = lib.build_corpus(b"".join(blobs), offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), len(blobs))
    if not handle:
        return None
    try:
        sizes = np.zeros(4, np.int64)
        lib.corpus_sizes(handle, sizes.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
        v, nnz, blob_bytes, n_docs = map(int, sizes)
        blob = ctypes.create_string_buffer(max(blob_bytes, 1))
        vocab_offsets = np.zeros(v + 1, np.int64)
        df = np.zeros(v, np.int32)
        doc_indptr = np.zeros(n_docs + 1, np.int64)
        pair_terms = np.zeros(max(nnz, 1), np.int32)
        pair_counts = np.zeros(max(nnz, 1), np.int32)
        doc_len = np.zeros(max(n_docs, 1), np.int32)
        lib.corpus_copy(handle, blob, *(a.ctypes.data_as(ctypes.c_void_p) for a in (
            vocab_offsets, df, doc_indptr, pair_terms, pair_counts, doc_len)))
        raw = blob.raw[:blob_bytes]
        vocab = [raw[vocab_offsets[i] : vocab_offsets[i + 1]].decode("utf-8") for i in range(v)]
        out = (vocab, df, doc_indptr, pair_terms[:nnz], pair_counts[:nnz], doc_len[:n_docs])
        if first_seen:
            rank = np.zeros(max(v, 1), np.int32)
            lib.corpus_first_seen(handle, rank.ctypes.data_as(ctypes.c_void_p))
            out += (rank[:v],)
        return out
    finally:
        lib.free_corpus(handle)


def tokenize_native(text: str) -> list[str] | None:
    """The native token stream of one text, or None when the library is
    unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    data = _prefold(text).encode("utf-8")
    cap = max(len(data) * 8 + 64, 4096)
    out = ctypes.create_string_buffer(cap)
    written = ctypes.c_int64(0)
    count = lib.tokenize_one(data, len(data), out, cap, ctypes.byref(written))
    tokens = []
    pos = 0
    raw = out.raw
    for _ in range(count):
        tlen = raw[pos] | (raw[pos + 1] << 8)
        tokens.append(raw[pos + 2 : pos + 2 + tlen].decode("utf-8"))
        pos += 2 + tlen
    return tokens
