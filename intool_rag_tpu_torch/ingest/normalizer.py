"""Per-page text normalization (copy of
``intool_rag_tpu/ingest/normalizer.py``).

Capability parity with the reference's ``PageNormalizer``/``TextNormalizer``
(reference: rag/ingest/page_normalizer.py:24-215): watermark removal, NFKC
unicode normalization, line-break and whitespace repair, header/footer
stripping, and a page-validity gate (minimum length + printable ratio).

The implementation is original: a single compiled-regex pass pipeline,
plus a corpus-level repeated-line detector for headers/footers (lines that
recur on most pages are boilerplate — more robust than the reference's
fixed regex list).
"""

from __future__ import annotations

import dataclasses
import re
import unicodedata
from collections import Counter

_WATERMARK_PATTERNS = [
    re.compile(r"(?im)^\s*(confidential|draft|internal use only|do not distribute)\s*$"),
    re.compile(r"(?im)^\s*watermark\s*$"),
    re.compile(r"(?im)^\s*sample\s*$"),
]

_PAGE_NUMBER_PATTERNS = [
    re.compile(r"(?im)^\s*(page\s+)?\d{1,4}(\s*(of|/)\s*\d{1,4})?\s*$"),
    re.compile(r"(?im)^\s*[-–—]\s*\d{1,4}\s*[-–—]\s*$"),
]

# Hyphenation across a line break: "infor-\nmation" -> "information"
_HYPHEN_BREAK = re.compile(r"(\w)-\n(\w)")
# Single newline inside a sentence (not a paragraph break) -> space
_SOFT_BREAK = re.compile(r"(?<!\n)\n(?!\n)")
_MULTI_SPACE = re.compile(r"[ \t ]{2,}")
_MULTI_NEWLINE = re.compile(r"\n{3,}")
_CONTROL = re.compile(r"[\x00-\x08\x0b\x0c\x0e-\x1f\x7f]")


@dataclasses.dataclass
class NormalizedPage:
    page: int
    text: str
    is_valid: bool
    raw_length: int


class TextNormalizer:
    """Stateless text-level cleanup."""

    def normalize(self, text: str) -> str:
        text = unicodedata.normalize("NFKC", text)
        text = _CONTROL.sub("", text)
        for pat in _WATERMARK_PATTERNS:
            text = pat.sub("", text)
        for pat in _PAGE_NUMBER_PATTERNS:
            text = pat.sub("", text)
        text = _HYPHEN_BREAK.sub(r"\1\2", text)
        text = _SOFT_BREAK.sub(" ", text)
        text = _MULTI_SPACE.sub(" ", text)
        text = _MULTI_NEWLINE.sub("\n\n", text)
        return text.strip()


class PageNormalizer:
    """Page-level normalization with a validity gate and corpus-level
    header/footer removal.

    Validity gate matches the reference's thresholds: at least
    ``min_chars`` characters and at least ``min_printable_ratio`` of them
    printable (reference: rag/ingest/page_normalizer.py:108-131).
    """

    def __init__(self, min_chars: int = 20, min_printable_ratio: float = 0.7) -> None:
        self.min_chars = min_chars
        self.min_printable_ratio = min_printable_ratio
        self._text_normalizer = TextNormalizer()

    def _strip_repeated_lines(self, pages: list[str]) -> list[str]:
        """Remove first/last lines that repeat on >60% of pages
        (headers/footers)."""
        if len(pages) < 3:
            return pages
        edge_lines: Counter[str] = Counter()
        for text in pages:
            lines = [ln.strip() for ln in text.splitlines() if ln.strip()]
            for ln in lines[:2] + lines[-2:]:
                if 0 < len(ln) <= 120:
                    edge_lines[ln] += 1
        threshold = max(3, int(0.6 * len(pages)))
        boilerplate = {ln for ln, n in edge_lines.items() if n >= threshold}
        if not boilerplate:
            return pages
        cleaned = []
        for text in pages:
            kept = [
                ln for ln in text.splitlines() if ln.strip() not in boilerplate
            ]
            cleaned.append("\n".join(kept))
        return cleaned

    def _is_valid(self, text: str) -> bool:
        if len(text) < self.min_chars:
            return False
        printable = sum(1 for ch in text if ch.isprintable() or ch in "\n\t ")
        return printable / max(1, len(text)) >= self.min_printable_ratio

    def normalize_page(self, page: int, raw_text: str) -> NormalizedPage:
        text = self._text_normalizer.normalize(raw_text)
        return NormalizedPage(
            page=page, text=text, is_valid=self._is_valid(text), raw_length=len(raw_text)
        )

    def normalize_pages(self, raw_pages: dict[int, str]) -> list[NormalizedPage]:
        """Normalize a whole document's pages (applies corpus-level
        header/footer removal first)."""
        order = sorted(raw_pages)
        stripped = self._strip_repeated_lines([raw_pages[p] for p in order])
        return [self.normalize_page(p, t) for p, t in zip(order, stripped)]
