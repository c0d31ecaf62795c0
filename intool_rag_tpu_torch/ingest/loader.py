"""Page-based document loading (copy of ``intool_rag_tpu/ingest/loader.py``;
reference: rag/ingest/page_loader.py).

PDF via the in-repo extractor (pdf.py), plus txt/markdown (paginated on
form feeds or length) — the reference gates to PDF-only
(page_loader.py:148-158). Pages without a text layer flow to the OCR
fallback hook when an OCR engine is registered (the reference's OCR
fallback is dead code due to an import bug — page_loader.py:31,
SURVEY.md §0; here it is a working injection point).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Protocol

from ..logging import get_logger
from ..exceptions import DocumentLoadError, UnsupportedFormatError
from .pdf import extract_pdf_text

logger = get_logger(__name__)


@dataclasses.dataclass
class RawPageData:
    """(reference: page_loader.py:38-48)"""

    page: int
    raw_content: str
    has_ocr: bool = False
    extraction_confidence: float = 1.0


class OCREngine(Protocol):
    def extract_page(self, pdf_bytes: bytes, page_number: int) -> tuple[str, float]:
        """Returns (text, confidence) for a rendered page."""


_ocr_engine: OCREngine | None = None


def register_ocr_engine(engine: OCREngine | None) -> None:
    global _ocr_engine
    _ocr_engine = engine


class PageBasedLoader:
    """Loads a document into per-page raw text."""

    SUPPORTED = (".pdf", ".txt", ".md", ".markdown")

    def __init__(self, max_chars_per_page: int = 20_000) -> None:
        self.max_chars_per_page = max_chars_per_page

    def load(self, filepath: str | Path) -> list[RawPageData]:
        path = Path(filepath)
        if not path.exists():
            raise DocumentLoadError(f"file not found: {path}")
        suffix = path.suffix.lower()
        if suffix == ".pdf":
            return self._load_pdf(path)
        if suffix in (".txt", ".md", ".markdown"):
            return self._load_text(path)
        raise UnsupportedFormatError(
            f"unsupported format {suffix!r}; supported: {self.SUPPORTED}"
        )

    def _load_pdf(self, path: Path) -> list[RawPageData]:
        data = path.read_bytes()
        try:
            texts = extract_pdf_text(data)
        except Exception as exc:
            raise DocumentLoadError(f"PDF parse failed for {path.name}: {exc}") from exc
        pages: list[RawPageData] = []
        for i, text in enumerate(texts):
            if text.strip():
                pages.append(RawPageData(page=i, raw_content=text))
            elif _ocr_engine is not None:
                # OCR fallback for scanned pages (page_loader.py:98-108 intent)
                try:
                    ocr_text, conf = _ocr_engine.extract_page(data, i)
                    pages.append(
                        RawPageData(
                            page=i, raw_content=ocr_text, has_ocr=True,
                            extraction_confidence=conf,
                        )
                    )
                except Exception as exc:
                    logger.warning("OCR failed on page %d of %s: %s", i, path.name, exc)
                    pages.append(RawPageData(page=i, raw_content="", extraction_confidence=0.0))
            else:
                pages.append(RawPageData(page=i, raw_content="", extraction_confidence=0.0))
        return pages

    def _load_text(self, path: Path) -> list[RawPageData]:
        text = path.read_text(encoding="utf-8", errors="replace")
        # paginate on form feeds, else fixed-size pages
        if "\f" in text:
            parts = text.split("\f")
        else:
            n = self.max_chars_per_page
            parts = [text[i : i + n] for i in range(0, max(len(text), 1), n)]
        return [RawPageData(page=i, raw_content=p) for i, p in enumerate(parts)]
