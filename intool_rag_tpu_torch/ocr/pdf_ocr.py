"""PDF → OCR bridge for scanned pages (port of
``intool_rag_tpu/ocr/pdf_ocr.py``; reference: rag/ingest/ocr/pdf_ocr.py:37-262,
which renders pages via PyMuPDF at 300 DPI). Scanned PDFs are full-page
embedded images, so this extracts the page's image XObjects directly:
DCTDecode via PIL (imported there only), FlateDecode raw bitmaps via NumPy.

Implements the ``OCREngine`` protocol of ingest/loader.py.
"""

from __future__ import annotations

import io

import numpy as np
import torch

from ..logging import get_logger
from ..ingest.pdf import Name, PDFDocument, Stream, decode_stream

logger = get_logger(__name__)


def _decode_image_xobject(doc: PDFDocument, stream: Stream) -> np.ndarray | None:
    d = stream.dict
    filters = d.get("Filter")
    if isinstance(filters, list):
        filters = [str(f) for f in filters]
    else:
        filters = [str(filters)] if filters else []
    width = int(doc.resolve_val(d.get("Width", 0)))
    height = int(doc.resolve_val(d.get("Height", 0)))
    if width <= 0 or height <= 0:
        return None
    if "DCTDecode" in filters or "JPXDecode" in filters:
        try:
            from PIL import Image

            img = Image.open(io.BytesIO(stream.raw))
            return np.asarray(img.convert("RGB"))
        except Exception as exc:  # PIL missing or a corrupt image: the page stays unread
            logger.warning("JPEG decode failed: %s", exc)
            return None
    try:
        data = decode_stream(stream, doc.resolve)
    except Exception as exc:  # a corrupt stream: the page stays unread
        logger.warning("image stream decode failed: %s", exc)
        return None
    bpc = int(doc.resolve_val(d.get("BitsPerComponent", 8)))
    cs = str(doc.resolve_val(d.get("ColorSpace", "DeviceGray")))
    channels = 3 if "RGB" in cs else 1
    expected = width * height * channels * bpc // 8
    if len(data) < expected:
        return None
    if bpc == 8:
        arr = np.frombuffer(data[:expected], np.uint8).reshape(height, width, channels)
        return arr if channels == 3 else np.repeat(arr, 3, axis=2)
    if bpc == 1:
        bits = np.unpackbits(
            np.frombuffer(data, np.uint8), count=width * height
        ).reshape(height, width)
        return np.repeat((bits * 255).astype(np.uint8)[:, :, None], 3, axis=2)
    return None


def extract_page_images(pdf_bytes: bytes, page_number: int) -> list[np.ndarray]:
    """All decodable image XObjects on a page, largest first."""
    doc = PDFDocument(pdf_bytes)
    pages = doc.pages()
    if page_number >= len(pages):
        return []
    res = doc.resolve_val(pages[page_number].get("Resources")) or {}
    xobjects = doc.resolve_val(res.get("XObject")) or {}
    images: list[np.ndarray] = []
    for ref in xobjects.values():
        obj = doc.resolve_val(ref)
        if isinstance(obj, Stream) and obj.dict.get("Subtype") == Name("Image"):
            img = _decode_image_xobject(doc, obj)
            if img is not None:
                images.append(img)
    images.sort(key=lambda im: -(im.shape[0] * im.shape[1]))
    return images


class PDFOCRBridge:
    """loader.OCREngine implementation: scanned page → text via OCR.

    The engine (on ``device``: the card unless the caller asks for the CPU)
    is built lazily on the first scanned page: the weight load must not
    stall service startup, and text-PDF ingest never touches it."""

    def __init__(self, engine=None, *, device: str | torch.device | None = None) -> None:
        self._engine = engine
        self._device = device

    @property
    def engine(self):
        if self._engine is None:
            from .pipeline import OCREngine

            self._engine = OCREngine(device=self._device)
        return self._engine

    def extract_page(self, pdf_bytes: bytes, page_number: int) -> tuple[str, float]:
        images = extract_page_images(pdf_bytes, page_number)
        if not images:
            return "", 0.0
        result = self.engine(images[0])
        return result.to_markdown(), result.mean_confidence()
