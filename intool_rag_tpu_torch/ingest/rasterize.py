"""PDF page rasterizer over the in-repo text extractor (copy of
``intool_rag_tpu/ingest/rasterize.py``).

The reference renders scanned pages via PyMuPDF (`page.get_pixmap`,
rag/ingest/ocr/pdf_ocr.py:127-146); PyMuPDF is not installed here, and
the OCR out-of-distribution eval needs real-document page images with
free ground truth. This renders a page image from the extractor's
positioned text segments (ingest/pdf.py `_collect_segments`): device
coordinates map to raster pixels (y flipped), each segment draws with a
DejaVu face at its PDF font size. Vector graphics/images are ignored —
the OCR det/rec path only consumes text ink, and the text LAYER is the
exact ground truth for scoring what OCR reads back.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .pdf import PDFDocument, _collect_segments


@dataclasses.dataclass
class RenderedLine:
    text: str
    x: float  # raster px of line start
    y: float  # raster px of baseline top
    size: float  # raster px font size


def rasterize_page(
    data: bytes,
    page_index: int = 0,
    *,
    scale: float = 2.0,
    font_path: str | None = None,
    min_size: float = 4.0,
) -> tuple[np.ndarray, list[RenderedLine]]:
    """Render page ``page_index`` of PDF ``data``.

    Returns (image [H, W, 3] float32 in [0,1] white background, rendered
    lines with raster-space geometry). ``scale`` is raster px per PDF
    unit (2.0 ≈ 144 DPI).
    """
    from PIL import Image, ImageDraw, ImageFont

    from ..ocr.synth import DEFAULT_FONTS

    font_path = font_path or DEFAULT_FONTS[0]
    doc = PDFDocument(data)
    pages = list(doc.pages())
    page = pages[page_index]
    media = doc.resolve_val(page.get("MediaBox")) or [0, 0, 612, 792]
    x0, y0, x1, y1 = [float(doc.resolve_val(v)) for v in media]
    w = max(int((x1 - x0) * scale), 8)
    h = max(int((y1 - y0) * scale), 8)

    segments = _collect_segments(doc, page)
    img = Image.new("L", (w, h), 255)
    draw = ImageDraw.Draw(img)
    fonts: dict[int, object] = {}
    lines: list[RenderedLine] = []
    for seg in segments:
        if not seg.text.strip():
            continue
        size_px = max(seg.size * scale, min_size)
        key = int(round(size_px))
        if key not in fonts:
            fonts[key] = ImageFont.truetype(font_path, key)
        fx = (seg.x - x0) * scale
        # PDF y grows upward from the baseline; PIL draws from the top
        fy = h - (seg.y - y0) * scale - size_px
        draw.text((fx, fy), seg.text, font=fonts[key], fill=0)
        lines.append(RenderedLine(seg.text, fx, fy, size_px))
    arr = np.asarray(img, np.float32) / 255.0
    return np.repeat(arr[:, :, None], 3, axis=2), lines


def page_ground_truth_lines(
    data: bytes, page_index: int = 0, *, min_chars: int = 3
) -> list[str]:
    """The text-layer lines of a page (the OCR eval's free ground truth),
    as the extractor assembles them."""
    from .pdf import extract_pdf_text

    text = extract_pdf_text(data)[page_index]
    return [ln.strip() for ln in text.splitlines() if len(ln.strip()) >= min_chars]
