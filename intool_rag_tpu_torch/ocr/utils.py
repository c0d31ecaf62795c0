"""OCR utilities (copy of ``intool_rag_tpu/ocr/utils.py``; reference:
rag/ingest/ocr/utils/ — SURVEY.md §2.7 #46, and CalRecBoxes #43): image
loading, word-box estimation from CTC columns, result visualization, JSON
export. PIL is imported inside the functions that draw or decode images."""

from __future__ import annotations

import io
import json
from pathlib import Path

import numpy as np

from .postprocess import TextBox


def load_image(source) -> np.ndarray:
    """Multi-format image → RGB uint8 array (reference: LoadImage,
    utils/load_image.py). Accepts path, bytes, PIL image, or ndarray."""
    from PIL import Image

    if isinstance(source, np.ndarray):
        arr = source
        if arr.ndim == 2:
            arr = np.repeat(arr[:, :, None], 3, axis=2)
        if arr.dtype != np.uint8:
            arr = np.clip(arr * (255.0 if arr.max() <= 1.5 else 1.0), 0, 255).astype(
                np.uint8
            )
        return arr[:, :, :3]
    if isinstance(source, (str, Path)):
        img = Image.open(source)
    elif isinstance(source, bytes):
        img = Image.open(io.BytesIO(source))
    else:
        img = source  # assume PIL
    return np.asarray(img.convert("RGB"))


def word_boxes_from_ctc(
    box: TextBox, logits: np.ndarray, charset: str
) -> list[tuple[TextBox, str]]:
    """Per-word boxes from CTC column indices (reference: CalRecBoxes,
    cal_rec_boxes/main.py:21-55): each emitted character maps back to a
    column; columns scale linearly onto the crop width; spaces split
    words."""
    blank = len(charset)
    ids = logits.argmax(axis=-1)  # [T]
    t_total = len(ids)
    # (char, first column, last column incl. repeated frames)
    chars: list[list] = []
    prev = -1
    for t, c in enumerate(ids):
        c = int(c)
        if c != blank:
            if c != prev:
                chars.append([charset[c], t, t])
            else:
                chars[-1][2] = t  # extend through repeats
        prev = c
    if not chars:
        return []
    words: list[tuple[str, int, int]] = []  # (word, t_start, t_end)
    current = ""
    t_start = chars[0][1]
    last_t = chars[0][2]
    for ch, t0, t1 in chars:
        if ch == " ":
            if current:
                words.append((current, t_start, last_t))
            current = ""
        else:
            if not current:
                t_start = t0
            current += ch
            last_t = t1
    if current:
        words.append((current, t_start, last_t))
    out = []
    for word, t0, t1 in words:
        x0 = box.x0 + int(box.width * t0 / max(1, t_total))
        x1 = box.x0 + int(box.width * (t1 + 1) / max(1, t_total))
        out.append((TextBox(x0, box.y0, max(x1, x0 + 1), box.y1, box.score), word))
    return out


def visualize_result(image: np.ndarray, result) -> np.ndarray:
    """Draw detection boxes + text onto a copy of the image (reference:
    VisRes, utils/vis_res.py). Returns an RGB uint8 array."""
    from PIL import Image, ImageDraw

    img = Image.fromarray(load_image(image))
    draw = ImageDraw.Draw(img)
    for line in result.lines:
        b = line.box
        draw.rectangle([b.x0, b.y0, b.x1, b.y1], outline=(255, 0, 0), width=2)
        draw.text((b.x0, max(0, b.y0 - 12)), f"{line.text} {line.confidence:.2f}",
                  fill=(0, 0, 255))
    return np.asarray(img)


def result_to_json(result) -> str:
    """Structured export (reference: ToJSON, utils/to_json.py)."""
    return json.dumps(
        {
            "lines": [
                {
                    "text": line.text,
                    "confidence": round(line.confidence, 4),
                    "box": [line.box.x0, line.box.y0, line.box.x1, line.box.y1],
                }
                for line in result.lines
            ],
            "elapse": result.elapse,
        },
        ensure_ascii=False,
    )
