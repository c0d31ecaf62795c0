"""OCR orchestrator: det → cls → rec over an image (port of
``intool_rag_tpu/ocr/pipeline.py``; reference: rag/ingest/ocr/main.py:35-467,
RapidOCR.__call__).

The model forwards run on the engine's device (the card unless the caller
asks for the CPU) in float32, with cuDNN's TF32 off for their
convolutions, so that the card's prob maps and logits follow the CPU's
and the JAX package's: a TF32 convolution can move a pixel across the
detector's 0.3 threshold or flip a near-tie in the CTC argmax. The
geometry, the beam decode and the lexicon repair are the JAX package's
host code, unchanged.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..logging import get_logger
from ..config import OCR_DEFAULT_WEIGHTS as DEFAULT_WEIGHTS
from ..device import resolve_device
from .models import OCRModelBundle
from .postprocess import (
    QuadBox,
    TextBox,
    crop_quad,
    ctc_greedy_decode,
    db_quads_from_prob_map,
    resize_norm_crop,
    split_quad_fragments,
    split_quad_lines,
    split_strip_columns,
    tighten_crop,
    to_markdown,
)

logger = get_logger(__name__)

def __getattr__(name: str):
    # DEFAULT_CHARSET (the JAX module's name), computed when first read:
    # on a homoglyph-table miss it renders glyphs
    if name == "DEFAULT_CHARSET":
        from .synth import build_charset

        return build_charset()
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


@dataclasses.dataclass
class OCRLine:
    box: TextBox  # axis-aligned bound (JSON/markdown layout)
    text: str
    confidence: float
    quad: QuadBox | None = None  # oriented region (rotated text)


@dataclasses.dataclass
class OCRResult:
    lines: list[OCRLine]
    elapse: dict[str, float]

    @property
    def text(self) -> str:
        return "\n".join(line.text for line in self.lines if line.text)

    def to_markdown(self) -> str:
        return to_markdown([(l.box, l.text, l.confidence) for l in self.lines])

    def mean_confidence(self) -> float:
        if not self.lines:
            return 0.0
        return float(np.mean([l.confidence for l in self.lines]))


def _round_up(x: int, m: int) -> int:
    return max(m, -(-x // m) * m)


def _suppress_nested(
    quads: list[QuadBox], *, containment: float = 0.8
) -> list[QuadBox]:
    """Drop quads nested inside a larger quad: a duplicate inner detection
    ('IY' inside the 'Item' header box) injects a phantom token into its
    visual row. A quad is suppressed when ≥ ``containment`` of its
    axis-aligned bbox area lies inside another quad's bbox of strictly
    larger area, or of equal area and a lower index (exact duplicates keep
    exactly one)."""
    if len(quads) < 2:
        return quads
    boxes = np.array(
        [[*q.points.min(axis=0), *q.points.max(axis=0)] for q in quads],
        np.float32,
    )  # [N, 4] x0 y0 x1 y1
    areas = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    keep = np.ones(len(quads), bool)
    for i in range(len(quads)):
        ix0 = np.maximum(boxes[i, 0], boxes[:, 0])
        iy0 = np.maximum(boxes[i, 1], boxes[:, 1])
        ix1 = np.minimum(boxes[i, 2], boxes[:, 2])
        iy1 = np.minimum(boxes[i, 3], boxes[:, 3])
        inter = np.clip(ix1 - ix0, 0, None) * np.clip(iy1 - iy0, 0, None)
        frac = inter / max(float(areas[i]), 1e-6)
        frac[i] = 0.0
        larger = (areas > areas[i]) | (
            (areas == areas[i]) & (np.arange(len(quads)) < i)
        )
        if np.any((frac >= containment) & larger & keep):
            keep[i] = False
    return [q for q, k in zip(quads, keep) if k]


class OCREngine:
    """det→cls→rec pipeline with per-stage timing (the reference records
    per-stage elapse, utils/output.py:25-30). ``bundle`` defaults to the
    shipped weights; ``device`` defaults to the card."""

    def __init__(
        self,
        bundle: OCRModelBundle | None = None,
        *,
        device: str | torch.device | None = None,
        use_cls: bool = True,
        text_score: float = 0.5,
        det_limit: int = 640,
        lm_rescore: bool = True,
        lexicon_repair: bool = True,
        auto_orient: bool = True,
    ) -> None:
        self.device = resolve_device(device)
        self.bundle = (bundle or self._default_bundle()).to(self.device)
        self.use_cls = use_cls
        self.text_score = text_score
        self.det_limit = det_limit
        # page-orientation pre-pass: a page whose detections are mostly
        # near-vertical (a 90°-rotated scan) is rerun upright
        self.auto_orient = auto_orient
        # bigram-LM CTC beam rescoring (ocr/rescore.py): fixes
        # near-homoglyph flips greedy decode cannot (I/l, O/0)
        self.lm_rescore = lm_rescore
        # word-level lexicon repair, separable from the LM beam
        self.lexicon_repair = lexicon_repair

    @staticmethod
    def _default_bundle() -> OCRModelBundle:
        """The shipped trained weights when present, else random init."""
        if DEFAULT_WEIGHTS.exists():
            try:
                return OCRModelBundle.load(DEFAULT_WEIGHTS)
            except (OSError, ValueError, KeyError) as exc:
                logger.warning("failed to load OCR weights: %s", exc)
        logger.warning("no trained OCR weights at %s — using random init", DEFAULT_WEIGHTS)
        from .synth import build_charset

        return OCRModelBundle.create(build_charset())

    def _forward(self, model: torch.nn.Module, batch: np.ndarray) -> np.ndarray:
        """One model forward on the engine's device, float32, TF32 off for
        cuDNN's convolutions."""
        x = torch.from_numpy(np.ascontiguousarray(batch, dtype=np.float32)).to(self.device)
        cudnn = torch.backends.cudnn
        with torch.inference_mode(), cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                                                 deterministic=cudnn.deterministic, allow_tf32=False):
            return model(x).cpu().numpy()

    # ---------------- stages ----------------

    def detect(self, image: np.ndarray) -> list[QuadBox]:
        """Oriented text regions, reading order (reference: TextDetector
        + DBPostProcess minAreaRect quads, ch_ppocr_det/utils.py:117-202)."""
        h, w = image.shape[:2]
        scale = min(1.0, self.det_limit / max(h, w))
        img = image.astype(np.float32)
        if img.max() > 1.5:
            img = img / 255.0
        if img.ndim == 2:
            img = np.repeat(img[:, :, None], 3, axis=2)
        # pad to multiples of 32 for clean stride-16 feature maps, with
        # white (1.0): black borders would read as giant text blobs
        ph, pw = _round_up(int(h * scale), 32), _round_up(int(w * scale), 32)
        canvas = np.ones((ph, pw, 3), np.float32)
        if scale < 1.0:
            resized = resize_norm_crop(img, target_h=int(h * scale), max_w=pw)
            canvas[: resized.shape[0]] = resized[:, :pw]
        else:
            canvas[:h, :w] = img
        prob = self._forward(self.bundle.det, canvas[None])[0]
        quads = db_quads_from_prob_map(prob, scale=2.0 / scale)
        # keep quads whose center is inside the image (crop_quad clips
        # sample coordinates, so out-of-range corners are safe)
        out = []
        for q in quads:
            cx, cy = q.points.mean(axis=0)
            if 0 <= cx < w and 0 <= cy < h and q.width >= 2 and q.height >= 2:
                out.append(q)
        return out

    def _batch_crops(self, crops: list[np.ndarray], target_h: int = 32) -> np.ndarray:
        """Crops resized to their content width at ``target_h`` and padded
        with zeros to a shared 32-multiple width; the batch to a multiple
        of 8 rows. The width cap (32·target_h) keeps ~50-char invoice rows
        unsquashed; the conv+CTC stack extrapolates in width."""
        resized = []
        for c in crops:
            h, w = c.shape[:2]
            w_cap = 32 * target_h
            cw = max(8, min(w_cap, int(round(w * target_h / max(1, h)))))
            resized.append(
                resize_norm_crop(c, target_h=target_h, max_w=w_cap)[:, :cw]
            )
        max_w = _round_up(max(r.shape[1] for r in resized), 32)
        batch = np.zeros((_round_up(len(crops), 8), target_h, max_w, 3), np.float32)
        for i, r in enumerate(resized):
            batch[i, :, : r.shape[1]] = r
        return batch

    def classify_and_fix(self, crops: list[np.ndarray]) -> list[np.ndarray]:
        """Rotate crops classified as 180° (score > 0.9, reference
        ch_ppocr_cls/main.py:36-74), with recognizer verification: a flip
        is kept only if the flipped orientation's emitted-frame confidence
        is at least the upright one's (one extra rec batch over the
        flagged crops, typically 0–2 a page)."""
        if not crops:
            return crops
        batch = self._batch_crops(crops)
        logits = self._forward(self.bundle.cls, batch)[: len(crops)]
        probs = np.exp(logits - logits.max(axis=1, keepdims=True))
        probs /= probs.sum(axis=1, keepdims=True)
        flagged = [i for i, p in enumerate(probs) if p[1] > 0.9]
        keep_flip = set()
        if flagged:
            pairs: list[np.ndarray] = []
            for i in flagged:
                pairs.append(crops[i])
                pairs.append(np.rot90(crops[i], 2).copy())
            rec = self._forward(
                self.bundle.rec, self._batch_crops(pairs, target_h=self.bundle.rec_h)
            )[: len(pairs)]
            for j, i in enumerate(flagged):
                if self._emit_conf(rec[2 * j + 1]) >= self._emit_conf(rec[2 * j]):
                    keep_flip.add(i)
        return [
            np.rot90(c, 2).copy() if i in keep_flip else c
            for i, c in enumerate(crops)
        ]

    @staticmethod
    def _emit_conf(logits: np.ndarray) -> float:
        """Mean log-prob over emitted (non-blank argmax) frames — the
        orientation score for flip verification."""
        x = logits - logits.max(axis=-1, keepdims=True)
        logp = x - np.log(np.exp(x).sum(axis=-1, keepdims=True))
        ids = logp.argmax(axis=-1)
        blank = logits.shape[-1] - 1
        emitted = ids != blank
        if not emitted.any():
            return float("-inf")
        return float(logp[emitted, ids[emitted]].mean())

    def _decode_batch(self, batch: np.ndarray, n: int) -> list[tuple[str, float]]:
        logits = self._forward(self.bundle.rec, batch)
        if self.lm_rescore:
            from .rescore import ctc_beam_decode, lexicon_correct

            decoded = ctc_beam_decode(logits[:n], self.bundle.charset)
            if not self.lexicon_repair:
                return decoded
            return [(lexicon_correct(t), c) for t, c in decoded]
        return ctc_greedy_decode(logits[:n], self.bundle.charset)

    def recognize(self, crops: list[np.ndarray]) -> list[tuple[str, float]]:
        if not crops:
            return []
        # aspect-sorted batching keeps padding waste bounded
        order = sorted(range(len(crops)), key=lambda i: crops[i].shape[1] / max(1, crops[i].shape[0]))
        results: list[tuple[str, float]] = [("", 0.0)] * len(crops)
        bs = 8
        for start in range(0, len(order), bs):
            idx = order[start : start + bs]
            decoded = self._decode_batch(
                self._batch_crops([crops[i] for i in idx], target_h=self.bundle.rec_h),
                len(idx),
            )
            for i, d in zip(idx, decoded):
                results[i] = d
        return results

    # ---------------- orchestration ----------------

    def __call__(self, image: np.ndarray, _depth: int = 0) -> OCRResult:
        elapse: dict[str, float] = {}
        t0 = time.perf_counter()
        quads = self.detect(image)
        elapse["det"] = time.perf_counter() - t0

        if self.auto_orient and _depth == 0 and len(quads) >= 3:
            ang = np.array([q.angle % 180.0 for q in quads])
            vertical = (ang >= 60.0) & (ang <= 120.0)
            if vertical.mean() > 0.6:
                # rotate clockwise to upright (180° ambiguity is fixed
                # by the orientation classifier on the crops)
                h_orig = image.shape[0]
                res = self.__call__(np.rot90(image, -1).copy(), _depth=1)
                lines = []
                for ln in res.lines:
                    if ln.quad is None:
                        lines.append(ln)
                        continue
                    pts = ln.quad.points
                    back = np.stack(
                        [pts[:, 1], h_orig - 1.0 - pts[:, 0]], axis=1
                    ).astype(np.float32)
                    nq = QuadBox(back, ln.quad.score)
                    lines.append(OCRLine(nq.aabb(), ln.text, ln.confidence, quad=nq))
                res.elapse["det"] += elapse["det"]
                return OCRResult(lines=lines, elapse=res.elapse)

        # DB maps merge vertically adjacent lines in dense layouts: cut
        # merged quads back into per-line sub-quads (projection profile);
        # quads still tall retry along the page's dominant text angle
        med_h = float(np.median([q.height for q in quads])) if quads else 0.0
        angs = [
            ((q.angle + 90.0) % 180.0) - 90.0
            for q in quads
            if q.width >= q.height
        ]
        med_a = float(np.median(angs)) if angs else 0.0
        out_quads = []
        for q in quads:
            parts = split_quad_lines(image, q)
            if len(parts) == 1 and abs(med_a) > 3.0 and med_h > 0:
                dev = abs(((q.angle - med_a) + 90.0) % 180.0 - 90.0)
                if q.height > 1.6 * med_h or dev > 4.0:
                    parts = split_quad_fragments(image, q, med_a, med_h)
            out_quads.extend(parts)
        quads = out_quads

        # rotated crop: each quad resampled to an upright strip, cut at
        # wide interior column gaps, then tightened to the ink bounding box
        split_pairs: list = []
        for q in quads:
            rec_h = self.bundle.rec_h
            strip = crop_quad(image, q, target_h=rec_h, max_w=32 * rec_h)
            if strip.size == 0:
                continue
            for part, sq in split_strip_columns(strip, q):
                tight = tighten_crop(part, target_h=rec_h)
                if tight.size > 0:
                    split_pairs.append((sq, tight))
        # nested-duplicate suppression on the final per-line quads (after
        # the vertical/column splits that create the duplicates)
        kept = _suppress_nested([p[0] for p in split_pairs])
        kept_ids = {id(q) for q in kept}
        split_pairs = [p for p in split_pairs if id(p[0]) in kept_ids]
        quads = [p[0] for p in split_pairs]
        crops = [p[1] for p in split_pairs]

        if self.use_cls and crops:
            t0 = time.perf_counter()
            crops = self.classify_and_fix(crops)
            elapse["cls"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        texts = self.recognize(crops)
        elapse["rec"] = time.perf_counter() - t0

        lines = [
            OCRLine(q.aabb(), text, conf, quad=q)
            for q, (text, conf) in zip(quads, texts)
            if conf >= self.text_score and text
        ]
        return OCRResult(lines=lines, elapse=elapse)
