"""DB postprocess + CTC decode + layout reconstruction (copy of
``intool_rag_tpu/ocr/postprocess.py``) — host-side
geometry (reference: ch_ppocr_det/utils.py DBPostProcess with
OpenCV/pyclipper; ch_ppocr_rec/utils.py CTCLabelDecode; utils/to_markdown
— SURVEY.md §2.7 #40/#42/#46). Implemented on NumPy/SciPy.
"""

from __future__ import annotations

import dataclasses

import numpy as np
from scipy import ndimage


@dataclasses.dataclass
class TextBox:
    """Axis-aligned text region (x0, y0, x1, y1) with detection score."""

    x0: int
    y0: int
    x1: int
    y1: int
    score: float

    @property
    def width(self) -> int:
        return self.x1 - self.x0

    @property
    def height(self) -> int:
        return self.y1 - self.y0

    def expand(self, ratio: float, shape: tuple[int, int]) -> "TextBox":
        """Unclip (reference uses pyclipper offsetting; for the
        axis-aligned case a proportional margin is equivalent)."""
        mx = int(self.width * ratio)
        my = int(self.height * ratio)
        h, w = shape
        return TextBox(
            max(0, self.x0 - mx), max(0, self.y0 - my),
            min(w, self.x1 + mx), min(h, self.y1 + my), self.score,
        )


@dataclasses.dataclass
class QuadBox:
    """Oriented text region: 4 corners [4, 2] float (x, y), ordered so
    points[0]→points[1] is the reading direction (reference: minAreaRect
    quads from DBPostProcess, ch_ppocr_det/utils.py:117-202)."""

    points: np.ndarray  # [4, 2] float32
    score: float

    @property
    def angle(self) -> float:
        """Rotation of the reading axis in degrees, in (-180, 180]."""
        v = self.points[1] - self.points[0]
        return float(np.degrees(np.arctan2(v[1], v[0])))

    @property
    def width(self) -> float:
        return float(np.linalg.norm(self.points[1] - self.points[0]))

    @property
    def height(self) -> float:
        return float(np.linalg.norm(self.points[3] - self.points[0]))

    def aabb(self) -> "TextBox":
        x0, y0 = self.points.min(axis=0)
        x1, y1 = self.points.max(axis=0)
        return TextBox(int(x0), int(y0), int(round(x1)), int(round(y1)), self.score)

    def scaled(self, s: float) -> "QuadBox":
        return QuadBox(self.points * s, self.score)

    def expanded(self, ratio: float) -> "QuadBox":
        """Unclip: grow along both axes proportionally to the minor
        extent (reference uses pyclipper area-based offsetting; for
        rectangles a uniform margin of ``ratio·height`` is equivalent)."""
        c = self.points.mean(axis=0)
        u = self.points[1] - self.points[0]
        v = self.points[3] - self.points[0]
        nu = u / max(1e-6, np.linalg.norm(u))
        nv = v / max(1e-6, np.linalg.norm(v))
        m = ratio * self.height
        pts = self.points.copy()
        pts[0] += -nu * m - nv * m
        pts[1] += +nu * m - nv * m
        pts[2] += +nu * m + nv * m
        pts[3] += -nu * m + nv * m
        return QuadBox(pts, self.score)


def _quad_from_mask(
    region_mask: np.ndarray, y_off: int, x_off: int, score: float
) -> QuadBox:
    """Oriented rectangle of a connected component via PCA of its pixel
    cloud (the NumPy equivalent of cv2.minAreaRect for elongated text
    components). The major axis is snapped to the reading direction:
    rightward, or downward for near-vertical text — a 180°-flipped crop
    is later corrected by the orientation classifier."""
    ys, xs = np.nonzero(region_mask)
    pts = np.stack([xs + x_off, ys + y_off], axis=1).astype(np.float32)
    return _quad_from_points(pts, score)


def _region_ink(region: np.ndarray) -> np.ndarray | None:
    """Binary ink mask of an image region via the adaptive midpoint of
    its 2nd/98th luminance percentiles; ``None`` for blank (low-
    contrast) regions. Shared by the splitters and crop tightening so
    their notion of 'ink' can never diverge."""
    gray = region.mean(axis=2) if region.ndim == 3 else region.astype(float)
    if gray.max() > 1.5:
        gray = gray / 255.0
    lo, hi = np.percentile(gray, (2, 98))
    if hi - lo < 0.15:
        return None
    return gray < (lo + hi) / 2.0


def db_quads_from_prob_map(
    prob_map: np.ndarray,
    *,
    bin_thresh: float = 0.3,
    box_thresh: float = 0.6,
    unclip_ratio: float = 0.25,
    min_area: int = 16,
    scale: float = 2.0,
) -> list[QuadBox]:
    """Binarize → connected components → PCA oriented rectangles →
    unclip → reading-order sort. The rotated-text counterpart of
    :func:`db_boxes_from_prob_map` (reference: DBPostProcess minAreaRect
    + unclip, ch_ppocr_det/utils.py:117-202)."""
    bitmap = prob_map > bin_thresh
    labels, n = ndimage.label(bitmap)
    if n == 0:
        return []
    quads: list[QuadBox] = []
    for i, sl in enumerate(ndimage.find_objects(labels)):
        if sl is None:
            continue
        region_mask = labels[sl] == (i + 1)
        if int(region_mask.sum()) < min_area:
            continue
        score = float(prob_map[sl][region_mask].mean())
        if score < box_thresh:
            continue
        quad = _quad_from_mask(region_mask, sl[0].start, sl[1].start, score)
        quads.append(quad.expanded(unclip_ratio).scaled(scale))
    # reading order: row bands by aabb y-center, then x
    def _key(q: QuadBox):
        bb = q.aabb()
        return (round((bb.y0 + bb.y1) / 2 / max(16, bb.height or 16)), bb.x0)

    quads.sort(key=_key)
    return quads


# reading-axis over-crop shared by crop_quad and the strip splitter's
# inverse mapping — tuning it in one place keeps sub-quad geometry exact
CROP_EXTEND_FRAC = 0.35


def crop_quad(
    image: np.ndarray, quad: QuadBox, *, target_h: int = 32, max_w: int = 640,
    extend_frac: float = CROP_EXTEND_FRAC,
) -> np.ndarray:
    """Rotated crop: bilinear-sample the quad onto an axis-aligned
    ``[target_h, W, 3]`` float image (reference: get_rotate_crop_image,
    ocr/main.py:229-237 — perspective warp; affine suffices for the
    rectangle quads our detector emits).

    The sampled span is extended by ``extend_frac``·height along the
    reading axis on both ends: DB probability maps respond weakly to
    thin edge glyphs (``l``, ``:``, ``°``), so detector quads clip them;
    over-cropping here is trimmed back to actual ink by
    ``tighten_crop``, which follows in the pipeline."""
    h_src, w_src = image.shape[:2]
    img = image.astype(np.float32)
    if img.ndim == 2:
        img = img[:, :, None]
    if img.shape[2] == 1:
        img = np.repeat(img, 3, axis=2)
    if img.max() > 1.5:
        img = img / 255.0
    qw, qh = max(quad.width, 1.0), max(quad.height, 1.0)
    ext = extend_frac * qh
    u = (quad.points[1] - quad.points[0]) / qw  # unit reading axis
    v = (quad.points[3] - quad.points[0]) / qh  # unit descender axis
    origin = quad.points[0] - ext * u
    qw = qw + 2.0 * ext
    out_w = int(np.clip(round(qw * target_h / qh), 8, max_w))
    cols = (np.arange(out_w) + 0.5) * (qw / out_w)
    rows = (np.arange(target_h) + 0.5) * (qh / target_h)
    xs = origin[0] + cols[None, :] * u[0] + rows[:, None] * v[0]
    ys = origin[1] + cols[None, :] * u[1] + rows[:, None] * v[1]
    xs = np.clip(xs, 0, w_src - 1)
    ys = np.clip(ys, 0, h_src - 1)
    x0 = np.floor(xs).astype(int)
    y0 = np.floor(ys).astype(int)
    x1 = np.minimum(x0 + 1, w_src - 1)
    y1 = np.minimum(y0 + 1, h_src - 1)
    wx = (xs - x0)[..., None]
    wy = (ys - y0)[..., None]
    top = img[y0, x0] * (1 - wx) + img[y0, x1] * wx
    bot = img[y1, x0] * (1 - wx) + img[y1, x1] * wx
    return top * (1 - wy) + bot * wy


def split_quad_lines(
    image: np.ndarray,
    quad: QuadBox,
    *,
    min_band_h: int = 5,
    max_bands: int = 8,
) -> list[QuadBox]:
    """Split a detector quad that covers SEVERAL stacked text lines into
    per-line sub-quads via a horizontal ink-projection profile.

    DB-style probability maps merge vertically adjacent lines whenever
    the inter-line gap shrinks below the map's blur radius (dense
    invoice/table layouts do this constantly; the reference inherits the
    same failure from DBPostProcess connected components,
    ch_ppocr_det/utils.py:117-202). A merged quad is fatal downstream:
    ``crop_quad`` squashes N lines into one 32-px strip and the
    recognizer reads overlapping glyph soup. Rectifying the quad at its
    NATIVE vertical resolution and cutting at blank rows recovers the
    individual lines with no retraining.

    The profile runs in AXIS-ALIGNED image space (a merged 2-line
    component's PCA axis is spuriously diagonal — cutting along it
    samples glyphs across both lines), and each resulting band gets its
    own PCA oriented rectangle from its own ink, exactly as detection
    would have produced had the lines not merged. Near-vertical quads
    (|reading angle| ≥ 30°) pass through: a row profile of 90° text
    would cut between GLYPHS, not lines. Single-band quads return
    ``[quad]`` unchanged (preserving the DB unclip margin); bands
    shorter than ``min_band_h`` rows merge into their neighbor (dot
    rows of i/j, underline artifacts)."""
    ang = quad.angle % 180.0
    if min(ang, 180.0 - ang) >= 30.0:
        return [quad]
    if quad.height < 2.0 * min_band_h:
        return [quad]
    bb = quad.aabb()
    h_img, w_img = image.shape[:2]
    y0, y1 = max(0, bb.y0), min(h_img, bb.y1)
    x0, x1 = max(0, bb.x0), min(w_img, bb.x1)
    if y1 - y0 < 2 * min_band_h or x1 - x0 < 2:
        return [quad]
    ink = _region_ink(image[y0:y1, x0:x1])
    if ink is None:  # blank region — nothing to split
        return [quad]
    prof = ink.mean(axis=1)
    # a row belongs to a text band if it carries a sliver of ink — the
    # threshold must stay LOW: a short label in a wide merged box (the
    # 'Terms:' over 'Order ID …' case) puts <1.5% row ink into its
    # crossbar rows, and clipping them beheads the glyphs
    on = prof > max(0.005, 0.04 * float(prof.max()))
    if not on.any():
        return [quad]
    # runs of consecutive ink rows
    edges = np.flatnonzero(np.diff(np.concatenate(([0], on.astype(np.int8), [0]))))
    bands = list(zip(edges[0::2], edges[1::2]))  # [r0, r1) pairs
    # merge tiny bands (diacritics/underlines) into the nearest band
    merged: list[list[int]] = []
    for r0, r1 in bands:
        if merged and (r1 - r0 < min_band_h or r0 - merged[-1][1] <= 1):
            merged[-1][1] = int(r1)
        else:
            merged.append([int(r0), int(r1)])
    if len(merged) > 1 and merged[0][1] - merged[0][0] < min_band_h:
        merged[1][0] = merged[0][0]
        merged.pop(0)
    if len(merged) <= 1 or len(merged) > max_bands:
        return [quad]
    out = []
    for r0, r1 in merged:
        band = np.zeros_like(ink)
        band[r0:r1] = ink[r0:r1]
        if int(band.sum()) < 8:
            continue
        sub = _quad_from_mask(band, y0, x0, quad.score)
        out.append(sub.expanded(0.12))
    return out or [quad]


def _quad_from_points(pts: np.ndarray, score: float) -> QuadBox:
    """PCA oriented rectangle of a pixel-coordinate cloud [N, 2] (x, y)
    — the point-cloud core of :func:`_quad_from_mask`."""
    center = pts.mean(axis=0)
    d = pts - center
    if len(pts) < 2:
        major = np.array([1.0, 0.0], np.float32)
    else:
        cov = d.T @ d / len(pts)
        evals, evecs = np.linalg.eigh(cov)
        major = evecs[:, np.argmax(evals)].astype(np.float32)
    if abs(major[0]) < 1e-3:
        if major[1] < 0:
            major = -major
    elif major[0] < 0:
        major = -major
    minor = np.array([-major[1], major[0]], np.float32)
    pm = d @ major
    pn = d @ minor
    a0, a1 = pm.min() - 0.5, pm.max() + 0.5
    b0, b1 = pn.min() - 0.5, pn.max() + 0.5
    corners = np.stack(
        [
            center + a0 * major + b0 * minor,
            center + a1 * major + b0 * minor,
            center + a1 * major + b1 * minor,
            center + a0 * major + b1 * minor,
        ]
    ).astype(np.float32)
    return QuadBox(corners, score)


def split_quad_fragments(
    image: np.ndarray,
    quad: QuadBox,
    angle_deg: float,
    line_h: float,
    *,
    min_band_h: int = 5,
    max_parts: int = 8,
) -> list[QuadBox]:
    """Angle-aware splitter for merged components the axis-aligned
    row profile cannot separate.

    Two jittered fragments on a ROTATED page merge into one DB
    component whose PCA axis is skewed between them; their rows overlap
    in both the axis-aligned frame and the (wrong) PCA frame, so
    :func:`split_quad_lines` passes them through and the skewed crop
    reads garbage. Here the component's ink pixel COORDINATES rotate by
    the page's dominant text angle (``angle_deg``, estimated from the
    other detected quads); banding runs on the rotated row coordinate,
    and when that still yields one band, on rotated-column gaps wider
    than ``line_h`` (word spaces are ~0.3–0.5·h; fragment gaps are
    line-scale). Each cluster gets its own PCA oriented rectangle from
    its own ink — no image resampling anywhere."""
    bb = quad.aabb()
    h_img, w_img = image.shape[:2]
    y0, y1 = max(0, bb.y0), min(h_img, bb.y1)
    x0, x1 = max(0, bb.x0), min(w_img, bb.x1)
    if y1 - y0 < 2 * min_band_h or x1 - x0 < 2:
        return [quad]
    ink = _region_ink(image[y0:y1, x0:x1])
    if ink is None:
        return [quad]
    ys, xs = np.nonzero(ink)
    if ys.size < 16:
        return [quad]
    # rotate by -angle so the reading direction (cos a, sin a) maps to
    # the x axis: points along a text line share y_rot
    a = np.radians(angle_deg)
    y_rot = -xs * np.sin(a) + ys * np.cos(a)
    x_rot = xs * np.cos(a) + ys * np.sin(a)
    pts = np.stack([xs + x0, ys + y0], axis=1).astype(np.float32)

    def clusters_1d(coord: np.ndarray, gap: float) -> list[np.ndarray]:
        order = np.argsort(coord)
        c = coord[order]
        breaks = np.flatnonzero(np.diff(c) > gap)
        groups = np.split(order, breaks + 1)
        return [g for g in groups if g.size >= 12]

    # rows first (stacked lines), then columns. Column gaps at fragment
    # scale are indistinguishable from word spaces, so cluster at WORD
    # scale and re-merge neighbors whose vertical placement/extent
    # agree — only genuinely inconsistent fragments (different
    # baselines or font sizes) stay split.
    groups = clusters_1d(y_rot, float(min_band_h))
    if len(groups) <= 1:
        words = clusters_1d(x_rot, max(4.0, 0.35 * float(line_h)))
        if len(words) > 1:
            merged: list[tuple[np.ndarray, float, float]] = []
            for g in words:
                m, p = float(y_rot[g].mean()), float(np.ptp(y_rot[g]))
                if merged:
                    g0, m0, p0 = merged[-1]
                    scale = max(p, p0, 1.0)
                    same_line = (
                        abs(m - m0) < 0.30 * scale
                        and max(p, p0) / max(1.0, min(p, p0)) < 1.5
                    )
                    if same_line:
                        n0, n = g0.size, g.size
                        merged[-1] = (
                            np.concatenate([g0, g]),
                            (m0 * n0 + m * n) / (n0 + n),
                            max(p0, p),
                        )
                        continue
                merged.append((g, m, p))
            if len(merged) > 1:
                groups = [t[0] for t in merged]
    def quad_at_angle(p: np.ndarray) -> QuadBox:
        """Oriented box with the axis FIXED to the page's dominant text
        angle — a merged component's own PCA axis is skewed between its
        fragments, and resampling along it tilts every glyph."""
        major = np.array([np.cos(a), np.sin(a)], np.float32)
        minor = np.array([-major[1], major[0]], np.float32)
        center = p.mean(axis=0)
        d = p - center
        pm = d @ major
        pn = d @ minor
        a0, a1 = pm.min() - 0.5, pm.max() + 0.5
        b0, b1 = pn.min() - 0.5, pn.max() + 0.5
        corners = np.stack([
            center + a0 * major + b0 * minor,
            center + a1 * major + b0 * minor,
            center + a1 * major + b1 * minor,
            center + a0 * major + b1 * minor,
        ]).astype(np.float32)
        return QuadBox(corners, quad.score).expanded(0.12)

    if len(groups) <= 1 or len(groups) > max_parts:
        # no split — but if this component's PCA axis disagrees with the
        # page, re-fit the box at the dominant angle so the crop samples
        # along the true baseline
        da = abs(((quad.angle - angle_deg) + 90.0) % 180.0 - 90.0)
        if da > 4.0:
            return [quad_at_angle(pts)]
        return [quad]
    # each split fragment is a clean single line — its own PCA is
    # reliable (and reads measurably better than the fixed-angle box)
    return [_quad_from_points(pts[g], quad.score).expanded(0.12) for g in groups]


def split_strip_columns(
    crop: np.ndarray,
    quad: QuadBox,
    *,
    extend_frac: float = CROP_EXTEND_FRAC,
    gap_frac: float = 1.2,
) -> list[tuple[np.ndarray, QuadBox]]:
    """Split a rectified strip at WIDE interior column gaps.

    Two text fragments rendered side by side (table cells, label/value
    columns) merge into one DB component whose PCA axis is skewed by
    their vertical offset; the rectified strip then carries both
    fragments separated by a blank run much wider than a word space.
    Reading such a strip whole fails twice over: ``tighten_crop`` keeps
    only the span connected to the center (discarding the other
    fragment), and the skewed axis tilts every glyph. Cutting at blank
    runs ≥ ``gap_frac``·height yields per-fragment crops and maps each
    back to its own sub-quad along the reading axis (the same fractional
    interpolation ``word_quads_from_ctc`` uses).

    Returns ``[(crop, quad)]`` unchanged when no wide gap exists."""
    h, w = crop.shape[:2]
    if w < 3 * h:
        return [(crop, quad)]
    ink = _region_ink(crop)
    if ink is None:
        return [(crop, quad)]
    has_ink = ink.any(axis=0)
    cols = np.flatnonzero(has_ink)
    if cols.size == 0:
        return [(crop, quad)]
    gap_w = max(8, int(gap_frac * h))
    edges = np.flatnonzero(
        np.diff(np.concatenate(([0], has_ink.astype(np.int8), [0])))
    )
    spans = list(zip(edges[0::2], edges[1::2]))  # ink spans [c0, c1)
    merged_spans: list[list[int]] = []
    for c0, c1 in spans:
        if merged_spans and c0 - merged_spans[-1][1] < gap_w:
            merged_spans[-1][1] = int(c1)
        else:
            merged_spans.append([int(c0), int(c1)])
    if len(merged_spans) <= 1:
        return [(crop, quad)]
    # reconstruct the extended reading-axis span crop_quad sampled
    qh = max(quad.height, 1.0)
    qw = max(quad.width, 1.0)
    u = (quad.points[1] - quad.points[0]) / qw
    v = quad.points[3] - quad.points[0]
    ext = extend_frac * qh
    origin = quad.points[0] - ext * u
    full_w = qw + 2.0 * ext
    out = []
    pad = max(2, h // 8)
    for c0, c1 in merged_spans:
        a = max(0, c0 - pad)
        b = min(w, c1 + pad)
        part = crop[:, a:b]
        f0 = a / w * full_w
        f1 = b / w * full_w
        p0 = origin + f0 * u
        p1 = origin + f1 * u
        pts = np.stack([p0, p1, p1 + v, p0 + v]).astype(np.float32)
        out.append((part, QuadBox(pts, quad.score)))
    return out


def word_quads_from_ctc(
    quad: QuadBox, logits: np.ndarray, charset: str
) -> list[tuple[QuadBox, str]]:
    """Per-word oriented boxes from CTC columns: column spans scale
    linearly along the quad's reading axis and rotate back into image
    coordinates (reference: CalRecBoxes rotation reversal,
    cal_rec_boxes/main.py:21-55)."""
    aabb = TextBox(0, 0, 1000, 1000, quad.score)  # column spans in [0,1000]
    from .utils import word_boxes_from_ctc

    words = word_boxes_from_ctc(aabb, logits, charset)
    u = (quad.points[1] - quad.points[0])
    v = (quad.points[3] - quad.points[0])
    out = []
    for wb, text in words:
        f0, f1 = wb.x0 / 1000.0, wb.x1 / 1000.0
        pts = np.stack(
            [
                quad.points[0] + f0 * u,
                quad.points[0] + f1 * u,
                quad.points[0] + f1 * u + v,
                quad.points[0] + f0 * u + v,
            ]
        ).astype(np.float32)
        out.append((QuadBox(pts, quad.score), text))
    return out


def db_boxes_from_prob_map(
    prob_map: np.ndarray,
    *,
    bin_thresh: float = 0.3,
    box_thresh: float = 0.6,
    unclip_ratio: float = 0.3,
    min_area: int = 16,
    scale: float = 2.0,
) -> list[TextBox]:
    """Binarize → connected components → scored boxes → unclip → sort
    top-to-bottom/left-to-right (reference: DBPostProcess utils.py:117-202
    and box sort main.py:79-103). ``scale`` maps prob-map coords back to
    image coords (the det head emits at 1/2 resolution)."""
    bitmap = prob_map > bin_thresh
    labels, n = ndimage.label(bitmap)
    if n == 0:
        return []
    boxes: list[TextBox] = []
    slices = ndimage.find_objects(labels)
    for i, sl in enumerate(slices):
        if sl is None:
            continue
        region_mask = labels[sl] == (i + 1)
        area = int(region_mask.sum())
        if area < min_area:
            continue
        score = float(prob_map[sl][region_mask].mean())
        if score < box_thresh:
            continue
        y0, x0 = sl[0].start, sl[1].start
        y1, x1 = sl[0].stop, sl[1].stop
        box = TextBox(
            int(x0 * scale), int(y0 * scale), int(x1 * scale), int(y1 * scale), score
        )
        boxes.append(box)
    h, w = prob_map.shape
    img_shape = (int(h * scale), int(w * scale))
    boxes = [b.expand(unclip_ratio, img_shape) for b in boxes]
    # reading order: rows by y-center, then x
    boxes.sort(key=lambda b: (round((b.y0 + b.y1) / 2 / max(16, b.height or 16)), b.x0))
    return boxes


def ctc_greedy_decode(
    logits: np.ndarray, charset: str
) -> list[tuple[str, float]]:
    """Argmax + collapse-repeats + drop-blank (reference: CTCLabelDecode,
    ch_ppocr_rec/utils.py:13-90). logits [B, T, V+1], blank id = V.
    Returns [(text, mean_prob)] per item."""
    blank = len(charset)
    # softmax probabilities for confidence
    x = logits - logits.max(axis=-1, keepdims=True)
    probs = np.exp(x)
    probs /= probs.sum(axis=-1, keepdims=True)
    ids = probs.argmax(axis=-1)  # [B, T]
    out: list[tuple[str, float]] = []
    for b in range(ids.shape[0]):
        chars: list[str] = []
        confs: list[float] = []
        prev = -1
        for t in range(ids.shape[1]):
            c = int(ids[b, t])
            if c != prev and c != blank:
                chars.append(charset[c])
                confs.append(float(probs[b, t, c]))
            prev = c
        out.append(("".join(chars), float(np.mean(confs)) if confs else 0.0))
    return out


def tighten_crop(
    crop: np.ndarray, *, pad_frac: float = 0.08, target_h: int = 32
) -> np.ndarray:
    """Re-crop a detector strip to its ink bounding box and resize back
    to ``target_h``.

    Detector quads carry the DB unclip margin, so raw crops frame the
    glyphs loosely (text fills ~50-75% of the strip at a random offset).
    The recognizer/classifier train on tightly-rendered lines; content
    tightening at inference collapses both distributions to one. The
    threshold adapts to the crop's own contrast (midpoint of the 2nd/98th
    luminance percentiles), so darkness variation and mild noise don't
    move the box. Blank crops pass through unchanged."""
    gray = crop.mean(axis=2) if crop.ndim == 3 else crop
    lo, hi = np.percentile(gray, (2, 98))
    if hi - lo < 0.15:  # no contrast — blank strip
        return crop
    ink = gray < (lo + hi) / 2.0
    rows = np.flatnonzero(ink.any(axis=1))
    cols = np.flatnonzero(ink.any(axis=0))
    if rows.size == 0 or cols.size == 0:
        return crop
    # keep only the column span connected to the crop center: crop_quad
    # over-extends the reading axis to rescue clipped edge glyphs, which
    # can pull a NEIGHBORING line segment into view — ink separated from
    # the central mass by a gap much wider than a word space belongs to
    # that neighbor, not this line
    has_ink = ink.any(axis=0)
    max_gap = max(3, int(0.75 * gray.shape[0]))
    center = gray.shape[1] // 2
    left = cols[0]
    right = cols[-1]
    gap = 0
    for x in range(center, cols[0] - 1, -1):
        gap = gap + 1 if not has_ink[x] else 0
        if gap > max_gap:
            left = x + gap
            break
    gap = 0
    for x in range(center, cols[-1] + 1):
        gap = gap + 1 if not has_ink[x] else 0
        if gap > max_gap:
            right = x - gap
            break
    cols = cols[(cols >= left) & (cols <= right)]
    rows = np.flatnonzero(ink[:, cols].any(axis=1))
    if rows.size == 0 or cols.size == 0:
        return crop
    h = rows[-1] - rows[0] + 1
    pad = max(1, int(round(pad_frac * h)))
    y0, y1 = max(0, rows[0] - pad), min(gray.shape[0], rows[-1] + 1 + pad)
    x0, x1 = max(0, cols[0] - pad), min(gray.shape[1], cols[-1] + 1 + pad)
    tight = crop[y0:y1, x0:x1]
    w = max(8, int(round(tight.shape[1] * target_h / max(1, tight.shape[0]))))
    return resize_norm_crop(tight, target_h=target_h, max_w=4096)[:, :w]


def crop_box(image: np.ndarray, box: TextBox) -> np.ndarray:
    """Extract a box crop (reference: get_rotate_crop_image — axis-aligned
    here since detection emits rects)."""
    return image[box.y0 : box.y1, box.x0 : box.x1]


def resize_norm_crop(
    crop: np.ndarray, target_h: int = 32, max_w: int = 320
) -> np.ndarray:
    """Resize to fixed height, preserve aspect, pad width (reference:
    resize-norm to 3×48×320, ch_ppocr_rec/main.py:152-173)."""
    h, w = crop.shape[:2]
    if h == 0 or w == 0:
        return np.zeros((target_h, max_w, 3), np.float32)
    new_w = max(8, min(max_w, int(round(w * target_h / h))))
    # bilinear resize via PIL-free numpy (nearest for simplicity at small
    # scale factors, linear along each axis)
    ys = np.clip((np.arange(target_h) + 0.5) * h / target_h - 0.5, 0, h - 1)
    xs = np.clip((np.arange(new_w) + 0.5) * w / new_w - 0.5, 0, w - 1)
    y0 = np.floor(ys).astype(int)
    x0 = np.floor(xs).astype(int)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    wy = (ys - y0)[:, None, None]
    wx = (xs - x0)[None, :, None]
    img = crop.astype(np.float32)
    if img.ndim == 2:
        img = img[:, :, None]
    top = img[y0][:, x0] * (1 - wx) + img[y0][:, x1] * wx
    bot = img[y1][:, x0] * (1 - wx) + img[y1][:, x1] * wx
    resized = top * (1 - wy) + bot * wy
    if resized.shape[2] == 1:
        resized = np.repeat(resized, 3, axis=2)
    if resized.max() > 1.5:
        resized = resized / 255.0
    out = np.zeros((target_h, max_w, 3), np.float32)
    out[:, :new_w] = resized[:, :max_w]
    return out


def to_markdown(results: list[tuple[TextBox, str, float]]) -> str:
    """Layout reconstruction: group boxes into lines by y-center overlap,
    join left-to-right (reference: utils/to_markdown.py:3-92)."""
    if not results:
        return ""
    items = sorted(results, key=lambda r: (r[0].y0 + r[0].y1) / 2)
    lines: list[list[tuple[TextBox, str]]] = []
    for box, text, _ in items:
        cy = (box.y0 + box.y1) / 2
        placed = False
        if lines:
            last_line = lines[-1]
            ref = last_line[0][0]
            if abs(cy - (ref.y0 + ref.y1) / 2) < max(8, ref.height * 0.6):
                last_line.append((box, text))
                placed = True
        if not placed:
            lines.append([(box, text)])
    out_lines = []
    for line in lines:
        line.sort(key=lambda r: r[0].x0)
        out_lines.append(" ".join(t for _, t in line if t))
    return "\n".join(ln for ln in out_lines if ln.strip())
