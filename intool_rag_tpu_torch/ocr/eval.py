"""OCR end-to-end evaluation (copy of ``intool_rag_tpu/ocr/eval.py``) on synthetic pages: render pages the
pipeline has never seen, run the full det→cls→rec engine, and score
string recovery (exact and fuzzy) — the verification the reference
delegates to its pretrained-model self-check (ingest/ocr/cli.py:19-25).
"""

from __future__ import annotations

import difflib

import numpy as np


def _best_ratio(text: str, candidates: list[str]) -> float:
    if not candidates:
        return 0.0
    return max(
        difflib.SequenceMatcher(None, text, c).ratio() for c in candidates
    )


def evaluate_engine(
    engine,
    *,
    pages: int = 5,
    rotation: float = 0.0,
    seed: int = 123,
    size: int = 448,
    font_sizes: tuple[int, int] = (18, 30),
) -> dict:
    """Render ``pages`` synthetic pages at ``rotation`` degrees, OCR each,
    and report line recovery rates. Returns dict with exact/fuzzy rates."""
    from .synth import render_page

    rng = np.random.default_rng(seed)
    total = 0
    exact = 0
    fuzzy_sum = 0.0
    detected = 0
    for _ in range(pages):
        img, gt = render_page(
            engine_rng(rng), engine.bundle.charset, size=size,
            rotation=rotation, font_sizes=font_sizes,
        )
        result = engine(img)
        got_texts = [ln.text for ln in result.lines]
        detected += len(got_texts)
        # candidate set includes contiguous word spans of each box
        # text: two gt fragments rendered side by side legitimately
        # detect as ONE line — segmentation granularity should not
        # dominate a recognition metric (same convention as the
        # invoice eval's row-join spans)
        cands = list(got_texts)
        for t in got_texts:
            ws = t.split(" ")
            if 1 < len(ws) <= 8:
                for i in range(len(ws)):
                    for j in range(i + 1, len(ws) + 1):
                        cands.append(" ".join(ws[i:j]))
        for _, want in gt:
            total += 1
            if want in cands:
                exact += 1
            fuzzy_sum += _best_ratio(want, cands)
    return {
        "lines": total,
        "detected": detected,
        "exact_rate": exact / max(total, 1),
        "fuzzy_rate": fuzzy_sum / max(total, 1),
    }


def engine_rng(rng: np.random.Generator) -> np.random.Generator:
    return np.random.default_rng(rng.integers(0, 2**31))


def evaluate_repair_generalization(
    *,
    pages: int = 4,
    seed: int = 77,
    size: int = 640,
    font_sizes: tuple[int, int] = (18, 28),
    device=None,
) -> dict:
    """Post-OCR repair generalization on a SECOND document family
    (round-4 verdict item 7): delivery-manifest pages
    (``synth.manifest_lines`` — courier/city/product vocabulary and
    layout disjoint from the invoice eval; only form labels overlap the
    serving lexicon). Runs the identical engine with the repair stack
    ON vs OFF and reports the exact rates plus ``false_rewrites`` —
    gt lines the beam+LM (mid) pass got exactly right that the full
    stack broke, i.e. damage attributable to the REPAIR classes alone
    (round-5 review fixed this docstring: the earlier wording said
    "OFF pass", which conflates beam damage with repair damage).
    ``regressions_vs_greedy`` separately counts greedy-right lines the
    full stack missed — beam OR repairs. The unique-candidate /
    common-word gates exist precisely so ``false_rewrites`` is zero on
    vocabulary the repairs have never seen. The engines run on ``device``
    (``None``: the card)."""
    from .pipeline import OCREngine
    from .synth import manifest_lines, render_page

    on = OCREngine(det_limit=1280, device=device)
    # beam+LM but NO lexicon repair: the delta on→mid isolates the
    # repair classes (false-rewrite attribution), off is greedy context
    mid = OCREngine(bundle=on.bundle, lexicon_repair=False, det_limit=1280, device=device)
    off = OCREngine(bundle=on.bundle, lm_rescore=False, det_limit=1280, device=device)

    def cands_of(result):
        got = [_norm_line(ln.text) for ln in result.lines if ln.text]
        cands = list(got)
        for t in got:
            ws = t.split(" ")
            if 1 < len(ws) <= 10:
                for i in range(len(ws)):
                    for j in range(i + 1, len(ws) + 1):
                        cands.append(" ".join(ws[i:j]))
        return cands + _join_rows(result.lines)

    rng = np.random.default_rng(seed)
    total = on_exact = mid_exact = off_exact = false_rewrites = 0
    regressions_vs_greedy = 0
    broken: list[str] = []
    for _ in range(pages):
        texts = manifest_lines(engine_rng(rng), on.bundle.charset)
        img, gt = render_page(
            engine_rng(rng), on.bundle.charset, size=size,
            font_sizes=font_sizes, texts=texts,
        )
        c_on = cands_of(on(img))
        c_mid = cands_of(mid(img))
        c_off = cands_of(off(img))
        for _, want in gt:
            want = _norm_line(want)
            total += 1
            hit_on = want in c_on
            hit_mid = want in c_mid
            hit_off = want in c_off
            on_exact += hit_on
            mid_exact += hit_mid
            off_exact += hit_off
            if hit_mid and not hit_on:
                # the repair classes broke a line the beam already had
                # exactly right — the failure mode the gates must prevent
                false_rewrites += 1
                broken.append(want)
            if hit_off and not hit_on:
                regressions_vs_greedy += 1
    return {
        "lines": total,
        "exact_on": on_exact / max(total, 1),
        "exact_beam_only": mid_exact / max(total, 1),
        "exact_off": off_exact / max(total, 1),
        "false_rewrites": false_rewrites,
        "regressions_vs_greedy": regressions_vs_greedy,
        "broken": broken,
    }


def _norm_line(s: str) -> str:
    return " ".join(s.split())


def _join_rows(lines) -> list[str]:
    """Group OCR boxes into visual rows (y-center proximity, left-to-
    right) and join every CONTIGUOUS SPAN of a row with single spaces —
    the PDF text layer assembles its "lines" at an arbitrary granularity
    (one gt line may be a single detected box, a full visual row across
    table columns, or a sub-span of one: 'Balance Due: $2,724.57' is
    boxes 2-3 of a 3-box row whose box 1 belongs to another gt line).
    Row sizes are small (≤ ~8 boxes), so the span count stays tiny."""
    items = [
        (l.box.y0 + l.box.y1, l.box.x0, l.text) for l in lines if l.text
    ]
    if not items:
        return []
    heights = [l.box.y1 - l.box.y0 for l in lines if l.text]
    med_h = float(np.median(heights)) or 16.0
    rows: list[list[tuple[float, float, str]]] = []
    for yc2, x0, text in sorted(items):
        if rows and abs(yc2 - rows[-1][-1][0]) <= med_h:  # same row band
            rows[-1].append((yc2, x0, text))
        else:
            rows.append([(yc2, x0, text)])
    out = []
    for row in rows:
        row.sort(key=lambda t: t[1])
        texts = [t[2] for t in row]
        for i in range(len(texts)):
            for j in range(i + 1, len(texts) + 1):
                out.append(_norm_line(" ".join(texts[i:j])))
    return out


def score_page(lines, gt: list[str]) -> dict:
    """One page's OCR ``lines`` against its ground-truth lines, scored as
    :func:`evaluate_on_invoices` scores a page: ``lines`` (gt lines),
    ``exact``, ``fuzzy_sum``, ``emitted`` (boxes with text) and
    ``spurious`` (emitted boxes that resemble no gt line)."""
    from .synth import canonicalize_text

    # candidates at BOTH granularities: per-box text and row-joined
    # (a gt line may be one detected box or several across columns)
    per_box = [_norm_line(ln.text) for ln in lines if ln.text]
    got = per_box + _join_rows(lines)
    # score in the recognizer's CANONICAL alphabet: the charset folds
    # near-homoglyph classes (I/l, O/0, s/S — synth.homoglyph_map),
    # so the model cannot express the raw distinction; exact match
    # compares canonical forms on both sides (same convention as the
    # synthetic e2e eval, whose gt comes pre-canonicalized)
    got = [canonicalize_text(g) for g in got]
    exact, fuzzy_sum = 0, 0.0
    gt_norm = [canonicalize_text(_norm_line(w)) for w in gt]
    for want_n in gt_norm:
        exact += want_n in got
        fuzzy_sum += _best_ratio(want_n, got)
    # the span-candidate scheme above is one-directional (it cannot
    # punish hallucinated/concatenated output); spurious covers that
    # axis: emitted boxes that resemble NO gt line
    spurious = 0
    for t in (canonicalize_text(t) for t in per_box):
        contained = any(t and t in g for g in gt_norm)
        if not contained and _best_ratio(t, gt_norm) < 0.5:
            spurious += 1
    return {"lines": len(gt_norm), "exact": exact, "fuzzy_sum": fuzzy_sum, "emitted": len(per_box),
            "spurious": spurious}


def evaluate_on_invoices(
    engine,
    *,
    pdf_dir: str,
    scale: float = 2.0,
    min_chars: int = 3,
) -> dict:
    """Out-of-distribution e2e eval (round-2 verdict item 5): rasterize
    the reference invoice PDFs in ``pdf_dir`` with the in-repo renderer
    (ingest/rasterize.py), OCR the page images, and score recovery
    against the PDF text layer (free exact ground truth, :func:`score_page`).
    Unlike the synthetic eval, content, layout, line density and font
    sizes here come from real documents the training pipeline never
    generates."""
    import glob

    from ..ingest.rasterize import page_ground_truth_lines, rasterize_page

    total = exact = emitted_total = spurious = 0
    fuzzy_sum = 0.0
    per_doc = {}
    for path in sorted(glob.glob(f"{pdf_dir}/*.pdf")):
        data = open(path, "rb").read()
        img, _ = rasterize_page(data, 0, scale=scale)
        gt = page_ground_truth_lines(data, 0, min_chars=min_chars)
        page = score_page(engine(img).lines, gt)
        total += page["lines"]
        exact += page["exact"]
        fuzzy_sum += page["fuzzy_sum"]
        emitted_total += page["emitted"]
        spurious += page["spurious"]
        per_doc[path.rsplit("/", 1)[-1]] = {"gt_lines": len(gt), "exact": page["exact"]}
    return {
        "lines": total,
        "exact_rate": exact / max(total, 1),
        "fuzzy_rate": fuzzy_sum / max(total, 1),
        "spurious_rate": spurious / max(emitted_total, 1),
        "per_doc": per_doc,
    }


if __name__ == "__main__":
    import json

    from .pipeline import OCREngine

    engine = OCREngine()  # on the card
    out = {}
    for rot in (0.0, 15.0, -15.0, 90.0):
        out[f"rot{rot:+.0f}"] = evaluate_engine(engine, rotation=rot)
    print(json.dumps(out, indent=1))
