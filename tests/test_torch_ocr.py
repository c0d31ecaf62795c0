"""The OCR host stages and the engine of the port against the JAX package's.

The host modules (postprocess, rescore, wordlist, synth) are copies, so
each case below runs the same inputs (those of the JAX package's
``tests/test_ocr.py``, ``test_ocr_split.py`` and ``test_rescore.py``)
through both packages and requires equal results: arrays bit for bit,
strings exactly. Given the JAX engine's own prob maps and logits, the
port's host stages give the same quads, crops and strings. The engines
themselves (the shipped weights; the port's on the CPU, float32) must give
the same lines on seeded synthetic pages: texts equal, boxes within 1 px,
confidences within 1e-4. The JAX slow cases (training) have their twins
in ``test_torch_ocr_train.py``.
"""

from __future__ import annotations

import dataclasses
import functools
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from test_ocr import _pdf_with_image, _rotated_bar_map
from test_rescore import CHARSET as RESCORE_CHARSET
from test_rescore import _logits_for
from test_torch_ocr_models import jax_bundle

torch.set_num_threads(2)

BOX_TOL_PX = 1
CONF_TOL = 1e-4


@functools.lru_cache(maxsize=1)
def _packages() -> dict[str, SimpleNamespace]:
    import intool_rag_tpu.ocr.pdf_ocr as jpdf
    import intool_rag_tpu.ocr.pipeline as jpipe
    import intool_rag_tpu.ocr.postprocess as jpost
    import intool_rag_tpu.ocr.rescore as jres
    import intool_rag_tpu.ocr.synth as jsyn
    import intool_rag_tpu.ocr.utils as jutil
    import intool_rag_tpu_torch.ocr.pdf_ocr as tpdf
    import intool_rag_tpu_torch.ocr.pipeline as tpipe
    import intool_rag_tpu_torch.ocr.postprocess as tpost
    import intool_rag_tpu_torch.ocr.rescore as tres
    import intool_rag_tpu_torch.ocr.synth as tsyn
    import intool_rag_tpu_torch.ocr.utils as tutil

    return {"jax": SimpleNamespace(post=jpost, rescore=jres, synth=jsyn, pipe=jpipe, pdf=jpdf, utils=jutil),
            "torch": SimpleNamespace(post=tpost, rescore=tres, synth=tsyn, pipe=tpipe, pdf=tpdf, utils=tutil)}


def _same(a, b, path="out"):
    """Equal results: dataclasses field by field, arrays bit for bit."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, path
        for f in dataclasses.fields(a):
            _same(getattr(a, f.name), getattr(b, f.name), f"{path}.{f.name}")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype and np.array_equal(a, b), path
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _same(a[k], b[k], f"{path}[{k!r}]")
    else:
        assert a == b or (a != a and b != b), (path, a, b)


def _quad(post, x0, y0, x1, y1):
    return post.QuadBox(np.array([[x0, y0], [x1, y0], [x1, y1], [x0, y1]], np.float32), 1.0)


def _page(h=200, w=400):
    return np.ones((h, w, 3), np.float32)


def _rotated_lines_page(lines: int) -> np.ndarray:
    img = _page(300, 500)
    a = np.radians(15.0)
    u, v = np.array([np.cos(a), np.sin(a)]), np.array([-np.sin(a), np.cos(a)])
    for line in range(lines):
        base = np.array([60.0, 60.0]) + v * (line * 34.0)
        for t in range(0, 280, 4):
            x, y = base + u * t
            img[int(y): int(y) + 14, int(x): int(x) + 3] = 0.0
    return img


def _crop_quad_case(p):
    from scipy import ndimage

    ink = p.synth.render_line("ROTATION-CHECK-42", font_size=22)
    rot, corners = p.synth._rotate_ink(ink, 17.0)
    img = np.repeat((1.0 - rot)[:, :, None], 3, axis=2)
    mask = ndimage.binary_dilation(rot > 0.3, iterations=5)
    quads = p.post.db_quads_from_prob_map(mask.astype(np.float32), scale=1.0, unclip_ratio=0.0, min_area=30)
    return corners, quads, [p.post.crop_quad(img, q, target_h=32) for q in quads]


def _split_lines_case(p):
    img = _page()
    img[40:60, 20:300] = 0.0
    img[72:92, 20:260] = 0.0
    return [p.post.split_quad_lines(img, _quad(p.post, *box)) for box in
            ((15, 35, 310, 97), (15, 35, 310, 65))] + [p.post.split_quad_lines(_page(), _quad(p.post, 15, 35, 310, 97))]


def _split_columns_case(p):
    out = []
    strip = np.ones((32, 400, 3), np.float32)
    strip[8:24, 10:120] = 0.0
    strip[8:24, 300:390] = 0.0
    out.append(p.post.split_strip_columns(strip, _quad(p.post, 0, 0, 400, 32), extend_frac=0.0))
    strip = np.ones((32, 300, 3), np.float32)
    for x0 in (10, 80, 150):
        strip[8:24, x0: x0 + 58] = 0.0
    out.append(p.post.split_strip_columns(strip, _quad(p.post, 0, 0, 300, 32), extend_frac=0.0))
    return out


def _fragments_case(p):
    out = []
    for lines in (2, 1):
        img = _rotated_lines_page(lines)
        ys, xs = np.nonzero(img[:, :, 0] < 0.5)
        q = _quad(p.post, xs.min() - 2, ys.min() - 2, xs.max() + 2, ys.max() + 2)
        out.append(p.post.split_quad_fragments(img, q, 15.0, 30.0))
    return out


def _word_quads_case(p):
    logits = np.full((8, 4), -10.0, np.float32)
    for i, c in enumerate([0, 0, 3, 2, 3, 1, 1, 3]):
        logits[i, c] = 10.0
    quad = p.post.QuadBox(np.array([[10, 10], [90, 50], [85, 60], [5, 20]], np.float32), 0.9)
    return p.post.word_quads_from_ctc(quad, logits, "ab ")


def _greedy_case(p):
    seq = [0, 0, 2, 1, 1, 2, 0]
    logits = np.full((2, len(seq), 3), -10.0, np.float32)
    for t, c in enumerate(seq):
        logits[0, t, c] = 10.0
    logits[1, :, 2] = 10.0  # all blank
    return p.post.ctc_greedy_decode(logits, "ab")


def _markdown_case(p):
    tb = p.post.TextBox
    return p.post.to_markdown([(tb(60, 10, 100, 20, 0.9), "world", 0.9), (tb(5, 11, 50, 21, 0.9), "hello", 0.9),
                               (tb(5, 40, 60, 52, 0.9), "second line", 0.9)])


def _tighten_case(p):
    ink = p.synth.render_line("Margin 42", font_size=20)
    h, w = ink.shape
    loose = np.ones((h * 2, w + 30, 3), np.float32)
    loose[h // 2: h // 2 + h, 15: 15 + w] -= ink[:, :, None] * 0.9
    return [p.post.tighten_crop(loose), p.post.tighten_crop(np.ones((32, 64, 3), np.float32)),
            p.post.resize_norm_crop(np.ones((16, 64, 3), np.float32), target_h=32, max_w=320)]


def _suppress_case(p):
    quads = [_quad(p.post, *b) for b in ((77, 438, 128, 472), (88, 450, 126, 466), (130, 440, 200, 470),
                                         (100, 430, 180, 450))]
    kept = {id(q) for q in p.pipe._suppress_nested(quads)}
    return [i for i, q in enumerate(quads) if id(q) in kept], p.pipe._suppress_nested(quads[:1])[0] is quads[0]


def _emit_conf_case(p):
    logits = np.full((12, 10), -5.0, np.float32)
    logits[:, 9] = 5.0
    first = p.pipe.OCREngine._emit_conf(logits)
    logits[3, 2] = 9.0
    return first, p.pipe.OCREngine._emit_conf(logits)


def _beam_case(p):
    cases = [_logits_for("$1250.50", {"0": ("O", 0.05)}), _logits_for("invoice", {"i": ("I", 0.03)}),
             _logits_for("hello 42", {})]
    return [p.rescore.ctc_beam_decode(x, RESCORE_CHARSET, alpha=0.7) for x in cases] + \
        [p.rescore.ctc_beam_decode(cases[2], RESCORE_CHARSET)]


LEXICON_CASES = [
    "Toal: $2,724.57", "Noes:", "Dae: Nov 15 2012", "Thanks foryour bsiness!", "TOAL",
    "Order ID : CA-2012AH10075140-41228", "FUR-BO-4861", "$624.49", "Total: $11.95", "Notes:", "ab",
    "Bookcases, Furniture", "INVOlCE", "BlLL TO", "McDonald", "llc", "Apollo", "SN4l7X", "AX-1l0B",
    "Model AX-100B", "Attn: Dale", "Dole banana", "mate", "rode", "deliver", "rat", "Checked mate",
    "We rode home", "deliver the goods", "Arount", "Sandad", "#4820", "Invoice #4820", "PO#12", "ABC#77",
    "Ref: PO#12 net30", "Tes:", "Notes!.", "Total!.", "Thanks for your business!", "Total!", "Great rate!",
    "ship to!", "Tes", "XY:", "Bookcases,Furniture,FUR-BO-4861", "Discount(20%): 624.49", "$3,122.43",
    "1,250", "f(x)", "Item Quantity Rate Arount", "lkea Librarv", "Ship Mode: Sandad Class", "Quanty",
    "BilITo: ShioTo:", "Thanks foryourbsiness!", "Huntington", "Saltillo, Coahuila,", "SupeStore", "UIVesal",
    "Aaron Hawkins",
]


def _charset_case(p):
    cs = p.synth.build_charset()
    return (cs, p.synth.homoglyph_map(cs), [p.synth.canonicalize_text(c) for c in ("о", "ο", "я", "Ѕhip ТО")],
            p.synth.build_charset_full())


def _generators_case(p):
    rng = np.random.default_rng(11)
    cs = p.synth.build_charset()
    return ([p.synth.random_text(rng, cs) for _ in range(20)], [p.synth.wordlike_text(rng, cs) for _ in range(50)],
            [p.synth.business_text(rng, cs) for _ in range(50)], p.synth.manifest_lines(rng, cs))


def _render_case(p):
    rng = np.random.default_rng(4)
    cs = p.synth.build_charset()
    return (p.synth.render_page(rng, cs, size=256), p.synth.render_page(rng, cs, size=256, rotation=15.0),
            p.synth.render_line("Quantity: 42", font_size=18))


def _extract_images_case(p):
    img = np.zeros((40, 60), np.uint8)
    img[10:20, 5:50] = 200
    return p.pdf.extract_page_images(_pdf_with_image(img), 0), p.pdf.extract_page_images(_pdf_with_image(img), 3)


def _word_boxes_case(p):
    logits = np.full((8, 4), -10.0, np.float32)
    for i, c in enumerate([0, 0, 3, 2, 3, 1, 1, 3]):
        logits[i, c] = 10.0
    return p.utils.word_boxes_from_ctc(p.post.TextBox(10, 5, 90, 25, 0.9), logits, "ab ")


HOST_CASES = {
    "db_boxes": lambda p: p.post.db_boxes_from_prob_map(
        np.pad(np.full((5, 26), 0.9, np.float32), ((5, 54), (4, 34))), min_area=16, scale=2.0),
    "db_boxes_threshold": lambda p: p.post.db_boxes_from_prob_map(np.full((32, 32), 0.4, np.float32)),
    "db_quads_rotated": lambda p: [p.post.db_quads_from_prob_map(_rotated_bar_map(a), scale=1.0, unclip_ratio=0.0)
                                   for a in (0.0, 15.0, -20.0, 90.0)],
    "crop_quad": _crop_quad_case,
    "word_quads": _word_quads_case,
    "word_boxes": _word_boxes_case,
    "ctc_greedy": _greedy_case,
    "markdown": _markdown_case,
    "tighten_resize": _tighten_case,
    "split_lines": _split_lines_case,
    "split_columns": _split_columns_case,
    "split_fragments": _fragments_case,
    "suppress_nested": _suppress_case,
    "emit_conf": _emit_conf_case,
    "beam": _beam_case,
    "lexicon": lambda p: [p.rescore.lexicon_correct(s) for s in LEXICON_CASES],
    "charsets": _charset_case,
    "generators": _generators_case,
    "render": _render_case,
    "extract_images": _extract_images_case,
}


@pytest.mark.parametrize("case", sorted(HOST_CASES))
def test_host_stage_equals_jax(case):
    pk = _packages()
    _same(HOST_CASES[case](pk["torch"]), HOST_CASES[case](pk["jax"]))


@pytest.mark.parametrize("charset", ["default", "rescore_tests"])
def test_bigram_lm_equals_jax(charset):
    pk = _packages()
    cs = pk["torch"].synth.build_charset() if charset == "default" else RESCORE_CHARSET
    got, want = pk["torch"].rescore.bigram_lm(cs), pk["jax"].rescore.bigram_lm(cs)
    assert got.dtype == want.dtype == np.float32 and got.shape == (len(cs) + 1,) * 2
    assert np.array_equal(got, want)


@functools.lru_cache(maxsize=1)
def _engines():
    from intool_rag_tpu.ocr.pipeline import OCREngine as JEngine
    from intool_rag_tpu_torch.ocr.pipeline import OCREngine

    return JEngine(jax_bundle()), OCREngine(device="cpu")


def test_host_stages_on_jax_model_outputs():
    """JAX's own prob map and rec logits through both packages' host code:
    the same quads, crops and decoded strings."""
    pk = _packages()
    jengine, _ = _engines()
    img, _ = pk["jax"].synth.render_page(np.random.default_rng(21), jengine.bundle.charset, size=448)
    prob = np.asarray(jengine._det_fn(jengine.bundle.det_params, img[None].astype(np.float32)))[0]
    out = {}
    for name, p in pk.items():
        quads = p.post.db_quads_from_prob_map(prob, scale=2.0)
        parts = [part for q in quads for part in p.post.split_quad_lines(img, q)]
        crops = [p.post.tighten_crop(p.post.crop_quad(img, q, target_h=32, max_w=1024), target_h=32)
                 for q in parts]
        out[name] = (quads, parts, crops)
    _same(out["torch"], out["jax"])
    crops = out["jax"][2]
    assert len(crops) >= 4
    batch = jengine._batch_crops(crops, target_h=32)
    logits = np.asarray(jengine._rec_fn(jengine.bundle.rec_params, batch))[: len(crops)]
    cs = jengine.bundle.charset
    decoded = {name: (p.post.ctc_greedy_decode(logits, cs), p.rescore.ctc_beam_decode(logits, cs),
                      [p.rescore.lexicon_correct(t) for t, _ in p.rescore.ctc_beam_decode(logits, cs)])
               for name, p in pk.items()}
    _same(decoded["torch"], decoded["jax"])
    assert any(t for t, _ in decoded["jax"][1])


def _same_lines(got, want):
    assert [ln.text for ln in got.lines] == [ln.text for ln in want.lines]
    for g, w in zip(got.lines, want.lines):
        gb = np.array([g.box.x0, g.box.y0, g.box.x1, g.box.y1])
        wb = np.array([w.box.x0, w.box.y0, w.box.x1, w.box.y1])
        assert np.abs(gb - wb).max() <= BOX_TOL_PX, (g.text, gb, wb)
        assert g.confidence == pytest.approx(w.confidence, abs=CONF_TOL)


@pytest.mark.parametrize("seed,rotation", [(0, 0.0), (1, 0.0), (2, 0.0), (3, 15.0), (4, 90.0)])
def test_engine_reads_synthetic_pages_like_jax(seed, rotation):
    jengine, tengine = _engines()
    img, _ = _packages()["torch"].synth.render_page(
        np.random.default_rng(seed), tengine.bundle.charset, size=448, rotation=rotation)
    want, got = jengine(img), tengine(img)
    assert len(want.lines) >= 3
    _same_lines(got, want)
    assert set(got.elapse) == set(want.elapse)
    assert got.to_markdown() == want.to_markdown()


def test_evaluate_engine_equals_jax():
    from intool_rag_tpu.ocr.eval import evaluate_engine as jeval
    from intool_rag_tpu_torch.ocr.eval import evaluate_engine

    jengine, tengine = _engines()
    got = evaluate_engine(tengine, pages=2, seed=7)
    want = jeval(jengine, pages=2, seed=7)
    assert got == want and got["lines"] >= 6


def test_classify_and_fix_recognizer_verified_pairing():
    """The classifier forced to flag every crop: the recognizer check keeps
    an upright crop upright and reverts a 180°-rotated one."""
    from intool_rag_tpu.ocr.train import render_text_image

    _, tengine = _engines()
    upright = render_text_image("TOTAL DUE 420", height=48)
    flipped = np.rot90(upright, 2).copy()
    engine = type(tengine)(tengine.bundle, device="cpu")
    forward = engine._forward

    def forced(model, batch):
        if model is engine.bundle.cls:  # p(180°) ≈ 1 for every crop
            return np.tile(np.array([-10.0, 10.0], np.float32), (batch.shape[0], 1))
        return forward(model, batch)

    engine._forward = forced
    out = engine.classify_and_fix([upright, flipped])
    assert np.array_equal(out[0], upright) and np.array_equal(out[1], upright)


def test_engine_on_random_weights_and_a_blank_page():
    from intool_rag_tpu_torch.ocr.models import OCRModelBundle
    from intool_rag_tpu_torch.ocr.pipeline import OCREngine

    engine = OCREngine(OCRModelBundle.create("ab", width=8), device="cpu", text_score=0.99)
    result = engine(np.full((64, 64, 3), 255, np.uint8))
    assert all(ln.confidence >= 0.99 for ln in result.lines) and "det" in result.elapse
    with torch.no_grad():
        assert tuple(engine.bundle.det(torch.zeros(1, 64, 96, 3)).shape) == (1, 32, 48)
        assert tuple(engine.bundle.rec(torch.zeros(2, 32, 64, 3)).shape) == (2, 16, 3)


def test_pdf_ocr_bridge_protocol_and_lazy_engine():
    from intool_rag_tpu_torch.ocr import pdf_ocr
    from intool_rag_tpu_torch.ocr.pipeline import OCRLine, OCRResult
    from intool_rag_tpu_torch.ocr.postprocess import TextBox

    class StubEngine:
        def __call__(self, image):
            return OCRResult(lines=[OCRLine(TextBox(0, 0, 10, 10, 0.9), "scanned text", 0.8)], elapse={})

    bridge = pdf_ocr.PDFOCRBridge(engine=StubEngine())
    text, conf = bridge.extract_page(_pdf_with_image(np.full((30, 30), 128, np.uint8)), 0)
    assert (text, conf) == ("scanned text", pytest.approx(0.8))
    from intool_rag_tpu_torch.ocr.synth import _text_layer_pdf

    lazy = pdf_ocr.PDFOCRBridge(device="cpu")  # a page without an image builds no engine
    assert lazy.extract_page(_text_layer_pdf([[(54.0, 700.0, 11.0, "no image here")]]), 0) == ("", 0.0)
    assert lazy._engine is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):  # the default device is the card
            pdf_ocr.PDFOCRBridge().engine


def test_evaluate_on_invoices_equals_jax(tmp_path):
    """Both packages' invoice eval over a directory holding a text PDF (a
    fixture builder's page): the rasterizer, the OCR and the scoring."""
    from intool_rag_tpu.ocr.eval import evaluate_on_invoices as jeval
    from intool_rag_tpu_torch.ocr.eval import evaluate_on_invoices
    from intool_rag_tpu_torch.ocr.synth import _text_layer_pdf, build_charset, scanned_invoice_lines

    rng = np.random.default_rng(9)
    (tmp_path / "inv.pdf").write_bytes(_text_layer_pdf([scanned_invoice_lines(rng, build_charset())]))
    jengine, tengine = _engines()
    got = evaluate_on_invoices(tengine, pdf_dir=str(tmp_path))
    want = jeval(jengine, pdf_dir=str(tmp_path))
    assert got == want and got["lines"] >= 20


def test_evaluate_repair_generalization_equals_jax(monkeypatch):
    from intool_rag_tpu.ocr import eval as jeval
    from intool_rag_tpu.ocr.pipeline import OCREngine as JEngine
    from intool_rag_tpu_torch.ocr.eval import evaluate_repair_generalization

    monkeypatch.setattr(JEngine, "_default_bundle", staticmethod(jax_bundle))  # without flax's init
    got = evaluate_repair_generalization(pages=1, seed=77, device="cpu")
    want = jeval.evaluate_repair_generalization(pages=1, seed=77)
    assert got == want and got["lines"] >= 10 and got["false_rewrites"] == 0


def test_invoice_text_layer_recovery():
    """Twin of ``tests/test_ocr_invoices.py``: the reference invoices (its
    ``INVOICES``), where mounted, read at the JAX package's measured level."""
    from test_ocr_invoices import INVOICES

    from intool_rag_tpu_torch.ocr.eval import evaluate_on_invoices
    from intool_rag_tpu_torch.ocr.pipeline import OCREngine

    if not INVOICES.is_dir():
        pytest.skip("reference invoices not mounted")
    result = evaluate_on_invoices(OCREngine(device="cpu", det_limit=1280), pdf_dir=str(INVOICES), scale=2.0)
    assert result["lines"] >= 40
    assert result["exact_rate"] >= 0.75 and result["fuzzy_rate"] >= 0.88, result
