"""The port's host-side ingest modules (PDF extractor, loader, normalizer,
heuristic analyzer, tree, chunker, multipart parser, task queue) give
exactly the JAX package's output on documents written here from a seed."""

from __future__ import annotations

import dataclasses
import threading
import zlib

import numpy as np
import pytest

from intool_rag_tpu import config as jconfig
from intool_rag_tpu import exceptions as jexc
from intool_rag_tpu.ingest import chunker as jchunker
from intool_rag_tpu.ingest import loader as jloader
from intool_rag_tpu.ingest import normalizer as jnormalizer
from intool_rag_tpu.ingest import pdf as jpdf
from intool_rag_tpu.ingest import tree as jtree
from intool_rag_tpu.llm.semantic import factory as jfactory
from intool_rag_tpu.providers.heuristic_semantic import HeuristicSemanticAnalyzer as JAnalyzer
from intool_rag_tpu.service.multipart import parse_multipart as jparse_multipart
from intool_rag_tpu_torch import config as tconfig
from intool_rag_tpu_torch import exceptions as texc
from intool_rag_tpu_torch import tasks as ttasks
from intool_rag_tpu_torch.ingest import chunker as tchunker
from intool_rag_tpu_torch.ingest import loader as tloader
from intool_rag_tpu_torch.ingest import normalizer as tnormalizer
from intool_rag_tpu_torch.ingest import pdf as tpdf
from intool_rag_tpu_torch.ingest import tree as ttree
from intool_rag_tpu_torch.llm.semantic import factory as tfactory
from intool_rag_tpu_torch.providers.heuristic_semantic import HeuristicSemanticAnalyzer as TAnalyzer
from intool_rag_tpu_torch.service.multipart import parse_multipart as tparse_multipart


def build_pdf(page_texts: list[str], *, xref_stream: bool = False, tounicode: bool = False) -> bytes:
    """A small valid PDF with one font and Flate content streams.

    ``xref_stream``: the font, page, pages and catalog dictionaries live in
    an object stream, and the cross-reference is a Flate stream behind a PNG
    "up" predictor (otherwise a classic xref table and trailer).
    ``tounicode``: the font's codes are arbitrary bytes that only its
    ToUnicode CMap (bfchar entries, one bfrange for the digits) maps to
    text, shown as hex strings."""
    n_pages = len(page_texts)
    font, cmap, content0 = 1, 2, 3
    page0 = content0 + n_pages
    pages_id, catalog = page0 + n_pages, page0 + n_pages + 1

    def flate(data: bytes, extra: bytes = b"") -> bytes:
        z = zlib.compress(data)
        return b"<< /Length %d /Filter /FlateDecode%s >>\nstream\n" % (len(z), extra) + z + b"\nendstream"

    chars = sorted({c for t in page_texts for c in t if c != "\n" and not c.isdigit()})
    code = {c: 0x21 + i for i, c in enumerate(chars)}
    code.update({str(d): 0xB0 + d for d in range(10)})
    assert len(chars) < 0x8F

    def show(line: str) -> bytes:
        if tounicode:
            return b"<" + "".join(f"{code[c]:02X}" for c in line).encode() + b"> Tj"
        esc = line.replace("\\", r"\\").replace("(", r"\(").replace(")", r"\)")
        return b"(" + esc.encode("latin-1", "replace") + b") Tj"

    bodies: dict[int, bytes] = {}
    if tounicode:
        bfchar = "\n".join(f"<{code[c]:02X}> <{ord(c):04X}>" for c in chars)
        bodies[cmap] = flate((
            "/CIDInit /ProcSet findresource begin 12 dict begin begincmap\n"
            "/CMapName /Adobe-Identity-UCS def /CMapType 2 def\n"
            "1 begincodespacerange <00> <FF> endcodespacerange\n"
            f"{len(chars)} beginbfchar\n{bfchar}\nendbfchar\n"
            "1 beginbfrange <B0> <B9> <0030> endbfrange\n"
            "endcmap CMapName currentdict /CMap defineresource pop end end\n"
        ).encode())
        bodies[font] = b"<< /Type /Font /Subtype /Type1 /BaseFont /Helvetica /ToUnicode %d 0 R >>" % cmap
    else:
        bodies[cmap] = b"null"
        bodies[font] = b"<< /Type /Font /Subtype /Type1 /BaseFont /Helvetica >>"
    for i, text in enumerate(page_texts):
        ops = [b"BT /F1 12 Tf 72 720 Td 14 TL"]
        for j, line in enumerate(text.split("\n")):
            if j:
                ops.append(b"T*")
            ops.append(show(line))
        ops.append(b"ET")
        bodies[content0 + i] = flate(b"\n".join(ops))
        bodies[page0 + i] = (
            b"<< /Type /Page /Parent %d 0 R /MediaBox [0 0 612 792] "
            b"/Resources << /Font << /F1 %d 0 R >> >> /Contents %d 0 R >>" % (pages_id, font, content0 + i)
        )
    kids = b" ".join(b"%d 0 R" % (page0 + i) for i in range(n_pages))
    bodies[pages_id] = b"<< /Type /Pages /Kids [%s] /Count %d >>" % (kids, n_pages)
    bodies[catalog] = b"<< /Type /Catalog /Pages %d 0 R >>" % pages_id

    out = bytearray(b"%PDF-1.5\n")
    offsets: dict[int, int] = {}

    def emit(num: int, body: bytes) -> None:
        offsets[num] = len(out)
        out.extend(b"%d 0 obj\n" % num + body + b"\nendobj\n")

    if not xref_stream:
        for num in sorted(bodies):
            emit(num, bodies[num])
        xref_pos = len(out)
        out += b"xref\n0 %d\n0000000000 65535 f \n" % (catalog + 1)
        for num in range(1, catalog + 1):
            out += b"%010d 00000 n \n" % offsets[num]
        out += b"trailer\n<< /Size %d /Root %d 0 R >>\nstartxref\n%d\n%%%%EOF" % (catalog + 1, catalog, xref_pos)
        return bytes(out)

    packed = [n for n in sorted(bodies) if b"stream" not in bodies[n]]
    objstm, xref = catalog + 1, catalog + 2
    header, blob = [], b""
    for n in packed:
        header.append(b"%d %d" % (n, len(blob)))
        blob += bodies[n] + b"\n"
    head = b" ".join(header) + b"\n"
    for num in sorted(bodies):
        if num not in packed:
            emit(num, bodies[num])
    emit(objstm, flate(head + blob, b" /Type /ObjStm /N %d /First %d" % (len(packed), len(head))))
    xref_pos = len(out)
    rows = []
    for num in range(xref + 1):
        if num == 0:
            rows.append(bytes(7))
        elif num in packed:
            rows.append(b"\x02" + objstm.to_bytes(4, "big") + packed.index(num).to_bytes(2, "big"))
        else:
            rows.append(b"\x01" + (xref_pos if num == xref else offsets[num]).to_bytes(4, "big") + bytes(2))
    predicted, prev = b"", bytes(7)
    for row in rows:  # PNG filter 2 ("up"): each byte minus the byte above it
        predicted += b"\x02" + bytes((a - b) & 0xFF for a, b in zip(row, prev))
        prev = row
    emit(xref, flate(predicted, b" /Type /XRef /Size %d /W [1 4 2] /Root %d 0 R "
                                b"/DecodeParms << /Predictor 12 /Columns 7 >>" % (xref + 1, catalog)))
    out += b"startxref\n%d\n%%%%EOF" % xref_pos
    return bytes(out)


def _document(seed: int, pages: int, *, accents: bool = False, symbols: bool = False) -> list[str]:
    """Seeded page texts with numbered headings, paragraphs and a repeated
    footer line, so that every host stage has something to do. ``symbols``
    adds words that keep a symbol inside them in the native analyzer
    (``€uro``, ``5€``, ``c++``)."""
    rng = np.random.default_rng(seed)
    words = ["invoice", "total", "amount", "shipping", "terms", "payment", "warranty", "region",
             "revenue", "quarter", "supplier", "contract", "delivery", "balance", "account"]
    if accents:
        words += ["café", "naïve", "straße", "señor"]
    if symbols:
        words += ["€uro", "5€", "c++"]
    out = []
    for p in range(pages):
        lines = [f"{p + 1}. {' '.join(rng.choice(words, 2)).title()}"]
        for s in range(int(rng.integers(1, 4))):
            lines += ["", f"{p + 1}.{s + 1} {' '.join(rng.choice(words, 3)).title()}", ""]
            for _ in range(int(rng.integers(1, 4))):
                n_sent = int(rng.integers(2, 7))
                sents = [" ".join(rng.choice(words, int(rng.integers(5, 14)))).capitalize()
                         + f" {int(rng.integers(10, 99999))}." for _ in range(n_sent)]
                lines += [" ".join(sents), ""]
        lines.append("Confidential report page footer")
        out.append("\n".join(lines))
    return out


@pytest.fixture(autouse=True)
def _heuristic_analyzer(monkeypatch):
    monkeypatch.setenv("LLM_PROVIDER", "heuristic")
    for mod in (jconfig, tconfig):
        mod.reset_config()
    for mod in (jfactory, tfactory):
        mod.reset_semantic_analyzer()
    yield
    for mod in (jfactory, tfactory):
        mod.reset_semantic_analyzer()
    for mod in (jloader, tloader):
        mod.register_ocr_engine(None)
    monkeypatch.undo()
    for mod in (jconfig, tconfig):
        mod.reset_config()


PDF_VARIANTS = {
    "classic-xref": dict(),
    "xref-stream-objstm-predictor": dict(xref_stream=True),
    "tounicode": dict(tounicode=True),
    "tounicode-in-xref-stream": dict(xref_stream=True, tounicode=True),
}


@pytest.mark.parametrize("variant", PDF_VARIANTS)
def test_pdf_text_equals_jax(variant):
    kw = PDF_VARIANTS[variant]
    texts = _document(3, 4, accents=kw.get("tounicode", False))
    data = build_pdf(texts, **kw)
    got = tpdf.extract_pdf_text(data)
    assert got == jpdf.extract_pdf_text(data)
    assert len(got) == 4
    for page, text in zip(got, texts):
        for line in text.split("\n"):
            assert line.strip() in page
    if kw.get("tounicode"):
        assert any(w in "".join(got) for w in ("café", "naïve", "straße", "señor"))


def test_pdf_failures_raise_the_ports_error(monkeypatch):
    with pytest.raises(texc.PDFParseError):
        tpdf.PDFDocument(b"this is not a pdf file")
    assert issubclass(texc.PDFParseError, texc.DocumentLoadError)
    assert issubclass(texc.UnsupportedFormatError, texc.DocumentLoadError)
    assert issubclass(texc.DocumentLoadError, texc.IngestError) and issubclass(texc.IngestError, texc.RAGError)
    assert not issubclass(texc.PDFParseError, jexc.RAGError)  # the port's own tree
    monkeypatch.setattr(tpdf, "MAX_STREAM_DECODED_BYTES", 1 << 20)
    bomb = tpdf.Stream(dict={"Filter": "FlateDecode"}, raw=zlib.compress(b"\x00" * (16 << 20)))
    with pytest.raises(texc.PDFParseError, match="bomb|exceeds"):
        tpdf.decode_stream(bomb)
    base = build_pdf(["fuzz target content"], xref_stream=True)
    rng = np.random.default_rng(0)
    for _ in range(20):  # corrupted input parses or raises PDFParseError, in both packages alike
        bad = bytearray(base)
        for pos in rng.integers(0, len(bad), size=10):
            bad[pos] = int(rng.integers(256))
        outcomes = []
        for mod, err in ((tpdf, texc.PDFParseError), (jpdf, jexc.PDFParseError)):
            try:
                outcomes.append(mod.extract_pdf_text(bytes(bad)))
            except err:
                outcomes.append("PDFParseError")
        assert outcomes[0] == outcomes[1]


def _write(tmp_path, kind: str, seed: int):
    if kind == "txt-form-feeds":
        path = tmp_path / "doc.txt"
        path.write_text("\f".join(_document(seed, 5)), encoding="utf-8")
    elif kind == "md-one-long-page":
        path = tmp_path / "doc.md"
        path.write_text("\n\n".join(_document(seed, 9)), encoding="utf-8")
    else:
        path = tmp_path / "doc.pdf"
        path.write_bytes(build_pdf(_document(seed, 5, accents=True), xref_stream=True, tounicode=True))
    return path


@pytest.mark.parametrize("kind", ["txt-form-feeds", "md-one-long-page", "pdf"])
def test_host_stages_equal_jax(tmp_path, kind):
    path = _write(tmp_path, kind, seed=len(kind))
    traw = tloader.PageBasedLoader(max_chars_per_page=6000).load(path)
    jraw = jloader.PageBasedLoader(max_chars_per_page=6000).load(path)
    assert [dataclasses.asdict(p) for p in traw] == [dataclasses.asdict(p) for p in jraw]
    assert len(traw) >= 2

    raw = {p.page: p.raw_content for p in traw}
    tnorm = tnormalizer.PageNormalizer().normalize_pages(raw)
    jnorm = jnormalizer.PageNormalizer().normalize_pages(raw)
    assert [dataclasses.asdict(p) for p in tnorm] == [dataclasses.asdict(p) for p in jnorm]
    pages = {p.page: p.text for p in tnorm if p.is_valid}
    assert pages
    if kind == "txt-form-feeds":  # a line on every page is boilerplate and goes
        assert not any("Confidential report page footer" in t for t in pages.values())

    ordered = [pages[k] for k in sorted(pages)]
    tspecs, jspecs = TAnalyzer().analyze(ordered), JAnalyzer().analyze(ordered)
    assert [dataclasses.asdict(s) for s in tspecs] == [dataclasses.asdict(s) for s in jspecs]
    # a PDF page comes back without blank lines, so its headings merge into one paragraph
    assert len(tspecs) >= (1 if kind == "pdf" else 2)

    meta = dict(source_file=path.name, project="p", language="en")
    ttree_index = ttree.SemanticTreeBuilder().build("doc", pages, **meta)
    jtree_index = jtree.SemanticTreeBuilder().build("doc", pages, **meta)
    assert ttree_index.to_dict() == jtree_index.to_dict()
    assert len(ttree_index.nodes) >= 2

    for cfg in (dict(), dict(max_chars=400, min_chars=50, target_chars=250, overlap_chars=40)):
        tchunks = tchunker.ChunksBuilder(tchunker.ChunkerConfig(**cfg)).build_chunks(pages, ttree_index)
        jchunks = jchunker.ChunksBuilder(jchunker.ChunkerConfig(**cfg)).build_chunks(pages, jtree_index)
        assert [c.to_dict() for c in tchunks] == [c.to_dict() for c in jchunks]
        assert len(tchunks) >= 3


def test_loader_errors_and_the_ocr_hook(tmp_path):
    loader = tloader.PageBasedLoader()
    with pytest.raises(texc.DocumentLoadError):
        loader.load(tmp_path / "absent.pdf")
    (tmp_path / "doc.docx").write_bytes(b"x")
    with pytest.raises(texc.UnsupportedFormatError):
        loader.load(tmp_path / "doc.docx")
    (tmp_path / "broken.pdf").write_bytes(b"%PDF-1.4\n" + b"\x00" * 100)
    with pytest.raises(texc.DocumentLoadError):
        loader.load(tmp_path / "broken.pdf")
    scanned = tmp_path / "scanned.pdf"
    scanned.write_bytes(build_pdf(["A page with a text layer", ""]))
    pages = loader.load(scanned)  # no engine registered: the empty page stays empty
    assert [dataclasses.asdict(p) for p in pages] == [
        dataclasses.asdict(p) for p in jloader.PageBasedLoader().load(scanned)]
    assert pages[1].raw_content == "" and pages[1].extraction_confidence == 0.0 and not pages[1].has_ocr

    class Engine:
        def extract_page(self, pdf_bytes, page_number):
            return f"recognized page {page_number}", 0.5

    tloader.register_ocr_engine(Engine())
    pages = loader.load(scanned)
    assert (pages[1].raw_content, pages[1].has_ocr, pages[1].extraction_confidence) == ("recognized page 1", True, 0.5)
    assert not pages[0].has_ocr


def test_analyzer_factory_serves_the_heuristic_one_or_refuses(monkeypatch):
    """The heuristic analyzer where it is asked for, and, as in the JAX
    package, where no LLM answers: no Gemini key and Ollama unreachable
    (its readiness probe refused in both packages)."""
    from intool_rag_tpu.providers.ollama import OllamaLLM as JOllama
    from intool_rag_tpu_torch.exceptions import ProviderConnectionError
    from intool_rag_tpu_torch.providers import http_utils

    def refused(method, url, body=None, *, timeout=None):
        raise ProviderConnectionError(f"{url}: connection refused")

    assert type(tfactory.get_semantic_analyzer()).__name__ == type(jfactory.get_semantic_analyzer()).__name__
    monkeypatch.setattr(JOllama, "is_ready", lambda self: False)
    monkeypatch.setattr(http_utils, "transport", refused)
    monkeypatch.setenv("GEMINI_API_KEY", "")
    try:
        for choice in ("", "gemini", "ollama"):
            monkeypatch.setenv("LLM_PROVIDER", choice)
            for config, factory in ((tconfig, tfactory), (jconfig, jfactory)):
                config.reset_config()
                factory.reset_semantic_analyzer()
            assert type(tfactory.get_semantic_analyzer()).__name__ == "HeuristicSemanticAnalyzer"
            assert type(jfactory.get_semantic_analyzer()).__name__ == "HeuristicSemanticAnalyzer"
    finally:
        for factory in (tfactory, jfactory):
            factory.reset_semantic_analyzer()


def test_config_carries_the_chunking_and_upload_fields(tmp_path, monkeypatch):
    monkeypatch.setenv("STORAGE_DIR", str(tmp_path / "s"))
    monkeypatch.setenv("CHUNK_MAX_CHARS", "1234")
    jcfg, tcfg = jconfig.reset_config(), tconfig.reset_config()
    for name in ("CHUNK_MAX_CHARS", "CHUNK_MIN_CHARS", "CHUNK_TARGET_CHARS", "CHUNK_OVERLAP_CHARS",
                 "UPLOAD_DIR", "EMBEDDING_MODEL", "LLM_PROVIDER"):
        assert getattr(tcfg, name) == getattr(jcfg, name), name
    assert tcfg.CHUNK_MAX_CHARS == 1234
    tcfg.ensure_dirs()
    assert tcfg.UPLOAD_DIR.is_dir()


def _multipart(parts: list[tuple[str, str | None, bytes]], boundary: str = "----b0undary", eol: bytes = b"\r\n"):
    body = b""
    for name, filename, data in parts:
        disp = f'form-data; name="{name}"' + (f'; filename="{filename}"' if filename is not None else "")
        body += b"--" + boundary.encode() + eol + b"Content-Disposition: " + disp.encode() + eol
        if filename is not None:
            body += b"Content-Type: application/pdf" + eol
        body += eol + data + eol
    return body + b"--" + boundary.encode() + b"--" + eol, f"multipart/form-data; boundary={boundary}"


@pytest.mark.parametrize("case", ["file-and-field", "binary-payload", "quoted-boundary", "no-file"])
def test_parse_multipart_equals_jax(case):
    payload = bytes(range(256)) * 3 if case == "binary-payload" else b"%PDF-1.4 plain"
    parts = [("note", None, b"hello")] if case == "no-file" else [
        ("file", "report v2.pdf", payload), ("note", None, "café".encode())]
    body, ctype = _multipart(parts)
    if case == "quoted-boundary":
        ctype = 'multipart/form-data; boundary="----b0undary"'
    got, want = tparse_multipart(body, ctype), jparse_multipart(body, ctype)
    assert got[0] == want[0]
    assert [dataclasses.asdict(f) for f in got[1]] == [dataclasses.asdict(f) for f in want[1]]
    if case != "no-file":
        assert got[1][0].data == payload and got[1][0].filename == "report v2.pdf"
    with pytest.raises(ValueError):
        tparse_multipart(body, "multipart/form-data")


def test_task_queue_runs_jobs_and_reports_failures():
    queue = ttasks.TaskQueue(workers=2, max_jobs=4)
    try:
        gate = threading.Event()
        slow = queue.submit("ingest", lambda: gate.wait(10) and {"chunks": 3})
        assert queue.get(slow.job_id).status in ("pending", "running")
        failing = queue.submit("ingest", lambda: 1 / 0)
        gate.set()
        assert queue.wait_all(timeout=10)
        assert queue.get(slow.job_id).to_dict()["status"] == "done"
        assert queue.get(slow.job_id).result == {"chunks": 3}
        failed = queue.get(failing.job_id).to_dict()
        assert failed["status"] == "failed" and "ZeroDivisionError" in failed["error"]
        assert failed["finished_at"] >= failed["started_at"] >= failed["submitted_at"]
        for i in range(6):  # past max_jobs the oldest finished jobs are dropped
            queue.submit("ingest", lambda i=i: i)
            assert queue.wait_all(timeout=10)
        assert len(queue.list_jobs()) <= 4 and queue.get(slow.job_id) is None
        assert queue.get("no-such-job") is None
    finally:
        queue.shutdown()
