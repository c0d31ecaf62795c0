"""The OCR slice as a whole: a scanned PDF (the committed fixture, image-only
pages) through ``POST /ingest`` of the port's service and the JAX
package's, both on the default configuration (``OCR_ENABLED`` unset, so on
exactly when the shipped weights exist), hash embeddings in both; the JAX
bridge's engine gets the shipped bundle read without flax's init (the same
parameters, ``test_torch_ocr_models.jax_bundle``). The
loaders' pages must agree: the same pages, ``has_ocr``, texts, and
confidences to 1e-5. With ``OCR_ENABLED=false`` the scanned page stays
empty in both. The committed fixture must equal what its builder makes
from its seed. Each service has its own ``STORAGE_DIR``."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_ingest import _multipart
from test_torch_ocr_models import jax_bundle

torch.set_num_threads(2)

CONF_TOL = 1e-5
FIXTURE_PAGES = 3  # the first pages of the committed fixture (each ~1 s of CPU a package)


def _scanned_pdf(pages: int) -> bytes:
    """The committed fixture's first ``pages`` pages, as an image-only PDF."""
    from intool_rag_tpu_torch.ocr.pdf_ocr import extract_page_images
    from intool_rag_tpu_torch.ocr.synth import _image_pdf, load_scanned_fixture

    pdf, _ = load_scanned_fixture()
    return _image_pdf([extract_page_images(pdf, i)[0][:, :, 0] for i in range(pages)])


@pytest.fixture
def make_services(tmp_path):
    """Builds (JAX service, the port's service) under ``env``; records each
    loader's pages in ``pages[name]``."""
    from intool_rag_tpu import config as jconfig
    from intool_rag_tpu.index.registry import CorpusRegistry as JRegistry
    from intool_rag_tpu.ingest.loader import register_ocr_engine as jregister
    from intool_rag_tpu.llm.semantic import factory as jfactory
    from intool_rag_tpu.providers.hash_embed import HashEmbeddingProvider as JHash
    from intool_rag_tpu.service.app import RAGService as JService
    from intool_rag_tpu_torch import config as tconfig
    from intool_rag_tpu_torch.ingest.loader import register_ocr_engine as tregister
    from intool_rag_tpu_torch.llm.semantic import factory as tfactory
    from intool_rag_tpu_torch.providers.hash_embed import HashEmbeddingProvider
    from intool_rag_tpu_torch.service.app import RAGService as TService

    mp = pytest.MonkeyPatch()
    pages: dict[str, list] = {}

    def recording(name, loader):
        load = loader.load

        def wrapped(path):
            out = load(path)
            pages[name] = out
            return out

        loader.load = wrapped

    def make(env: dict):
        for key, val in {"LLM_PROVIDER": "heuristic", "RERANKER_ENABLED": "0", "INDEX_DTYPE": "float32",
                         "SHARDED_SEARCH": "off", **env}.items():
            mp.setenv(key, val)
        if "OCR_ENABLED" not in env:
            mp.delenv("OCR_ENABLED", raising=False)
        jregister(None)  # the JAX service registers only when on; a bridge left by another test stays
        for name, cfg, factory in (("jax", jconfig, jfactory), ("torch", tconfig, tfactory)):
            mp.setenv("STORAGE_DIR", str(tmp_path / name))
            mp.setenv("CACHE_DIR", str(tmp_path / name / "cache"))
            cfg.reset_config()
            factory.reset_semantic_analyzer()
            if name == "jax":
                jservice = JService(registry=JRegistry(), llm=object(), provider=JHash(64))
            else:
                tservice = TService(HashEmbeddingProvider(64), device="cpu", llm=object())
        from intool_rag_tpu.ingest import loader as jloader
        from intool_rag_tpu.ocr.pipeline import OCREngine as JEngine

        if jloader._ocr_engine is not None:  # the shipped weights without 20 s of flax init
            jloader._ocr_engine._engine = JEngine(jax_bundle())
        recording("jax", jservice.pipeline.loader)
        recording("torch", tservice.pipeline.loader)
        return jservice, tservice, pages

    try:
        yield make
    finally:
        mp.undo()
        jregister(None)
        tregister(None)
        jconfig.reset_config()
        tconfig.reset_config()
        jfactory.reset_semantic_analyzer()
        tfactory.reset_semantic_analyzer()


def _ingest(service, pdf: bytes) -> dict:
    body, ctype = _multipart([("file", "scan.pdf", pdf)])
    status, out = service.handle("POST", "/ingest?project=scans&doc_id=scan", body, ctype)
    assert status == 200, out
    return out


def test_ocr_enabled_default_is_the_shipped_weights():
    from intool_rag_tpu import config as jconfig
    from intool_rag_tpu_torch import config as tconfig
    from intool_rag_tpu_torch.ocr.pipeline import DEFAULT_WEIGHTS

    mp = pytest.MonkeyPatch()
    try:
        mp.delenv("OCR_ENABLED", raising=False)
        assert tconfig.Config().OCR_ENABLED == DEFAULT_WEIGHTS.exists() == jconfig._ocr_weights_exist()
        assert DEFAULT_WEIGHTS.samefile(Path(jconfig.__file__).parent / "ocr" / "weights" / "default.npz")
        mp.setenv("OCR_ENABLED", "false")
        assert not tconfig.Config().OCR_ENABLED
    finally:
        mp.undo()


def test_scanned_pdf_ingests_like_jax(make_services):
    from intool_rag_tpu_torch.ingest import loader as tloader
    from intool_rag_tpu_torch.ocr.pdf_ocr import PDFOCRBridge

    jservice, tservice, pages = make_services({})
    assert isinstance(tloader._ocr_engine, PDFOCRBridge)
    assert tloader._ocr_engine._engine is None  # built on the first scanned page
    pdf = _scanned_pdf(FIXTURE_PAGES)
    want, got = _ingest(jservice, pdf), _ingest(tservice, pdf)
    for key in ("success", "total_pages", "total_chunks", "vectors_indexed"):
        assert got[key] == want[key], key
    assert got["total_pages"] == FIXTURE_PAGES and got["total_chunks"] >= FIXTURE_PAGES
    assert tloader._ocr_engine.engine.device == torch.device("cpu")
    assert [p.page for p in pages["torch"]] == [p.page for p in pages["jax"]] == list(range(FIXTURE_PAGES))
    for g, w in zip(pages["torch"], pages["jax"]):
        assert g.has_ocr and w.has_ocr
        assert g.raw_content == w.raw_content and g.raw_content.strip()
        assert g.extraction_confidence == pytest.approx(w.extraction_confidence, abs=CONF_TOL)
    # the OCR'd chunks are searchable: each page's longest line finds that
    # page (numbered from 1 in /search) in the top 5
    for page in pages["torch"]:
        line = max(page.raw_content.splitlines(), key=len).strip("| ")
        status, out = tservice.handle("POST", "/search", json.dumps({"question": line}).encode())
        assert status == 200 and page.page + 1 in [h["page"] for h in out["hits"][:5]], (line, out["hits"][:5])


def test_ocr_disabled_leaves_the_scanned_page_empty(make_services):
    jservice, tservice, pages = make_services({"OCR_ENABLED": "false"})
    body, ctype = _multipart([("file", "scan.pdf", _scanned_pdf(1))])
    answers = [service.handle("POST", "/ingest?project=scans&doc_id=scan", body, ctype)
               for service in (jservice, tservice)]
    assert answers[0] == answers[1] == (400, {"detail": "no valid text in scan.pdf"})
    for name in ("jax", "torch"):
        (page,) = pages[name]
        assert (page.raw_content, page.has_ocr, page.extraction_confidence) == ("", False, 0.0), name


def test_committed_fixture_equals_its_builder(tmp_path):
    from intool_rag_tpu_torch.ocr.synth import DEFAULT_FONTS, SCANNED_FIXTURE, write_scanned_fixture

    pytest.importorskip("PIL")
    if not Path(DEFAULT_FONTS[0]).exists():
        pytest.skip(f"{DEFAULT_FONTS[0]} is missing: the fixture is rendered with it")
    out = tmp_path / SCANNED_FIXTURE.name
    write_scanned_fixture(out)
    assert out.read_bytes() == SCANNED_FIXTURE.read_bytes()
    assert out.with_suffix(".json").read_text() == SCANNED_FIXTURE.with_suffix(".json").read_text()
    assert SCANNED_FIXTURE.stat().st_size < 2 * 2**20
    meta = json.loads(out.with_suffix(".json").read_text())
    assert meta["pages"] == len(meta["truth"]) == 8 and all(len(t) >= 20 for t in meta["truth"])
    shutil.rmtree(tmp_path)


def test_fixture_pages_are_letter_at_144_dpi():
    from intool_rag_tpu_torch.ingest.pdf import extract_pdf_text
    from intool_rag_tpu_torch.ocr.pdf_ocr import extract_page_images
    from intool_rag_tpu_torch.ocr.synth import load_scanned_fixture

    pdf, truth = load_scanned_fixture()
    assert extract_pdf_text(pdf) == [""] * len(truth)  # no text layer: every page is scanned
    images = extract_page_images(pdf, len(truth) - 1)
    assert len(images) == 1 and images[0].shape == (1584, 1224, 3)
    assert np.array_equal(images[0][:, :, 0], images[0][:, :, 2])
