"""The port stands alone: no JAX, flax, pydantic or JAX-package import, no
library attention or compiler in place of a hand-written kernel, and CUDA is
never silently replaced by the CPU."""

from __future__ import annotations

import ast
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "pydantic", "msgpack", "intool_rag_tpu", "flash_attn", "xformers")
# what would stand in for a hand-written kernel; chip_smoke.py may time a
# library call beside a kernel, the package never calls one
LIBRARY_KERNELS = ("scaled_dot_product_attention", "flash_attn", "xformers", "torch.compile")


def _port_files():
    files = sorted((ROOT / "intool_rag_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py", ROOT / "k5_mutants.py"]
    assert len(files) > 20
    return files


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(encoding="utf-8"), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_forbidden_imports(path):
    bad = [m for m in _imported_roots(path) if m in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


@pytest.mark.parametrize(
    "path", [p for p in _port_files() if p.name != "chip_smoke.py"], ids=lambda p: str(p.relative_to(ROOT))
)
def test_no_library_kernel_in_the_package(path):
    text = path.read_text(encoding="utf-8")
    bad = [name for name in LIBRARY_KERNELS if name in text]
    assert not bad, f"{path} mentions {bad}"


def test_new_modules_are_covered():
    names = {str(p.relative_to(ROOT / "intool_rag_tpu_torch")) for p in _port_files()[:-2]}
    assert {"ops/flash_attention.py", "models/packing.py", "ingest/pdf.py", "ingest/pipeline.py",
            "llm/semantic/factory.py", "providers/heuristic_semantic.py", "tasks.py",
            "service/multipart.py", "train/contrastive.py", "train/rerank.py", "models/reranker.py",
            "eval/metrics.py", "eval/harness.py", "eval/synthetic.py", "llm/reranker_factory.py",
            "models/decoder.py", "providers/cuda_llm.py", "providers/fake.py", "llm/factory.py",
            "core/container.py", "storage/cache.py", "query/context.py", "query/prompts.py",
            "query/response.py", "observability.py", "backend.py", "agent/__init__.py", "agent/state.py",
            "agent/steps.py", "agent/orchestrator.py", "models/scheduler.py", "ocr/__init__.py",
            "ocr/wordlist.py", "ocr/postprocess.py", "ocr/synth.py", "ocr/rescore.py", "ocr/models.py",
            "ocr/pipeline.py", "ocr/utils.py", "ocr/pdf_ocr.py", "ocr/eval.py", "ingest/rasterize.py",
            "index/ivf_index.py", "index/ivf_residual.py", "index/segmented_residual.py", "models/lm_train.py",
            "ocr/train.py", "parallel/tp_decoder.py", "parallel/sequence.py", "logging.py"} <= names
    kernel_dir = ROOT / "intool_rag_tpu_torch" / "kernels"
    kernels = {p.name for p in kernel_dir.glob("*.cu")}
    assert {"flash_attention.cu", "flash_attention_bwd.cu"} <= kernels
    for source in [*kernels, *(p.name for p in kernel_dir.glob("*.cuh"))]:
        # no PyTorch header in a kernel source: it would take minutes to build
        assert "torch/" not in (kernel_dir / source).read_text()


def test_every_kernel_source_is_built():
    from intool_rag_tpu_torch.kernels import build

    kernels = {p.name for p in (ROOT / "intool_rag_tpu_torch" / "kernels").glob("*.cu")}
    assert set(build.SOURCES) == kernels


# the modules that may import ``transformers``, each inside a function
TRANSFORMERS_IMPORTERS = {"llm/reranker_factory.py", "models/tokenizer.py", "providers/cuda_llm.py"}


def test_only_the_factory_imports_transformers_and_only_lazily():
    """``transformers`` is optional: the reranker factory imports it inside
    ``_build``, under the ``try`` that turns a missing package or missing
    weights into "no reranker"; ``HFTokenizer`` inside ``__init__``, under
    ``get_tokenizer``'s fallback to the hashing tokenizer; ``CudaLLM``
    inside ``_load_hf``, for an ``LLM_MODEL_PATH`` checkpoint's tokenizer.
    Nothing imports it at module level."""
    package = ROOT / "intool_rag_tpu_torch"
    for path in _port_files():
        tree = ast.parse(path.read_text(encoding="utf-8"))
        top = [n for n in tree.body if isinstance(n, (ast.Import, ast.ImportFrom))]
        names = {a.name.split(".")[0] for n in top if isinstance(n, ast.Import) for a in n.names}
        names |= {n.module.split(".")[0] for n in top if isinstance(n, ast.ImportFrom) and n.module and n.level == 0}
        assert "transformers" not in names, path
        if "transformers" in set(_imported_roots(path)):
            assert path.is_relative_to(package), path
            assert str(path.relative_to(package)) in TRANSFORMERS_IMPORTERS, path


def test_service_and_ocr_path_load_without_pil_or_fonttools():
    """Neither PIL nor fontTools is on the card's machine: with both
    blocked, the service, ``ocr.pipeline`` and ``ocr.pdf_ocr`` import, the
    shipped bundle loads, and a scanned page of the committed fixture is
    read through the bridge (the charset and the LM from the committed
    homoglyph tables, no glyph rendered)."""
    import subprocess
    import sys

    code = """
import sys
sys.modules["PIL"] = None
sys.modules["fontTools"] = None
import intool_rag_tpu_torch.service.app
from intool_rag_tpu_torch.ocr import pipeline, synth
from intool_rag_tpu_torch.ocr.pdf_ocr import PDFOCRBridge
bundle = pipeline.OCRModelBundle.load(pipeline.DEFAULT_WEIGHTS)
assert len(bundle.charset) == 204 and pipeline.DEFAULT_CHARSET == synth.build_charset()
pdf, truth = synth.load_scanned_fixture()
text, conf = PDFOCRBridge(device="cpu").extract_page(pdf, 0)
assert text.strip() and conf > 0.5, (text, conf)
try:
    synth.render_line("x")
except ImportError:
    print("ok")
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip().endswith("ok"), out.stderr[-2000:]


def test_resolve_device_raises_without_cuda():
    from intool_rag_tpu_torch.device import resolve_device

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: resolve_device(None) is valid here")
    with pytest.raises(RuntimeError):
        resolve_device(None)
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_entry_points_default_to_cuda():
    from intool_rag_tpu_torch.index.chunk_store import ChunkStore

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError):
        ChunkStore(dim=8)
    assert ChunkStore(dim=8, device="cpu").embeddings.device.type == "cpu"
    # the model-parallel entry points: with no devices given they take every CUDA device
    from intool_rag_tpu_torch.models.decoder import DecoderConfig, DecoderLM
    from intool_rag_tpu_torch.models.encoder import EncoderConfig, TextEncoder
    from intool_rag_tpu_torch.parallel.sequence import seq_mesh
    from intool_rag_tpu_torch.parallel.tp_decoder import shard_decoder_params
    from intool_rag_tpu_torch.train.contrastive import shard_params

    decoder = DecoderLM(DecoderConfig.tiny(), device="cpu").init_random(torch.Generator().manual_seed(0))
    encoder = TextEncoder(EncoderConfig.tiny(), device="cpu", param_dtype=torch.float32)
    for call in (seq_mesh, lambda: shard_decoder_params(decoder), lambda: shard_params(encoder)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert seq_mesh(["cpu"] * 2).shape == {"seq": 2}
