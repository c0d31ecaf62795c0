"""The port stands alone: no JAX, flax, pydantic or JAX-package import,
and CUDA is never silently replaced by the CPU."""

from __future__ import annotations

import ast
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "pydantic", "msgpack", "intool_rag_tpu")


def _port_files():
    files = sorted((ROOT / "intool_rag_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
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
