"""Per-document artifact persistence (copy of ``intool_rag_tpu/storage/artifacts.py``:
the on-disk format is identical, so either package serves a
``STORAGE_DIR`` the other wrote).

The quartet mirrors the reference's layout per document
(reference: rag/storage/file_storage.py:23-26):

- ``{doc}_page_index.json``  — semantic tree (PageIndex)
- ``{doc}_chunks.json``      — chunk list (ChunksIndex)
- ``{doc}_vectors.npz``      — embedding matrix [M, D] f32 + pages
  (replaces ``{doc}_faiss.index``)
- ``{doc}_vector_meta.json`` — vector_id ↔ chunk_id mapping (VectorMeta,
  the reference's ``{doc}_faiss_meta.json``)

Identity is positional: vector_id = row in the npz, exactly like the
reference's positional faiss_id (faiss_index.py:178-181).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from ..config import get_config
from ..exceptions import IndexNotFoundError
from ..ingest.schemas import (
    ChunksIndex,
    PageIndex,
    VectorMeta,
    load_json,
    save_json,
)


class FileStorageManager:
    """Reads/writes the per-document artifact quartet
    (reference: rag/storage/file_storage.py:20-326)."""

    def __init__(self, storage_dir: Path | str | None = None) -> None:
        self.storage_dir = Path(storage_dir or get_config().STORAGE_DIR)
        self.storage_dir.mkdir(parents=True, exist_ok=True)

    # ---------------- paths ----------------

    def _p(self, doc_id: str, suffix: str) -> Path:
        return self.storage_dir / f"{doc_id}_{suffix}"

    # ---------------- page index ----------------

    def save_page_index(self, page_index: PageIndex) -> Path:
        path = self._p(page_index.doc_id, "page_index.json")
        save_json(page_index, path)
        return path

    def load_page_index(self, doc_id: str) -> PageIndex:
        path = self._p(doc_id, "page_index.json")
        if not path.exists():
            raise IndexNotFoundError(f"no page index for {doc_id}")
        return PageIndex.from_dict(load_json(path))

    # ---------------- chunks ----------------

    def save_chunks(self, chunks: ChunksIndex) -> Path:
        path = self._p(chunks.doc_id, "chunks.json")
        save_json(chunks, path)
        return path

    def load_chunks(self, doc_id: str) -> ChunksIndex:
        path = self._p(doc_id, "chunks.json")
        if not path.exists():
            raise IndexNotFoundError(f"no chunks for {doc_id}")
        return ChunksIndex.from_dict(load_json(path))

    # ---------------- vectors ----------------

    def save_vectors(
        self, doc_id: str, embeddings: np.ndarray, meta: VectorMeta
    ) -> Path:
        path = self._p(doc_id, "vectors.npz")
        np.savez_compressed(
            path.with_suffix(""),
            embeddings=embeddings.astype(np.float32),
            pages=np.asarray(meta.pages, np.int32),
        )
        save_json(meta, self._p(doc_id, "vector_meta.json"))
        return path

    def load_vectors(self, doc_id: str) -> tuple[np.ndarray, VectorMeta]:
        path = self._p(doc_id, "vectors.npz")
        if not path.exists():
            raise IndexNotFoundError(f"no vectors for {doc_id}")
        arrays = np.load(path)
        meta = VectorMeta.from_dict(load_json(self._p(doc_id, "vector_meta.json")))
        return arrays["embeddings"], meta

    # ---------------- document listing ----------------

    def list_documents(self) -> list[str]:
        return sorted(
            p.name[: -len("_vector_meta.json")]
            for p in self.storage_dir.glob("*_vector_meta.json")
        )

    def document_info(self, doc_id: str) -> dict:
        page_index = self.load_page_index(doc_id)
        chunks = self.load_chunks(doc_id)
        meta = VectorMeta.from_dict(load_json(self._p(doc_id, "vector_meta.json")))
        return {
            "doc_id": doc_id,
            "source_file": page_index.source_file,
            "project": page_index.project,
            "language": page_index.language,
            "page_count": page_index.page_count,
            "chunk_count": len(chunks),
            "vectors_indexed": meta.count,
            "embedding_model": meta.model,
            "dimension": meta.dimension,
        }

    def delete_document(self, doc_id: str) -> bool:
        found = False
        for suffix in (
            "page_index.json",
            "chunks.json",
            "vectors.npz",
            "vector_meta.json",
        ):
            path = self._p(doc_id, suffix)
            if path.exists():
                path.unlink()
                found = True
        return found
