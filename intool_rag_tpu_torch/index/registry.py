"""Corpus registry: every stored document merged into one searchable
device corpus (port of ``intool_rag_tpu/index/registry.py``)."""

from __future__ import annotations

import threading
from pathlib import Path

import numpy as np
import torch

from ..logging import get_logger
from ..config import get_config
from ..device import resolve_device
from ..exceptions import IndexNotFoundError
from .bm25_index import BM25Index
from .chunk_store import ChunkStore
from .hybrid import HybridEngine

logger = get_logger(__name__)


class CorpusRegistry:
    """Owns the global ChunkStore + BM25 index + HybridEngine, kept in sync
    with the on-disk artifact quartets of ``STORAGE_DIR``."""

    def __init__(self, storage_dir: Path | str | None = None, device: str | torch.device | None = None) -> None:
        from ..storage.artifacts import FileStorageManager

        self.device = resolve_device(device)
        self.storage = FileStorageManager(storage_dir)
        self.store: ChunkStore | None = None
        self.bm25: BM25Index | None = None
        self.engine: HybridEngine | None = None
        self.doc_projects: dict[str, str] = {}
        self.page_indexes: dict = {}
        self.chunk_nodes: dict[tuple[str, str], str] = {}
        self.version = 0
        self._lock = threading.Lock()

    def load_all(self) -> int:
        """Startup preload of every stored document."""
        with self._lock:
            self.store = None
            self.bm25 = None
            self.engine = None
            self.doc_projects = {}
            self.page_indexes = {}
            self.chunk_nodes = {}
            count = 0
            for doc_id in self.storage.list_documents():
                try:
                    self._add_doc_locked(doc_id)
                    count += 1
                except (IndexNotFoundError, OSError, ValueError, KeyError) as exc:  # degrade per doc, keep serving
                    logger.error("failed to load document %s: %s", doc_id, exc)
            self._rebuild_bm25_locked()
            logger.info("corpus loaded: %d documents, %d chunks",
                        count, len(self.store) if self.store else 0)
            return count

    def _add_doc_locked(self, doc_id: str) -> list[str]:
        embeddings, meta = self.storage.load_vectors(doc_id)
        chunks = self.storage.load_chunks(doc_id)
        page_index = self.storage.load_page_index(doc_id)
        self.doc_projects[doc_id] = page_index.project
        self.page_indexes[doc_id] = page_index
        for c in chunks:
            self.chunk_nodes[(doc_id, c.chunk_id)] = c.node_id
        texts_by_id = {c.chunk_id: c.text for c in chunks}
        texts = [texts_by_id.get(cid, "") for cid in meta.chunk_ids]
        if self.store is None:
            self.store = ChunkStore(
                dim=embeddings.shape[1], dtype=get_config().INDEX_DTYPE, device=self.device
            )
        self.store.append(
            np.asarray(embeddings, np.float32), doc_id=doc_id, chunk_ids=list(meta.chunk_ids),
            pages=list(meta.pages), texts=texts,
        )
        return texts

    def _rebuild_bm25_locked(self) -> None:
        if self.store is None or len(self.store) == 0:
            self.bm25 = None
            self.engine = None
            return
        self.bm25 = BM25Index.build(self.store.texts, device=self.device)
        self.engine = HybridEngine(self.store, self.bm25)

    def add_document(self, doc_id: str) -> int:
        """Load one persisted document into the live corpus. BM25 extends
        incrementally: only the new document's texts are tokenized."""
        with self._lock:
            texts = self._add_doc_locked(doc_id)
            if self.bm25 is not None and self.bm25._counted is not None:
                self.bm25 = self.bm25.append(texts)
                # the same store object keeps its dense index, so the capacity
                # tier appends the new rows instead of retraining and
                # re-encoding the corpus
                self.engine = HybridEngine(
                    self.store, self.bm25, dense=self.engine.dense if self.engine else None
                )
            else:
                self._rebuild_bm25_locked()
            self.version += 1
            return len(texts)

    def remove_document(self, doc_id: str) -> bool:
        """Delete a document's artifacts and drop its rows from the live
        corpus. The store is replaced copy-on-write, so a concurrent search
        that holds the old store and engine keeps consistent row identities;
        the dense index rebuilds over the new store."""
        with self._lock:
            removed = self.storage.delete_document(doc_id)
            if self.store is not None:
                self.store, _ = self.store.without_doc(doc_id)
                self._rebuild_bm25_locked()
            self.doc_projects.pop(doc_id, None)
            self.page_indexes.pop(doc_id, None)
            self.chunk_nodes = {k: v for k, v in self.chunk_nodes.items() if k[0] != doc_id}
            self.version += 1
            return removed

    def search(
        self,
        query_texts: list[str],
        query_embeddings: torch.Tensor,
        k: int,
        *,
        project: str | None = None,
        candidates: int | None = None,
    ) -> list[list[dict]]:
        """Corpus-wide hybrid search; per-query hit dicts with chunk
        identity and text, optionally filtered by project. The query count
        is padded to a power of two (empty text, zero vector), so batch
        shapes stay few, as on the JAX side, ready for CUDA-graph capture."""
        with self._lock:
            engine, store = self.engine, self.store
            doc_projects = dict(self.doc_projects) if project is not None else {}
        if engine is None or store is None or len(store) == 0:
            return [[] for _ in query_texts]
        pool = candidates or max(k, get_config().RETRIEVAL_CANDIDATES)
        if project is not None:
            pool = min(pool * 4, len(store))
        q_n = len(query_texts)
        q_pad = 1
        while q_pad < q_n:
            q_pad *= 2
        if q_pad > q_n:
            query_texts = list(query_texts) + [""] * (q_pad - q_n)
            query_embeddings = torch.cat([
                query_embeddings,
                torch.zeros((q_pad - q_n, query_embeddings.shape[1]),
                            dtype=query_embeddings.dtype, device=query_embeddings.device),
            ])
        vals, rows = engine.search(query_texts, query_embeddings, max(k, pool), candidates=pool)
        vals = vals[:q_n].cpu().numpy()
        rows = rows[:q_n].cpu().numpy()
        results: list[list[dict]] = []
        for qi in range(rows.shape[0]):
            hits: list[dict] = []
            for score, row in zip(vals[qi], rows[qi]):
                if row < 0 or not np.isfinite(score):
                    continue
                ref = store.ref(int(row))
                if project is not None and doc_projects.get(ref.doc_id) != project:
                    continue
                hits.append({
                    "doc_id": ref.doc_id,
                    "chunk_id": ref.chunk_id,
                    "page": ref.page,
                    "score": float(score),
                    "text": store.texts[int(row)],
                })
                if len(hits) >= k:
                    break
            results.append(hits)
        return results

    def list_documents(self) -> list[dict]:
        return [self.storage.document_info(d) for d in self.storage.list_documents()]

    def stats(self) -> dict:
        return {
            "documents": len(self.doc_projects),
            "chunks": len(self.store) if self.store else 0,
            "bm25_vocab": len(self.bm25.vocab) if self.bm25 else 0,
        }


_registry: CorpusRegistry | None = None
_registry_lock = threading.Lock()


def get_registry(device: str | torch.device | None = None) -> CorpusRegistry:
    """The process's registry over ``STORAGE_DIR``, loaded on the first
    call (on ``device``, default CUDA)."""
    global _registry
    if _registry is None:
        with _registry_lock:
            if _registry is None:
                registry = CorpusRegistry(device=device)
                registry.load_all()
                _registry = registry
    return _registry


def reset_registry() -> None:
    global _registry
    _registry = None
