"""Ingestion pipeline: load → normalize → tree → chunk → embed → persist
(port of ``intool_rag_tpu/ingest/pipeline.py``; same four phases and the
same result contract, plus ``timings``: the seconds by stage, host =
load…chunk, embed, persist). The embedding provider is an argument; left
out, the pipeline builds its own from the embedding factory on first use,
behind the disk embedding cache (``storage/cache.py``) when
``CACHE_EMBEDDINGS`` is set, as the JAX pipeline does."""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np
import torch

from ..logging import get_logger
from ..config import get_config
from ..exceptions import IngestError
from ..ingest.chunker import ChunkerConfig, ChunksBuilder
from ..ingest.loader import PageBasedLoader
from ..ingest.normalizer import PageNormalizer
from ..ingest.schemas import ChunksIndex, VectorMeta
from ..ingest.tree import SemanticTreeBuilder
from ..storage.artifacts import FileStorageManager

logger = get_logger(__name__)


class IngestionPipeline:
    def __init__(
        self,
        embedding_provider=None,
        storage: FileStorageManager | None = None,
        device: str | torch.device | None = None,
    ) -> None:
        self.storage = storage or FileStorageManager()
        self._provider = embedding_provider
        self._device = device
        self.loader = PageBasedLoader()
        self.normalizer = PageNormalizer()
        self.tree_builder = SemanticTreeBuilder()
        cfg = get_config()
        self.chunks_builder = ChunksBuilder(
            ChunkerConfig(
                max_chars=cfg.CHUNK_MAX_CHARS,
                min_chars=cfg.CHUNK_MIN_CHARS,
                target_chars=cfg.CHUNK_TARGET_CHARS,
                overlap_chars=cfg.CHUNK_OVERLAP_CHARS,
            )
        )

    @property
    def provider(self):
        if self._provider is None:
            from ..llm.embeddings.factory import get_embedding_provider

            provider = get_embedding_provider(self._device)
            if get_config().CACHE_EMBEDDINGS:
                from ..storage.cache import CachingEmbeddingProvider

                provider = CachingEmbeddingProvider(provider)
            self._provider = provider
        return self._provider

    def ingest_file(
        self,
        filepath: str | Path,
        *,
        project: str,
        doc_id: str,
        source_filename: str | None = None,
        language: str = "en",
    ) -> dict:
        start = time.time()
        source_filename = source_filename or Path(filepath).name

        # PHASE 1: load + normalize
        raw_pages = self.loader.load(filepath)
        if not raw_pages:
            raise IngestError(f"no pages extracted from {source_filename}")
        normalized = self.normalizer.normalize_pages(
            {p.page: p.raw_content for p in raw_pages}
        )
        pages = {p.page: p.text for p in normalized if p.is_valid}
        if not pages:
            raise IngestError(f"no valid text in {source_filename}")
        logger.info("phase 1: %d/%d valid pages", len(pages), len(raw_pages))

        # PHASE 2: semantic tree
        page_index = self.tree_builder.build(
            doc_id,
            pages,
            source_file=source_filename,
            project=project,
            language=language,
        )
        self.storage.save_page_index(page_index)
        logger.info("phase 2: %d semantic nodes", len(page_index.nodes))

        # PHASE 3: chunking
        chunks = self.chunks_builder.build_chunks(pages, page_index)
        if not chunks:
            raise IngestError(f"chunking produced nothing for {source_filename}")
        chunks_index = ChunksIndex(doc_id=doc_id, chunks=chunks)
        self.storage.save_chunks(chunks_index)
        logger.info("phase 3: %d chunks", len(chunks))

        # PHASE 4: embed + persist vectors
        provider = self.provider
        t_host = time.time()
        embeddings = provider.embed_batch([c.text for c in chunks])
        t_embed = time.time()
        for i, chunk in enumerate(chunks):
            chunk.embedding_id = i
        meta = VectorMeta(
            doc_id=doc_id,
            model=provider.model_name,
            dimension=provider.dimension,
            count=len(chunks),
            chunk_ids=[c.chunk_id for c in chunks],
            pages=[c.page for c in chunks],
        )
        self.storage.save_vectors(doc_id, np.asarray(embeddings, np.float32), meta)
        logger.info("phase 4: %d vectors (dim %d)", meta.count, meta.dimension)
        t_done = time.time()

        return {
            "success": True,
            "doc_id": doc_id,
            "page_count": len(raw_pages),
            "chunk_count": len(chunks),
            "vectors_indexed": meta.count,
            "processing_time": t_done - start,
            "timings": {"host": t_host - start, "embed": t_embed - t_host, "persist": t_done - t_embed},
        }
