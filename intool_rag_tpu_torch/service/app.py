"""Framework-free router for the served subset (port of
``intool_rag_tpu/service/app.py``): ``POST /search``, ``GET /health`` and
``GET /documents``. Directly callable in tests; served over HTTP by
service/http.py. ``/query``, ``/ingest`` and the rest wait for later
slices."""

from __future__ import annotations

import dataclasses
import logging
from urllib.parse import urlparse

import torch

from .. import __version__
from ..config import get_config
from ..exceptions import RAGError
from ..index.registry import CorpusRegistry
from ..query.retriever import PageLevelRetriever
from .batcher import QueryBatcher
from .models import DocumentInfo, HealthResponse, QueryRequest

logger = logging.getLogger(__name__)


class HTTPError(Exception):
    def __init__(self, status: int, detail: str) -> None:
        super().__init__(detail)
        self.status = status
        self.detail = detail


class RAGService:
    """Routes requests to the retrieval path. ``provider`` embeds queries
    (a :class:`..providers.cuda_embed.CudaEmbeddingProvider`)."""

    def __init__(self, provider, registry: CorpusRegistry | None = None,
                 device: str | torch.device | None = None) -> None:
        self.registry = registry or CorpusRegistry(device=device)
        self.registry.load_all()
        self.retriever = PageLevelRetriever(self.registry, provider)
        cfg = get_config()
        self.batcher = (
            QueryBatcher(self.retriever.retrieve_chunks_batch) if cfg.QUERY_MAX_BATCH > 1 else None
        )

    def handle(self, method: str, path: str, body: bytes = b"", content_type: str = "") -> tuple[int, dict]:
        route = urlparse(path).path.rstrip("/") or "/"
        try:
            if method == "POST" and route == "/search":
                return 200, self.search(body)
            if method == "GET" and route == "/documents":
                return 200, self.list_documents()
            if method == "GET" and route == "/health":
                return 200, self.health()
            raise HTTPError(404, f"no route {method} {route}")
        except HTTPError as exc:
            return exc.status, {"detail": exc.detail}
        except RAGError as exc:
            logger.error("request failed: %s", exc)
            return 400, {"detail": str(exc)}
        except Exception as exc:  # request boundary: report a 500, keep serving
            logger.exception("internal error")
            return 500, {"detail": str(exc)}

    def search(self, body: bytes) -> dict:
        """Raw retrieval (no LLM): hybrid top-k chunks with scores and
        identities. Concurrent requests coalesce in the micro-batcher."""
        try:
            request = QueryRequest.from_json(body)
        except (ValueError, TypeError) as exc:
            raise HTTPError(400, f"invalid search request: {exc}") from exc
        if self.batcher is not None:
            chunks = self.batcher.submit(request.question, request.project)
        else:
            chunks = self.retriever.retrieve_chunks(request.question, project=request.project)
        return {
            "hits": [
                {
                    "doc_id": c.doc_id,
                    "chunk_id": c.chunk_id,
                    "page": c.page + 1,
                    "score": round(c.score, 4),
                    "text": c.text,
                }
                for c in chunks
            ],
            "total": len(chunks),
        }

    def list_documents(self) -> dict:
        docs = [dataclasses.asdict(DocumentInfo(**info)) for info in self.registry.list_documents()]
        return {"documents": docs, "total": len(docs)}

    def health(self) -> dict:
        stats = self.registry.stats()
        return dataclasses.asdict(HealthResponse(
            status="ok", documents=stats["documents"], chunks=stats["chunks"],
            backend=str(self.registry.device), version=__version__,
        ))
