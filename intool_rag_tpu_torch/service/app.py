"""Framework-free router for the served subset (port of
``intool_rag_tpu/service/app.py``): ``POST /search``, ``POST /ingest``
(sync and ``mode=async``), ``GET /jobs``, ``GET /jobs/{id}``,
``GET /documents``, ``GET`` and ``DELETE /documents/{id}`` and
``GET /health``. Directly callable in tests; served over HTTP by
service/http.py. ``/query``, ``/agent/query``, ``/metrics`` and
``/debug/trace`` are not ported yet."""

from __future__ import annotations

import dataclasses
import logging
import re
import time
import uuid
from pathlib import Path
from urllib.parse import parse_qs, urlparse

import torch

from .. import __version__
from ..config import get_config
from ..exceptions import IndexNotFoundError, RAGError
from ..index.registry import CorpusRegistry
from ..ingest.pipeline import IngestionPipeline
from ..llm.reranker_factory import get_reranker
from ..query.retriever import PageLevelRetriever
from ..tasks import TaskQueue
from .batcher import QueryBatcher
from .models import DocumentInfo, HealthResponse, IngestResponse, QueryRequest
from .multipart import parse_multipart

logger = logging.getLogger(__name__)
_DOC_ID = re.compile(r"[A-Za-z0-9._-]+")


class HTTPError(Exception):
    def __init__(self, status: int, detail: str) -> None:
        super().__init__(detail)
        self.status = status
        self.detail = detail


class RAGService:
    """Routes requests to the ingest and retrieval paths. ``provider``
    embeds chunks and queries (a
    :class:`..providers.cuda_embed.CudaEmbeddingProvider`). ``reranker``
    reorders ``/search`` hits when ``RERANKER_ENABLED``; left out, it comes
    from ``llm/reranker_factory.py`` (None without local weights)."""

    def __init__(self, provider, registry: CorpusRegistry | None = None,
                 device: str | torch.device | None = None, reranker=None) -> None:
        self.registry = registry or CorpusRegistry(device=device)
        self.registry.load_all()
        self.pipeline = IngestionPipeline(provider, storage=self.registry.storage)
        if reranker is None:
            reranker = get_reranker(self.registry.device)
        self.retriever = PageLevelRetriever(self.registry, provider, reranker=reranker)
        self.tasks = TaskQueue(workers=1)
        self.last_ingest_timings: dict[str, float] = {}
        cfg = get_config()
        self.batcher = (
            QueryBatcher(self.retriever.retrieve_chunks_batch) if cfg.QUERY_MAX_BATCH > 1 else None
        )

    def handle(self, method: str, path: str, body: bytes = b"", content_type: str = "") -> tuple[int, dict]:
        parsed = urlparse(path)
        route = parsed.path.rstrip("/") or "/"
        params = {k: v[0] for k, v in parse_qs(parsed.query).items()}
        try:
            if method == "POST" and route == "/ingest":
                return 200, self.ingest(params, body, content_type)
            if method == "POST" and route == "/search":
                return 200, self.search(body)
            if method == "GET" and route == "/documents":
                return 200, self.list_documents()
            if method == "GET" and route.startswith("/documents/"):
                return 200, self.document_detail(route.split("/", 2)[2])
            if method == "GET" and route == "/health":
                return 200, self.health()
            if method == "GET" and route == "/jobs":
                return 200, {"jobs": self.tasks.list_jobs()}
            if method == "GET" and route.startswith("/jobs/"):
                return 200, self.job_detail(route.split("/", 2)[2])
            if method == "DELETE" and route.startswith("/documents/"):
                return 200, self.delete_document(route.split("/", 2)[2])
            raise HTTPError(404, f"no route {method} {route}")
        except HTTPError as exc:
            return exc.status, {"detail": exc.detail}
        except RAGError as exc:
            logger.error("request failed: %s", exc)
            return 400, {"detail": str(exc)}
        except Exception as exc:  # request boundary: report a 500, keep serving
            logger.exception("internal error")
            return 500, {"detail": str(exc)}

    def ingest(self, params: dict, body: bytes, content_type: str) -> dict:
        """One uploaded file → pages → tree → chunks → vectors → live
        corpus. ``mode=async`` queues the work and returns a job id."""
        project = params.get("project")
        if not project:
            raise HTTPError(400, "query parameter 'project' is required")
        language = params.get("language", "en")
        doc_id = params.get("doc_id") or str(uuid.uuid4())
        if not _DOC_ID.fullmatch(doc_id):  # it names files under STORAGE_DIR
            raise HTTPError(400, "doc_id may hold letters, digits, '.', '_' and '-' only")
        if "multipart" not in content_type:
            raise HTTPError(400, "expected multipart/form-data file upload")
        try:
            _, files = parse_multipart(body, content_type)
        except ValueError as exc:
            raise HTTPError(400, str(exc)) from exc
        if not files:
            raise HTTPError(400, "no file in upload")
        upload = files[0]
        cfg = get_config()
        cfg.ensure_dirs()
        # the client's file name is kept as a label; only its last component names the copy on disk
        filepath = cfg.UPLOAD_DIR / f"{doc_id}_{Path(upload.filename).name}"
        filepath.write_bytes(upload.data)

        if params.get("mode") == "async":
            job = self.tasks.submit(
                "ingest", lambda: self._do_ingest(filepath, project, doc_id, upload.filename, language)
            )
            return {"job_id": job.job_id, "status": job.status, "doc_id": doc_id}

        start = time.time()
        result = self._do_ingest(filepath, project, doc_id, upload.filename, language)
        return dataclasses.asdict(IngestResponse(
            success=result["success"], doc_id=doc_id, source_file=upload.filename, project=project,
            total_pages=result["page_count"], total_chunks=result["chunk_count"],
            vectors_indexed=result["vectors_indexed"],
            processing_time_seconds=round(time.time() - start, 3),
        ))

    def _do_ingest(self, filepath, project, doc_id, filename, language) -> dict:
        result = self.pipeline.ingest_file(
            filepath, project=project, doc_id=doc_id, source_filename=filename, language=language
        )
        start = time.time()
        self.registry.add_document(doc_id)
        # seconds by stage: host (load…chunk), embed, persist, append to the live corpus
        result["timings"]["append"] = time.time() - start
        self.last_ingest_timings = result["timings"]
        return result

    def job_detail(self, job_id: str) -> dict:
        job = self.tasks.get(job_id)
        if job is None:
            raise HTTPError(404, f"job {job_id} not found")
        return job.to_dict()

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

    def document_detail(self, doc_id: str) -> dict:
        try:
            info = self.registry.storage.document_info(doc_id)
        except IndexNotFoundError as exc:
            raise HTTPError(404, f"document {doc_id} not found") from exc
        page_index = self.registry.storage.load_page_index(doc_id)
        info["nodes"] = [n.to_dict() for n in page_index.nodes]
        return info

    def delete_document(self, doc_id: str) -> dict:
        if not self.registry.remove_document(doc_id):
            raise HTTPError(404, f"document {doc_id} not found")
        return {"deleted": doc_id}

    def health(self) -> dict:
        stats = self.registry.stats()
        return dataclasses.asdict(HealthResponse(
            status="ok", documents=stats["documents"], chunks=stats["chunks"],
            backend=str(self.registry.device), version=__version__,
        ))
