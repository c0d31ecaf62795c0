"""Framework-free router for the served subset (port of
``intool_rag_tpu/service/app.py``): ``POST /query`` (a cited answer from
the LLM; ``stream: true`` answers as server-sent events), ``POST /search``,
``POST /ingest`` (sync and ``mode=async``), ``GET /jobs``,
``GET /jobs/{id}``, ``GET /documents``, ``GET`` and
``DELETE /documents/{id}``, ``GET /health``, ``POST /agent/query`` and
``GET /agent/health`` (the page-aware agent), ``GET /metrics`` (counters
and latency windows) and ``POST /debug/trace`` (a ``torch.profiler``
window written under ``STORAGE_DIR/traces``). Directly callable in tests;
served over HTTP by service/http.py."""

from __future__ import annotations

import collections
import dataclasses
import json
import logging
import re
import time
import uuid
from pathlib import Path
from urllib.parse import parse_qs, urlparse

import torch

from .. import __version__
from ..backend import ensure_backend
from ..config import get_config
from ..exceptions import IndexNotFoundError, RAGError
from ..index.registry import CorpusRegistry
from ..ingest.pipeline import IngestionPipeline
from ..llm.factory import get_llm
from ..llm.reranker_factory import get_reranker
from ..observability import Metrics, get_metrics, start_device_trace, stop_device_trace, trace_phase
from ..query.response import build_rag_prompt, create_page_aware_response
from ..query.retriever import PageLevelRetriever
from ..storage.cache import QueryResultCache
from ..tasks import TaskQueue
from .batcher import QueryBatcher
from .models import (
    DocumentInfo, HealthResponse, IngestResponse, QueryRequest, QueryResponse, SourceReference,
)
from .multipart import parse_multipart

logger = logging.getLogger(__name__)
_DOC_ID = re.compile(r"[A-Za-z0-9._-]+")


class HTTPError(Exception):
    def __init__(self, status: int, detail: str) -> None:
        super().__init__(detail)
        self.status = status
        self.detail = detail


NOT_FOUND_ANSWER = "I could not find relevant information to answer your question."


class RAGService:
    """Routes requests to the ingest, retrieval and answer paths.
    ``provider`` embeds chunks and queries (a
    :class:`..providers.cuda_embed.CudaEmbeddingProvider`); left out, the
    embedding factory's, which ingest reads through the disk embedding
    cache when ``CACHE_EMBEDDINGS`` is set. ``reranker`` reorders hits when
    ``RERANKER_ENABLED``; left out, it comes from
    ``llm/reranker_factory.py`` (None without local weights). ``llm``
    answers ``/query``; left out, the LLM factory's, built on the first
    query. With ``CACHE_QUERY_RESULTS``, answers are cached on disk under
    ``CACHE_DIR``, keyed by question, project, parameters and corpus
    version. The service's own :class:`..observability.Metrics` count its
    requests and time its phases; ``GET /metrics`` adds the process-global
    ones (the LLM's wave server reports there)."""

    def __init__(self, provider=None, registry: CorpusRegistry | None = None,
                 device: str | torch.device | None = None, reranker=None, llm=None) -> None:
        logger.info("compute backend: %s", ensure_backend(registry.device if registry is not None else device))
        self.registry = registry or CorpusRegistry(device=device)
        self.registry.load_all()
        self.pipeline = IngestionPipeline(provider, storage=self.registry.storage, device=self.registry.device)
        if provider is None:
            from ..llm.embeddings.factory import get_embedding_provider

            provider = get_embedding_provider(self.registry.device)
        if reranker is None:
            reranker = get_reranker(self.registry.device)
        self.retriever = PageLevelRetriever(self.registry, provider, reranker=reranker)
        self._llm = llm
        self._agent = None
        self.metrics = Metrics()  # this service's, not the process-global ones
        self.tasks = TaskQueue(workers=1)
        self.last_ingest_timings: dict[str, float] = {}
        # seconds by stage of recent answered (not cached) queries: retrieve, generate
        self.query_timings: collections.deque[dict[str, float]] = collections.deque(maxlen=1024)
        cfg = get_config()
        self.query_cache = QueryResultCache() if cfg.CACHE_QUERY_RESULTS else None
        self.batcher = (
            QueryBatcher(self.retriever.retrieve_chunks_batch) if cfg.QUERY_MAX_BATCH > 1 else None
        )

    @property
    def llm(self):
        if self._llm is None:
            self._llm = get_llm(self.registry.device)
        return self._llm

    def handle(self, method: str, path: str, body: bytes = b"", content_type: str = "") -> tuple[int, dict]:
        parsed = urlparse(path)
        route = parsed.path.rstrip("/") or "/"
        params = {k: v[0] for k, v in parse_qs(parsed.query).items()}
        try:
            if method == "POST" and route == "/ingest":
                return 200, self.ingest(params, body, content_type)
            if method == "POST" and route == "/query":
                return 200, self.query(body)
            if method == "POST" and route == "/search":
                return 200, self.search(body)
            if method == "GET" and route == "/documents":
                return 200, self.list_documents()
            if method == "GET" and route.startswith("/documents/"):
                return 200, self.document_detail(route.split("/", 2)[2])
            if method == "GET" and route == "/health":
                return 200, self.health()
            if method == "GET" and route == "/metrics":
                return 200, self.metrics_snapshot()
            if method == "POST" and route == "/agent/query":
                return 200, self.agent_query(body)
            if method == "GET" and route == "/agent/health":
                return 200, {"status": "ok", "pipeline": "page-aware-agent"}
            if method == "GET" and route == "/jobs":
                return 200, {"jobs": self.tasks.list_jobs()}
            if method == "POST" and route == "/debug/trace":
                return 200, self.debug_trace(body)
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
        self.metrics.inc("ingest_requests")

        if params.get("mode") == "async":
            job = self.tasks.submit(
                "ingest", lambda: self._do_ingest(filepath, project, doc_id, upload.filename, language)
            )
            return {"job_id": job.job_id, "status": job.status, "doc_id": doc_id}

        start = time.time()
        with trace_phase("ingest", self.metrics):
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

    def query(self, body: bytes) -> dict:
        """Retrieve and rank pages, build the cited prompt, answer with the
        LLM. A cached answer comes back as it was; ``stream: true`` returns
        ``{"__stream__": events}`` for the HTTP layer and is not cached."""
        try:
            request = QueryRequest.from_json(body)
        except (ValueError, TypeError) as exc:
            raise HTTPError(400, f"invalid query request: {exc}") from exc
        self.metrics.inc("query_requests")
        cache_params = f"{request.top_pages}|{request.max_context_length}"
        if self.query_cache is not None and not request.stream:
            cached = self.query_cache.get(request.question, request.project or "", cache_params,
                                          self.registry.version)
            if cached is not None:
                self.metrics.inc("query_cache_hits")
                return cached
        start = time.perf_counter()
        with trace_phase("query.retrieve", self.metrics):
            if self.batcher is not None:
                chunks = self.batcher.submit(request.question, request.project)
                ranked = self.retriever.rank_pages(chunks, request.top_pages) if chunks else []
            else:
                ranked = self.retriever.retrieve_and_rank_pages(
                    request.question, project=request.project, top_pages=request.top_pages)
        retrieved = time.perf_counter()
        if not ranked:
            return dataclasses.asdict(QueryResponse(answer=NOT_FOUND_ANSWER, sources=[], confidence="low"))
        prompt = build_rag_prompt(request.question, ranked, request.max_context_length)
        if request.stream:
            return {"__stream__": self._stream_answer(prompt, ranked)}
        with trace_phase("query.generate", self.metrics):
            answer = self.llm.generate(prompt)
        self.query_timings.append({"retrieve": retrieved - start, "generate": time.perf_counter() - retrieved})
        response = create_page_aware_response(answer, ranked)
        result = dataclasses.asdict(QueryResponse(
            answer=answer,
            sources=[SourceReference(**src) for src in response["sources"]["primary_sources"]],
            confidence=response["confidence"],
        ))
        if self.query_cache is not None:
            self.query_cache.put(request.question, request.project or "", cache_params,
                                 self.registry.version, result)
        return result

    def _stream_answer(self, prompt: str, ranked):
        """Server-sent events: ``sources`` first, then ``token`` deltas of
        the LLM's stream, then ``done`` with the confidence, or ``error``."""
        sources = create_page_aware_response("", ranked)["sources"]["primary_sources"]

        def events():
            yield "event: sources\ndata: " + json.dumps(sources) + "\n\n"
            parts = []
            try:
                for chunk in self.llm.generate_stream(prompt):
                    parts.append(chunk)
                    yield "event: token\ndata: " + json.dumps({"text": chunk}) + "\n\n"
            except Exception as exc:  # the stream has started: report in band, as the JAX service does
                yield "event: error\ndata: " + json.dumps({"detail": str(exc)}) + "\n\n"
                return
            final = create_page_aware_response("".join(parts), ranked)
            yield "event: done\ndata: " + json.dumps({"confidence": final["confidence"]}) + "\n\n"

        return events()

    def search(self, body: bytes) -> dict:
        """Raw retrieval (no LLM): hybrid top-k chunks with scores and
        identities. Concurrent requests coalesce in the micro-batcher."""
        try:
            request = QueryRequest.from_json(body)
        except (ValueError, TypeError) as exc:
            raise HTTPError(400, f"invalid search request: {exc}") from exc
        self.metrics.inc("search_requests")
        with trace_phase("search", self.metrics):
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

    def agent_query(self, body: bytes) -> dict:
        """The 11-step agent (``agent/orchestrator.py``) over this service's
        registry, LLM and embedding provider, built on the first call."""
        try:
            request = QueryRequest.from_json(body)
        except (ValueError, TypeError) as exc:
            raise HTTPError(400, f"invalid agent query: {exc}") from exc
        if self._agent is None:
            from ..agent import PageAwareAgent

            self._agent = PageAwareAgent(self.registry, llm=self.llm, provider=self.retriever.provider)
        self.metrics.inc("agent_requests")
        with trace_phase("agent.query", self.metrics):
            return self._agent.query(request.question, project=request.project)

    def debug_trace(self, body: bytes) -> dict:
        """A ``torch.profiler`` window of ``seconds`` (clamped to [0.5, 60])
        over every thread's work, CUDA kernels included on the card, written
        as a Chrome trace JSON under ``STORAGE_DIR/traces``."""
        try:
            seconds = float(json.loads(body or b"{}").get("seconds", 3))
        except Exception as exc:  # any malformed body is the client's error
            raise HTTPError(400, f"invalid trace request: {exc}") from exc
        seconds = min(max(seconds, 0.5), 60.0)
        trace_dir = str(get_config().STORAGE_DIR / "traces")
        start_device_trace(trace_dir, cuda=self.registry.device.type == "cuda")
        try:
            time.sleep(seconds)
        finally:
            stop_device_trace()
        return {"trace_dir": trace_dir, "seconds": seconds}

    def metrics_snapshot(self) -> dict:
        """This service's counters and latency windows, the corpus, the query
        cache and the batcher; ``process`` holds the process-global metrics
        when they hold anything."""
        snap = self.metrics.snapshot()
        snap["corpus"] = self.registry.stats()
        if self.query_cache is not None:
            snap["query_cache"] = {"hits": self.query_cache.hits, "misses": self.query_cache.misses}
        if self.batcher is not None:
            snap["batcher"] = {"batches_run": self.batcher.batches_run, "requests_served": self.batcher.requests_served}
        process = get_metrics().snapshot()
        if process["counters"] or process["latency_s"]:
            snap["process"] = process
        return snap

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
