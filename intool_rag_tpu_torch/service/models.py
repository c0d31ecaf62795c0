"""Request/response models (port of ``intool_rag_tpu/service/models.py``):
dataclasses with the same JSON field names as the JAX package's pydantic
models; ``dataclasses.asdict`` gives their JSON bodies."""

from __future__ import annotations

import dataclasses
import json


@dataclasses.dataclass
class QueryRequest:
    question: str
    project: str | None = None
    top_pages: int = 5
    max_context_length: int = 8000
    stream: bool = False

    @classmethod
    def from_json(cls, body: bytes) -> "QueryRequest":
        """Parse and type-check a JSON body; raises ValueError."""
        data = json.loads(body or b"{}")
        if not isinstance(data, dict):
            raise ValueError("request body must be a JSON object")
        if not isinstance(data.get("question"), str):
            raise ValueError("field 'question' (string) is required")
        known = {f.name for f in dataclasses.fields(cls)}
        data = {k: v for k, v in data.items() if k in known}  # extra fields are ignored
        project = data.get("project")
        if project is not None and not isinstance(project, str):
            raise ValueError("field 'project' must be a string or null")
        for name in ("top_pages", "max_context_length"):
            if name in data and (not isinstance(data[name], int) or isinstance(data[name], bool)):
                raise ValueError(f"field {name!r} must be an integer")
        if "stream" in data and not isinstance(data["stream"], bool):
            raise ValueError("field 'stream' must be a boolean")
        return cls(**data)


@dataclasses.dataclass
class SourceReference:
    page: int
    chapter: str | None = None
    section: str | None = None
    subsection: str | None = None
    title: str | None = None
    source_file: str | None = None
    relevance_score: float = 0.0


@dataclasses.dataclass
class QueryResponse:
    answer: str
    sources: list[SourceReference]
    confidence: str  # "high" | "medium" | "low"


@dataclasses.dataclass
class DocumentInfo:
    doc_id: str
    source_file: str = ""
    project: str = ""
    language: str = "en"
    page_count: int = 0
    chunk_count: int = 0
    vectors_indexed: int = 0
    embedding_model: str = ""
    dimension: int = 0


@dataclasses.dataclass
class HealthResponse:
    status: str
    documents: int
    chunks: int
    backend: str
    version: str


@dataclasses.dataclass
class IngestResponse:
    success: bool
    doc_id: str
    source_file: str
    project: str
    total_pages: int
    total_chunks: int
    vectors_indexed: int
    processing_time_seconds: float
