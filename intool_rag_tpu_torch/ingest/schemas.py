"""Document data model: semantic nodes, page index, chunks, vector metadata
(copy of ``intool_rag_tpu/ingest/schemas.py``; the JSON format is
identical, so the port reads artifacts the JAX service wrote).

IDs follow the reference formats: chunk ids ``c_{page:03d}_{index:03d}``,
node ids ``n_{ordinal:03d}``.
"""

from __future__ import annotations

import dataclasses
import enum
import json
from pathlib import Path
from typing import Any, Iterable


class NodeLevel(str, enum.Enum):
    """Hierarchy levels of the semantic document tree
    (reference: rag/ingest/schemas.py:7-13)."""

    DOCUMENT = "document"
    CHAPTER = "chapter"
    SECTION = "section"
    SUBSECTION = "subsection"
    PARAGRAPH = "paragraph"

    @property
    def depth(self) -> int:
        return _LEVEL_DEPTH[self]


_LEVEL_DEPTH = {
    NodeLevel.DOCUMENT: 0,
    NodeLevel.CHAPTER: 1,
    NodeLevel.SECTION: 2,
    NodeLevel.SUBSECTION: 3,
    NodeLevel.PARAGRAPH: 4,
}

def make_node_id(ordinal: int) -> str:
    return f"n_{ordinal:03d}"


def make_chunk_id(page: int, index: int) -> str:
    return f"c_{page:03d}_{index:03d}"


@dataclasses.dataclass
class SemanticNode:
    """One node of the semantic tree (reference: rag/ingest/schemas.py:16-70)."""

    node_id: str
    title: str
    level: NodeLevel
    page_index: int
    summary: str = ""
    parent_id: str | None = None
    children: list[str] = dataclasses.field(default_factory=list)
    char_start: int = 0
    char_end: int = 0
    token_estimate: int = 0

    def to_dict(self) -> dict[str, Any]:
        d = dataclasses.asdict(self)
        d["level"] = self.level.value
        return d

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "SemanticNode":
        d = dict(d)
        d["level"] = NodeLevel(d["level"])
        return cls(**d)


@dataclasses.dataclass
class PageIndex:
    """Flat node list with tree accessors
    (reference: rag/ingest/schemas.py:73-153)."""

    doc_id: str
    source_file: str = ""
    project: str = ""
    language: str = "en"
    page_count: int = 0
    nodes: list[SemanticNode] = dataclasses.field(default_factory=list)

    def __post_init__(self) -> None:
        self._by_id = {n.node_id: n for n in self.nodes}

    def get_node(self, node_id: str) -> SemanticNode | None:
        return self._by_id.get(node_id)

    def get_parent(self, node_id: str) -> SemanticNode | None:
        node = self.get_node(node_id)
        if node is None or node.parent_id is None:
            return None
        return self.get_node(node.parent_id)

    def get_children(self, node_id: str) -> list[SemanticNode]:
        node = self.get_node(node_id)
        if node is None:
            return []
        return [c for cid in node.children if (c := self.get_node(cid)) is not None]

    def get_siblings(self, node_id: str) -> list[SemanticNode]:
        node = self.get_node(node_id)
        if node is None:
            return []
        parent = self.get_parent(node_id)
        if parent is None:
            return [n for n in self.nodes if n.parent_id is None and n is not node]
        return [c for c in self.get_children(parent.node_id) if c.node_id != node_id]

    def nodes_for_page(self, page: int) -> list[SemanticNode]:
        return [n for n in self.nodes if n.page_index == page]

    def ancestry(self, node_id: str) -> list[SemanticNode]:
        """Path from root-most ancestor down to the node itself."""
        path: list[SemanticNode] = []
        node = self.get_node(node_id)
        seen: set[str] = set()
        while node is not None and node.node_id not in seen:
            seen.add(node.node_id)
            path.append(node)
            node = self.get_parent(node.node_id)
        return list(reversed(path))

    def add_node(self, node: SemanticNode) -> None:
        self.nodes.append(node)
        self._by_id[node.node_id] = node

    def to_dict(self) -> dict[str, Any]:
        return {
            "doc_id": self.doc_id,
            "source_file": self.source_file,
            "project": self.project,
            "language": self.language,
            "page_count": self.page_count,
            "nodes": [n.to_dict() for n in self.nodes],
        }

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "PageIndex":
        return cls(
            doc_id=d["doc_id"],
            source_file=d.get("source_file", ""),
            project=d.get("project", ""),
            language=d.get("language", "en"),
            page_count=d.get("page_count", 0),
            nodes=[SemanticNode.from_dict(n) for n in d.get("nodes", [])],
        )


@dataclasses.dataclass
class Chunk:
    """A retrieval unit bound to a page and a semantic node
    (reference: rag/ingest/schemas.py:155-195)."""

    chunk_id: str
    node_id: str
    page: int
    text: str
    char_start: int = 0
    char_end: int = 0
    seq_index: int = 0
    token_estimate: int = 0
    embedding_id: int | None = None
    has_table: bool = False
    has_structured_data: bool = False

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "Chunk":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


@dataclasses.dataclass
class ChunksIndex:
    """Ordered chunk collection for one document
    (reference: rag/ingest/schemas.py:198-241)."""

    doc_id: str
    chunks: list[Chunk] = dataclasses.field(default_factory=list)

    def __post_init__(self) -> None:
        self._by_id = {c.chunk_id: c for c in self.chunks}

    def __len__(self) -> int:
        return len(self.chunks)

    def __iter__(self) -> Iterable[Chunk]:
        return iter(self.chunks)

    def to_dict(self) -> dict[str, Any]:
        return {"doc_id": self.doc_id, "chunks": [c.to_dict() for c in self.chunks]}

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "ChunksIndex":
        return cls(
            doc_id=d["doc_id"],
            chunks=[Chunk.from_dict(c) for c in d.get("chunks", [])],
        )


@dataclasses.dataclass
class VectorMeta:
    """vector_id ↔ chunk_id mapping plus page lookup (the reference's
    ``FAISSMeta`` — rag/ingest/schemas.py:243-295). vector_id is the row
    index into the document's embedding matrix."""

    doc_id: str
    model: str = ""
    dimension: int = 0
    count: int = 0
    chunk_ids: list[str] = dataclasses.field(default_factory=list)  # row -> chunk_id
    pages: list[int] = dataclasses.field(default_factory=list)  # row -> page

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "VectorMeta":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


# --- JSON save/load helpers (reference: rag/ingest/schemas.py:321-357) ---


def save_json(obj: Any, path: Path | str) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    data = obj.to_dict() if hasattr(obj, "to_dict") else obj
    path.write_text(json.dumps(data, ensure_ascii=False, indent=2), encoding="utf-8")


def load_json(path: Path | str) -> Any:
    return json.loads(Path(path).read_text(encoding="utf-8"))
