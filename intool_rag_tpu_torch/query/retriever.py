"""Page-level retrieval (port of ``intool_rag_tpu/query/retriever.py``).

Flow: embed query → corpus-wide hybrid top-K chunks (with
``RERANKER_ENABLED`` and a reranker: ``max(limit, RERANKER_CANDIDATES)``
of them, reordered by the cross-encoder and cut to the limit, score =
sigmoid of the relevance logit) → group by
(doc, page) → page score = avg(chunk scores) + min(0.05·n_chunks, 0.15),
times ``TABLE_BOOST_MULTIPLIER`` for pages with tables → top-N pages with
citation metadata. ``retrieve_and_rank_pages`` runs the whole flow for
one query, ``retrieve_and_rank_pages_batch`` for a batch.
"""

from __future__ import annotations

import dataclasses
import math
import re

import torch

from ..config import get_config
from ..index.registry import CorpusRegistry
from ..ingest.schemas import NodeLevel
from ..observability import trace_phase

# same pattern as intool_rag_tpu/ingest/chunker.py
_TABLE_HINT = re.compile(r"(\|.+\|)|(\t.+\t)|(^\s*[-+=]{3,}\s*$)", re.M)


@dataclasses.dataclass
class RetrievedChunk:
    doc_id: str
    chunk_id: str
    page: int
    text: str
    score: float
    has_table: bool = False


@dataclasses.dataclass
class PageRanking:
    doc_id: str
    page: int
    score: float
    chunks: list[RetrievedChunk]
    source_file: str = ""
    chapter: str | None = None
    section: str | None = None
    subsection: str | None = None
    title: str | None = None

    @property
    def context_text(self) -> str:
        ordered = sorted(self.chunks, key=lambda c: c.chunk_id)
        return "\n\n".join(c.text for c in ordered)


def _chunks(hits: list[dict]) -> list[RetrievedChunk]:
    return [
        RetrievedChunk(
            doc_id=h["doc_id"], chunk_id=h["chunk_id"], page=h["page"], text=h["text"],
            score=h["score"], has_table=bool(_TABLE_HINT.search(h["text"])),
        )
        for h in hits
    ]


class PageLevelRetriever:
    def __init__(self, registry: CorpusRegistry, provider, reranker=None) -> None:
        self.registry = registry
        self.provider = provider
        self._reranker = reranker

    def _rerank_fetch(self, limit: int) -> tuple[bool, int]:
        """(rerank?, hits to fetch): a wider pool when the cross-encoder
        reorders it."""
        cfg = get_config()
        rerank = cfg.RERANKER_ENABLED and self._reranker is not None
        return rerank, max(limit, cfg.RERANKER_CANDIDATES) if rerank else limit

    def _rerank(self, query: str, hits: list[dict], limit: int) -> list[dict]:
        """Cross-encoder order of ``hits`` cut to ``limit``; the sigmoid maps
        the logits into the [0, 1] space the page scoring expects."""
        reranked = self._reranker.rerank(query, hits, top_k=limit)
        for h in reranked:
            h["score"] = 1.0 / (1.0 + math.exp(-h["rerank_score"]))
        return reranked

    def _embed(self, queries: list[str]) -> torch.Tensor:
        """Query embeddings on the corpus device; a provider with
        ``embed_batch_device`` keeps them on the card. Span
        ``retrieve.embed``."""
        with trace_phase("retrieve.embed"):
            emb_dev_fn = getattr(self.provider, "embed_batch_device", None)
            emb = emb_dev_fn(list(queries), is_query=True) if emb_dev_fn else None
            if emb is None:
                emb = torch.as_tensor(self.provider.embed_batch(list(queries), is_query=True))
            return emb[: len(queries)].to(self.registry.device)

    def retrieve_chunks(
        self, query: str, *, project: str | None = None, limit: int | None = None
    ) -> list[RetrievedChunk]:
        """One query; the project filter applies inside the registry's
        (4× over-fetched) candidate pool."""
        cfg = get_config()
        limit = limit or cfg.RETRIEVAL_CANDIDATES
        rerank, fetch = self._rerank_fetch(limit)
        hits = self.registry.search([query], self._embed([query]), fetch, project=project)[0]
        if rerank and hits:
            hits = self._rerank(query, hits, limit)
        chunks = _chunks(hits)
        return [c for c in chunks if c.score >= cfg.RETRIEVAL_MIN_SCORE] or chunks[:5]

    def retrieve_chunks_batch(
        self, queries: list[str], projects: list[str | None], *, limit: int | None = None
    ) -> list[list[RetrievedChunk]]:
        """One embedding forward + one device search for the whole batch;
        per-query project filters apply on the host."""
        cfg = get_config()
        limit = limit or cfg.RETRIEVAL_CANDIDATES
        rerank, fetch = self._rerank_fetch(limit)
        if any(p is not None for p in projects):
            fetch *= 4
        hit_lists = self.registry.search(list(queries), self._embed(queries), fetch)
        out: list[list[RetrievedChunk]] = []
        for query, hits, project in zip(queries, hit_lists, projects):
            if project is not None:
                hits = [h for h in hits if self.registry.doc_projects.get(h["doc_id"]) == project]
            if rerank and hits:
                hits = self._rerank(query, hits, limit)
            chunks = _chunks(hits[:limit])
            kept = [c for c in chunks if c.score >= cfg.RETRIEVAL_MIN_SCORE]
            out.append(kept or chunks[:5])
        return out

    def rank_pages(self, chunks: list[RetrievedChunk], top_pages: int | None = None) -> list[PageRanking]:
        cfg = get_config()
        top_pages = top_pages or cfg.TOP_PAGES
        groups: dict[tuple[str, int], list[RetrievedChunk]] = {}
        for chunk in chunks:
            groups.setdefault((chunk.doc_id, chunk.page), []).append(chunk)
        rankings: list[PageRanking] = []
        for (doc_id, page), page_chunks in groups.items():
            avg = sum(c.score for c in page_chunks) / len(page_chunks)
            boost = min(cfg.PAGE_CHUNK_BOOST * len(page_chunks), cfg.PAGE_CHUNK_BOOST_CAP)
            score = avg + boost
            if cfg.TABLE_CONTEXT_PRIORITY and any(c.has_table for c in page_chunks):
                score *= cfg.TABLE_BOOST_MULTIPLIER
            ranking = PageRanking(doc_id=doc_id, page=page, score=score, chunks=page_chunks)
            self._attach_citation(ranking)
            rankings.append(ranking)
        rankings.sort(key=lambda r: -r.score)
        return rankings[:top_pages]

    def _attach_citation(self, ranking: PageRanking) -> None:
        """Chapter/section/subsection from the semantic tree via the page's
        best chunk's node ancestry."""
        page_index = self.registry.page_indexes.get(ranking.doc_id)
        if page_index is None:
            return
        ranking.source_file = page_index.source_file
        best = max(ranking.chunks, key=lambda c: c.score)
        node_id = self.registry.chunk_nodes.get((ranking.doc_id, best.chunk_id), "")
        node = page_index.get_node(node_id) if node_id else None
        if node is None:
            nodes = page_index.nodes_for_page(ranking.page)
            node = nodes[0] if nodes else None
        if node is None:
            return
        ranking.title = node.title
        for ancestor in page_index.ancestry(node.node_id):
            if ancestor.level is NodeLevel.CHAPTER:
                ranking.chapter = ancestor.title
            elif ancestor.level is NodeLevel.SECTION:
                ranking.section = ancestor.title
            elif ancestor.level is NodeLevel.SUBSECTION:
                ranking.subsection = ancestor.title

    def retrieve_and_rank_pages_batch(
        self, queries: list[str], projects: list[str | None], *, top_pages: int | None = None
    ) -> list[list[PageRanking]]:
        chunk_lists = self.retrieve_chunks_batch(queries, projects)
        return [self.rank_pages(chunks, top_pages) if chunks else [] for chunks in chunk_lists]

    def retrieve_and_rank_pages(
        self, query: str, *, project: str | None = None, top_pages: int | None = None
    ) -> list[PageRanking]:
        chunks = self.retrieve_chunks(query, project=project)
        if not chunks:
            return []
        return self.rank_pages(chunks, top_pages)


def retrieve_and_rank_pages(
    query: str, *, project: str | None = None, top_pages: int | None = None
) -> list[PageRanking]:
    """One query over the process's registry and embedding provider
    (``index/registry.py::get_registry``, the embedding factory)."""
    from ..index.registry import get_registry
    from ..llm.embeddings.factory import get_embedding_provider

    return PageLevelRetriever(get_registry(), get_embedding_provider()).retrieve_and_rank_pages(
        query, project=project, top_pages=top_pages
    )
