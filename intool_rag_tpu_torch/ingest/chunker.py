"""Node-aware chunking: greedy paragraph packing bound to semantic nodes
(copy of ``intool_rag_tpu/ingest/chunker.py``).

Capability parity with the reference's ``NodeAwareChunker``/``ChunksBuilder``
(reference: rag/ingest/node_aware_chunker.py:38-298): paragraph-split on
blank lines, greedy packing into chunks of at most ``max_chars`` (1000),
minimum ``min_chars`` (100), target ``target_chars`` (600); chunk ids
``c_{page:03d}_{index:03d}``; token estimate ``words / 0.75``.

Two deliberate improvements over the reference:

- ``_extract_node_text`` in the reference is a stub that always returns
  the whole page (node_aware_chunker.py:220-235), making node binding
  nominal. Here node text extraction is real: a node owns the page span
  between its own heading position and the next node's on the same page.
- Oversized single paragraphs are sentence-split rather than emitted
  over ``max_chars``.
"""

from __future__ import annotations

import dataclasses
import re

from .schemas import Chunk, NodeLevel, PageIndex, SemanticNode, make_chunk_id

_PARA_SPLIT = re.compile(r"\n\s*\n")
_SENT_SPLIT = re.compile(r"(?<=[.!?。！？])\s+")
_TABLE_HINT = re.compile(r"(\|.+\|)|(\t.+\t)|(^\s*[-+=]{3,}\s*$)", re.M)
_STRUCTURED_HINT = re.compile(r"(?m)^\s*([-*•]|\d+[.)])\s+\S")


def estimate_tokens(text: str) -> int:
    """Reference token heuristic: words / 0.75
    (rag/ingest/node_aware_chunker.py:121-124)."""
    words = len(text.split())
    return int(words / 0.75)


@dataclasses.dataclass
class ChunkerConfig:
    max_chars: int = 1000
    min_chars: int = 100
    target_chars: int = 600
    # chars of trailing context repeated at the next chunk's head (the
    # reference declares CHUNK_OVERLAP but never implements it —
    # config.py:34 vs node_aware_chunker.py; implemented here, default off
    # to preserve the reference's actual behavior)
    overlap_chars: int = 0


class NodeAwareChunker:
    """Greedy paragraph packer for a single node's text."""

    def __init__(self, config: ChunkerConfig | None = None) -> None:
        self.config = config or ChunkerConfig()

    def _split_oversized(self, paragraph: str) -> list[str]:
        """Split a paragraph longer than max_chars at sentence boundaries,
        falling back to hard cuts."""
        cfg = self.config
        pieces: list[str] = []
        current = ""
        for sent in _SENT_SPLIT.split(paragraph):
            if not sent:
                continue
            if current and len(current) + 1 + len(sent) > cfg.max_chars:
                pieces.append(current)
                current = sent
            else:
                current = f"{current} {sent}".strip()
            # A single sentence can still exceed max_chars: hard-cut it.
            while len(current) > cfg.max_chars:
                pieces.append(current[: cfg.max_chars])
                current = current[cfg.max_chars :]
        if current:
            pieces.append(current)
        return pieces

    def chunk_text(self, text: str) -> list[str]:
        """Pack paragraphs greedily toward target_chars, never exceeding
        max_chars; trailing fragments below min_chars merge backward."""
        cfg = self.config
        paragraphs: list[str] = []
        for para in _PARA_SPLIT.split(text):
            para = para.strip()
            if not para:
                continue
            if len(para) > cfg.max_chars:
                paragraphs.extend(self._split_oversized(para))
            else:
                paragraphs.append(para)

        chunks: list[str] = []
        current = ""
        for para in paragraphs:
            candidate_len = len(current) + (2 if current else 0) + len(para)
            if current and (
                candidate_len > cfg.max_chars
                or (len(current) >= cfg.target_chars and candidate_len > cfg.target_chars)
            ):
                chunks.append(current)
                current = para
            else:
                current = f"{current}\n\n{para}" if current else para
        if current:
            if chunks and len(current) < cfg.min_chars:
                merged = f"{chunks[-1]}\n\n{current}"
                if len(merged) <= cfg.max_chars:
                    chunks[-1] = merged
                else:
                    chunks.append(current)
            else:
                chunks.append(current)
        if cfg.overlap_chars > 0 and len(chunks) > 1:
            chunks = self._apply_overlap(chunks, cfg.overlap_chars, cfg.max_chars)
        return chunks

    @staticmethod
    def _apply_overlap(chunks: list[str], overlap: int, max_chars: int) -> list[str]:
        """Prepend the previous chunk's word-aligned tail to each chunk."""
        out = [chunks[0]]
        for prev, cur in zip(chunks, chunks[1:]):
            tail = prev[-overlap:]
            space = tail.find(" ")
            if 0 <= space < len(tail) - 1:
                tail = tail[space + 1 :]
            merged = f"{tail} {cur}" if tail else cur
            out.append(merged[:max_chars])
        return out


class ChunksBuilder:
    """Builds the document's chunk list from normalized pages and the
    semantic tree (reference: rag/ingest/node_aware_chunker.py:147-218)."""

    def __init__(self, config: ChunkerConfig | None = None) -> None:
        self.chunker = NodeAwareChunker(config)

    def _node_spans(
        self, page_text: str, nodes: list[SemanticNode]
    ) -> list[tuple[SemanticNode | None, str]]:
        """Assign each node the page span from its heading occurrence to the
        next node's heading. Falls back to the whole page when headings are
        not found in the text."""
        positions: list[tuple[int, SemanticNode]] = []
        for node in nodes:
            if node.level == NodeLevel.DOCUMENT or not node.title:
                continue
            pos = page_text.find(node.title)
            if pos >= 0:
                positions.append((pos, node))
        if not positions:
            anchor = nodes[0] if nodes else None
            return [(anchor, page_text)]
        positions.sort(key=lambda t: t[0])
        spans: list[tuple[SemanticNode | None, str]] = []
        first_pos = positions[0][0]
        if first_pos > 0:
            spans.append((positions[0][1], page_text[:first_pos]))
        for i, (pos, node) in enumerate(positions):
            end = positions[i + 1][0] if i + 1 < len(positions) else len(page_text)
            spans.append((node, page_text[pos:end]))
        return [(n, s) for n, s in spans if s.strip()]

    def build_chunks(
        self, pages: dict[int, str], page_index: PageIndex
    ) -> list[Chunk]:
        chunks: list[Chunk] = []
        for page in sorted(pages):
            text = pages[page]
            if not text.strip():
                continue
            nodes = page_index.nodes_for_page(page)
            seq = 0
            for node, span in self._node_spans(text, nodes):
                offset = text.find(span)
                for piece in self.chunker.chunk_text(span):
                    start = text.find(piece[:80], max(0, offset))
                    if start < 0:
                        start = offset
                    chunks.append(
                        Chunk(
                            chunk_id=make_chunk_id(page, seq),
                            node_id=node.node_id if node else "",
                            page=page,
                            text=piece,
                            char_start=start,
                            char_end=start + len(piece),
                            seq_index=seq,
                            token_estimate=estimate_tokens(piece),
                            has_table=bool(_TABLE_HINT.search(piece)),
                            has_structured_data=bool(_STRUCTURED_HINT.search(piece)),
                        )
                    )
                    seq += 1
        return chunks
