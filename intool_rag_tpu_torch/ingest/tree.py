"""Semantic tree building (copy of ``intool_rag_tpu/ingest/tree.py``;
reference: rag/ingest/semantic/tree_builder.py).

Takes the analyzer's flat section list and resolves the hierarchy with a
parent stack keyed on level depth (chapter > section > subsection >
paragraph — tree_builder.py:77-104), producing a PageIndex.
"""

from __future__ import annotations

from ..llm.semantic import analyze_document
from ..llm.semantic.base import SectionSpec
from .chunker import estimate_tokens
from .schemas import NodeLevel, PageIndex, SemanticNode, make_node_id

_LEVELS = {
    "document": NodeLevel.DOCUMENT,
    "chapter": NodeLevel.CHAPTER,
    "section": NodeLevel.SECTION,
    "subsection": NodeLevel.SUBSECTION,
    "paragraph": NodeLevel.PARAGRAPH,
}


class SemanticTreeBuilder:
    def build(
        self,
        doc_id: str,
        pages: dict[int, str],
        *,
        source_file: str = "",
        project: str = "",
        language: str = "en",
        sections: list[SectionSpec] | None = None,
    ) -> PageIndex:
        """Build the PageIndex; ``sections=None`` invokes the configured
        semantic analyzer (LLM or heuristic)."""
        ordered = [pages[p] for p in sorted(pages)]
        if sections is None:
            sections = analyze_document(ordered)
        page_numbers = sorted(pages)

        page_index = PageIndex(
            doc_id=doc_id,
            source_file=source_file,
            project=project,
            language=language,
            page_count=len(pages),
        )
        root = SemanticNode(
            node_id=make_node_id(0),
            title=source_file or doc_id,
            level=NodeLevel.DOCUMENT,
            page_index=page_numbers[0] if page_numbers else 0,
        )
        page_index.add_node(root)

        # parent-stack hierarchy resolution (tree_builder.py:132-150)
        stack: list[SemanticNode] = [root]
        for i, spec in enumerate(sections):
            level = _LEVELS.get(str(spec.level).lower(), NodeLevel.SECTION)
            if level == NodeLevel.DOCUMENT:
                level = NodeLevel.CHAPTER
            # map analyzer page_index (position in ordered list) to the
            # document's actual page number
            pos = min(max(int(spec.page_index), 0), max(len(page_numbers) - 1, 0))
            page_no = page_numbers[pos] if page_numbers else 0
            while len(stack) > 1 and stack[-1].level.depth >= level.depth:
                stack.pop()
            parent = stack[-1]
            node = SemanticNode(
                node_id=make_node_id(i + 1),
                title=spec.title,
                level=level,
                page_index=page_no,
                summary=spec.summary,
                parent_id=parent.node_id,
                token_estimate=estimate_tokens(spec.summary),
            )
            parent.children.append(node.node_id)
            page_index.add_node(node)
            stack.append(node)
        return page_index
