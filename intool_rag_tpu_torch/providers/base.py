"""Shared provider helpers (port of ``intool_rag_tpu/providers/base.py``)."""

from __future__ import annotations

from ..config import get_config


def instruction_prefix(is_query: bool) -> str:
    """The embedding instruction prefix from config."""
    cfg = get_config()
    return cfg.EMBEDDING_QUERY_INSTRUCTION if is_query else cfg.EMBEDDING_PASSAGE_INSTRUCTION
