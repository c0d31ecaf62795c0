"""Retrieval quality evaluation: metrics + harness (port of
``intool_rag_tpu/eval/``)."""

from .metrics import mrr, ndcg_at_k, recall_at_k  # noqa: F401
from .harness import EvalExample, evaluate_engine  # noqa: F401
