"""Capability interfaces and env-driven factories (the part of
``intool_rag_tpu/llm/`` the port serves: ``BaseLLM``, the LLM factory, the
embedding provider factory, the semantic analyzer and the reranker
factory)."""
