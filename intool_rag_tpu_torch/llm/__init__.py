"""Capability interfaces and env-driven factories (the part of
``intool_rag_tpu/llm/`` the port serves: ``BaseLLM``, the embedding
provider factory and the semantic analyzer)."""
