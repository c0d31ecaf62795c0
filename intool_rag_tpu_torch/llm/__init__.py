"""Capability interfaces and env-driven factories (the part of
``intool_rag_tpu/llm/`` the port serves: the semantic analyzer)."""
