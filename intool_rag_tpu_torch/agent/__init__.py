"""Page-aware agent (port of ``intool_rag_tpu/agent``): the 11-step
pipeline behind ``POST /agent/query``, wired to the registry, the page
retriever and the service's LLM."""

from .orchestrator import PageAwareAgent  # noqa: F401
from .state import AgentState, QueryIntent  # noqa: F401
