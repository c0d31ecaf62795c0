"""Text-generation capability (port of ``intool_rag_tpu/llm/base.py``)."""

from __future__ import annotations

import abc
from typing import Iterator


class BaseLLM(abc.ABC):
    """Text-generation capability."""

    @abc.abstractmethod
    def generate(self, prompt: str, **kwargs) -> str:
        """Generate a completion for the prompt."""

    def generate_stream(self, prompt: str, **kwargs) -> Iterator[str]:
        """Stream completion chunks; by default the whole completion at once."""
        yield self.generate(prompt, **kwargs)

    @abc.abstractmethod
    def is_ready(self) -> bool:
        """Whether the provider can serve requests."""

    def get_info(self) -> dict:
        return {"provider": type(self).__name__}
