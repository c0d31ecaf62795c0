"""Dependency container: lazy, thread-safe owners of process-wide
resources and their shutdown (port of ``intool_rag_tpu/core/container.py``).

The port's provider HTTP has no pooled client (``providers/http_utils.py``
opens one connection per request), so the container hands out that module
as the HTTP client and has nothing of it to close."""

from __future__ import annotations

import threading

import torch

from ..logging import get_logger

logger = get_logger(__name__)


class Container:
    """Builds each resource on first use, on ``device`` (default CUDA)."""

    def __init__(self, device: str | torch.device | None = None) -> None:
        self.device = device
        self._lock = threading.Lock()
        self._http_client = None
        self._llm = None
        self._embedding_provider = None
        self._registry = None

    def get_http_client(self):
        if self._http_client is None:
            with self._lock:
                if self._http_client is None:
                    from ..providers import http_utils

                    self._http_client = http_utils
        return self._http_client

    def get_llm_provider(self):
        if self._llm is None:
            with self._lock:
                if self._llm is None:
                    from ..llm.factory import get_llm

                    self._llm = get_llm(self.device)
        return self._llm

    def get_embedding_provider(self):
        if self._embedding_provider is None:
            with self._lock:
                if self._embedding_provider is None:
                    from ..llm.embeddings.factory import get_embedding_provider

                    self._embedding_provider = get_embedding_provider(self.device)
        return self._embedding_provider

    def get_registry(self):
        if self._registry is None:
            with self._lock:
                if self._registry is None:
                    from ..index.registry import get_registry

                    self._registry = get_registry(self.device)
        return self._registry

    def shutdown(self) -> None:
        """Drop every resource; the next ``get_*`` builds it again."""
        with self._lock:
            self._http_client = None
            self._llm = None
            self._embedding_provider = None
            self._registry = None


_container: Container | None = None
_container_lock = threading.Lock()


def get_container(device: str | torch.device | None = None) -> Container:
    global _container
    if _container is None:
        with _container_lock:
            if _container is None:
                _container = Container(device)
    return _container


def reset_container() -> None:
    global _container
    if _container is not None:
        _container.shutdown()
    _container = None
