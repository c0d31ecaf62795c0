"""Logging setup (port of ``intool_rag_tpu/logging.py``).

One root configuration, at ``LOG_LEVEL`` and in the JAX package's format,
made by the first :func:`get_logger` call; every module of the package
takes its logger from it at import.
"""

from __future__ import annotations

import logging as _logging

from .config import get_config

_FORMAT = "%(asctime)s - %(name)s - %(levelname)s - %(message)s"
_configured = False


def _configure() -> None:
    global _configured
    if _configured:
        return
    _logging.basicConfig(level=get_config().LOG_LEVEL, format=_FORMAT)
    _configured = True


def get_logger(name: str) -> _logging.Logger:
    _configure()
    return _logging.getLogger(name)
