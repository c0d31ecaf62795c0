"""Cross-cutting core: the dependency container."""

from .container import Container, get_container, reset_container  # noqa: F401
