from .base import EmbeddingProvider  # noqa: F401
from .factory import get_embedding_provider, reset_embedding_provider  # noqa: F401
