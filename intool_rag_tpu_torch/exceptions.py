"""The part of the JAX package's exception tree the port raises."""


class RAGError(Exception):
    """Root of the framework's exception tree."""


class ProviderError(RAGError):
    pass


class EmbeddingProviderError(ProviderError):
    pass


class LLMProviderError(ProviderError):
    pass


class ProviderConnectionError(ProviderError):
    pass


class ProviderTimeoutError(ProviderError):
    pass


class VectorStoreError(RAGError):
    pass


class IndexNotFoundError(VectorStoreError):
    pass


class IngestError(RAGError):
    pass


class DocumentLoadError(IngestError):
    pass


class UnsupportedFormatError(DocumentLoadError):
    pass


class PDFParseError(DocumentLoadError):
    pass
