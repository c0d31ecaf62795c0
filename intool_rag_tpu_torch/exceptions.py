"""The part of the JAX package's exception tree the port raises."""


class RAGError(Exception):
    """Root of the framework's exception tree."""


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
