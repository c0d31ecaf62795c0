"""Index layer: chunk store, flat and capacity-tier dense indexes, BM25,
the hybrid engine and the multi-document registry."""

from .ivf_index import IVFFlatIndex  # noqa: F401
