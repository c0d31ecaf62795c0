"""The reading of ``bm25_prep_ms.py`` in the bits cell, where it moves
``device_us_per_query``."""

from portbench.manifest import reader

read = reader("bm25_prep_ms")
