"""The reading of ``launches_per_batch.py``, in the cells whose end-to-end rate of
questions is too unsteady on the host to bound (PERF.md), where it moves
``device_us_per_query``."""

from portbench.manifest import reader

read = reader("launches_per_batch")
