"""The reading of ``device_idle_share.py``, in the cells whose end-to-end rate of
questions is too unsteady on the host to bound (PERF.md), where it moves
``device_us_per_query``."""

from portbench.manifest import reader

read = reader("device_idle_share")
