"""The reading of ``device_idle_share.py`` in the ``query`` cell, where it
moves ``device_us_per_query``."""

from portbench.manifest import reader

read = reader("device_idle_share")
