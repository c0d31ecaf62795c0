"""The reading of ``encoder_graph_share.py`` in the bits cell, where it
moves ``device_us_per_query``."""

from portbench.manifest import reader

read = reader("encoder_graph_share")
