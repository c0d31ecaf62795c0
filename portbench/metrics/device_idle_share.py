"""Device: the share of the traced slice's wall time in which no
operation ran on the card (1 - the union of device operations over the
slice), in percent."""

from portbench.metrics_util import idle_share


def read(run):
    return idle_share(run.trace)
