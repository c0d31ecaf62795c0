"""Seconds from the start of the process to the opening of the window:
loading, the kernels' build or load, the inputs drawn from the seed, the
system's construction and the warm-up of every shape the traffic uses."""


def read(run):
    return run.setup_s
