"""Questions answered per second over the whole window (closed loop):
every question of every batch sent, over the window's wall time to the
end of the last batch."""


def read(run):
    return run.queries / run.window_s if run.window_s > 0 else None
