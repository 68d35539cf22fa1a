"""Seconds from the process's start to the window's: imports, the card's
context, the kernels' build where it is not cached, and the warm-up that
runs each sweep's key eagerly once and captures its graph."""


def read(run):
    return run.setup_s
