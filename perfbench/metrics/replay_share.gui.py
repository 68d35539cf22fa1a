"""Share of the window's sweeps replayed from a captured CUDA graph (the
change in `graphs.stats()` replays over the sweeps run), in %. Below 100
means a sweep ran eagerly or captured inside the window."""


def read(run):
    return 100.0 * run.replays / run.sweeps if run.sweeps else None
