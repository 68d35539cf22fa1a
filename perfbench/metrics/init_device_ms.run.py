"""Device milliseconds an image of the initialisation: the program's spans
`init`, `cluster` and `pyramid`, each timed by CUDA events, summed over
the window's untraced images."""

from perfbench.spans import device_ms, untraced_records


def read(run):
    records = untraced_records(run)
    ms = device_ms(records, ("init", "cluster", "pyramid"))
    return None if ms is None else ms / len(records)
