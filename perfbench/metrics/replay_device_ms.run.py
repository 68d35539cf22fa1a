"""Device milliseconds a sweep: the mean of the program's spans
`sweep.replay` (a captured graph's launch) and `sweep.eager`, each timed
by CUDA events, over the window's untraced images."""

from perfbench.spans import device_ms, spans, untraced_records

SWEEPS = ("sweep.replay", "sweep.eager")


def read(run):
    records = untraced_records(run)
    ms = device_ms(records, SWEEPS)
    return None if ms is None else ms / len(spans(records, SWEEPS))
