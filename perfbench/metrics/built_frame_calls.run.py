"""Kernel B's calls a sweep that were handed frames built in torch, not a
`FrameSource` whose frames B builds in its loads: the program's counter
`b.frame_calls` over the window's untraced images, divided by their
sweeps. The calls outside the visits (an image's initial carried error)
count too. Nothing where the program keeps no such counter."""

from perfbench.spans import untraced_records

COUNTER = "b.frame_calls"


def read(run):
    records = untraced_records(run)
    sweeps = sum(r["steps"] for r in run.images if not r["traced"])
    # Every image's initial carried error makes such a call, so a program
    # that counts them has the counter in each record.
    if not records or not sweeps or not all(
            any(k == COUNTER for k, _ in r.counts) for r in records):
        return None
    return sum(r.total(COUNTER) for r in records) / sweeps
