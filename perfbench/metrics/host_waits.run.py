"""Times an image the program blocks on the device: its counter
`host_waits` (k-means iterations, the stop rule's reads, the stage
clocks' syncs, copies to and from the host), over the window's untraced
images."""

from perfbench.spans import untraced_records


def read(run):
    records = untraced_records(run)
    if not records:
        return None
    return sum(r.total("host_waits") for r in records) / len(records)
