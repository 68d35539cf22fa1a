"""Share of the gated visits whose gate closed: the program's counters
(`gate.closed` + `gate.closed_coarse`) / `gate.visits`, over the window's
untraced images, in %."""

from perfbench.spans import untraced_records


def read(run):
    records = untraced_records(run)
    visits = sum(r.total("gate.visits") for r in records)
    closed = [r.total(k) for r in records
              for k in ("gate.closed", "gate.closed_coarse")]
    if not visits or None in closed:
        return None
    return 100.0 * sum(closed) / visits
