"""Host milliseconds a replayed sweep spends binding its graph: the mean
of the program's span `sweep.bind` (the copies of the state, the error
and the pyramid into the graph's buffers, and the draws filled one
`randint` a visit), over the window's untraced images."""

from perfbench.spans import spans, untraced_records


def read(run):
    binds = spans(untraced_records(run), ("sweep.bind",))
    return sum(s.host_ms for s in binds) / len(binds) if binds else None
