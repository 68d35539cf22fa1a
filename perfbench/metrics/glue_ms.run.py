"""Device milliseconds a sweep of the operations that are none of kernels
A-G (the visit's glue), over the traced images; their initialisation's
device operations, a few per cent of the time, are counted with them."""


def read(run):
    if run.trace is None:
        return None
    steps = sum(r["steps"] for r in run.traced_images)
    glue = run.trace.seconds_by_kernel().get("glue", 0.0)
    return 1e3 * glue / steps if steps and glue > 0 else None
