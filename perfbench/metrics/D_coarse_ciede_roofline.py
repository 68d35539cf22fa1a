"""Kernel D's share of its roofline over the traced images, in %: the least
time of the work the cell gave it (perfbench/roofline/D_coarse_ciede.py) over
its device time in the trace."""

from perfbench.roofline import D_coarse_ciede as kernel


def read(run):
    if run.trace is None or not run.traced_images:
        return None
    device = run.trace.seconds_by_kernel().get(kernel.KERNEL, 0.0)
    if device <= 0:
        return None
    steps = [r["steps"] for r in run.traced_images]
    return 100.0 * kernel.least_seconds(run.config, steps) / device
