"""Share of the program's span `optimize` on the device's clock that no
sweep covers: 1 - (device ms of the spans `sweep.replay` and
`sweep.eager`) / (device ms of `optimize`), summed over the window's
untraced images, in %. What is left is the device idle between sweeps
and the few copies that bind a graph's inputs."""

from perfbench.spans import device_ms, untraced_records


def read(run):
    records = untraced_records(run)
    total = device_ms(records, ("optimize",))
    sweeps = device_ms(records, ("sweep.replay", "sweep.eager"))
    if not total or sweeps is None:
        return None
    return 100.0 * (1.0 - sweeps / total)
