"""Milliseconds a sweep: `pipeline.run`'s `optimize_seconds` over the
sweeps run, for the window's untraced images."""


def read(run):
    imgs = [r for r in run.images if "optimize_seconds" in r and not r["traced"]]
    steps = sum(r["steps"] for r in imgs)
    if not steps:
        return None
    return 1e3 * sum(r["optimize_seconds"] for r in imgs) / steps
