"""Share of an image's entry time spent initialising (tile assignment,
k-means, remap): `pipeline.run`'s `init_seconds` over `init_seconds +
optimize_seconds`, summed over the window's untraced images, in %."""


def read(run):
    imgs = [r for r in run.images if "init_seconds" in r and not r["traced"]]
    init = sum(r["init_seconds"] for r in imgs)
    total = init + sum(r["optimize_seconds"] for r in imgs)
    return 100.0 * init / total if total > 0 else None
