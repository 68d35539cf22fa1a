"""What the program records of itself in the window's untraced images.

In a traced run the traced entry (`pipeline.run`) records each image it
converts (the program's `utils/profiling.py`: spans with host and device
times, and counters). The readers take the records made without the
profiler, the last as many as the window's untraced images, so that the
profiler's host cost is in none of them. A program that keeps no such
records gives none, and the readers then report nothing.
"""


def untraced_records(run) -> list:
    n = sum(not r["traced"] for r in run.images)
    if n == 0:
        return []
    try:
        from snesimage_torch.utils import profiling
    except ImportError:
        return []
    runs = getattr(profiling, "runs", None)
    if runs is None:
        return []
    return [r for r in runs() if not r.profiled][-n:]


def spans(records, names) -> list:
    return [s for r in records for s in r.spans if s.name in names]


def device_ms(records, names) -> float | None:
    """The device milliseconds of every span named in `names`, summed;
    None where there is none, or one was not timed on the card."""
    ms = [s.device_ms for s in spans(records, names)]
    return None if not ms or None in ms else sum(ms)
