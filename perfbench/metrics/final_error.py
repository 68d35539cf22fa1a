"""Final error (100 - SSIMULACRA2) as the benchmark's plain reference
scores each output against its source: each distinct image of the mix's
set counts once (the mean over its repeats in the window), and the result
is the mean over content kinds of each kind's mean, so that neither a
repeat nor a kind that gets one image more weighs more."""


def read(run):
    by_member = {}
    for image in run.images:
        if image.get("reference_final") is not None:
            by_member.setdefault((image["kind"], image["member"]), []).append(
                image["reference_final"])
    if not by_member:
        return None
    by_kind = {}
    for (kind, _), finals in by_member.items():
        by_kind.setdefault(kind, []).append(sum(finals) / len(finals))
    means = [sum(v) / len(v) for v in by_kind.values()]
    return sum(means) / len(means)
