"""The comparison that decides `correct`: the program's outputs against the
plain reference (perfbench/reference), number by number.

The answers judged are what the timed path hands a user: the JSON text of
each converted image (or of the GUI's last state), the error the program
carried for it, and in the GUI cell the frames it redrew. Each answer
gives these numbers; a cell's reading of a number is the largest over its
answers, and each has a limit of its own (perfbench/limits/<cell>.json):

- json_bad: breaches of the reference's JSON format, plus one where the
  text is not the reference's encoding of what it decodes to (limit 0);
- remap_off: pixels whose entry is not the one the reference's remap
  (red-mean, or Floyd-Steinberg when dithered) gives under the output's
  own palette and tiles (limit 0);
- tiles_off: tiles whose subpalette is not the reference initialisation's
  (the sweeps never move a tile, so the output keeps the init's; limit 0);
- init_px_off (GUI): pixels of the first frame, the initial state as the
  GUI draws it, that differ from the reference initialisation's render
  (limit 0);
- error_gap: |the program's carried error - the reference's SSIMULACRA2
  error of the rendered output| (for the GUI, also of each judged step's
  frame against that step's error);
- steps_bad (image cells, perfbench/loops/images.py): faults of the step
  errors the entry returned: one not finite, a last one that is not the
  carried error, more steps than the recipe allows (limit 0);
- stall: 1 / (the reference init's error - the reference error of the
  output), with the gain floored at 0.001: a run whose sweeps changed
  nothing reads about 1000.

Answers that cost little (json_bad, remap_off, error_gap) are judged for
every image; the initialisation (tiles_off, stall) for a sample drawn from
the seed.
"""

from __future__ import annotations

import numpy as np

from perfbench.reference import json_format, remap
from perfbench.reference.init import initial_state
from perfbench.reference.ssimulacra2 import Scorer

MIN_GAIN = 1e-3
# What a number reads where the answer cannot be decoded at all (finite,
# so that the result line stays plain JSON).
UNREADABLE = 1e9


def judge_answer(rgba: np.ndarray, text: str, carried: float, spec: dict,
                 deep: bool, scorer: Scorer | None = None) -> dict:
    """The numbers of one answer, and "final" (the reference's error of the
    output) and "init_error" where `deep`. `spec` holds subpalette_count,
    subpalette_size and dither."""
    c, s, dithered = (spec["subpalette_count"], spec["subpalette_size"],
                      spec["dither"])
    alpha = rgba[..., 3]
    palette5, tiles, pmap, bad = json_format.decode(text, c, s, alpha)
    if palette5 is None:
        return {"json_bad": bad, "remap_off": UNREADABLE,
                "error_gap": UNREADABLE, "final": None,
                **({"tiles_off": UNREADABLE, "stall": UNREADABLE}
                   if deep else {})}
    scorer = scorer or Scorer(rgba[..., :3])
    final = scorer.error(remap.render(palette5, tiles, pmap, alpha))
    out = {
        "json_bad": bad,
        "remap_off": int((remap.palette_map(rgba[..., :3], alpha, tiles,
                                            palette5, dithered)
                          != pmap).sum()),
        "error_gap": abs(float(carried) - final),
        "final": final,
    }
    if deep:
        tiles0, palette0, pmap0 = initial_state(rgba, c, s, dithered)
        init_error = scorer.error(remap.render(palette0, tiles0, pmap0,
                                               alpha))
        out["tiles_off"] = int((tiles0 != tiles).sum())
        out["stall"] = 1.0 / max(init_error - final, MIN_GAIN)
        out["init_error"] = init_error
    return out


def judge_frames(rgba: np.ndarray, frames: list, errors: list,
                 scorer: Scorer) -> float:
    """The largest |step error - the reference's error of the step's frame|
    over the (H, W, 3) frames given."""
    return max((abs(float(e) - scorer.error(f)) for f, e in zip(frames, errors)),
               default=0.0)


def judge_init_frame(rgba: np.ndarray, frame: np.ndarray, spec: dict) -> int:
    """Pixels of the GUI's first frame that differ from the reference
    initialisation's render."""
    tiles0, palette0, pmap0 = initial_state(
        rgba, spec["subpalette_count"], spec["subpalette_size"], spec["dither"])
    ref = remap.render(palette0, tiles0, pmap0, rgba[..., 3])
    return int((np.asarray(frame) != ref).any(-1).sum())


def reading(per_answer: list[dict], name: str):
    """A cell's reading of a number: the largest over the answers that
    have it, or None."""
    values = [a[name] for a in per_answer if name in a]
    return max(values) if values else None


def verdict(readings: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {number: {"value", "limit"}}): every number the limits
    name must be read and lie within its limit."""
    checks, ok = {}, True
    for name, limit in limits.items():
        value = readings.get(name)
        checks[name] = {"value": value, "limit": limit}
        if value is None or not value <= limit:
            ok = False
    return ok, checks


def failed_answers(per_answer: list[dict], limits: dict) -> int:
    """Answers with any number over its limit."""
    return sum(any(name in a and not a[name] <= limit
                   for name, limit in limits.items()) for a in per_answer)
