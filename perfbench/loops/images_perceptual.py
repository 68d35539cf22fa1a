"""The closed loop of perfbench/loops/images.py (its window and its check
of the step errors, `steps_bad`) for a configuration with perceptual
palettes: each image's answer is judged against the CIEDE2000 remap and,
on a sample of "judge_sample" images drawn from the seed, the CIELAB
initialisation (perfbench/reference/perceptual.py), with the numbers of
perfbench/judge.py: json_bad, remap_off (pixels whose entry the float32
program cannot have chosen, perceptual.remap_off), tiles_off, error_gap,
steps_bad and stall.
"""

import numpy as np

from perfbench import harness, judge
from perfbench.harness import span
from perfbench.loops.images import steps_bad, window  # noqa: F401
from perfbench.reference import json_format, perceptual, remap
from perfbench.reference.ssimulacra2 import Scorer


def judge_answer(rgba: np.ndarray, text: str, carried: float, spec: dict,
                 deep: bool, scorer: Scorer | None = None) -> dict:
    """The numbers of one answer, as `judge.judge_answer` gives them for
    the red-mean remap."""
    if spec["dither"]:
        raise ValueError("the perceptual check knows the undithered remap")
    c, s = spec["subpalette_count"], spec["subpalette_size"]
    alpha = rgba[..., 3]
    palette5, tiles, pmap, bad = json_format.decode(text, c, s, alpha)
    if palette5 is None:
        return {"json_bad": bad, "remap_off": judge.UNREADABLE,
                "error_gap": judge.UNREADABLE, "final": None,
                **({"tiles_off": judge.UNREADABLE,
                    "stall": judge.UNREADABLE} if deep else {})}
    scorer = scorer or Scorer(rgba[..., :3])
    final = scorer.error(remap.render(palette5, tiles, pmap, alpha))
    out = {
        "json_bad": bad,
        "remap_off": perceptual.remap_off(rgba[..., :3], alpha, tiles,
                                          palette5, pmap),
        "error_gap": abs(float(carried) - final),
        "final": final,
    }
    if deep:
        tiles0, palette0, pmap0 = perceptual.initial_state(rgba, c, s)
        init_error = scorer.error(remap.render(palette0, tiles0, pmap0,
                                               alpha))
        out["tiles_off"] = int((tiles0 != tiles).sum())
        out["stall"] = 1.0 / max(init_error - final, judge.MIN_GAIN)
        out["init_error"] = init_error
    return out


def _deep(seed: int, spec, n: int) -> set:
    return set(harness.sample(np.random.default_rng([seed % 2 ** 64, 2]), n,
                              spec.traffic["judge_sample"]))


def check(spec, run, outputs, seed):
    """Judges every image's answer; the initialisation on a sample."""
    deep = _deep(seed, spec, len(outputs))
    answers = []
    for k, (img, text, carried, errors) in enumerate(outputs):
        with span("reference_check"):
            a = judge_answer(img, text, carried, spec.config, k in deep)
        a["steps_bad"] = steps_bad(errors, carried, spec.traffic["recipe"])
        run.images[k]["reference_final"] = a["final"]
        answers.append(a)
    return answers


def control_answer(img: np.ndarray, text: str, config: dict, deep: bool,
                   scorer: Scorer) -> dict:
    """The control's answer for the image whose program output is `text`:
    the program's palettes, with the tiles, the map and the carried error
    that the reference gives in the control's precision."""
    from perfbench.control import LOW

    c, s = config["subpalette_count"], config["subpalette_size"]
    alpha = img[..., 3]
    palette5 = json_format.decode(text, c, s, alpha)[0]
    tiles = perceptual.initial_state(img, c, s, LOW)[0]
    pmap = perceptual.palette_map(img[..., :3], alpha, tiles, palette5, LOW)
    carried = Scorer(img[..., :3], LOW).error(
        remap.render(palette5, tiles, pmap, alpha))
    return judge_answer(img, json_format.encode(palette5, tiles, pmap, alpha),
                        carried, config, deep, scorer)


def control(spec, run, outputs, seed):
    """The control's answer to every image, judged as the program's are."""
    deep = _deep(seed, spec, len(outputs))
    answers = []
    for k, (img, text, carried, errors) in enumerate(outputs):
        a = control_answer(img, text, spec.config, k in deep,
                           Scorer(img[..., :3]))
        # The control takes the program's steps as it takes its palettes.
        a["steps_bad"] = steps_bad(errors, carried, spec.traffic["recipe"])
        answers.append(a)
    return answers
